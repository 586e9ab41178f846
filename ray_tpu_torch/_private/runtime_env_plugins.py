"""Runtime-env plugin protocol: extensible per-key env materialization.

The port's copy of ``ray_tpu/_private/runtime_env_plugins.py``.

Capability parity with the reference's plugin architecture (reference:
``python/ray/_private/runtime_env/plugin.py:1`` — ``RuntimeEnvPlugin``
ABC with per-key validate/create/modify-context hooks, priority ordering,
and ``RAY_RUNTIME_ENV_PLUGINS`` third-party loading), re-designed for
this runtime's driver/worker split:

- ``validate(value)``   — driver, raise on malformed config
- ``prepare(value, ctx)``— driver: upload blobs via ``ctx.kv_put``,
  return the JSON-safe wire form shipped in the task/actor spec
- ``apply(wire, ctx)``  — worker: materialize (extract/install/chdir/
  sys.path) using ``ctx.kv_get`` + ``ctx.scratch_dir``

Built-ins (env_vars, working_dir, py_modules, pip, conda) are instances
of the same protocol, registered at import; third-party plugins load
from the ``RT_RUNTIME_ENV_PLUGINS`` env var (comma-separated
``module:Class`` refs — the reference's ``RAY_RUNTIME_ENV_PLUGINS``
mechanism) or programmatically via :func:`register_plugin`.

Ordering: plugins apply sorted by ``priority`` (lower first), matching
the reference's ``RuntimeEnvPlugin.priority`` semantics — e.g. ``conda``
(interpreter-level, priority 5) applies before ``working_dir`` /
``py_modules`` (path-level, 10) so user code shadows packed packages.
"""
from __future__ import annotations

import importlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass
class PrepareContext:
    """Driver-side services available to ``prepare``."""
    kv_put: Callable[[str, bytes], None]


@dataclass
class ApplyContext:
    """Worker-side services available to ``apply``."""
    kv_get: Callable[[str], Optional[bytes]]
    scratch_dir: str


class RuntimeEnvPlugin:
    """One runtime_env key's lifecycle (reference ``plugin.py:30``)."""

    #: the runtime_env dict key this plugin owns
    name: str = ""
    #: apply order, lower first (reference: ``priority``, default 10)
    priority: int = 10
    #: skip prepare() for falsy values ({} env_vars is a no-op). Leave
    #: False for third-party plugins: {} / 0 may be valid configs.
    skip_empty: bool = False

    def validate(self, value: Any) -> Any:
        """Raise ValueError on malformed config; return (possibly
        normalized) value."""
        return value

    def prepare(self, value: Any, ctx: PrepareContext) -> Any:
        """Driver side: upload any blobs, return the wire form (must be
        JSON/pickle-safe and stable — it participates in env_hash)."""
        return value

    def apply(self, wire: Any, ctx: ApplyContext) -> None:
        """Worker side: materialize the env in this process."""

    def uris(self, wire: Any) -> List[str]:
        """Cache URIs this wire form pins (for eviction accounting)."""
        return []

    # -- wire-dict adapters (built-ins override to keep their legacy
    # flat wire keys; third-party plugins live under "plugin:<name>") --
    def _prepare_into(self, value: Any, out: dict,
                      ctx: PrepareContext) -> None:
        out[f"plugin:{self.name}"] = self.prepare(value, ctx)

    def _apply_from(self, wire: dict, ctx: ApplyContext) -> None:
        w = wire.get(f"plugin:{self.name}")
        if w is not None:
            self.apply(w, ctx)


_registry: Dict[str, RuntimeEnvPlugin] = {}
_env_loaded = False


def register_plugin(plugin: RuntimeEnvPlugin, *,
                    allow_override: bool = False) -> None:
    if not plugin.name:
        raise ValueError("plugin needs a non-empty .name")
    if plugin.name in _registry and not allow_override:
        raise ValueError(f"runtime_env plugin {plugin.name!r} already "
                         "registered")
    _registry[plugin.name] = plugin


def unregister_plugin(name: str) -> None:
    _registry.pop(name, None)


def _load_env_plugins() -> None:
    """Load third-party plugins named in RT_RUNTIME_ENV_PLUGINS
    (``module:Class`` comma-separated), once per process."""
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get("RT_RUNTIME_ENV_PLUGINS", "")
    for ref in filter(None, (s.strip() for s in spec.split(","))):
        mod_name, _, cls_name = ref.partition(":")
        cls = getattr(importlib.import_module(mod_name), cls_name)
        register_plugin(cls(), allow_override=True)


def plugins() -> List[RuntimeEnvPlugin]:
    """Registered plugins in apply order (priority, then name)."""
    _load_env_plugins()
    return sorted(_registry.values(), key=lambda p: (p.priority, p.name))


def get_plugin(name: str) -> Optional[RuntimeEnvPlugin]:
    _load_env_plugins()
    return _registry.get(name)
