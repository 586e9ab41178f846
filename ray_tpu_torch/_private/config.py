"""Central config/flag registry (the port's copy of
``ray_tpu/_private/config.py``, without the reference's two TPU slice
flags, which nothing reads).

Mirrors the *capability* of the reference's single macro table of
``RAY_CONFIG(type, name, default)`` flags (reference:
``src/ray/common/ray_config_def.h:22``): one declarative table, every flag
overridable per-process via ``RT_<NAME>`` environment variables, plus a
cluster-level ``system_config`` dict passed through ``init()``.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict


def _parse_bool(v: str) -> bool:
    return v.lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}

# name -> (type, default, doc)
_FLAG_TABLE: Dict[str, tuple] = {}


def _flag(name: str, typ: type, default: Any, doc: str = ""):
    _FLAG_TABLE[name] = (typ, default, doc)


# --- Core runtime -----------------------------------------------------------
_flag("max_inline_object_size", int, 100 * 1024,
      "Objects <= this many bytes live in the owner's in-process memory "
      "store; larger objects go to the node shared-memory store.")
_flag("object_store_memory", int, 2 * 1024**3,
      "Bytes of shared memory reserved for the node object store.")
_flag("worker_lease_timeout_s", float, 30.0,
      "How long a task waits for a worker lease before erroring.")
_flag("lease_idle_ttl_s", float, 2.0,
      "Idle leased workers return to the shared pool after this long.")
_flag("dashboard_port", int, 0,
      "Dashboard HTTP port (0 = ephemeral, -1 = disabled).")
_flag("actor_gc_grace_s", float, 1.0,
      "Delay before killing an actor whose handle count hit zero.")
_flag("borrow_release_grace_s", float, 2.0,
      "Delay before a finished submission's arg borrows are released "
      "(covers in-flight borrower ref_incs on other connections).")
_flag("task_max_retries", int, 3, "Default retry count for failed tasks.")
_flag("actor_max_restarts", int, 0, "Default actor restart count.")
_flag("num_workers_soft_limit", int, 0,
      "0 = one worker per logical CPU resource.")
_flag("health_check_period_s", float, 1.0,
      "Node health-check ping period (head -> node daemons).")
_flag("health_check_failure_threshold", int, 5,
      "Consecutive failed pings before a node is marked dead.")
_flag("scheduler_spread_threshold", float, 0.5,
      "Hybrid policy: prefer local node below this utilization, else spread.")
_flag("scheduler_top_k_fraction", float, 0.2,
      "Hybrid policy: random choice among the best k=max(1, frac*n) nodes.")
_flag("pubsub_poll_timeout_s", float, 60.0, "Long-poll timeout for pubsub.")
_flag("metrics_report_period_s", float, 5.0, "Metrics export period.")
_flag("rpc_connect_timeout_s", float, 10.0, "Socket connect timeout.")
_flag("shm_chunk_size", int, 8 * 1024 * 1024,
      "Chunk size for spilled / transferred object streaming.")
_flag("spill_directory", str, "", "Directory for object spilling ('' = tmp).")
_flag("enable_timeline", bool, True, "Record task timeline events.")
_flag("lineage_enabled", bool, True,
      "Keep task specs for lineage reconstruction of lost objects.")
_flag("memory_usage_threshold", float, 0.95,
      "Node memory usage fraction above which workers are OOM-killed.")
_flag("memory_monitor_refresh_ms", int, 250,
      "Memory monitor sampling period (0 disables the monitor).")
_flag("memory_monitor_min_free_bytes", int, -1,
      "Additionally require this much free memory (-1 = fraction only).")
_flag("memory_monitor_kill_grace_s", float, 2.0,
      "Minimum seconds between OOM kills on one node (lets a kill "
      "actually release memory before the next policy decision).")

# --- accelerators -----------------------------------------------------------
_flag("mesh_default_axis", str, "data", "Default mesh axis for collectives.")


class Config:
    """Process-wide config. Values resolve env var > system_config > default."""

    def __init__(self, system_config: Dict[str, Any] | None = None):
        self._overrides: Dict[str, Any] = dict(system_config or {})
        for k in self._overrides:
            if k not in _FLAG_TABLE:
                raise ValueError(f"Unknown system_config flag: {k}")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            typ, default, _doc = _FLAG_TABLE[name]
        except KeyError:
            raise AttributeError(f"Unknown config flag: {name}") from None
        env = os.environ.get("RT_" + name.upper())
        if env is not None:
            return _PARSERS[typ](env)
        if name in self._overrides:
            return self._overrides[name]
        return default

    def to_dict(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in _FLAG_TABLE}


_global_config = Config()


def global_config() -> Config:
    return _global_config


def set_global_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
