"""Runtime environments: per-task/actor env vars, working_dir, py_modules.

The port's copy of ``ray_tpu/_private/runtime_env.py``.

Capability parity with the reference's runtime_env subsystem (reference:
``python/ray/_private/runtime_env/`` — working_dir/py_modules packaging
via zip blobs in GCS, env_vars plumbed to worker startup, pip installs),
re-designed for this runtime:

- ``working_dir``/``py_modules`` zip locally, ship through the head KV
  (sha-keyed, deduped) and extract once per worker into session scratch,
- ``env_vars`` apply at worker level: the lease shape key includes the
  runtime-env hash, so tasks with different envs never share a worker
  (the reference isolates the same way — dedicated workers per env),
- ``pip`` installs from a LOCAL WHEELHOUSE into per-env-hash cached
  package dirs (reference: ``runtime_env/pip.py`` virtualenv-per-hash +
  ``uri_cache.py`` eviction, re-designed for zero egress):
  ``pip={"packages": [...], "wheelhouse": "/path/to/wheels"}`` (or the
  ``RT_PIP_WHEELHOUSE`` env var) runs ``pip install --no-index
  --find-links <wheelhouse> --target <cache>/<hash>`` once per env
  hash, then prepends the cached dir to the dedicated worker's
  ``sys.path`` (the lease shape key isolates workers per env, so this
  is the venv-interpreter isolation without a respawn). Without a
  wheelhouse, ``pip`` degrades to import-validation: packages must be
  baked into the image, missing ones raise instead of downloading.
"""
from __future__ import annotations

import hashlib
import importlib.util
import io
import json
import os
import sys
import time
import zipfile
from typing import Any, Dict, Optional, Tuple

_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
MAX_PACKAGE_BYTES = 100 * 1024 * 1024


def validate(runtime_env: Dict[str, Any]) -> Dict[str, Any]:
    """Per-key validation, dispatched to the plugin registry (built-ins
    plus anything registered — reference: plugin.py validate hooks)."""
    from . import runtime_env_plugins as rep

    known = {p.name: p for p in rep.plugins()}
    unknown = set(runtime_env) - set(known)
    if unknown:
        raise ValueError(
            f"unsupported runtime_env keys {sorted(unknown)}; "
            f"supported: {sorted(known)}")
    out = dict(runtime_env)
    for key, value in out.items():
        out[key] = known[key].validate(value)
    return out


def zip_directory(path: str) -> bytes:
    """Deterministic zip of a directory tree (the reference's
    ``package_utils`` blob format, rebuilt)."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise ValueError(f"working_dir {path!r} is not a directory")
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
            for name in sorted(files):
                full = os.path.join(root, name)
                rel = os.path.relpath(full, path)
                total += os.path.getsize(full)
                if total > MAX_PACKAGE_BYTES:
                    raise ValueError(
                        f"working_dir exceeds {MAX_PACKAGE_BYTES} bytes")
                zi = zipfile.ZipInfo(rel)  # fixed date → stable sha
                zi.compress_type = zipfile.ZIP_DEFLATED  # ZipInfo defaults
                with open(full, "rb") as f:              # to STORED
                    zf.writestr(zi, f.read())
    return buf.getvalue()


def package_key(blob: bytes, kind: str = "working_dir") -> str:
    return f"runtime_env/{kind}/{hashlib.sha256(blob).hexdigest()[:32]}"


def env_hash(runtime_env: Optional[Dict[str, Any]]) -> str:
    """Stable hash naming the worker-pool partition for this env."""
    if not runtime_env:
        return ""
    return hashlib.sha256(
        json.dumps(runtime_env, sort_keys=True).encode()
    ).hexdigest()[:16]


def prepare(runtime_env: Dict[str, Any], kv_put) -> Dict[str, Any]:
    """Driver side: validate, upload packages, return the wire form.
    Each key's work is its plugin's ``prepare`` (built-ins keep their
    legacy flat wire keys; third-party plugins nest under
    ``plugin:<name>``)."""
    from . import runtime_env_plugins as rep

    runtime_env = validate(dict(runtime_env))
    ctx = rep.PrepareContext(kv_put=kv_put)
    out: Dict[str, Any] = {}
    for plugin in rep.plugins():
        if plugin.name not in runtime_env:
            continue
        value = runtime_env[plugin.name]
        # Built-ins keep the legacy falsy-skip ({} env_vars, empty
        # py_modules list are no-ops); third-party plugins get their
        # prepare for ANY present value — {} or 0 may be a valid
        # all-defaults config, and silently dropping it would make the
        # env never materialize with no error.
        if plugin.skip_empty and not value:
            continue
        plugin._prepare_into(value, out, ctx)
    return out


def apply(wire_env: Dict[str, Any], kv_get, scratch_dir: str) -> None:
    """Worker side: materialize the env in THIS process (the worker is
    dedicated to this env via the lease shape key). Plugins apply in
    priority order — interpreter-level (conda, pip) before path-level
    (working_dir, py_modules), so user code shadows packed packages."""
    from . import runtime_env_plugins as rep

    ctx = rep.ApplyContext(kv_get=kv_get, scratch_dir=scratch_dir)
    for plugin in rep.plugins():
        plugin._apply_from(wire_env, ctx)


def _pip_cache_root() -> str:
    return os.path.join(os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch",
                        "pip_envs")


def _cached_build(root: str, key: str, build_fn) -> str:
    """Shared per-hash cache discipline (flock + staging dir + atomic
    replace + .ok LRU marker) for materialized envs — one copy of the
    locking/eviction rules for pip installs AND packed-env extraction,
    so fixes cannot drift between them. ``build_fn(stage_dir)``
    populates the staging dir; any exception cleans the stage and
    propagates."""
    import fcntl
    import shutil

    os.makedirs(root, exist_ok=True)
    env_dir = os.path.join(root, key)
    marker = env_dir + ".ok"
    with open(os.path.join(root, key + ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                os.utime(marker)  # LRU touch
                return env_dir
            # Build into staging and rename: a crash mid-build must not
            # leave a partial env that a retry would adopt and marker.
            stage = env_dir + ".staging"
            shutil.rmtree(stage, ignore_errors=True)
            try:
                build_fn(stage)
            except BaseException:
                shutil.rmtree(stage, ignore_errors=True)
                raise
            shutil.rmtree(env_dir, ignore_errors=True)
            os.replace(stage, env_dir)
            open(marker, "w").close()
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return env_dir


def ensure_pip_env(packages, wheelhouse: str) -> str:
    """Install ``packages`` from the local wheelhouse into a cached
    per-hash package dir; return it (reference: ``pip.py``'s
    virtualenv-per-hash + ``uri_cache.py``'s eviction). Concurrent
    workers serialize on a file lock; a hit only touches the marker
    (its mtime is the LRU clock)."""
    import subprocess

    root = _pip_cache_root()
    # The cache key covers the wheelhouse CONTENTS (filename+size+mtime),
    # not just its path: with unpinned requirements, dropping a newer
    # wheel into the same wheelhouse must invalidate the cached env
    # instead of silently serving the stale install forever.
    try:
        wheels = sorted(
            (e.name, e.stat().st_size, int(e.stat().st_mtime))
            for e in os.scandir(wheelhouse) if e.is_file())
    except OSError:
        wheels = []
    h = hashlib.sha256(json.dumps(
        [sorted(packages), os.path.abspath(wheelhouse), wheels]).encode()
    ).hexdigest()[:16]

    def build(stage):
        proc = subprocess.run(
            [sys.executable, "-m", "pip", "install", "--quiet",
             "--no-index", "--find-links", wheelhouse,
             "--target", stage, *packages],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"pip install from wheelhouse {wheelhouse!r} failed "
                f"for {list(packages)}: {proc.stderr[-2000:]}")

    env_dir = _cached_build(root, h, build)
    _evict_pip_envs(keep=env_dir)
    return env_dir


def _evict_pip_envs(keep: str = "",
                    cap: Optional[int] = None) -> None:
    """Drop least-recently-used cached pip envs beyond the cap
    (``RT_PIP_ENV_CACHE_SIZE``, default 10). Best-effort: an env
    evicted while an old worker still imports from it only affects
    that worker's COLD imports, and the next use reinstalls."""
    import shutil

    root = _pip_cache_root()
    cap = cap if cap is not None else int(
        os.environ.get("RT_PIP_ENV_CACHE_SIZE", "10"))
    listed_at = time.time()
    try:
        markers = sorted(
            (os.path.join(root, f) for f in os.listdir(root)
             if f.endswith(".ok")),
            key=os.path.getmtime)
    except OSError:
        return
    import fcntl

    excess = len(markers) - cap
    for m in markers:
        if excess <= 0:
            break
        env_dir = m[:-3]
        if env_dir == keep:
            continue
        # Evict only under the env's lock (non-blocking): a concurrent
        # ensure_pip_env holding it may be mid-install or about to
        # return this dir to a fresh worker — skip rather than delete
        # a directory someone just adopted.
        try:
            lockf = open(env_dir + ".lock", "w")
        except OSError:
            continue
        try:
            try:
                fcntl.flock(lockf, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                continue  # in use right now
            # a hit may have touched the marker after we listed it —
            # it is no longer LRU, and its adopter is importing from it
            if os.path.getmtime(m) >= listed_at - 1.0:
                continue
            os.unlink(m)  # marker first: a racing hit re-installs
            shutil.rmtree(env_dir, ignore_errors=True)
            # the .lock file STAYS: unlinking it would let a racing
            # ensure_pip_env flock a fresh inode while another holds
            # the old one — two concurrent installs into one dir
        except OSError:
            pass
        finally:
            lockf.close()
        excess -= 1


def _extract(key: str, kv_get, scratch_dir: str) -> str:
    blob = kv_get(key)
    if blob is None:
        raise RuntimeError(f"runtime_env package {key!r} missing from KV")
    target = os.path.join(scratch_dir, key.replace("/", "_"))
    marker = target + ".ok"
    if not os.path.exists(marker):
        os.makedirs(target, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(bytes(blob))) as zf:
            zf.extractall(target)
        open(marker, "w").close()
    return target


# --------------------------------------------------------------- conda
def _conda_cache_root() -> str:
    return os.path.join(os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch",
                        "conda_envs")


def ensure_extracted_env(tarball: str) -> str:
    """Extract a conda-pack-style tarball into a per-hash cached dir
    (reference: ``conda.py``'s env-per-hash, re-designed egress-free for
    packed envs). Cache discipline shared with pip via
    :func:`_cached_build`."""
    import tarfile

    tarball = os.path.abspath(tarball)
    st = os.stat(tarball)
    h = hashlib.sha256(json.dumps(
        [tarball, st.st_size, int(st.st_mtime)]).encode()).hexdigest()[:16]

    def build(stage):
        os.makedirs(stage)
        with tarfile.open(tarball) as tf:
            # "data" filter: refuse absolute paths / traversal /
            # device nodes from untrusted archives
            tf.extractall(stage, filter="data")

    return _cached_build(_conda_cache_root(), h, build)


def _activate_env_prefix(prefix: str) -> None:
    """Put an env prefix's site-packages on sys.path and its bin on
    PATH — the packed-env equivalent of conda activate."""
    import glob as _glob

    sites = _glob.glob(os.path.join(prefix, "lib", "python*",
                                    "site-packages"))
    for site in sites:
        if site not in sys.path:
            sys.path.insert(0, site)
    bin_dir = os.path.join(prefix, "bin")
    if os.path.isdir(bin_dir):
        parts = os.environ.get("PATH", "").split(os.pathsep)
        if bin_dir not in parts:
            os.environ["PATH"] = bin_dir + os.pathsep + \
                os.environ.get("PATH", "")
    importlib.invalidate_caches()


# ------------------------------------------------- built-in plugins
from . import runtime_env_plugins as _rep  # noqa: E402


class _EnvVarsPlugin(_rep.RuntimeEnvPlugin):
    skip_empty = True
    name = "env_vars"
    priority = 8

    def validate(self, value):
        if not isinstance(value, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in value.items()):
            raise ValueError("runtime_env env_vars must be str->str")
        return value

    def _prepare_into(self, value, out, ctx):
        out["env_vars"] = dict(value)

    def _apply_from(self, wire, ctx):
        for k, v in (wire.get("env_vars") or {}).items():
            os.environ[k] = v


class _WorkingDirPlugin(_rep.RuntimeEnvPlugin):
    skip_empty = True
    name = "working_dir"
    priority = 10

    def _prepare_into(self, value, out, ctx):
        blob = zip_directory(value)
        key = package_key(blob, "working_dir")
        ctx.kv_put(key, blob)
        out["working_dir_key"] = key

    def _apply_from(self, wire, ctx):
        wd_key = wire.get("working_dir_key")
        if not wd_key:
            return
        target = _extract(wd_key, ctx.kv_get, ctx.scratch_dir)
        os.chdir(target)
        if target not in sys.path:
            sys.path.insert(0, target)

    def uris(self, wire):
        return [wire["working_dir_key"]] if wire.get(
            "working_dir_key") else []


class _PyModulesPlugin(_rep.RuntimeEnvPlugin):
    skip_empty = True
    name = "py_modules"
    priority = 11

    def validate(self, value):
        if not isinstance(value, (list, tuple)) or not all(
                isinstance(p, str) for p in value):
            raise ValueError(
                "runtime_env py_modules must be a list of paths")
        return list(value)

    def _prepare_into(self, value, out, ctx):
        mods = []
        for mod_path in value:
            blob = zip_directory(mod_path)
            key = package_key(blob, "py_module")
            ctx.kv_put(key, blob)
            mods.append((os.path.basename(mod_path.rstrip("/")), key))
        if mods:
            out["py_module_keys"] = mods

    def _apply_from(self, wire, ctx):
        for mod_name, key in wire.get("py_module_keys") or []:
            target = _extract(key, ctx.kv_get, ctx.scratch_dir)
            # a py_module zip IS the module dir: expose its parent
            parent = os.path.dirname(target)
            link = os.path.join(parent, mod_name)
            if not os.path.exists(link):
                os.symlink(target, link)
            if parent not in sys.path:
                sys.path.insert(0, parent)

    def uris(self, wire):
        return [k for _, k in wire.get("py_module_keys") or []]


class _PipPlugin(_rep.RuntimeEnvPlugin):
    skip_empty = True
    name = "pip"
    priority = 6

    def validate(self, value):
        if isinstance(value, dict):
            if set(value) - {"packages", "wheelhouse"}:
                raise ValueError(
                    "runtime_env pip dict accepts only "
                    "'packages' and 'wheelhouse'")
            pkgs = value.get("packages")
            wh = value.get("wheelhouse")
            if pkgs is not None and (
                    not isinstance(pkgs, (list, tuple))
                    or not all(isinstance(p, str) for p in pkgs)):
                raise ValueError(
                    "runtime_env pip packages must be a LIST of "
                    "requirement strings (a bare string would be "
                    "split into characters)")
            if wh is not None and not isinstance(wh, str):
                raise ValueError("runtime_env pip wheelhouse must be "
                                 "a directory path string")
        elif isinstance(value, (list, tuple)):
            if not all(isinstance(p, str) for p in value):
                raise ValueError(
                    "runtime_env pip must be a list of requirement "
                    "strings")
        else:
            raise ValueError(
                "runtime_env pip must be a list of requirements or "
                "{'packages': [...], 'wheelhouse': <dir>}")
        return value

    def _prepare_into(self, value, out, ctx):
        if isinstance(value, dict):
            wh = value.get("wheelhouse")
            out["pip"] = {
                "packages": list(value.get("packages") or []),
                "wheelhouse": os.path.abspath(wh) if wh else None,
            }
        else:
            out["pip"] = {"packages": list(value), "wheelhouse": None}

    def _apply_from(self, wire, ctx):
        pip = wire.get("pip")
        if not pip:
            return
        if isinstance(pip, dict):
            packages = pip.get("packages") or []
            wheelhouse = pip.get("wheelhouse") or \
                os.environ.get("RT_PIP_WHEELHOUSE")
        else:  # legacy wire form: bare list
            packages, wheelhouse = list(pip), \
                os.environ.get("RT_PIP_WHEELHOUSE")
        if wheelhouse and packages:
            env_dir = ensure_pip_env(packages, wheelhouse)
            if env_dir not in sys.path:
                sys.path.insert(0, env_dir)
            importlib.invalidate_caches()
        else:
            for name in packages:
                base = name.split("==")[0].split(">=")[0].split("[")[0]
                base = base.replace("-", "_")
                if importlib.util.find_spec(base) is None:
                    raise RuntimeError(
                        f"runtime_env pip package {name!r} is not "
                        "available and this deployment is zero-egress; "
                        "bake it into the image or provide a "
                        "'wheelhouse' (RT_PIP_WHEELHOUSE)")


class _CondaPlugin(_rep.RuntimeEnvPlugin):
    """Packed-env conda (reference: ``runtime_env/conda.py``,
    re-designed egress-free): ``{"packed": <conda-pack tarball>}``
    extracts into a per-hash cache, ``{"prefix": <env dir>}`` uses an
    existing env in place. Interpreter-level, so it applies before the
    path-level plugins."""

    name = "conda"
    priority = 5
    skip_empty = True

    def validate(self, value):
        if not isinstance(value, dict):
            raise ValueError(
                "runtime_env conda must be {'packed': <tarball>} or "
                "{'prefix': <env dir>}")
        keys = set(value)
        if keys - {"packed", "prefix"} or len(keys) != 1:
            raise ValueError(
                "runtime_env conda takes exactly one of 'packed' or "
                "'prefix'")
        (v,) = value.values()
        if not isinstance(v, str):
            raise ValueError("runtime_env conda paths must be strings")
        return value

    def _prepare_into(self, value, out, ctx):
        out["conda"] = {k: os.path.abspath(v) for k, v in value.items()}

    def _apply_from(self, wire, ctx):
        conda = wire.get("conda")
        if not conda:
            return
        if conda.get("packed"):
            prefix = ensure_extracted_env(conda["packed"])
        else:
            prefix = conda["prefix"]
            if not os.path.isdir(prefix):
                raise RuntimeError(
                    f"runtime_env conda prefix {prefix!r} does not "
                    "exist on this node")
        _activate_env_prefix(prefix)


for _p in (_CondaPlugin(), _PipPlugin(), _EnvVarsPlugin(),
           _WorkingDirPlugin(), _PyModulesPlugin()):
    _rep.register_plugin(_p, allow_override=True)
del _p
