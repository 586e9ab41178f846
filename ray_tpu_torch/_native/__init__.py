"""Native codec loader: compile-on-first-use with a pure-Python fallback.

The port's copy of ``ray_tpu/_native/__init__.py``. ``codec.cpp`` is the
reference's source unchanged, so a blob packed here is byte-equal to one
the reference packs. The reference caches its ``.so`` next to the
source; the port builds it with the system compiler (``g++``, or
``$CXX``) into ``build/native/`` at the checkout root (git-ignored, where
the kernels are built too), keyed by a hash of the source, the flags and
the Python ABI, so a fresh checkout builds it anew and two checkouts
never share a stale library. If no compiler is available the callers
fall back to the Python implementations in ``_private/serialization.py``
(the reference's own host contract); :func:`which` says which one
loaded.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

_here = Path(__file__).resolve().parent
BUILD_DIR = _here.parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_mod = None
_tried = False
_error = ""


def _so_path() -> Path:
    tag = sysconfig.get_config_var("SOABI") or "generic"
    h = hashlib.sha256((_here / "codec.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"_rt_native-{h.hexdigest()[:16]}.{tag}.so"


def _build() -> Path:
    out = _so_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    cxx = os.environ.get("CXX", "g++")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, f"-I{include}", str(_here / "codec.cpp"),
           "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)
    return out


def load():
    """The native module, or None when unavailable."""
    global _mod, _tried, _error
    if _mod is not None or _tried:
        return _mod
    with _lock:
        if _mod is not None or _tried:
            return _mod
        _tried = True
        if os.environ.get("RT_DISABLE_NATIVE", "") == "1":
            _error = "RT_DISABLE_NATIVE=1"
            return None
        try:
            so = _build()
            import importlib.util

            spec = importlib.util.spec_from_file_location("_rt_native",
                                                          str(so))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mod = mod
        except Exception as e:  # noqa: BLE001 - fall back to pure python
            _error = f"{type(e).__name__}: {e}"
            _mod = None
        return _mod


def which() -> str:
    """``"native (<path>)"`` or ``"python (<why>)"``: the codec this
    process packs and unpacks frames with."""
    if load() is not None:
        return f"native ({_so_path()})"
    return f"python ({_error})"
