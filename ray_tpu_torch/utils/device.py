"""Host↔device staging helpers for the card (the port's copy of
``ray_tpu/utils/device.py``).

The object plane gets host-side zero-copy for numpy values for free:
large values live in shm segments, serialization keeps array bodies as
out-of-band pickle-5 buffers, and ``rt.get`` returns numpy arrays that
ALIAS the (read-only) segment. A tensor's ``get`` returns a CPU tensor
that owns its memory (``_private/serialization.py``). What remains is the
host→device hop, which :func:`device_put_shm` makes explicit and
measurable.

The reference's ``donate_wrapper`` (``jax.jit`` with donated buffers) has
no PyTorch counterpart: eager PyTorch frees or reuses a tensor's memory
when the caller drops it, and in-place ops already write into the
caller's buffer.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Any

_stats_lock = threading.Lock()
_stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "copies": 0}


def transfer_stats(reset: bool = False) -> dict:
    """Cumulative host→device staging telemetry for this process:
    calls, bytes, wall seconds (and derived GiB/s), and how many inputs
    needed a contiguity copy before the transfer."""
    with _stats_lock:
        out = dict(_stats)
        if reset:
            _stats.update({"calls": 0, "bytes": 0, "seconds": 0.0,
                           "copies": 0})
    secs = out["seconds"]
    out["gib_per_s"] = (out["bytes"] / (1 << 30) / secs) if secs else 0.0
    return out


def device_put_shm(x: Any, device="cuda"):
    """Stage a host value on ``device``: a numpy array (a zero-copy shm
    view or otherwise), a tensor, or a dict, list or tuple of them (the
    result has the same structure). Returns tensors on ``device``; other
    leaves pass through.

    Non-contiguous or non-native-endian numpy inputs force a host copy
    before the transfer; this chokepoint makes that copy explicit
    (counted in :func:`transfer_stats`), so an shm-aliased array that
    silently lost contiguity shows up in telemetry instead of as mystery
    latency. The returned tensors never alias the store: a transfer to
    the card copies, and a "cpu" target copies a numpy view.
    """
    import numpy as np
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device_put_shm to {dev}: no CUDA device is "
                           "visible in this process")
    counts = {"bytes": 0, "copies": 0}

    def put(v):
        if isinstance(v, dict):
            return {k: put(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(put(u) for u in v)
        if isinstance(v, np.ndarray):
            if v.dtype.byteorder not in ("=", "|", "<"):
                v = v.astype(v.dtype.newbyteorder("="))
                counts["copies"] += 1
            if not v.flags.c_contiguous:
                v = np.ascontiguousarray(v)
                counts["copies"] += 1
            counts["bytes"] += v.nbytes
            with warnings.catch_warnings():
                # A read-only shm view: only read, by the copy below.
                warnings.simplefilter("ignore", UserWarning)
                t = torch.from_numpy(v)
            return t.to(dev, copy=True)
        if isinstance(v, torch.Tensor):
            if not v.is_contiguous():
                v = v.contiguous()
                counts["copies"] += 1
            counts["bytes"] += v.numel() * v.element_size()
            return v.to(dev)
        return v

    t0 = time.perf_counter()
    out = put(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    with _stats_lock:
        _stats["calls"] += 1
        _stats["bytes"] += counts["bytes"]
        _stats["seconds"] += dt
        _stats["copies"] += counts["copies"]
    return out
