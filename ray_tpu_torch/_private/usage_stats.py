"""Usage stats: anonymous feature-usage counters, local-file only.

The port's copy of ``ray_tpu/_private/usage_stats.py``.

Capability parity with the reference's usage-stats subsystem (reference:
``python/ray/_private/usage/usage_lib.py`` — feature counters + cluster
metadata reported once per session), re-designed for zero egress: the
report is WRITTEN to the session directory (``usage_stats.json``) and
never leaves the machine. Disable entirely with RT_USAGE_STATS_DISABLED=1
(mirrors RAY_USAGE_STATS_ENABLED=0).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter
from typing import Dict

_lock = threading.Lock()
_features: Counter = Counter()
_start = time.time()


def enabled() -> bool:
    return os.environ.get("RT_USAGE_STATS_DISABLED", "") != "1"


def record_feature(name: str) -> None:
    """Count a library/API touchpoint (e.g. 'train', 'serve', 'tune')."""
    if not enabled():
        return
    with _lock:
        _features[name] += 1


def report() -> Dict:
    with _lock:
        feats = dict(_features)
    import ray_tpu_torch

    return {
        "version": ray_tpu_torch.__version__,
        "uptime_s": round(time.time() - _start, 1),
        "features": feats,
        "schema_version": 1,
    }


def write_report(session_dir: str) -> str:
    """Persist the local report; returns its path ('' when disabled)."""
    if not enabled():
        return ""
    path = os.path.join(session_dir, "usage_stats.json")
    try:
        with open(path, "w") as f:
            json.dump(report(), f, indent=1)
    except OSError:
        return ""
    return path
