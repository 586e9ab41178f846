"""Host memory monitor (reference: ``src/ray/common/memory_monitor.h:52``).

The port's copy of ``ray_tpu/_private/memory_monitor.py``.

Samples node memory usage the way the reference does — cgroup-aware, so
a container sees its own limit rather than the host's — and reports
whether usage crossed the kill threshold. The kill POLICY lives at the
head (``head.py`` ``_handle_memory_pressure``), which knows every
worker's assignment; daemons only sample and report, the same split as
raylet's MemoryMonitor callback → WorkerKillingPolicy.

``RT_MEMORY_LIMIT_BYTES`` caps the detected total — the test hook and
the escape hatch for partial-host deployments.
"""
from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class MemorySnapshot:
    used_bytes: int
    total_bytes: int

    @property
    def used_fraction(self) -> float:
        return self.used_bytes / max(1, self.total_bytes)


_CGV2 = "/sys/fs/cgroup"
_CGV1 = "/sys/fs/cgroup/memory"


def _read_int(path: str):
    try:
        with open(path) as f:
            v = f.read().strip()
        return None if v == "max" else int(v)
    except (OSError, ValueError):
        return None


def _read_stat_key(path: str, key: str):
    try:
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2 and parts[0] == key:
                    return int(parts[1])
    except (OSError, ValueError):
        pass
    return None


def _host_meminfo() -> MemorySnapshot:
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                if total is not None and avail is not None:
                    break
    except OSError:
        pass
    if total is None:
        return MemorySnapshot(0, 1)
    if avail is None:
        avail = total
    return MemorySnapshot(total - avail, total)


def sample_memory() -> MemorySnapshot:
    """Current node memory usage. Cgroup v2 → v1 → /proc/meminfo, like
    the reference's MemoryMonitor (``memory_monitor.h`` cgroup paths);
    file-cache pages (inactive_file/active_file) are excluded from
    usage — they are reclaimable, and counting them would kill workers
    for the page cache's sins."""
    host = _host_meminfo()
    used, total = host.used_bytes, host.total_bytes
    # cgroup v2
    limit = _read_int(os.path.join(_CGV2, "memory.max"))
    current = _read_int(os.path.join(_CGV2, "memory.current"))
    stat = os.path.join(_CGV2, "memory.stat")
    if current is None:
        # cgroup v1
        limit = _read_int(os.path.join(_CGV1, "memory.limit_in_bytes"))
        current = _read_int(os.path.join(_CGV1, "memory.usage_in_bytes"))
        stat = os.path.join(_CGV1, "memory.stat")
        inactive = _read_stat_key(stat, "total_inactive_file")
        active = _read_stat_key(stat, "total_active_file")
    else:
        inactive = _read_stat_key(stat, "inactive_file")
        active = _read_stat_key(stat, "active_file")
    if current is not None and limit is not None and \
            0 < limit < host.total_bytes:
        used = current - (inactive or 0) - (active or 0)
        total = limit
    env_cap = os.environ.get("RT_MEMORY_LIMIT_BYTES")
    if env_cap:
        total = min(total, int(env_cap))
    return MemorySnapshot(max(0, used), max(1, total))


def kill_threshold_bytes(snapshot: MemorySnapshot,
                         usage_threshold: float,
                         min_free_bytes: int = -1) -> int:
    """Bytes of usage above which workers are killed.

    ``min_free_bytes >= 0`` additionally requires that much free memory
    (the reference's ``min_memory_free_bytes``), tightening the
    fraction-based threshold on huge-memory hosts."""
    t = int(snapshot.total_bytes * usage_threshold)
    if min_free_bytes >= 0:
        t = min(t, snapshot.total_bytes - min_free_bytes)
    return max(0, t)
