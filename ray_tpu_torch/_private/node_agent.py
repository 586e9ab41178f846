"""Per-node dashboard agent (reference: ``dashboard/agent.py:28`` —
the DashboardAgent process every raylet hosts, serving node-local
stats and logs that the dashboard head aggregates).

The port's copy of ``ray_tpu/_private/node_agent.py``, with
:func:`collect_node_stats` reading ``/proc`` in place of ``psutil``
(which the card's machine lacks), under the same keys. Re-designed for
this runtime: instead of a separate agent process per
node, the agent is a tiny asyncio HTTP server INSIDE the node daemon
(and the head, for its own host) — same endpoints, one fewer process
to babysit:

- ``GET /api/stats``   → host cpu/mem/load + per-worker pid/rss/cpu
- ``GET /api/workers`` → worker ids + pids this daemon owns
- ``GET /api/logs``    → log file list / tail (``worker_id=``, ``bytes=``)

The head additionally proxies every node's stats/logs over its
existing daemon RPC connections (``/api/node?node_id=…`` on the head
dashboard), so one URL serves the whole cluster on multi-host
deployments where agent ports may not be reachable from outside.
"""
from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _meminfo() -> Dict[str, int]:
    """``/proc/meminfo`` in bytes, by field name."""
    out = {}
    for line in _read("/proc/meminfo").splitlines():
        name, _, rest = line.partition(":")
        parts = rest.split()
        if parts:
            out[name] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


def _cpu_times() -> Tuple[float, float]:
    """(busy, total) jiffies of the host since boot, from the ``cpu``
    line of ``/proc/stat`` (idle and iowait count as idle)."""
    fields = [float(v) for v in _read("/proc/stat").split("\n", 1)[0]
              .split()[1:]]
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0.0)
    total = sum(fields[:8])
    return total - idle, total


_STATUS = {"R": "running", "S": "sleeping", "D": "disk-sleep",
           "T": "stopped", "t": "tracing-stop", "Z": "zombie",
           "X": "dead", "I": "idle", "W": "waking", "P": "parked"}
_TICKS = os.sysconf("SC_CLK_TCK")
_PAGE = os.sysconf("SC_PAGE_SIZE")
# The previous sample of each counter, so a percentage covers the time
# since the last call (psutil's ``interval=None`` semantics: 0.0 on the
# first call).
_last_host: Optional[Tuple[float, float]] = None
_last_proc: Dict[int, Tuple[float, float]] = {}


def _proc_sample(pid: int) -> dict:
    """rss, cpu percent since the last sample, and status of one pid,
    from ``/proc/<pid>/stat``; raises OSError when the pid is gone."""
    stat = _read(f"/proc/{pid}/stat")
    # comm (field 2) may hold spaces and parens: split after the last ')'
    rest = stat.rsplit(")", 1)[1].split()
    state, utime, stime, rss_pages = rest[0], rest[11], rest[12], rest[21]
    cpu_s = (float(utime) + float(stime)) / _TICKS
    now = time.monotonic()
    prev = _last_proc.get(pid)
    _last_proc[pid] = (cpu_s, now)
    pct = 0.0
    if prev is not None and now > prev[1]:
        pct = 100.0 * (cpu_s - prev[0]) / (now - prev[1])
    return {"rss_bytes": int(rss_pages) * _PAGE,
            "cpu_percent": round(pct, 1),
            "status": _STATUS.get(state, state)}


def collect_node_stats(worker_pids: Dict[str, int]) -> dict:
    """Node-local stats snapshot (like the reference's agent
    ``node_stats``), read from ``/proc`` with the keys the reference
    fills from psutil: host cpu percent since the previous call, cpu
    count, memory total/available/percent, load, and per worker its pid,
    rss, cpu percent and status (``"gone"`` once it exited)."""
    global _last_host
    mem = _meminfo()
    total = mem.get("MemTotal", 0)
    avail = mem.get("MemAvailable", mem.get("MemFree", 0))
    try:
        load1, load5, load15 = os.getloadavg()
    except OSError:
        load1 = load5 = load15 = 0.0
    workers = []
    for hexid, pid in worker_pids.items():
        try:
            workers.append({"worker_id": hexid[:12], "pid": pid,
                            **_proc_sample(pid)})
        except (OSError, IndexError, ValueError):
            workers.append({"worker_id": hexid[:12], "pid": pid,
                            "status": "gone"})
    busy, jiffies = _cpu_times()
    cpu_pct = 0.0
    if _last_host is not None and jiffies > _last_host[1]:
        cpu_pct = 100.0 * (busy - _last_host[0]) / (jiffies - _last_host[1])
    _last_host = (busy, jiffies)
    return {
        "time": time.time(),
        "cpu_percent": round(cpu_pct, 1),
        "cpu_count": os.cpu_count(),
        "mem_total_bytes": total,
        "mem_available_bytes": avail,
        "mem_percent": round(100.0 * (total - avail) / total, 1)
        if total else 0.0,
        "load_avg": [load1, load5, load15],
        "num_workers": len(worker_pids),
        "workers": workers,
    }


class NodeAgentServer:
    """The agent's HTTP face: dependency-free GET-only asyncio server
    (same parser discipline as the head's dashboard-lite)."""

    def __init__(self, stats_fn: Callable[[], dict],
                 workers_fn: Callable[[], list],
                 log_fn: Callable[[dict], dict],
                 host: str = "127.0.0.1", port: int = 0):
        self._stats_fn = stats_fn
        self._workers_fn = workers_fn
        self._log_fn = log_fn
        self._host = host
        self._port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self):
        self._server = await asyncio.start_server(
            self._serve, host=self._host, port=self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def port(self) -> int:
        return self._port

    async def stop(self):
        if self._server:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _serve(self, reader, writer):
        from .dashboard import read_get_request, respond

        try:
            parsed = await read_get_request(reader)
            if parsed is None:
                await respond(writer, 405, "application/json",
                              b'{"error":"GET only"}')
                return
            path, q = parsed
            if path == "/api/stats":
                body = json.dumps(self._stats_fn()).encode()
            elif path == "/api/workers":
                body = json.dumps(self._workers_fn()).encode()
            elif path == "/api/logs":
                try:
                    body = json.dumps(self._log_fn(q)).encode()
                except Exception as e:  # noqa: BLE001 - missing file
                    await respond(writer, 404, "application/json",
                                  json.dumps({"error": str(e)}).encode())
                    return
            elif path == "/":
                body = json.dumps({"endpoints": [
                    "/api/stats", "/api/workers", "/api/logs"]}).encode()
            else:
                await respond(writer, 404, "application/json",
                              b'{"error":"not found"}')
                return
            await respond(writer, 200, "application/json", body)
        except Exception:  # noqa: BLE001 - bad client mustn't kill daemon
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
