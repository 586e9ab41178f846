"""Node daemon: per-host agent that attaches to the head over TCP.

The port's copy of ``ray_tpu/_private/node.py``.

Capability parity with the reference's raylet node manager
(reference: ``src/ray/raylet/node_manager.cc:1780`` — local worker pool,
resource reporting, worker liveness) re-designed for this runtime's
head-centric resource accounting: the daemon only *spawns and reaps*
worker processes on its host; all scheduling decisions stay at the head.

Workers spawned here listen on TCP (so any node can pull objects from
them) and register directly with the head, tagged with this node's id.
"""
from __future__ import annotations

import asyncio
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from . import reaper, rpc
from .ids import NodeID, WorkerID
from .utils import spawn_env_with_pkg_root


def tail_worker_log(session_dir: str, payload: dict) -> dict:
    """Serve the tail of a worker's log file from this host (reference:
    the per-node dashboard log agent, ``dashboard/modules/log/`` — logs
    stay on the node that produced them and are fetched on demand).

    ``payload``: ``worker_id`` (hex, >=12 chars; omit to list log files)
    and ``bytes`` (tail size, default 64KiB).
    """
    logs_dir = os.path.join(session_dir, "logs")
    wid = payload.get("worker_id", "")
    if not wid:
        try:
            return {"files": sorted(os.listdir(logs_dir))}
        except OSError:
            return {"files": []}
    if not all(c in "0123456789abcdefABCDEF" for c in wid):
        # worker ids are hex; anything else is a path-traversal probe
        # (the agent HTTP endpoint feeds user-supplied strings here)
        raise rpc.RpcError(f"invalid worker id {wid[:32]!r}")
    nbytes = int(payload.get("bytes", 65536))
    path = os.path.join(logs_dir, f"worker-{wid[:12]}.log")
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - nbytes))
            data = f.read()
    except OSError as e:
        raise rpc.RpcError(f"log unavailable for worker {wid[:12]}: {e}")
    return {"data": data.decode("utf-8", "replace"), "size": size}


class NodeService:
    def __init__(self, head_address: Tuple[str, int], session_dir: str,
                 resources: Dict[str, float],
                 shm_domain: Optional[str] = None,
                 private_domain: bool = False,
                 labels: Optional[Dict[str, str]] = None,
                 node_ip: Optional[str] = None):
        self.head_address = head_address
        self.session_dir = session_dir
        self.resources = dict(resources)
        self.node_id = NodeID.from_random()
        # shm_domain: workers on the same domain exchange large objects via
        # host shared memory; across domains they ship bytes over TCP. Tests
        # set a synthetic domain per node to exercise the cross-node path on
        # one machine.
        from .utils import session_shm_domain

        # Session-scoped default, same recipe as CoreWorker: a daemon
        # without an explicit domain gets one derived from ITS OWN
        # session dir — never the bare hostname, which two sessions on
        # one machine would collide on.
        self.shm_domain = shm_domain or session_shm_domain(session_dir)
        # Only a domain EXPLICITLY declared private may be swept at
        # stop: an inferred guard (hostname comparison) would clobber
        # nodes deliberately sharing a custom domain on one host.
        self.private_domain = private_domain
        self.labels = dict(labels or {})
        # The IP other nodes dial to reach workers on this host. Must be
        # routable cluster-wide on a real multi-host deployment.
        self.node_ip = node_ip or os.environ.get("RT_NODE_IP") or \
            _detect_node_ip(head_address)
        self._conn: Optional[rpc.Connection] = None
        from .config import Config

        self.config = Config()  # replaced by the head's at registration
        self._agent = None  # NodeAgentServer, started in start()
        self._agent_adv_host = self.node_ip
        self._procs: Dict[str, subprocess.Popen] = {}  # worker hex -> proc
        self._reap_task: Optional[asyncio.Task] = None
        self._stopping = False
        self._spawn_env = spawn_env_with_pkg_root(
            {"RT_NODE_IP": self.node_ip})

    async def start(self):
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        # Per-node dashboard agent (reference ``dashboard/agent.py:28``):
        # node-local stats/logs over HTTP, also proxied by the head.
        # Default bind is LOOPBACK: the agent serves worker logs and
        # process stats unauthenticated, and the head-proxy path
        # (/api/node, node RPC) already gives cluster-wide access — so
        # nothing on the cluster network gets a direct unauthenticated
        # door by default. Set RT_AGENT_BIND to the node IP (or a
        # wildcard) to expose it deliberately; "off" disables.
        bind = os.environ.get("RT_AGENT_BIND", "127.0.0.1")
        if bind and bind.lower() not in ("off", "disabled", "none"):
            from .node_agent import NodeAgentServer

            self._agent = NodeAgentServer(
                stats_fn=self._agent_stats,
                workers_fn=lambda: [{"worker_id": h[:12], "pid": p.pid}
                                    for h, p in self._procs.items()],
                log_fn=lambda q: tail_worker_log(self.session_dir, q),
                host=bind)
            await self._agent.start()
            # Advertise the address the agent actually LISTENS on
            # (wildcard → the routable node IP). A loopback bind
            # advertises NOTHING cluster-wide — a 127.0.0.1 URL would
            # resolve to the VIEWER's machine; the head-proxy path
            # (/api/node over the node RPC) serves those consumers.
            if bind in ("0.0.0.0", "::"):
                self._agent_adv_host = self.node_ip
            elif bind.startswith("127.") or bind in ("localhost", "::1"):
                self._agent_adv_host = None
            else:
                self._agent_adv_host = bind
        self._conn = await rpc.connect(self.head_address, self._handle)
        resp = await self._conn.call_simple("register_node", {
            "node_id": self.node_id.hex(),
            "hostname": self.shm_domain,
            "host": socket.gethostname(),
            "resources": self.resources,
            "labels": self.labels,
            "agent_url": (
                f"http://{self._agent_adv_host}:{self._agent.port}"
                if self._agent and self._agent_adv_host else None),
        }, timeout=30.0)
        self._adopt_head_config(resp)
        self._reap_task = asyncio.get_running_loop().create_task(
            self._reap_loop())
        return self

    def _agent_stats(self) -> dict:
        from .node_agent import collect_node_stats

        stats = collect_node_stats(
            {h: p.pid for h, p in self._procs.items()})
        stats["node_id"] = self.node_id.hex()
        return stats

    async def stop(self):
        self._stopping = True
        if self._agent:
            await self._agent.stop()
        if self._reap_task:
            self._reap_task.cancel()
        for proc in self._procs.values():
            try:
                proc.terminate()
            except Exception:
                pass
        if self._conn:
            await self._conn.close()
        if self.private_domain:
            # Nothing outside this node can own segments of a private
            # domain — sweep what SIGKILLed workers left. Wait for the
            # just-terminated workers first: a worker mid-put could
            # otherwise create a segment after the sweep listed
            # /dev/shm.
            deadline = time.time() + 2.0
            for proc in self._procs.values():
                while proc.poll() is None and time.time() < deadline:
                    await asyncio.sleep(0.05)
                if proc.poll() is None:
                    try:
                        proc.kill()
                    except Exception:  # noqa: BLE001
                        pass
            from .object_store import sweep_domain_segments

            sweep_domain_segments(self.shm_domain)

    async def run_forever(self):
        """Block until the head is gone for good. A dropped head
        connection starts a reconnect loop (a restarted head re-binds
        the same address and adopts us again); the daemon only exits —
        taking its workers with it — once the grace window expires
        (reference: raylet reconnect after GCS failover)."""
        while True:
            closed = asyncio.get_running_loop().create_future()
            prev = self._conn.on_close

            def _on_close(prev=prev, closed=closed):
                if prev:
                    prev()
                if not closed.done():
                    closed.set_result(None)

            self._conn.on_close = _on_close
            await closed
            if self._stopping:
                return
            if not await self._reconnect_head():
                return

    async def _reconnect_head(self) -> bool:
        grace = float(os.environ.get("RT_HEAD_RECONNECT_TIMEOUT_S", "60"))
        deadline = time.time() + grace
        while not self._stopping and time.time() < deadline:
            try:
                conn = await rpc.connect(self.head_address, self._handle)
                resp = await conn.call_simple("register_node", {
                    "node_id": self.node_id.hex(),
                    "hostname": self.shm_domain,
                    "host": socket.gethostname(),
                    "resources": self.resources,
                    "labels": self.labels,
                    "agent_url": (
                        f"http://{self._agent_adv_host}:"
                        f"{self._agent.port}"
                        if self._agent and self._agent_adv_host
                        else None),
                }, timeout=30.0)
                self._adopt_head_config(resp)
                self._conn = conn
                return True
            except Exception:  # noqa: BLE001 - head still down
                await asyncio.sleep(0.5)
        return False

    def _adopt_head_config(self, register_resp: dict):
        """Resolve flags as local env > HEAD's cluster config > default,
        so ``system_config`` passed to init()/Cluster governs remote
        daemons too (reference: raylet receives the GCS's
        system-config blob at registration)."""
        from .config import Config

        try:
            self.config = Config(register_resp.get("config") or {})
        except (ValueError, TypeError):  # version-skewed head: defaults
            self.config = Config()

    # ------------------------------------------------------------- handler
    async def _handle(self, method: str, payload: Any, bufs: List[bytes],
                      conn: rpc.Connection):
        if method == "spawn_worker":
            return await self._spawn_worker(payload["worker_id"])
        if method == "kill_worker":
            return self._kill_worker(payload["worker_id"],
                                     force=payload.get("force", False))
        if method == "ping":
            return {"ok": True, "node_id": self.node_id.hex()}
        if method == "tail_log":
            return tail_worker_log(self.session_dir, payload)
        if method == "agent_stats":
            return self._agent_stats()
        if method == "pubsub":
            return {}
        raise rpc.RpcError(f"node daemon: unknown method {method}")

    async def _spawn_worker(self, worker_hex: str):
        log = open(os.path.join(self.session_dir, "logs",
                                f"worker-{worker_hex[:12]}.log"), "ab")
        host, port = self.head_address
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main",
             "--session-dir", self.session_dir,
             "--worker-id", worker_hex,
             "--head-tcp", f"{host}:{port}",
             "--node-id", self.node_id.hex(),
             "--shm-domain", self.shm_domain,
             "--tcp"],
            stdout=log, stderr=subprocess.STDOUT,
            env={**self._spawn_env,
                 reaper.EXPECTED_PPID_ENV: str(os.getpid())},
            cwd=os.getcwd(),
        )
        self._procs[worker_hex] = proc
        return {"pid": proc.pid}

    def _kill_worker(self, worker_hex: str, force: bool = False):
        proc = self._procs.pop(worker_hex, None)
        if proc is not None:
            try:
                # force (OOM kills): SIGKILL releases the memory NOW —
                # a SIGTERM handler in a thrashing worker may never run
                proc.kill() if force else proc.terminate()
            except Exception:
                pass
        return {}

    async def _reap_loop(self):
        from .memory_monitor import kill_threshold_bytes, sample_memory

        last_memcheck = 0.0
        while not self._stopping:
            cfg = self.config  # re-read: a reconnect may refresh it
            refresh_s = cfg.memory_monitor_refresh_ms / 1000.0
            await asyncio.sleep(0.2)
            for hex_id, proc in list(self._procs.items()):
                code = proc.poll()
                if code is not None:
                    self._procs.pop(hex_id, None)
                    try:
                        self._conn.push("worker_died", {
                            "worker_id": hex_id,
                            "cause": f"exit code {code}"})
                    except Exception:
                        pass
            # Memory monitor: sample THIS host, report breaches to the
            # head — the kill policy needs assignment info only the
            # head has (reference: MemoryMonitor callback → raylet's
            # WorkerKillingPolicy, ``memory_monitor.h:52``).
            now = time.time()
            if refresh_s > 0 and now - last_memcheck >= refresh_s:
                last_memcheck = now
                try:
                    snap = sample_memory()
                    thr = kill_threshold_bytes(
                        snap, cfg.memory_usage_threshold,
                        cfg.memory_monitor_min_free_bytes)
                    if snap.used_bytes > thr:
                        self._conn.push("memory_pressure", {
                            "node_id": self.node_id.hex(),
                            "used_bytes": snap.used_bytes,
                            "total_bytes": snap.total_bytes,
                            "threshold_bytes": thr,
                        })
                except Exception:  # noqa: BLE001 - monitoring only
                    pass


def _detect_node_ip(head_address: Tuple[str, int]) -> str:
    """The local IP used to reach the head — the address workers advertise
    (reference: ``ray._private.services.get_node_ip_address``)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect((head_address[0], head_address[1] or 80))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"
