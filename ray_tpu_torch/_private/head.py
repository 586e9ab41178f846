"""Head service: cluster control plane (GCS + per-node raylet equivalent).

The port's copy of ``ray_tpu/_private/head.py``.

Capability parity with the reference's GCS server (actor/node/job/KV/PG
managers — reference: ``src/ray/gcs/gcs_server/gcs_server.cc:138-236``), the
raylet's worker pool + lease protocol (reference:
``src/ray/raylet/worker_pool.h:83``, ``node_manager.cc:1780``), and the
cluster scheduling policies (reference:
``src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h:50``,
``bundle_scheduling_policy.h:82-106``), re-designed as one asyncio daemon
for this runtime. The head owns all resource accounting (so placement-group
"two-phase commit" degenerates to one atomic multi-node reservation), while
remote **node daemons** (``_private/node.py``) attach over TCP, spawn
workers on their host, and report worker deaths.

Responsibilities:
- node registry: head-local node + TCP-attached remote nodes, health
- worker pool: spawn/reuse/kill worker processes per node, prestart
- leases: resource-aware worker leases (hybrid/spread/affinity policies)
- actors: dedicated-worker placement, restarts, named actor registry
- placement groups: multi-node bundle placement with PACK/SPREAD/STRICT_*
- KV store: function exports, library checkpoints
- pubsub: topic fan-out to subscriber connections
- health: worker/node liveness -> actor death notifications
"""
from __future__ import annotations

import asyncio
import json
import os
import socket
import subprocess
import sys
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from . import reaper, rpc
from .config import Config
from .ids import ActorID, NodeID, PlacementGroupID, WorkerID
from .utils import spawn_env_with_pkg_root
from .wal import HeadWAL


@dataclass
class WorkerInfo:
    worker_id: WorkerID
    address: Any  # UDS path (local) or (host, port) tuple (remote)
    pid: int
    node: str = ""  # node_id hex
    proc: Optional[subprocess.Popen] = None
    conn: Optional[rpc.Connection] = None
    # None = idle pool worker; "lease" = leased for normal tasks;
    # ActorID = dedicated actor worker.
    assignment: Any = None
    # charge tuple: ("node", node_hex, req) | ("pg", pg_id, idx, req) | None
    charge: Any = None
    started_at: float = field(default_factory=time.time)
    leased_at: Optional[float] = None  # last lease grant (OOM ranking)


@dataclass
class NodeInfo:
    node_id: str  # hex
    hostname: str
    total: Dict[str, float]
    available: Dict[str, float]
    address: Any = None  # remote daemon address, None for head-local
    conn: Optional[rpc.Connection] = None  # daemon conn (remote only)
    idle: deque = field(default_factory=deque)
    state: str = "ALIVE"  # ALIVE | DEAD
    is_head: bool = False
    labels: Dict[str, str] = field(default_factory=dict)
    # Physical host (gethostname): co-hosted nodes share one memory
    # pool, so OOM kill grace is keyed on this, not the node id.
    # Assumes hostnames are unique across machines in one cluster (the
    # usual case; containers sharing a fixed hostname would couple
    # their kill grace windows — conservative, never unsafe).
    phys_host: str = ""
    # Per-node dashboard agent endpoint (reference dashboard/agent.py)
    agent_url: Optional[str] = None

    def utilization(self) -> float:
        fracs = [1.0 - self.available.get(k, 0.0) / v
                 for k, v in self.total.items() if v > 0]
        return max(fracs) if fracs else 0.0


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: str
    state: str  # PENDING | ALIVE | RESTARTING | DEAD
    worker: Optional[WorkerInfo]
    resources: Dict[str, float]
    max_restarts: int
    restarts_used: int = 0
    creation_spec_meta: Any = None  # for restarts
    strategy: Any = None  # for restarts on another node
    death_cause: str = ""
    registered_at: float = 0.0
    creation_started: bool = False
    # Handle GC (reference: GCS kills actors when all handles go out of
    # scope). Detached actors — explicit lifetime="detached" or named —
    # opt out; handle_refs aggregates per-process inc/dec pushes.
    detached: bool = False
    handle_refs: int = 0
    pending_gc: Any = None  # asyncio task for the grace-period kill
    restart_inflight: bool = False  # _restart_actor placement running


@dataclass
class Bundle:
    index: int
    resources: Dict[str, float]


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    bundles: List[Bundle]
    strategy: str
    state: str  # PENDING | CREATED | RESCHEDULING | REMOVED
    name: str = ""
    # per-bundle remaining capacity
    remaining: List[Dict[str, float]] = field(default_factory=list)
    # per-bundle node assignment (node_id hex, or None while lost)
    bundle_nodes: List[Optional[str]] = field(default_factory=list)
    # tombstone timestamp once state hits REMOVED (reaper prunes later)
    removed_at: Optional[float] = None


class HeadService:
    def __init__(self, session_dir: str, config: Config,
                 resources: Dict[str, float]):
        self.session_dir = session_dir
        self.config = config
        self.node_id = NodeID.from_random()
        self.sock_path = os.path.join(session_dir, "head.sock")
        self._server: Optional[rpc.RpcServer] = None
        self._tcp_server: Optional[rpc.RpcServer] = None
        local = NodeInfo(node_id=self.node_id.hex(),
                         hostname=socket.gethostname(),
                         total=dict(resources), available=dict(resources),
                         is_head=True, phys_host=socket.gethostname())
        self.nodes: Dict[str, NodeInfo] = {local.node_id: local}
        self.local_node = local
        self.workers: Dict[WorkerID, WorkerInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[str, ActorID] = {}
        self.pgs: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        # pg_state polls for ids with no entry: id -> first-seen time
        # (grace window for the async-create race)
        self._pg_unknown_since: Dict[PlacementGroupID, float] = {}
        self.kv: Dict[str, Dict[str, bytes]] = defaultdict(dict)
        # Object copy directory (reference capability:
        # ``ownership_based_object_directory.h`` — which nodes hold a
        # copy): oid hex -> {location key -> (address, shm_domain)}.
        # Pullers use it to spread big pulls over every live copy.
        self.object_locations: Dict[str, Dict[str, tuple]] = {}
        # (object hex, domain) -> (claimer key, ts): one cross-domain
        # pull per domain at a time.
        self._pull_claims: Dict[tuple, tuple] = {}
        self._pending_leases: deque = deque()  # (req, pg_meta, strategy, fut)
        self._registration_waiters: Dict[WorkerID, asyncio.Future] = {}
        # Workers killed after a registration timeout whose in-flight
        # register RPC may still arrive; insertion-ordered for pruning.
        self._doomed_workers: Dict[WorkerID, None] = {}
        self._subs: Dict[str, List[rpc.Connection]] = defaultdict(list)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._reaper_task = None
        self.job_counter = 0
        self._spread_rr = 0
        # Workers must be able to import ray_tpu_torch no matter the driver's cwd
        # (the driver may have put the package on sys.path manually).
        self._spawn_env = spawn_env_with_pkg_root()
        self.task_events: deque = deque(maxlen=100_000)
        # Finished tracing spans reported by workers/drivers
        # (ray_tpu_torch/util/tracing.py), plus the cluster-wide count of
        # spans processes dropped at buffer capacity before flushing.
        self.spans: deque = deque(maxlen=100_000)
        self.spans_dropped_total = 0
        self._shutting_down = False
        # Observability: per-process metric snapshots (worker_id → snap)
        # merged on demand; dashboard server started in start().
        self.metrics_snapshots: Dict[str, dict] = {}
        self.dashboard = None
        # Job submission (reference: dashboard/modules/job JobManager):
        # job_id → {entrypoint, status, proc, log_path, ...}
        self.jobs: Dict[str, dict] = {}
        # OOM kill ledger (reference: raylet worker-killing events in the
        # state API): newest-first visibility for debugging memory kills.
        self.oom_kills: deque = deque(maxlen=1000)
        self._last_oom_kill: Dict[str, float] = {}  # node hex -> ts
        self._memmon_task = None
        # Mutation WAL: actor/PG/KV/job changes are appended (and
        # flushed) before the RPC reply, so a kill -9 between periodic
        # snapshots loses nothing a client saw acknowledged.
        self.wal = HeadWAL(session_dir)
        # One persist at a time: two concurrent roll+write+drop cycles
        # could delete a WAL generation covered only by the NEWER
        # snapshot and then overwrite it with the older one.
        self._persist_lock = asyncio.Lock()

    # ------------------------------------------------------------- lifecycle
    async def start(self):
        self._loop = asyncio.get_running_loop()
        os.makedirs(os.path.join(self.session_dir, "workers"), exist_ok=True)
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self._sweep_dead_sessions()
        # Head restart on an existing session dir adopts the durable
        # control-plane state (GCS-restart analogue).
        state_path = os.path.join(self.session_dir, "head_state.pkl")
        self._restored_tcp_port = None
        restored = False
        if os.path.exists(state_path):
            try:
                self.restore_state(state_path)
                restored = True
            except Exception:  # noqa: BLE001 - a bad snapshot can't brick
                pass
        else:
            # Killed before the first snapshot: the WAL alone is the
            # durable state, and the predecessor's session.json is the
            # only record of the TCP port remote peers keep redialing.
            try:
                if self._replay_wal(0):
                    restored = True
                    with open(os.path.join(self.session_dir,
                                           "session.json")) as f:
                        self._restored_tcp_port = json.load(
                            f)["tcp_address"][1]
            except Exception:  # noqa: BLE001
                pass
        self.wal.open_active()
        # A SIGKILL'd predecessor leaves its socket file behind; the new
        # head must re-bind the same path (workers reconnect to it). But
        # NEVER steal the socket of a LIVE head — probe it first, or a
        # double-start would silently split-brain the session.
        if os.path.exists(self.sock_path):
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(1.0)
            try:
                probe.connect(self.sock_path)
                probe.close()
                raise RuntimeError(
                    f"a head is already serving {self.sock_path}; refusing "
                    "to start a second one on the same session")
            except (ConnectionRefusedError, FileNotFoundError,
                    socket.timeout, OSError):
                probe.close()
            try:
                os.unlink(self.sock_path)
            except OSError:
                pass
        self._server = rpc.RpcServer(self._handle, path=self.sock_path)
        await self._server.start()
        # TCP listener for remote node daemons / workers / drivers
        # (reference: GCS listens on a TCP port for raylet registration).
        # On restart, reclaim the predecessor's port so remote peers'
        # reconnect loops find us at the address they already know.
        try:
            self._tcp_server = rpc.RpcServer(
                self._handle, host="0.0.0.0",
                port=self._restored_tcp_port or 0)
            await self._tcp_server.start()
        except OSError:
            self._tcp_server = rpc.RpcServer(self._handle, host="0.0.0.0")
            await self._tcp_server.start()
        if restored:
            rpc.spawn(self._reconcile_after_restart(), self._loop)
        self._reaper_task = self._loop.create_task(self._reap_loop())
        if self.config.memory_monitor_refresh_ms > 0:
            self._memmon_task = self._loop.create_task(
                self._memory_monitor_loop())
        if getattr(self.config, "dashboard_port", 0) >= 0:
            from .dashboard import DashboardServer

            self.dashboard = DashboardServer(
                self.state_listing, self.metrics_text, self.chrome_trace,
                log_fn=lambda q: self._rpc_worker_log(q, []),
                node_fn=lambda q: self._rpc_node_stats(q, []),
                jobs_fn=lambda: self._rpc_list_jobs({}, []),
                job_logs_fn=lambda q: self._rpc_job_logs(q, []),
                port=getattr(self.config, "dashboard_port", 0))
            await self.dashboard.start()
        # Discovery file for the CLI (`python -m ray_tpu_torch status`).
        with open(os.path.join(self.session_dir, "session.json"), "w") as f:
            json.dump({
                "head_sock": self.sock_path,
                "tcp_address": list(self.tcp_address),
                "dashboard_url": self.dashboard.url if self.dashboard
                else None,
                "pid": os.getpid(),
                "started_at": time.time(),
            }, f)
        return self

    @property
    def tcp_address(self) -> Tuple[str, int]:
        return ("127.0.0.1", self._tcp_server._port)

    async def stop(self):
        self._shutting_down = True
        try:
            await self.persist_state(offload=False)
        except Exception:  # noqa: BLE001
            pass
        if self.dashboard is not None:
            await self.dashboard.stop()
        if self._reaper_task:
            self._reaper_task.cancel()
        if self._memmon_task:
            self._memmon_task.cancel()
        for w in list(self.workers.values()):
            if w.proc is not None:
                try:
                    w.proc.terminate()
                except Exception:
                    pass
            elif w.conn is not None:
                try:
                    w.conn.push("shutdown", {})
                except Exception:
                    pass
        # Give children a moment, then hard-kill.
        deadline = time.time() + 2.0
        for w in list(self.workers.values()):
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=max(0.05, deadline - time.time()))
            except Exception:
                try:
                    w.proc.kill()
                except Exception:
                    pass
        if self._server:
            await self._server.stop()
        if self._tcp_server:
            await self._tcp_server.stop()
        # Last act of the session on this host: sweep the session's shm
        # domain. Segment names are session-scoped (session_shm_domain),
        # so only THIS session's leftovers — e.g. from SIGKILLed chaos
        # workers, which never ran unlink — can match. Live mmaps held
        # elsewhere stay valid (POSIX unlink semantics).
        from .object_store import sweep_domain_segments
        from .utils import session_shm_domain

        sweep_domain_segments(session_shm_domain(self.session_dir))
        self.wal.close()

    def _sweep_dead_sessions(self):
        """Reclaim shm segments of SESSIONS THAT DIED WITHOUT CLEANUP
        (SIGKILLed heads skip the clean-stop sweep). Session domains are
        derivable from the discovery-root session dirs, and a recorded
        head pid that no longer runs proves the session is over. Our own
        session dir is skipped — a crash-RESTARTED head adopts its live
        segments (failover), it doesn't reclaim them."""
        import glob as _glob

        from .object_store import sweep_domain_segments
        from .utils import process_exited, session_shm_domain

        root = os.path.join(os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch")
        own = os.path.abspath(self.session_dir)
        for path in _glob.glob(os.path.join(root, "*", "session.json")):
            sdir = os.path.dirname(path)
            if os.path.abspath(sdir) == own:
                continue
            try:
                with open(path) as f:
                    pid = json.load(f)["pid"]
            except (OSError, KeyError, ValueError, json.JSONDecodeError):
                pid = None
            # process_exited (not signal-0): a zombie head — dead but
            # unreaped by its parent — still answers kill(pid, 0), and
            # its session must be swept like any other dead one.
            if pid is not None and not process_exited(pid):
                continue
            try:
                sweep_domain_segments(session_shm_domain(sdir))
            except Exception:  # noqa: BLE001 - hygiene only
                pass

    # --------------------------------------------------- memory monitor
    async def _memory_monitor_loop(self):
        """Sample the HEAD host's memory and run the kill policy on
        breach (node daemons sample their own hosts and report via
        ``memory_pressure``). Reference: ``memory_monitor.h:52`` —
        monitor fires a callback per interval; the raylet kills via a
        WorkerKillingPolicy."""
        from .memory_monitor import kill_threshold_bytes, sample_memory

        period = self.config.memory_monitor_refresh_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            try:
                snap = await self._loop.run_in_executor(None, sample_memory)
                thr = kill_threshold_bytes(
                    snap, self.config.memory_usage_threshold,
                    self.config.memory_monitor_min_free_bytes)
                if snap.used_bytes > thr:
                    await self._handle_memory_pressure(
                        self.local_node.node_id, snap.used_bytes,
                        snap.total_bytes, thr)
            except Exception:  # noqa: BLE001 - keep the monitor alive
                pass

    def _select_oom_victim(self, node_hex: str):
        """Retriable-newest-first policy (reference:
        ``worker_killing_policy.h:1``): prefer the NEWEST leased task
        worker — its task loses the least progress and retries via the
        normal ConnectionLost path (lineage recovery rebuilds its lost
        objects) — then the newest actor worker that still has restart
        budget. Leased workers are presumed retriable (leases are
        task-agnostic here; a max_retries=0 task on a killed lease
        surfaces WorkerCrashedError to its caller, the reference's
        OutOfMemoryError analog). Actors without restart budget and
        idle pool workers are never killed — better to let the kernel
        OOM killer make that call than to silently destroy
        unrestartable state."""
        cands = [w for w in self.workers.values() if w.node == node_hex]
        leased = [w for w in cands if w.assignment == "lease"]
        if leased:
            return (max(leased,
                        key=lambda w: w.leased_at or w.started_at),
                    "leased task")
        restartable = []
        for w in cands:
            if isinstance(w.assignment, ActorID):
                a = self.actors.get(w.assignment)
                if a and a.state != "DEAD" and \
                        a.restarts_used < a.max_restarts:
                    restartable.append(w)
        if restartable:
            return (max(restartable, key=lambda w: w.started_at),
                    "restartable actor")
        return None, None

    async def _handle_memory_pressure(self, node_hex: str, used: int,
                                      total: int, threshold: int):
        now = time.time()
        # Grace keyed by PHYSICAL host: a co-hosted head + daemons all
        # observe the same breach within one sampling period, and one
        # kill must cover all of them.
        n = self.nodes.get(node_hex)
        grace_key = (n.phys_host if n is not None and n.phys_host
                     else node_hex)
        if now - self._last_oom_kill.get(grace_key, 0.0) < \
                self.config.memory_monitor_kill_grace_s:
            return  # let the previous kill actually release memory
        w, kind = self._select_oom_victim(node_hex)
        if w is None:
            return
        self._last_oom_kill[grace_key] = now
        cause = (f"OOM-killed by the memory monitor: node {node_hex[:12]} "
                 f"used {used / 2**30:.2f}GiB of {total / 2**30:.2f}GiB "
                 f"(threshold {threshold / 2**30:.2f}GiB); policy chose "
                 f"the newest {kind}")
        self.oom_kills.append({
            "time": now, "node_id": node_hex,
            "worker_id": w.worker_id.hex(), "pid": w.pid, "kind": kind,
            "used_bytes": used, "total_bytes": total,
            "threshold_bytes": threshold,
        })
        from .metrics import core_metrics

        core_metrics()["oom_workers_killed"].inc()
        if w.proc is not None:  # head-local: SIGKILL releases NOW
            try:
                w.proc.kill()
            except Exception:  # noqa: BLE001
                pass
        else:
            node = self.nodes.get(node_hex)
            if node is not None and node.conn is not None:
                try:
                    await node.conn.call_simple(
                        "kill_worker",
                        {"worker_id": w.worker_id.hex(), "force": True},
                        timeout=10.0)
                except Exception:  # noqa: BLE001 - daemon reap covers it
                    pass
        await self._on_worker_death(w, cause)

    async def _rpc_memory_pressure(self, payload, bufs):
        """Pushed by a node daemon whose host crossed the threshold."""
        await self._handle_memory_pressure(
            payload["node_id"], int(payload["used_bytes"]),
            int(payload["total_bytes"]), int(payload["threshold_bytes"]))
        return {}

    async def _reap_loop(self):
        period = self.config.health_check_period_s
        last_persist = time.time()
        while True:
            await asyncio.sleep(period)
            self._poll_jobs()
            # Prune REMOVED placement-group tombstones: kept long enough
            # for stale ready() polls to observe the terminal state, not
            # for the head's lifetime (unbounded growth under retry
            # loops). pg_state's unknown-id grace covers pruned ids.
            now = time.time()
            for pid, pg in list(self.pgs.items()):
                if pg.state == "REMOVED" and pg.removed_at is not None \
                        and now - pg.removed_at > 600.0:
                    del self.pgs[pid]
            # Unknown-pg grace entries are normally cleared by the next
            # poll, but a client that polled once and went away would
            # pin its entry forever. Sweep on the tombstone horizon:
            # any re-poll within 600s still gets its fail-fast REMOVED
            # verdict (entries older than the 10s grace answer REMOVED
            # on sight); only a poller with a >600s gap between polls
            # restarts its grace clock — accepted, ready() loops poll
            # sub-second — in exchange for a bounded dict.
            for ugid, t0 in list(self._pg_unknown_since.items()):
                if now - t0 > 600.0:
                    del self._pg_unknown_since[ugid]
            if time.time() - last_persist > 10.0:
                last_persist = time.time()
                try:
                    # Dict walk on the loop (no concurrent mutation);
                    # only pickle+write leave the thread.
                    await self.persist_state()
                except Exception:  # noqa: BLE001 - keep the reaper alive
                    import traceback as _tb

                    print("head: state persist failed:",
                          _tb.format_exc(limit=2), file=sys.stderr)
            for w in list(self.workers.values()):
                if w.proc is not None and w.proc.poll() is not None:
                    await self._on_worker_death(
                        w, f"exit code {w.proc.returncode}")
            # Registered-but-never-created actors (client died between the
            # register and create RPCs) would otherwise pin their name
            # forever; expire them after the lease timeout.
            ttl = self.config.worker_lease_timeout_s
            now = time.time()
            for a in list(self.actors.values()):
                if (a.state == "PENDING" and not a.creation_started
                        and a.registered_at
                        and now - a.registered_at > ttl):
                    self._mark_actor_dead(a, "registration expired: "
                                             "creation never requested")

    # ------------------------------------------------------------- nodes
    async def _on_node_death(self, node: NodeInfo, cause: str):
        """A node daemon's connection dropped: everything on it is gone
        (reference: ``gcs_node_manager.cc`` OnNodeFailure ->
        ``gcs_actor_manager.cc`` OnNodeDead)."""
        if node.state == "DEAD":
            return
        node.state = "DEAD"
        self.nodes.pop(node.node_id, None)
        self.publish("nodes", {"event": "DEAD", "node_id": node.node_id,
                               "cause": cause})
        for w in list(self.workers.values()):
            if w.node == node.node_id:
                await self._on_worker_death(w, f"node died: {cause}",
                                            node_dead=True)
        # Bundles placed on the dead node are lost; try to re-place them
        # (reference: gcs_placement_group_manager reschedules bundles).
        for pg in self.pgs.values():
            if pg.state != "CREATED":
                continue
            for i, nid in enumerate(pg.bundle_nodes):
                if nid == node.node_id:
                    pg.bundle_nodes[i] = None
                    pg.remaining[i] = {}
                    pg.state = "RESCHEDULING"
        self._replace_lost_bundles()
        self._pump_leases()

    def _replace_lost_bundles(self):
        for pg in self.pgs.values():
            if pg.state != "RESCHEDULING":
                continue
            lost = [i for i, nid in enumerate(pg.bundle_nodes) if nid is None]
            ok = True
            survivors = {nid for nid in pg.bundle_nodes if nid}
            for i in lost:
                b = pg.bundles[i]
                cands = [n for n in self._alive_nodes()
                         if self._node_fits(n, b.resources)]
                if pg.strategy == "STRICT_SPREAD":
                    cands = [n for n in cands if n.node_id not in survivors]
                elif pg.strategy == "STRICT_PACK":
                    # Colocation guarantee: lost bundles may only rejoin the
                    # node hosting the surviving bundles (or, if everything
                    # was lost, any single node that fits them all).
                    if survivors:
                        cands = [n for n in cands if n.node_id in survivors]
                    else:
                        need = self._sum_bundles([pg.bundles[j] for j in lost])
                        cands = [n for n in cands
                                 if self._node_fits(n, need)]
                elif pg.strategy == "PACK" and survivors:
                    packed = [n for n in cands if n.node_id in survivors]
                    if packed:
                        cands = packed
                if not cands:
                    ok = False
                    continue
                n = min(cands, key=lambda n: n.utilization())
                self._node_acquire(n, b.resources)
                pg.bundle_nodes[i] = n.node_id
                pg.remaining[i] = dict(b.resources)
                survivors.add(n.node_id)
            if ok and all(nid is not None for nid in pg.bundle_nodes):
                pg.state = "CREATED"

    def _alive_nodes(self) -> List[NodeInfo]:
        return [n for n in self.nodes.values() if n.state == "ALIVE"]

    async def _on_worker_death(self, w: WorkerInfo, cause: str,
                               node_dead: bool = False):
        self.workers.pop(w.worker_id, None)
        self.metrics_snapshots.pop(w.worker_id.hex(), None)
        # A dead worker's object copies are gone: drop its directory
        # entries so pullers stop picking it as a source, and free any
        # pull claims it held so peers take over immediately.
        wkey = repr(w.address)
        for oid in list(self.object_locations):
            locs = self.object_locations[oid]
            if wkey in locs:
                locs.pop(wkey, None)
                if not locs:
                    self.object_locations.pop(oid, None)
        for ckey in list(self._pull_claims):
            if self._pull_claims[ckey][0] == wkey:
                self._pull_claims.pop(ckey, None)
        node = self.nodes.get(w.node)
        if node is not None:
            try:
                node.idle.remove(w)
            except ValueError:
                pass
        self._release_charged(w.charge)
        w.charge = None
        if isinstance(w.assignment, ActorID):
            actor = self.actors.get(w.assignment)
            if actor and actor.state != "DEAD":
                await self._handle_actor_failure(actor, cause)
        self._pump_leases()

    async def _reconcile_after_restart(self):
        """Grace window after a head restart: actors whose workers have
        not reattached by then go through the normal failure path
        (restart from creation spec or DEAD). Reference:
        ``gcs_failover_worker_reconnect_timeout`` (``ray_config_def.h:60``)."""
        grace = float(os.environ.get("RT_HEAD_RECONNECT_GRACE_S", "10"))
        await asyncio.sleep(grace)
        for a in list(self.actors.values()):
            if a.state == "RESTARTING" and a.worker is None:
                await self._handle_actor_failure(
                    a, "worker did not reconnect after head restart")

    async def _handle_actor_failure(self, actor: ActorInfo, cause: str):
        if actor.restarts_used < actor.max_restarts:
            actor.restarts_used += 1
            actor.state = "RESTARTING"
            # Gate against the reattach path: a worker reconnecting
            # mid-restart must not flip this actor ALIVE on the old
            # process while a new instance is being placed (two live
            # instances with divergent state).
            actor.restart_inflight = True
            self.publish(f"actor:{actor.actor_id.hex()}",
                         {"state": "RESTARTING", "cause": cause})
            try:
                await self._restart_actor(actor)
                self.publish(f"actor:{actor.actor_id.hex()}",
                             {"state": "ALIVE",
                              "address": actor.worker.address,
                              "restarts": actor.restarts_used})
            except Exception as e:  # noqa: BLE001
                self._mark_actor_dead(actor, f"restart failed: {e}")
            finally:
                actor.restart_inflight = False
        else:
            self._mark_actor_dead(actor, cause)

    async def _restart_actor(self, actor: ActorInfo):
        req = actor.resources
        strategy = actor.strategy or {}
        pg_meta = None
        if strategy.get("kind") == "PLACEMENT_GROUP":
            # Restart back into the actor's own bundle, not raw node
            # resources (the bundle charge was released on worker death).
            pg_meta = (PlacementGroupID.from_hex(strategy["pg_id"]),
                       strategy.get("bundle_index", -1))
        deadline = time.time() + self.config.worker_lease_timeout_s
        while True:
            found = self._find_grant(req, pg_meta, strategy)
            if found is not None:
                break
            if time.time() > deadline:
                raise RuntimeError("no node can host the restarted actor")
            await asyncio.sleep(0.02)
        node, charge = found
        self._apply_charge(charge)
        try:
            w = await self._place_actor(actor, node)
        except Exception:
            self._release_charged(charge)
            raise
        w.charge = charge

    def _mark_actor_dead(self, actor: ActorInfo, cause: str):
        actor.state = "DEAD"
        actor.death_cause = cause
        actor.worker = None
        if actor.name:
            self.named_actors.pop(actor.name, None)
        self.wal.append({"op": "actor_dead",
                         "actor_id": actor.actor_id.hex(), "cause": cause})
        self.publish(f"actor:{actor.actor_id.hex()}",
                     {"state": "DEAD", "cause": cause})

    # ------------------------------------------------------------- resources
    @staticmethod
    def _node_fits(node: NodeInfo, req: Dict[str, float]) -> bool:
        return all(node.available.get(k, 0.0) + 1e-9 >= v
                   for k, v in req.items())

    @staticmethod
    def _node_acquire(node: NodeInfo, req: Dict[str, float]):
        for k, v in req.items():
            node.available[k] = node.available.get(k, 0.0) - v

    @staticmethod
    def _node_release(node: NodeInfo, req: Dict[str, float]):
        for k, v in req.items():
            node.available[k] = node.available.get(k, 0.0) + v

    def _release_charged(self, charge):
        """Release a node-resource or placement-group bundle charge."""
        if not charge:
            return
        kind = charge[0]
        if kind == "pg":
            _, pg_id, idx, req = charge
            pg = self.pgs.get(pg_id)
            if pg is not None and pg.state in ("CREATED", "RESCHEDULING"):
                rem = pg.remaining[idx]
                for k, v in req.items():
                    rem[k] = rem.get(k, 0.0) + v
        else:  # ("node", node_hex, req)
            _, node_hex, req = charge
            node = self.nodes.get(node_hex)
            if node is not None:
                self._node_release(node, req)

    # ------------------------------------------------------- scheduling policy
    def _pick_node(self, req: Dict[str, float], strategy) -> Optional[NodeInfo]:
        """Choose a node for a lease/actor under the given strategy.

        - DEFAULT: hybrid — prefer the head-local node while its utilization
          stays under ``scheduler_spread_threshold``, then least-utilized
          (reference: ``hybrid_scheduling_policy.h:50``).
        - SPREAD: round-robin over feasible nodes
          (reference: ``spread_scheduling_policy.h``).
        - NODE_AFFINITY: the named node; ``soft`` falls back to hybrid
          (reference: ``node_affinity_scheduling_policy.h``).
        - NODE_LABEL: nodes carrying every hard label; soft-label
          matches preferred among them (reference:
          ``node_label_scheduling_policy.h``).
        """
        kind = (strategy or {}).get("kind", "DEFAULT") if isinstance(
            strategy, dict) else "DEFAULT"
        nodes = self._alive_nodes()
        fitting = [n for n in nodes if self._node_fits(n, req)]
        if not fitting:
            return None
        if kind == "NODE_AFFINITY":
            want = strategy.get("node_id")
            target = self.nodes.get(want)
            if target is not None and target.state == "ALIVE" and \
                    self._node_fits(target, req):
                return target
            if not strategy.get("soft"):
                return None
            kind = "DEFAULT"
        if kind == "NODE_LABEL":
            hard = strategy.get("hard_labels") or {}
            soft = strategy.get("soft_labels") or {}
            feasible = [n for n in fitting
                        if all(n.labels.get(k) == v
                               for k, v in hard.items())]
            if not feasible:
                return None
            preferred = [n for n in feasible
                         if all(n.labels.get(k) == v
                                for k, v in soft.items())]
            pool = preferred or feasible
            return min(pool, key=lambda n: n.utilization())
        if kind == "SPREAD":
            self._spread_rr += 1
            order = sorted(fitting, key=lambda n: n.node_id)
            return order[self._spread_rr % len(order)]
        # DEFAULT hybrid
        threshold = getattr(self.config, "scheduler_spread_threshold", 0.5)
        local = self.nodes.get(self.node_id.hex())
        if (local is not None and local in fitting
                and local.utilization() < threshold):
            return local
        return min(fitting, key=lambda n: n.utilization())

    # ------------------------------------------------------------- workers
    async def _spawn_worker(self, node: NodeInfo) -> WorkerInfo:
        """Spawn with one retry on registration timeout: under heavy
        host load a fresh interpreter can miss the lease window while
        importing — a transient condition that must not fail the user's
        task when a second attempt would land (the stuck first process
        is killed before the retry)."""
        try:
            return await self._spawn_worker_once(node)
        except RuntimeError as e:
            if "failed to register" not in str(e):
                raise
            return await self._spawn_worker_once(node)

    async def _spawn_worker_once(self, node: NodeInfo) -> WorkerInfo:
        worker_id = WorkerID.from_random()
        fut = self._loop.create_future()
        self._registration_waiters[worker_id] = fut
        proc = None
        try:
            if node.is_head:
                log = open(os.path.join(self.session_dir, "logs",
                                        f"worker-{worker_id.hex()[:12]}.log"),
                           "ab")
                try:
                    proc = subprocess.Popen(
                        [sys.executable, "-m",
                         "ray_tpu_torch._private.worker_main",
                         "--session-dir", self.session_dir,
                         "--worker-id", worker_id.hex(),
                         "--node-id", self.node_id.hex(),
                         "--head-sock", self.sock_path],
                        stdout=log, stderr=subprocess.STDOUT,
                        env={**self._spawn_env,
                             reaper.EXPECTED_PPID_ENV: str(os.getpid())},
                        cwd=os.getcwd(),
                    )
                finally:
                    log.close()  # the child holds its own dup of the fd
            else:
                await node.conn.call_simple(
                    "spawn_worker", {"worker_id": worker_id.hex()},
                    timeout=self.config.worker_lease_timeout_s)
            info: WorkerInfo = await asyncio.wait_for(
                fut, timeout=self.config.worker_lease_timeout_s
            )
        except asyncio.TimeoutError:
            # A late register RPC from this (now killed) worker must not
            # be adopted into the idle pool as a corpse.
            self._doomed_workers[worker_id] = None
            while len(self._doomed_workers) > 1024:
                self._doomed_workers.pop(
                    next(iter(self._doomed_workers)), None)
            if proc is not None:
                proc.kill()
                try:
                    # SIGKILL'd child reaps near-instantly; waiting here
                    # avoids accumulating zombies for the head's life.
                    await self._loop.run_in_executor(
                        None, lambda: proc.wait(timeout=5))
                except Exception:  # noqa: BLE001
                    pass
            elif node.conn is not None:
                # Remote spawn: tell the node daemon to reap the stuck
                # process so it doesn't linger unregistered.
                try:
                    node.conn.push("kill_worker",
                                   {"worker_id": worker_id.hex()})
                except Exception:
                    pass
            raise RuntimeError("worker failed to register in time")
        finally:
            self._registration_waiters.pop(worker_id, None)
        info.proc = proc
        return info

    async def _get_worker(self, node: NodeInfo) -> WorkerInfo:
        while node.idle:
            w = node.idle.popleft()
            if w.worker_id in self.workers:
                return w
        return await self._spawn_worker(node)

    def _return_worker(self, w: WorkerInfo):
        if w.worker_id in self.workers:
            w.assignment = None
            node = self.nodes.get(w.node)
            if node is not None and node.state == "ALIVE":
                node.idle.append(w)

    def _kill_worker(self, w: WorkerInfo):
        if w.proc is not None:
            try:
                w.proc.terminate()
            except Exception:
                pass
        else:
            # Remote worker: tell it to exit; its node daemon reaps it.
            try:
                if w.conn is not None:
                    w.conn.push("shutdown", {})
            except Exception:
                pass
        self.workers.pop(w.worker_id, None)
        self.metrics_snapshots.pop(w.worker_id.hex(), None)

    # ------------------------------------------------------------- leases
    def _find_grant(self, req: Dict[str, float], pg_meta, strategy
                    ) -> Optional[Tuple[NodeInfo, Any]]:
        """Find (node, charge) for a request, or None if infeasible now."""
        if pg_meta is not None:
            pg_id, bundle_index = pg_meta
            pg = self.pgs.get(pg_id)
            if pg is None or pg.state != "CREATED":
                return None
            idxs = ([bundle_index] if bundle_index >= 0
                    else range(len(pg.bundles)))
            for i in idxs:
                rem = pg.remaining[i]
                nid = pg.bundle_nodes[i]
                node = self.nodes.get(nid) if nid else None
                if node is None or node.state != "ALIVE":
                    continue
                if all(rem.get(k, 0.0) + 1e-9 >= v for k, v in req.items()):
                    return node, ("pg", pg_id, i, dict(req))
            return None
        node = self._pick_node(req, strategy)
        if node is None:
            return None
        return node, ("node", node.node_id, dict(req))

    def _apply_charge(self, charge):
        if charge[0] == "pg":
            _, pg_id, idx, req = charge
            rem = self.pgs[pg_id].remaining[idx]
            for k, v in req.items():
                rem[k] = rem.get(k, 0.0) - v
        else:
            _, node_hex, req = charge
            self._node_acquire(self.nodes[node_hex], req)

    async def _grant_lease(self, node: NodeInfo, charge) -> dict:
        """Spawn/reuse a worker for an ALREADY-APPLIED charge (callers must
        call ``_apply_charge`` synchronously right after ``_find_grant`` so
        concurrent grants can't double-book the same capacity)."""
        try:
            w = await self._get_worker(node)
        except Exception:
            self._release_charged(charge)
            raise
        w.assignment = "lease"
        w.leased_at = time.time()  # OOM policy ranks by LEASE age —
        # pooled workers' process age says nothing about task progress
        w.charge = charge
        from .metrics import core_metrics

        core_metrics()["leases_granted"].inc()
        return {"worker_id": w.worker_id.hex(), "address": w.address}

    def _pump_leases(self):
        """Grant queued lease requests that now fit."""
        still = deque()
        self._replace_lost_bundles()
        while self._pending_leases:
            req, pg_meta, strategy, fut = self._pending_leases.popleft()
            if fut.done():
                continue
            found = self._find_grant(req, pg_meta, strategy)
            if found is not None:
                node, charge = found
                self._apply_charge(charge)
                rpc.spawn(self._grant_into(node, charge, fut), self._loop)
            else:
                still.append((req, pg_meta, strategy, fut))
        self._pending_leases = still

    async def _grant_into(self, node, charge, fut):
        try:
            res = await self._grant_lease(node, charge)
            if not fut.done():
                fut.set_result(res)
        except Exception as e:  # noqa: BLE001
            if not fut.done():
                fut.set_exception(e)

    # ------------------------------------------------------------- actors
    async def _place_actor(self, actor: ActorInfo, node: NodeInfo):
        w = await self._get_worker(node)
        w.assignment = actor.actor_id
        actor.worker = w
        # Ask the worker to instantiate the actor.
        meta, _ = await w.conn.call("create_actor", actor.creation_spec_meta)
        actor.state = "ALIVE"
        return w

    # ------------------------------------------------------------- pubsub
    def publish(self, topic: str, msg: Any):
        dead = []
        for conn in self._subs.get(topic, []):
            try:
                conn.push("pubsub", {"topic": topic, "msg": msg})
            except Exception:
                dead.append(conn)
        for c in dead:
            try:
                self._subs[topic].remove(c)
            except ValueError:
                pass

    # ------------------------------------------------------------- handler
    async def _handle(self, method: str, payload: Any, bufs: List[bytes],
                      conn: rpc.Connection):
        if method == "subscribe":
            topic = payload["topic"]
            self._subs[topic].append(conn)
            return {}
        if method == "unsubscribe":
            topic = payload["topic"]
            try:
                self._subs[topic].remove(conn)
            except ValueError:
                pass
            return {}
        if method == "publish":
            self.publish(payload["topic"], payload["msg"])
            return {}
        if method == "register_node":
            return await self._register_node(payload, conn)
        fn = getattr(self, "_rpc_" + method, None)
        if fn is None:
            raise rpc.RpcError(f"head: unknown method {method}")
        return await fn(payload, bufs)

    async def _register_node(self, payload, conn: rpc.Connection):
        """A node daemon attached over TCP; its connection IS its liveness
        (reference: raylet registration + health checks,
        ``gcs_node_manager.cc`` HandleRegisterNode)."""
        node = NodeInfo(
            node_id=payload["node_id"],
            hostname=payload.get("hostname") or "?",
            total=dict(payload["resources"]),
            available=dict(payload["resources"]),
            conn=conn,
            labels=dict(payload.get("labels") or {}),
            phys_host=payload.get("host") or payload.get("hostname") or "?",
            agent_url=payload.get("agent_url"),
        )
        self.nodes[node.node_id] = node
        prev_close = conn.on_close

        def _closed():
            if prev_close:
                prev_close()
            rpc.spawn(self._on_node_death(node, "node connection lost"),
                      self._loop)

        conn.on_close = _closed
        self.publish("nodes", {"event": "ALIVE", "node_id": node.node_id})
        self._pump_leases()
        return {"node_id": node.node_id, "config": self.config.to_dict(),
                "head_node_id": self.node_id.hex()}

    async def _rpc_register_worker(self, payload, bufs):
        worker_id = WorkerID.from_hex(payload["worker_id"])
        if worker_id in self._doomed_workers:
            # Registered after its spawn timed out and it was killed:
            # the process is (about to be) dead — adopting it into the
            # idle pool would hand tasks to a corpse.
            del self._doomed_workers[worker_id]
            raise rpc.RpcError(
                f"worker {worker_id.hex()[:12]} was reaped after a "
                f"registration timeout; not adopting")
        address = payload["address"]
        if isinstance(address, list):
            address = tuple(address)
        node_hex = payload.get("node_id") or self.node_id.hex()
        info = WorkerInfo(worker_id=worker_id, address=address,
                          pid=payload["pid"], node=node_hex)
        # The registering connection is the one this call arrived on; we
        # instead open a dedicated control connection to the worker.
        info.conn = await rpc.connect(address, self._handle)
        if worker_id in self._doomed_workers:
            # The spawn timed out (and the process was killed) WHILE we
            # were connecting — same corpse, later window.
            del self._doomed_workers[worker_id]
            try:
                await info.conn.close()
            except Exception:  # noqa: BLE001
                pass
            raise rpc.RpcError(
                f"worker {worker_id.hex()[:12]} was reaped after a "
                f"registration timeout; not adopting")
        self.workers[worker_id] = info
        # Reattach after a head restart: the worker announces the actors
        # it still hosts; RESTARTING records flip back to ALIVE. An
        # actor whose restart placement is already in flight (transient
        # disconnect, not a head crash) must NOT reattach — the restart
        # wins, and the stale instance is told to drop itself.
        reattached = False
        stale = []
        for ahex in payload.get("hosting_actors") or ():
            a = self.actors.get(ActorID.from_hex(ahex))
            can_attach = a is not None and not a.restart_inflight and (
                a.state in ("RESTARTING", "PENDING")
                # Asymmetric disconnect: the head never saw a failure
                # (actor still ALIVE, recorded at this same worker
                # address) — the SAME healthy process re-registering
                # must reattach, not be told it is stale.
                or (a.state == "ALIVE" and a.worker is not None
                    and a.worker.address == address))
            if can_attach:
                a.state = "ALIVE"
                a.worker = info
                a.death_cause = ""
                info.assignment = a.actor_id
                reattached = True
                self.publish(f"actor:{ahex}",
                             {"state": "ALIVE", "address": address})
            else:
                stale.append(ahex)
        fut = self._registration_waiters.get(worker_id)
        if fut is not None and not fut.done():
            fut.set_result(info)
        elif not reattached:
            node = self.nodes.get(node_hex)
            if node is not None:
                node.idle.append(info)  # adopted externally-started worker
        return {"node_id": node_hex,
                "stale_actors": stale,
                "config": self.config.to_dict()}

    async def _rpc_lease_worker(self, payload, bufs):
        req: Dict[str, float] = payload.get("resources") or {}
        strategy = payload.get("strategy") or {}
        pg_meta = None
        if strategy.get("kind") == "PLACEMENT_GROUP":
            pg_meta = (PlacementGroupID.from_hex(strategy["pg_id"]),
                       strategy.get("bundle_index", -1))
        found = self._find_grant(req, pg_meta, strategy)
        if found is not None:
            node, charge = found
            self._apply_charge(charge)
            return await self._grant_lease(node, charge)
        fut = self._loop.create_future()
        self._pending_leases.append((req, pg_meta, strategy, fut))
        timeout = payload.get("timeout", self.config.worker_lease_timeout_s)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise rpc.RpcError(
                f"lease timed out after {timeout}s: requested {req}, "
                f"available {self._available_summary()}"
            )

    def _available_summary(self) -> Dict[str, float]:
        total: Dict[str, float] = defaultdict(float)
        for n in self._alive_nodes():
            for k, v in n.available.items():
                total[k] += v
        return dict(total)

    async def _rpc_return_lease(self, payload, bufs):
        worker_id = WorkerID.from_hex(payload["worker_id"])
        w = self.workers.get(worker_id)
        if w is not None:
            self._release_charged(w.charge)
            w.charge = None
            if payload.get("kill"):
                self._kill_worker(w)
            else:
                self._return_worker(w)
        self._pump_leases()
        return {}

    def _register_actor(self, payload) -> ActorInfo:
        """Record actor metadata + name (state PENDING). Mirrors the sync
        half of the reference's split (``gcs_actor_manager.cc:311``
        RegisterActor vs :340 CreateActor)."""
        actor_id = ActorID.from_hex(payload["actor_id"])
        existing = self.actors.get(actor_id)
        if existing is not None and existing.state != "DEAD":
            return existing
        # DEAD records (e.g. a failed earlier placement) are rebuilt so a
        # retried create re-registers the name it lost in _mark_actor_dead.
        name = payload.get("name") or ""
        if name and name in self.named_actors:
            raise rpc.RpcError(f"actor name '{name}' already taken")
        actor = ActorInfo(
            actor_id=actor_id, name=name, state="PENDING", worker=None,
            resources=payload.get("resources") or {},
            max_restarts=payload.get("max_restarts", 0),
            creation_spec_meta=payload["spec_meta"],
            strategy=payload.get("strategy") or {},
            registered_at=time.time(),
            detached=bool(name) or payload.get("lifetime") == "detached",
        )
        self.actors[actor_id] = actor
        if name:
            self.named_actors[name] = actor_id
        self.wal.append({"op": "actor", "rec": self._actor_record(actor)})
        return actor

    async def _rpc_register_actor(self, payload, bufs):
        self._register_actor(payload)
        return {}

    async def _rpc_create_actor(self, payload, bufs):
        actor = self._register_actor(payload)
        actor.creation_started = True
        req = payload.get("resources") or {}
        strategy = payload.get("strategy") or {}
        pg_meta = None
        if strategy.get("kind") == "PLACEMENT_GROUP":
            pg_meta = (PlacementGroupID.from_hex(strategy["pg_id"]),
                       strategy.get("bundle_index", -1))
        deadline = time.time() + self.config.worker_lease_timeout_s
        while True:
            found = self._find_grant(req, pg_meta, strategy)
            if found is not None:
                break
            if time.time() > deadline:
                self._mark_actor_dead(actor, "resources unavailable")
                raise rpc.RpcError(
                    f"cannot place actor: requested {req}, available "
                    f"{self._available_summary()}")
            await asyncio.sleep(0.02)
        node, charge = found
        self._apply_charge(charge)
        try:
            w = await self._place_actor(actor, node)
        except Exception as e:  # noqa: BLE001
            self._release_charged(charge)
            self._mark_actor_dead(actor, f"creation failed: {e}")
            raise
        w.charge = charge
        return {"address": w.address, "worker_id": w.worker_id.hex()}

    async def _rpc_get_actor(self, payload, bufs):
        actor_id = ActorID.from_hex(payload["actor_id"])
        a = self.actors.get(actor_id)
        if a is None:
            raise rpc.RpcError(f"no such actor {actor_id}")
        return {"state": a.state,
                "address": a.worker.address if a.worker else None,
                "death_cause": a.death_cause,
                "name": a.name,
                "has_concurrency_groups": bool(
                    (a.creation_spec_meta or {}).get(
                        "concurrency_groups"))}

    async def _rpc_get_named_actor(self, payload, bufs):
        name = payload["name"]
        actor_id = self.named_actors.get(name)
        if actor_id is None:
            raise rpc.RpcError(f"no actor named '{name}'")
        a = self.actors[actor_id]
        return {"actor_id": actor_id.hex(), "state": a.state,
                "address": a.worker.address if a.worker else None}

    async def _rpc_list_actors(self, payload, bufs):
        out = []
        for a in self.actors.values():
            out.append({"actor_id": a.actor_id.hex(), "name": a.name,
                        "state": a.state,
                        "resources": a.resources,
                        "restarts": a.restarts_used,
                        "node_id": a.worker.node if a.worker else None,
                        "death_cause": a.death_cause})
        return out

    async def _rpc_kill_actor(self, payload, bufs):
        actor_id = ActorID.from_hex(payload["actor_id"])
        a = self.actors.get(actor_id)
        if a is None or a.state == "DEAD":
            return {}
        self._kill_actor_now(a, "killed via kill_actor",
                             no_restart=payload.get("no_restart", True))
        return {}

    def _kill_actor_now(self, a: ActorInfo, cause: str,
                        no_restart: bool = True):
        a.max_restarts = 0 if no_restart else a.max_restarts
        w = a.worker
        self._mark_actor_dead(a, cause)
        if w is not None:
            self._release_charged(w.charge)
            w.charge = None
            self._kill_worker(w)
        self._pump_leases()

    async def _rpc_actor_handle_change(self, payload, bufs):
        """Per-process handle counts: +1 when a process gains its first
        handle to an actor, -1 when it loses its last. On zero the actor
        is garbage-collected after a short grace period (an in-flight
        handle transfer sends its inc within the window). Detached/named
        actors opt out (reference: gcs_actor_manager.cc handle-out-of-
        scope death, simplified to head-aggregated counting)."""
        a = self.actors.get(ActorID.from_hex(payload["actor_id"]))
        if a is None or a.state == "DEAD":
            return {}
        a.handle_refs += payload["delta"]
        if a.handle_refs > 0 and a.pending_gc is not None:
            a.pending_gc.cancel()
            a.pending_gc = None
        if (a.handle_refs <= 0 and payload["delta"] < 0
                and not a.detached and a.pending_gc is None):
            a.pending_gc = self._loop.create_task(self._actor_gc_after(a))
        return {}

    async def _actor_gc_after(self, a: ActorInfo):
        await asyncio.sleep(
            getattr(self.config, "actor_gc_grace_s", 1.0))
        a.pending_gc = None
        if a.state != "DEAD" and a.handle_refs <= 0 and not a.detached:
            self._kill_actor_now(a, "all actor handles went out of scope")

    # ------------------------------------------------------------- KV
    async def _rpc_kv_put(self, payload, bufs):
        ns = payload.get("ns", "default")
        overwrite = payload.get("overwrite", True)
        k = payload["key"]
        store = self.kv[ns]
        if not overwrite and k in store:
            return {"added": False}
        store[k] = bufs[0] if bufs else payload.get("value", b"")
        self.wal.append({"op": "kv_put", "ns": ns, "key": k,
                         "value": bytes(store[k])})
        return {"added": True}

    async def _rpc_kv_get(self, payload, bufs):
        ns = payload.get("ns", "default")
        v = self.kv[ns].get(payload["key"])
        if v is None:
            return {"found": False}
        return ({"found": True}, [bytes(v)])

    async def _rpc_kv_del(self, payload, bufs):
        ns = payload.get("ns", "default")
        existed = self.kv[ns].pop(payload["key"], None) is not None
        if existed:
            self.wal.append({"op": "kv_del", "ns": ns,
                             "key": payload["key"]})
        return {"deleted": existed}

    async def _rpc_kv_keys(self, payload, bufs):
        ns = payload.get("ns", "default")
        prefix = payload.get("prefix", "")
        return [k for k in self.kv[ns] if k.startswith(prefix)]

    # ------------------------------------------------------------- PGs
    def _place_bundles(self, bundles: List[Bundle], strategy: str
                       ) -> Optional[List[str]]:
        """Assign each bundle a node per the PG strategy, atomically
        (reference: ``bundle_scheduling_policy.h:82-106``). Returns node ids
        or None if infeasible right now."""
        nodes = self._alive_nodes()
        # Work on a scratch copy of availability so the reservation is
        # all-or-nothing (the head is the single resource owner, so this IS
        # the 2-phase commit: prepare on the copy, commit below).
        scratch = {n.node_id: dict(n.available) for n in nodes}

        def fits(nid, req):
            av = scratch[nid]
            return all(av.get(k, 0.0) + 1e-9 >= v for k, v in req.items())

        def take(nid, req):
            av = scratch[nid]
            for k, v in req.items():
                av[k] = av.get(k, 0.0) - v

        assignment: List[Optional[str]] = [None] * len(bundles)
        if strategy in ("PACK", "STRICT_PACK"):
            # Try to fit everything on one node (least-utilized first so
            # PACK actually packs).
            total = self._sum_bundles(bundles)
            for n in sorted(nodes, key=lambda n: n.utilization()):
                if fits(n.node_id, total):
                    return [n.node_id] * len(bundles)
            if strategy == "STRICT_PACK":
                return None
            # PACK fallback: greedy first-fit across nodes.
            for i, b in enumerate(bundles):
                placed = False
                for n in nodes:
                    if fits(n.node_id, b.resources):
                        take(n.node_id, b.resources)
                        assignment[i] = n.node_id
                        placed = True
                        break
                if not placed:
                    return None
            return assignment
        if strategy in ("SPREAD", "STRICT_SPREAD"):
            order = sorted(nodes, key=lambda n: n.utilization())
            used: Set[str] = set()
            for i, b in enumerate(bundles):
                # distinct nodes first; SPREAD may reuse when exhausted
                cands = [n for n in order if n.node_id not in used
                         and fits(n.node_id, b.resources)]
                if not cands and strategy == "SPREAD":
                    cands = [n for n in order if fits(n.node_id, b.resources)]
                if not cands:
                    return None
                n = cands[0]
                take(n.node_id, b.resources)
                used.add(n.node_id)
                assignment[i] = n.node_id
            return assignment
        raise rpc.RpcError(f"unknown placement strategy {strategy!r}")

    @staticmethod
    def _sum_bundles(bundles: List[Bundle]) -> Dict[str, float]:
        total: Dict[str, float] = defaultdict(float)
        for b in bundles:
            for k, v in b.resources.items():
                total[k] += v
        return dict(total)

    async def _rpc_create_placement_group(self, payload, bufs):
        pg_id = PlacementGroupID.from_hex(payload["pg_id"])
        bundles = [Bundle(i, dict(b)) for i, b in enumerate(payload["bundles"])]
        strategy = payload.get("strategy", "PACK")
        pg = PlacementGroupInfo(pg_id=pg_id, bundles=bundles, strategy=strategy,
                                state="PENDING", name=payload.get("name", ""))
        self.pgs[pg_id] = pg
        self.wal.append({"op": "pg", "rec": self._pg_record(pg)})
        deadline = time.time() + payload.get(
            "timeout", self.config.worker_lease_timeout_s)
        while True:
            if pg.state == "REMOVED":
                # remove_placement_group raced the pending create: the
                # caller's removal wins; committing would leak bundles.
                raise rpc.RpcError("placement group removed during creation")
            assignment = self._place_bundles(bundles, strategy)
            if assignment is not None:
                break
            if time.time() > deadline or self._shutting_down:
                # Keep the entry, terminally REMOVED: async creators'
                # ready() polls must see a fast failure here — the
                # unknown-id → PENDING fallback in pg_state only covers
                # the create-RPC-in-flight race.
                pg.state = "REMOVED"
                pg.removed_at = time.time()
                self.wal.append({"op": "pg_remove", "pg_id": pg_id.hex()})
                raise rpc.RpcError(
                    f"placement group infeasible: strategy {strategy}, "
                    f"bundles {[b.resources for b in bundles]}, "
                    f"nodes {[(n.node_id[:8], n.available) for n in self._alive_nodes()]}")
            await asyncio.sleep(0.02)
        # Commit the reservation.
        for b, nid in zip(bundles, assignment):
            self._node_acquire(self.nodes[nid], b.resources)
        pg.bundle_nodes = list(assignment)
        pg.remaining = [dict(b.resources) for b in bundles]
        pg.state = "CREATED"
        return {"state": "CREATED",
                "bundle_nodes": list(assignment)}

    async def _rpc_remove_placement_group(self, payload, bufs):
        pg_id = PlacementGroupID.from_hex(payload["pg_id"])
        pg = self.pgs.get(pg_id)
        if pg is None or pg.state == "REMOVED":
            return {}
        if pg.state in ("CREATED", "RESCHEDULING"):
            for b, nid in zip(pg.bundles, pg.bundle_nodes):
                node = self.nodes.get(nid) if nid else None
                if node is not None:
                    self._node_release(node, b.resources)
        pg.state = "REMOVED"
        pg.removed_at = time.time()
        self.wal.append({"op": "pg_remove", "pg_id": pg_id.hex()})
        self._pump_leases()
        return {}

    async def _rpc_pg_state(self, payload, bufs):
        pg_id = PlacementGroupID.from_hex(payload["pg_id"])
        pg = self.pgs.get(pg_id)
        if pg is None:
            # Creation is async (the driver fires create_placement_group
            # on a background thread and returns the handle at once): an
            # unknown id is usually a ready() poll winning the race
            # against the create RPC — but only briefly, since create
            # registers the entry as its first act. Answer PENDING
            # within a short grace window; past it the id is genuinely
            # dead (lost create RPC, pruned tombstone, head restart) and
            # must fail fast, not spin out the caller's whole timeout.
            now = time.time()
            first = self._pg_unknown_since.setdefault(pg_id, now)
            if now - first < 10.0:
                return {"state": "PENDING", "bundle_nodes": []}
            self._pg_unknown_since.pop(pg_id, None)
            return {"state": "REMOVED", "bundle_nodes": []}
        self._pg_unknown_since.pop(pg_id, None)
        return {"state": pg.state, "bundle_nodes": pg.bundle_nodes}

    # ------------------------------------------------------------- cluster
    async def _rpc_cluster_resources(self, payload, bufs):
        total: Dict[str, float] = defaultdict(float)
        for n in self._alive_nodes():
            for k, v in n.total.items():
                total[k] += v
        return dict(total)

    async def _rpc_available_resources(self, payload, bufs):
        return self._available_summary()

    async def _rpc_list_nodes(self, payload, bufs):
        return [{"node_id": n.node_id, "hostname": n.hostname,
                 "is_head": n.is_head, "state": n.state,
                 "total": dict(n.total), "available": dict(n.available),
                 "labels": dict(n.labels), "agent_url": n.agent_url}
                for n in self.nodes.values()]

    async def _rpc_node_stats(self, payload, bufs):
        """Per-node stats, proxied through the head (reference: the
        dashboard head aggregating every agent's node_stats). The
        head's own node is served locally; remote nodes answer over
        their daemon RPC connection."""
        node_hex = payload.get("node_id") or self.local_node.node_id
        node = self.nodes.get(node_hex)
        if node is None:
            raise rpc.RpcError(f"no such node {node_hex[:12]}")
        if node.node_id == self.local_node.node_id:
            from .node_agent import collect_node_stats

            pids = {w.worker_id.hex(): w.pid
                    for w in self.workers.values()
                    if w.node == node_hex and w.proc is not None}
            stats = collect_node_stats(pids)
            stats["node_id"] = node_hex
            return stats
        if node.conn is None:
            raise rpc.RpcError(f"node {node_hex[:12]} has no daemon "
                               "connection")
        return await node.conn.call_simple("agent_stats", {},
                                           timeout=15.0)

    async def _rpc_get_head_tcp_address(self, payload, bufs):
        return {"address": list(self.tcp_address)}

    async def _rpc_worker_died(self, payload, bufs):
        """Pushed by a node daemon when one of its workers exits."""
        worker_id = WorkerID.from_hex(payload["worker_id"])
        w = self.workers.get(worker_id)
        if w is not None:
            await self._on_worker_death(
                w, payload.get("cause", "worker process exited"))
        return {}

    async def _rpc_report_task_events(self, payload, bufs):
        self.task_events.extend(payload)
        return {}

    async def _rpc_report_spans(self, payload, bufs):
        # New wire shape: {"spans": [...], "dropped": n}; a bare list is
        # the legacy shape from pre-upgrade workers.
        if isinstance(payload, dict):
            self.spans_dropped_total += int(payload.get("dropped", 0))
            payload = payload.get("spans", [])
        if self.spans.maxlen:
            # The bounded deque evicts silently on extend; those drops
            # must show in the same honest count as process-side ones.
            self.spans_dropped_total += max(
                0, len(self.spans) + len(payload) - self.spans.maxlen)
        self.spans.extend(payload)
        return {}

    async def _rpc_get_spans(self, payload, bufs):
        limit = payload.get("limit", 1000)
        spans = list(self.spans)[-limit:]
        if payload.get("with_meta"):
            return {"spans": spans,
                    "dropped_total": self.spans_dropped_total}
        return spans

    # ------------------------------------------------- object directory
    async def _rpc_object_loc_add(self, payload, bufs):
        addr = payload["address"]
        key = repr(addr)
        locs = self.object_locations.setdefault(payload["object_id"], {})
        locs[key] = {"address": addr,
                     "domain": payload.get("shm_domain"),
                     "frame_sizes": payload.get("frame_sizes")}
        # The copy exists: release any pull claim for this domain so a
        # future re-pull (after this copy is freed) isn't stalled behind
        # a stale claim.
        self._pull_claims.pop(
            (payload["object_id"], payload.get("shm_domain")), None)
        return {}

    async def _rpc_object_loc_get(self, payload, bufs):
        locs = self.object_locations.get(payload["object_id"], {})
        return {"locations": list(locs.values())}

    async def _rpc_object_pull_claim(self, payload, bufs):
        """Grant one puller per (object, shm domain): peers wait for the
        claimer's copy and attach it locally instead of each moving the
        same bytes across domains (reference: pull dedup in
        ``pull_manager.h`` + plasma create/seal)."""
        key = (payload["object_id"], payload.get("shm_domain"))
        now = time.time()
        cur = self._pull_claims.get(key)
        if (cur is None or payload.get("force")
                or cur[0] == repr(payload["address"])
                or now - cur[1] > 300.0):
            self._pull_claims[key] = (repr(payload["address"]), now)
            return {"granted": True}
        return {"granted": False}

    async def _rpc_object_loc_del(self, payload, bufs):
        if payload.get("address") is not None:
            locs = self.object_locations.get(payload["object_id"])
            if locs:
                locs.pop(repr(payload["address"]), None)
                if not locs:
                    self.object_locations.pop(payload["object_id"], None)
        else:
            self.object_locations.pop(payload["object_id"], None)
        return {}

    async def _rpc_get_task_events(self, payload, bufs):
        limit = payload.get("limit", 10000)
        return list(self.task_events)[-limit:]

    async def _rpc_worker_log(self, payload, bufs):
        """Tail a worker's log wherever it lives: head-local logs read
        from the head's session dir, remote ones fetched through the
        owning node daemon (reference: ``dashboard/modules/log/`` routes
        log reads through per-node agents)."""
        from .node import tail_worker_log

        wid = payload.get("worker_id", "")
        req = {"worker_id": wid, "bytes": payload.get("bytes", 65536)}
        if wid:  # empty = list the head's log dir, never a node's
            for info in self.workers.values():
                if info.worker_id.hex().startswith(wid):
                    # Log files are named by the FULL id's first 12 hex
                    # chars; a shorter matched prefix must be resolved.
                    req["worker_id"] = info.worker_id.hex()
                    node = self.nodes.get(info.node)
                    if node is not None and not node.is_head \
                            and node.conn is not None:
                        return await node.conn.call_simple("tail_log", req,
                                                           timeout=15.0)
                    break
        # Head-local worker (alive or dead — its file is in the head's
        # session dir), else a DEAD remote worker: the head no longer
        # tracks it, but the node daemon that ran it still has the file,
        # so ask each live node until one finds it.
        try:
            return tail_worker_log(self.session_dir, req)
        except rpc.RpcError:
            if wid:
                for node in self._alive_nodes():
                    if node.is_head or node.conn is None:
                        continue
                    try:
                        return await node.conn.call_simple("tail_log", req,
                                                           timeout=15.0)
                    except Exception:  # noqa: BLE001 - not on this node
                        continue
            raise

    # -------------------------------------------------------- observability
    async def _rpc_report_metrics(self, payload, bufs):
        """Workers/drivers push their metric registry snapshots.

        A driver in the head's own process shares the head's
        process-global registry, which metrics_text merges directly —
        storing its snapshot too would double-count every counter."""
        if payload.get("pid") == os.getpid():
            return {}
        self.metrics_snapshots[payload["component"]] = payload["snapshot"]
        return {}

    async def _rpc_metrics_text(self, payload, bufs):
        return {"text": self.metrics_text()}

    async def _rpc_metrics_merged(self, payload, bufs):
        """Cluster-merged metric snapshot in wire form — the structured
        twin of metrics_text, for consumers that compute on buckets
        (serve.status()'s latency block)."""
        from . import metrics as m

        snaps = [m.global_registry().snapshot()]
        snaps.extend(self.metrics_snapshots.values())
        return m.merged_to_wire(m.merge_snapshots(snaps))

    async def _rpc_state(self, payload, bufs):
        return self.state_listing(payload.get("kind", "summary"))

    async def _rpc_dashboard_url(self, payload, bufs):
        return {"url": self.dashboard.url if self.dashboard else None}

    async def _rpc_chrome_trace(self, payload, bufs):
        return self.chrome_trace()

    # ------------------------------------------------------------- jobs
    async def _rpc_submit_job(self, payload, bufs):
        """Spawn a driver subprocess for an entrypoint shell command
        (reference: ``dashboard/modules/job/job_manager.py`` submit_job).
        The job attaches to this head via RT_ADDRESS."""
        import uuid as _uuid

        job_id = payload.get("submission_id") or \
            f"raysubmit_{_uuid.uuid4().hex[:12]}"
        if job_id in self.jobs and self.jobs[job_id]["status"] in (
                "PENDING", "RUNNING"):
            raise rpc.RpcError(f"job {job_id!r} already running")
        wire_env = payload.get("runtime_env") or {}
        env = dict(self._spawn_env)
        env["RT_ADDRESS"] = self.sock_path
        env["RT_JOB_ID"] = job_id
        env.update(wire_env.get("env_vars") or {})
        wd_key = wire_env.get("working_dir_key")
        blob = None
        if wd_key:
            blob = self.kv["default"].get(wd_key)
            if blob is None:
                raise rpc.RpcError(
                    f"job working_dir package {wd_key!r} missing")
        log_path = os.path.join(self.session_dir, "logs",
                                f"job-{job_id}.log")

        def _spawn():
            # Blocking work (zip extraction, file opens, fork) stays off
            # the head's event loop.
            cwd = os.getcwd()
            if wd_key:
                from . import runtime_env as renv

                scratch = os.path.join(self.session_dir, "runtime_envs")
                os.makedirs(scratch, exist_ok=True)
                cwd = renv._extract(wd_key, lambda k: blob, scratch)
                env["PYTHONPATH"] = (
                    cwd + os.pathsep + env.get("PYTHONPATH", ""))
            with open(log_path, "ab") as log:
                # Popen inherits the fd; the parent must not keep it.
                return subprocess.Popen(
                    ["/bin/bash", "-c", payload["entrypoint"]],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=cwd)

        proc = await self._loop.run_in_executor(None, _spawn)
        self.jobs[job_id] = {
            "job_id": job_id, "entrypoint": payload["entrypoint"],
            "status": "RUNNING", "proc": proc, "log_path": log_path,
            "started_at": time.time(), "finished_at": None,
            "returncode": None,
        }
        self.wal.append({"op": "job",
                         "rec": self._job_public(self.jobs[job_id])})
        return {"job_id": job_id}

    def _poll_jobs(self):
        for job in self.jobs.values():
            proc = job.get("proc")
            if proc is not None and job["status"] == "RUNNING" and \
                    proc.poll() is not None:
                job["returncode"] = proc.returncode
                job["status"] = ("SUCCEEDED" if proc.returncode == 0
                                 else "FAILED")
                job["finished_at"] = time.time()
                self.wal.append({"op": "job",
                                 "rec": self._job_public(job)})

    def _job_public(self, job: dict) -> dict:
        return {k: v for k, v in job.items() if k != "proc"}

    async def _rpc_job_status(self, payload, bufs):
        self._poll_jobs()
        job = self.jobs.get(payload["job_id"])
        if job is None:
            raise rpc.RpcError(f"no job {payload['job_id']!r}")
        return self._job_public(job)

    async def _rpc_list_jobs(self, payload, bufs):
        self._poll_jobs()
        return [self._job_public(j) for j in self.jobs.values()]

    async def _rpc_stop_job(self, payload, bufs):
        job = self.jobs.get(payload["job_id"])
        if job is None:
            raise rpc.RpcError(f"no job {payload['job_id']!r}")
        proc = job.get("proc")
        if proc is not None and proc.poll() is None:
            proc.terminate()
            job["status"] = "STOPPED"
            job["finished_at"] = time.time()
        return self._job_public(job)

    async def _rpc_job_logs(self, payload, bufs):
        job = self.jobs.get(payload["job_id"])
        if job is None:
            raise rpc.RpcError(f"no job {payload['job_id']!r}")
        try:
            with open(job["log_path"], "rb") as f:
                data = f.read()[-payload.get("tail_bytes", 1 << 20):]
        except OSError:
            data = b""
        return {"logs": data.decode("utf-8", "replace")}

    # -------------------------------------------------------- persistence
    def snapshot_state(self) -> dict:
        """Durable control-plane state (reference: GCS tables behind
        Redis, ``store_client/redis_store_client.h``): KV, named actors +
        actor metadata, placement-group specs, job records, job counter.
        Live worker processes are NOT part of it — like a GCS restart,
        compute is re-created, metadata survives.

        MUST run on the event-loop thread (it iterates live dicts);
        pickling/writing the result may be offloaded."""
        actors = [self._actor_record(a) for a in list(self.actors.values())]
        pgs = [self._pg_record(pg) for pg in list(self.pgs.values())
               if pg.state != "REMOVED"]
        return {
            "kv": {ns: dict(store) for ns, store in list(self.kv.items())},
            "actors": actors,
            "pgs": pgs,
            "jobs": [self._job_public(j) for j in list(self.jobs.values())],
            "job_counter": self.job_counter,
            # A restarted head re-binds the same TCP port so node
            # daemons/workers/drivers reconnect to the address they know.
            "tcp_port": self._tcp_server._port if self._tcp_server
            else None,
            # First WAL generation NOT covered by this snapshot
            # (persist rolls the WAL immediately before capturing).
            "wal_gen": self.wal.gen,
            "timestamp": time.time(),
        }

    @staticmethod
    def _actor_record(a: ActorInfo) -> dict:
        """Durable form of an actor — shared by snapshot and WAL."""
        return {
            "actor_id": a.actor_id.hex(), "name": a.name, "state": a.state,
            "resources": dict(a.resources), "max_restarts": a.max_restarts,
            "spec_meta": a.creation_spec_meta, "strategy": a.strategy,
            "detached": a.detached, "death_cause": a.death_cause,
        }

    @staticmethod
    def _pg_record(pg: PlacementGroupInfo) -> dict:
        return {
            "pg_id": pg.pg_id.hex(), "strategy": pg.strategy,
            "name": pg.name,
            "bundles": [dict(b.resources) for b in pg.bundles],
        }

    def _write_snapshot(self, data: dict) -> str:
        """Blocking half (pickle + atomic write) — executor-safe."""
        from .. import cloudpickle

        path = os.path.join(self.session_dir, "head_state.pkl")
        with open(path + ".tmp", "wb") as f:
            f.write(cloudpickle.dumps(data))
        os.replace(path + ".tmp", path)
        return path

    def _snapshot_for_persist(self) -> dict:
        """Roll the WAL, then capture — both on the event loop, so the
        snapshot covers exactly the generations below the new one."""
        self.wal.roll()
        return self.snapshot_state()

    async def persist_state(self, offload: bool = True) -> str:
        """Serialized snapshot+WAL-cleanup cycle (reaper, RPC, and stop
        all funnel here — see ``_persist_lock``)."""
        async with self._persist_lock:
            data = self._snapshot_for_persist()
            if offload:
                path = await self._loop.run_in_executor(
                    None, self._write_snapshot, data)
            else:
                path = self._write_snapshot(data)
            self.wal.drop_below(data["wal_gen"])
            return path

    def restore_state(self, path: str) -> None:
        """Adopt a previous head's durable state. Actors whose processes
        died with the old head are recorded DEAD (their names stay
        resolvable for diagnosis until re-created); PGs re-enter PENDING
        and re-reserve once nodes attach."""
        from .. import cloudpickle

        with open(path, "rb") as f:
            st = cloudpickle.loads(f.read())
        for ns, store in st["kv"].items():
            self.kv[ns].update(store)
        self._restored_tcp_port = st.get("tcp_port")
        for rec in st["actors"]:
            self._restore_actor_record(rec)
        for rec in st["pgs"]:
            self._restore_pg_record(rec)
        for job in st["jobs"]:
            self._restore_job_record(job)
        self.job_counter = max(self.job_counter, st.get("job_counter", 0))
        self._replay_wal(st.get("wal_gen", 0))

    def _restore_actor_record(self, rec: dict):
        actor_id = ActorID.from_hex(rec["actor_id"])
        was_live = rec["state"] not in ("DEAD",)
        a = ActorInfo(
            actor_id=actor_id, name=rec["name"],
            # Live actors' processes may have survived the head
            # crash (node-daemon workers): hold them RESTARTING for
            # the reconnect grace window; workers that reattach with
            # ``hosting_actors`` flip them back to ALIVE, the rest
            # go through the normal failure/restart path (reference:
            # ``gcs_failover_worker_reconnect_timeout``,
            # ``ray_config_def.h:60``).
            state="RESTARTING" if was_live else "DEAD",
            worker=None, resources=rec["resources"],
            max_restarts=rec["max_restarts"],
            creation_spec_meta=rec["spec_meta"],
            strategy=rec["strategy"], detached=rec["detached"],
            death_cause=(rec["death_cause"] if not was_live
                         else ""),
            registered_at=time.time(),
        )
        self.actors[actor_id] = a
        # Live actors (re)claim their name; dead ones keep it resolvable
        # for diagnosis only if nobody else holds it.
        if a.name and (was_live or a.name not in self.named_actors):
            self.named_actors[a.name] = actor_id

    def _restore_pg_record(self, rec: dict):
        pg_id = PlacementGroupID.from_hex(rec["pg_id"])
        bundles = [Bundle(i, dict(r))
                   for i, r in enumerate(rec["bundles"])]
        self.pgs[pg_id] = PlacementGroupInfo(
            pg_id=pg_id, bundles=bundles, strategy=rec["strategy"],
            state="PENDING", name=rec["name"],
            remaining=[dict(b.resources) for b in bundles],
            bundle_nodes=[None] * len(bundles))

    def _restore_job_record(self, job: dict):
        job = dict(job)
        if job["status"] in ("PENDING", "RUNNING"):
            job["status"] = "FAILED"
            job["finished_at"] = job.get("finished_at") or time.time()
        self.jobs[job["job_id"]] = job

    def _replay_wal(self, first_gen: int) -> int:
        """Apply mutations logged after the snapshot being restored.
        Records replay in append order over the snapshot state; the
        appliers are upserts, so a record both snapshotted AND logged
        (snapshot raced the write) converges to the same state."""
        n = 0
        for rec in self.wal.replay_from(first_gen):
            n += 1
            op = rec.get("op")
            if op == "kv_put":
                self.kv[rec["ns"]][rec["key"]] = rec["value"]
            elif op == "kv_del":
                self.kv[rec["ns"]].pop(rec["key"], None)
            elif op == "actor":
                self._restore_actor_record(rec["rec"])
            elif op == "actor_dead":
                a = self.actors.get(ActorID.from_hex(rec["actor_id"]))
                if a is not None:
                    a.state = "DEAD"
                    a.death_cause = rec.get("cause", "")
                    if a.name:
                        self.named_actors.pop(a.name, None)
            elif op == "pg":
                self._restore_pg_record(rec["rec"])
            elif op == "pg_remove":
                self.pgs.pop(
                    PlacementGroupID.from_hex(rec["pg_id"]), None)
            elif op == "job":
                self._restore_job_record(rec["rec"])
            elif op == "job_counter":
                self.job_counter = max(self.job_counter, rec["value"])
        return n

    async def _rpc_persist_state(self, payload, bufs):
        return {"path": await self.persist_state()}

    async def _rpc_autoscaler_state(self, payload, bufs):
        """Demand signals for the autoscaler loop (reference: v2 instance
        manager reads cluster resource state from the GCS)."""
        unplaced = 0
        shapes: list = []
        for pg in self.pgs.values():
            if pg.state in ("PENDING", "RESCHEDULING"):
                for i, n in enumerate(pg.bundle_nodes):
                    if n is None:
                        unplaced += 1
                        shapes.append(dict(pg.bundles[i].resources))
        for req, pg_meta, _strategy, _fut in list(self._pending_leases):
            # Bundle-targeted leases draw on capacity their PG already
            # accounts for (above if unplaced, reserved if placed) —
            # counting them again would double the demand signal.
            if pg_meta:
                continue
            shapes.append(dict(req))
        return {
            "pending_lease_requests": len(self._pending_leases),
            "unplaced_pg_bundles": unplaced,
            # Resource dict per unmet demand unit, so gang-aware
            # providers (TPU slices) can pick a node type.
            "pending_resource_shapes": shapes,
            "node_utilization": {
                n.node_id: n.utilization()
                for n in self._alive_nodes() if not n.is_head},
        }

    def metrics_text(self) -> str:
        """Cluster-merged prometheus exposition."""
        from . import metrics as m

        core = m.core_metrics()
        core["actors_alive"].set(
            sum(1 for a in self.actors.values() if a.state == "ALIVE"))
        core["workers_alive"].set(len(self.workers))
        snaps = [m.global_registry().snapshot()]
        snaps.extend(self.metrics_snapshots.values())
        return m.render_prometheus(m.merge_snapshots(snaps))

    def state_listing(self, kind: str):
        """State API listings (reference: ``util/state/api.py`` list_*)."""
        if kind == "nodes":
            return [{"node_id": n.node_id, "hostname": n.hostname,
                     "is_head": n.is_head, "state": n.state,
                     "total": dict(n.total),
                     "available": dict(n.available),
                     "agent_url": n.agent_url}
                    for n in self.nodes.values()]
        if kind == "workers":
            return [{"worker_id": w.worker_id.hex(), "pid": w.pid,
                     "node_id": w.node, "assignment": str(w.assignment)}
                    for w in self.workers.values()]
        if kind == "actors":
            return [{"actor_id": a.actor_id.hex(), "name": a.name,
                     "state": a.state, "resources": dict(a.resources),
                     "death_cause": a.death_cause}
                    for a in self.actors.values()]
        if kind == "placement_groups":
            # REMOVED entries are tombstones for stale ready() polls,
            # not live state — they stay out of listings.
            return [{"pg_id": pg.pg_id.hex(), "state": pg.state,
                     "strategy": pg.strategy,
                     "bundles": [dict(b.resources) for b in pg.bundles],
                     "bundle_nodes": list(pg.bundle_nodes)}
                    for pg in self.pgs.values()
                    if pg.state != "REMOVED"]
        if kind == "tasks":
            return list(self.task_events)[-1000:]
        if kind == "oom_kills":
            return list(self.oom_kills)
        if kind == "objects":
            return {"snapshots": {
                k: {n: d for n, d in snap.items()
                    if n.startswith("object_store")}
                for k, snap in self.metrics_snapshots.items()}}
        if kind == "summary":
            return {
                "nodes": len(self.nodes),
                "workers": len(self.workers),
                "actors_alive": sum(1 for a in self.actors.values()
                                    if a.state == "ALIVE"),
                "placement_groups": sum(1 for p in self.pgs.values()
                                        if p.state != "REMOVED"),
                "task_events": len(self.task_events),
                "resources_total": dict(self._cluster_totals()),
                "resources_available": self._available_summary(),
            }
        raise rpc.RpcError(f"unknown state kind {kind!r}")

    def _cluster_totals(self) -> Dict[str, float]:
        total: Dict[str, float] = defaultdict(float)
        for n in self._alive_nodes():
            for k, v in n.total.items():
                total[k] += v
        return total

    def chrome_trace(self) -> list:
        """Task events → chrome://tracing 'X' events (reference:
        ``timeline()`` chrome-trace export in the dashboard)."""
        out = []
        for ev in list(self.task_events):
            out.append({
                "name": ev.get("name") or ev.get("task_id", "")[:8],
                "cat": "task", "ph": "X",
                "ts": int(ev["start"] * 1e6),
                "dur": int((ev["end"] - ev["start"]) * 1e6),
                "pid": "ray_tpu_torch",
                "tid": ev.get("worker_id", "?")[:12],
            })
        # Tracing spans render on per-trace rows so one request's
        # submit → execute chain reads left-to-right on one line.
        for sp in list(self.spans):
            out.append({
                "name": sp["name"], "cat": f"span:{sp['kind']}", "ph": "X",
                "ts": int(sp["start"] * 1e6),
                "dur": max(1, int((sp["end"] - sp["start"]) * 1e6)),
                "pid": "trace",
                "tid": sp["trace_id"][:12],
                "args": {"span_id": sp["span_id"],
                         "parent_id": sp.get("parent_id"),
                         "status": sp.get("status", "ok"),
                         **({"attrs": sp["attrs"]} if sp.get("attrs")
                            else {})},
            })
        return out

    async def _rpc_ping(self, payload, bufs):
        return {"ok": True, "time": time.time()}

    async def _rpc_new_job_id(self, payload, bufs):
        self.job_counter += 1
        # Durable before reply: a restarted head must never hand out a
        # job index that collides with one it already granted.
        self.wal.append({"op": "job_counter", "value": self.job_counter})
        return {"job_index": self.job_counter}

    async def _rpc_prestart_workers(self, payload, bufs):
        n = payload.get("n", 1)
        created = []
        for _ in range(n):
            w = await self._spawn_worker(self.local_node)
            self._return_worker(w)
            created.append(w.worker_id.hex())
        return created
