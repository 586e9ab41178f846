"""CoreWorker: the per-process engine embedded in drivers and workers.

The port's copy of ``ray_tpu/core/worker.py``.

Capability parity with the reference's C++ core worker (reference:
``src/ray/core_worker/core_worker.cc`` — SubmitTask :2147, CreateActor :2224,
SubmitActorTask :2469, ExecuteTask :2883, Put :1242, Get :1542, Wait :1735)
and its direct task submitter / actor submitter
(``transport/direct_task_transport.cc``, ``direct_actor_task_submitter.cc``),
re-designed for this runtime:

- one background IO thread runs an asyncio loop owning every socket
- normal tasks: resource-shaped worker leases from the head, then direct
  push to the leased worker (lease reuse + pipelining)
- actor tasks: ordered direct push to the actor's dedicated worker
- objects: owner-based — every ref carries its owner's address; small
  objects live in the owner's memory store, large in host shared memory
- failures: task retries on worker death, actor restart tracking via pubsub
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import os
import socket
import threading
import time
import traceback
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Tuple

from .. import cloudpickle

from .._private import rpc
from .._private.config import Config
from .._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from .._private.object_store import MemoryStore, SharedMemoryStore
from .._private.serialization import get_context
from .._private.task_spec import SchedulingStrategy, TaskSpec, TaskType
from ..exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    TaskError,
    WorkerCrashedError,
)
from ..util import tracing


# Structured token embedded in the "actor not hosted here" RpcError so
# callers key on a stable contract, not diagnostic prose.
ACTOR_NOT_ON_WORKER = "[actor-not-on-worker]"


class ObjectRef:
    """A reference to a (possibly pending) remote object.

    Owner-based like the reference (``reference_count.h:61``): the ref itself
    carries the owner's serving address, so any holder can resolve it.
    Creation/destruction feed the process-local reference counter so the
    owner can free the backing store when the last holder (local or
    borrower) drops the ref.
    """

    __slots__ = ("object_id", "owner_address", "_weak_core", "_counted")

    def __init__(self, object_id: ObjectID, owner_address: Any,
                 _counted: bool = True):
        self.object_id = object_id
        self.owner_address = owner_address
        # _counted=False refs (task-arg refs materialized by the executing
        # worker) are covered by the submitting driver's per-task borrow
        # and must not touch the reference counter.
        self._counted = _counted
        core = CoreWorker._current
        if _counted and core is not None and not core._shutdown:
            core.refs.on_created(self)

    def __del__(self):
        if not getattr(self, "_counted", False):
            return
        core = CoreWorker._current
        if core is not None and not core._shutdown:
            try:
                core.refs.on_deleted(self)
            except Exception:  # noqa: BLE001 - never raise from __del__
                pass

    def binary(self) -> bytes:
        return self.object_id.binary()

    def hex(self) -> str:
        return self.object_id.hex()

    def __hash__(self):
        return hash(self.object_id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.object_id == self.object_id

    def __repr__(self):
        return f"ObjectRef({self.object_id.hex()[:14]}…)"

    def __reduce__(self):
        return (ObjectRef, (self.object_id, self.owner_address))

    # ``await ref`` support inside async actors.
    def __await__(self):
        core = CoreWorker.current()
        fut = asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(
                core._async_get_one(self), core._loop))
        return fut.__await__()


class ReferenceCounter:
    """Distributed reference counting for owned objects.

    Capability parity with the reference's ReferenceCounter
    (reference: ``src/ray/core_worker/reference_count.h:61``), simplified to
    an owner-centric protocol for this runtime:

    - every process counts live ``ObjectRef`` pythons per object id
    - serializing a ref charges one *external* borrow at the owner
      (locally if we are the owner, else a fire-and-forget ``ref_inc``)
    - when a process's local count hits zero it sends ``ref_dec`` to the
      owner (or decrements locally if it is the owner)
    - the owner frees memory-store + shm entries when local == external == 0

    Known simplification vs the reference: a borrower forwarding a ref to a
    third process races its own dec against the forwarded inc; the
    reference solves this with contained-in tracking. Here the worst case
    of that rare pattern is an early free surfacing as ObjectLostError.

    Deadlock safety: ``ObjectRef.__del__`` may run from a cyclic-GC pass
    triggered by an allocation made *while this thread already holds*
    ``_lock`` (or a store lock further down the free path). ``on_deleted``
    therefore never blocks: it appends to a lock-free deque and drains with
    a non-blocking acquire; every lock-releasing entry point re-drains, and
    the core's IO-loop sweeper is the backstop.
    """

    def __init__(self, core: "CoreWorker"):
        self.core = core
        self._lock = threading.Lock()
        self._local: Dict[bytes, int] = defaultdict(int)
        self._external: Dict[bytes, int] = defaultdict(int)
        self._pending: deque = deque()  # (ObjectID, owner_address) decs
        # container object → refs its serialized bytes borrow
        self._containment: Dict[bytes, list] = {}
        self.enabled = os.environ.get("RT_DISABLE_REF_GC", "") != "1"

    def add_containment(self, container: ObjectID, contained: list):
        """Record that ``container``'s bytes hold borrows on ``contained``
        refs; freeing the container releases them."""
        if not self.enabled or not contained:
            return
        with self._lock:
            self._containment.setdefault(
                container.binary(), []).extend(contained)

    def pop_containment(self, container: ObjectID) -> list:
        with self._lock:
            return self._containment.pop(container.binary(), [])

    def _is_owner(self, owner_address) -> bool:
        return owner_address == self.core.address

    # ----------------------------------------------------- local lifecycle
    def on_created(self, ref: "ObjectRef"):
        if not self.enabled:
            return
        with self._lock:
            self._local[ref.object_id.binary()] += 1
        self._drain()

    def on_deleted(self, ref: "ObjectRef"):
        """Called from ``__del__`` — must never block on any lock."""
        if not self.enabled:
            return
        self._pending.append((ref.object_id, ref.owner_address))
        # Deaths come in bursts (a result list going out of scope kills
        # thousands of refs back-to-back). Draining each one costs a
        # lock round-trip per ref on the caller's critical path; batch
        # them and let one drain (or the 100ms IO-loop sweeper) pay the
        # lock once for the whole burst.
        if len(self._pending) >= 256:
            self._drain()

    def _drain(self):
        """Apply pending decrements; skip (not block) if the lock is busy."""
        while self._pending:
            if not self._lock.acquire(blocking=False):
                return  # holder re-drains on release; sweeper is backstop
            to_free, to_dec = [], []
            try:
                while True:
                    try:
                        oid, owner = self._pending.popleft()
                    except IndexError:
                        break
                    key = oid.binary()
                    n = self._local.get(key, 0) - 1
                    if n > 0:
                        self._local[key] = n
                    else:
                        self._local.pop(key, None)
                    if owner == self.core.address:
                        if n <= 0:
                            to_free.append(oid)
                    else:
                        # EVERY remote-owned counted ref acquired its own
                        # borrow at creation (deserialize hook), so every
                        # death pays one back — N copies, N incs, N decs.
                        to_dec.append((oid, owner))
            finally:
                self._lock.release()
            for oid in to_free:
                self._maybe_free(oid)
            for oid, owner in to_dec:
                self._notify_owner(oid, owner, "ref_dec")

    # ------------------------------------------------------------ borrows
    def on_serialized(self, ref: "ObjectRef"):
        """A ref is leaving this process (task arg, return value, pickle)."""
        self.acquire_borrow(ref.object_id, ref.owner_address)

    def acquire_borrow(self, object_id: ObjectID, owner_address):
        """Charge one external borrow at the object's owner."""
        if not self.enabled:
            return
        if self._is_owner(owner_address):
            with self._lock:
                self._external[object_id.binary()] += 1
        else:
            self._notify_owner(object_id, owner_address, "ref_inc")
        self._drain()

    def release_borrow(self, object_id: ObjectID, owner_address):
        """Pay back one acquire_borrow charge."""
        if not self.enabled:
            return
        if self._is_owner(owner_address):
            self.on_borrow_change(object_id, -1)
        else:
            self._notify_owner(object_id, owner_address, "ref_dec")

    def on_borrow_change(self, object_id: ObjectID, delta: int):
        """Owner-side handler for ref_inc / ref_dec pushes."""
        if not self.enabled:
            return
        key = object_id.binary()
        with self._lock:
            self._external[key] = self._external.get(key, 0) + delta
            freed = self._external[key] <= 0
            if freed:
                self._external.pop(key, None)
        self._drain()
        if freed:
            self._maybe_free(object_id)

    def on_result_stored(self, object_id: ObjectID):
        """A task result landed; free it immediately if every ref died
        while the task was still running."""
        self._maybe_free(object_id)

    def on_results_stored(self, object_ids):
        """Batch form of :meth:`on_result_stored` — one lock pass for a
        whole reply chunk (refs are almost always still alive, so the
        common case is pure bookkeeping)."""
        if not self.enabled:
            return
        to_free = []
        with self._lock:
            for oid in object_ids:
                key = oid.binary()
                if self._local.get(key, 0) > 0 or \
                        self._external.get(key, 0) > 0:
                    continue
                to_free.append(oid)
        for oid in to_free:
            self.core.free_object(oid)

    def _maybe_free(self, object_id: ObjectID):
        key = object_id.binary()
        with self._lock:
            if self._local.get(key, 0) > 0 or self._external.get(key, 0) > 0:
                return
        self.core.free_object(object_id)

    def _notify_owner(self, object_id: ObjectID, owner_address, method: str):
        core = self.core
        if core._loop is None or not core._loop.is_running():
            return

        async def _send():
            try:
                conn = await core._get_conn(owner_address)
                conn.push(method, {"object_id": object_id.hex()})
            except Exception:  # noqa: BLE001 - missed dec only leaks
                pass

        asyncio.run_coroutine_threadsafe(_send(), core._loop)

    def counts(self, object_id: ObjectID) -> Tuple[int, int]:
        self._drain()
        key = object_id.binary()
        with self._lock:
            return self._local.get(key, 0), self._external.get(key, 0)


class ObjectRefGenerator:
    """Iterator over a streaming task's return refs.

    Capability parity with ``num_returns="streaming"`` (reference:
    ``core_worker.proto:462`` ReportGeneratorItemReturns +
    ``python/ray/_raylet`` ObjectRefGenerator): the executing worker pushes
    each yielded item back to the owner as it is produced; iteration yields
    ``ObjectRef``s that are already (or about to become) local. Consumable
    in the owner process.
    """

    def __init__(self, task_id: TaskID, owner_address: Any):
        self.task_id = task_id
        self.owner_address = owner_address
        self._next_index = 0
        self._finished = False  # stream fully consumed (or errored)

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        core = CoreWorker.current()
        try:
            ref = core.generator_next(self.task_id, self._next_index,
                                      self.owner_address)
        except (StopIteration, Exception):
            self._finished = True
            raise
        self._next_index += 1
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self):
        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, self.__next__)
        except StopIteration:
            raise StopAsyncIteration from None

    def __del__(self):
        if self._finished:
            return  # stream fully drained: nothing to free or track
        core = CoreWorker._current
        if core is not None and not core._shutdown:
            try:
                # Never touch locks from __del__ (same hazard as
                # ObjectRef GC): defer to the IO-loop sweeper.
                core._dropped_gen_pending.append(
                    (self.task_id, self._next_index))
            except Exception:  # noqa: BLE001
                pass


def _deserialize_object_ref(t):
    """Unpickle hook for nested ObjectRefs: the new counted ref acquires
    its own borrow (paid back by its death), keeping repeated
    deserialize/del cycles net-zero on the container's borrow."""
    oid, owner = t
    core = CoreWorker._current
    if core is not None and not core._shutdown and owner != core.address:
        core.refs.acquire_borrow(oid, owner)
    return ObjectRef(oid, owner)


def _small_value(v) -> bool:
    """Cheap-to-serialize check: primitives and tiny containers package on
    the IO loop; everything else hops to the thread pool."""
    if v is None or isinstance(v, (bool, int, float)):
        return True
    if isinstance(v, (str, bytes)) and len(v) < 4096:
        return True
    return False


class _LeaseCache:
    """Leased workers grouped by resource shape, with pipelining slots."""

    def __init__(self):
        # shape key -> list of dict(worker_id, address, conn, inflight)
        self.by_shape: Dict[tuple, List[dict]] = defaultdict(list)
        self.max_inflight_per_worker = 16
        # Pool ceiling per shape: more simultaneous worker processes than
        # physical cores only adds context-switch overhead for the
        # CPU-bound trivial tasks that drive pool growth (a 1-core box
        # timesharing 8 workers halves throughput vs 1 worker; measured
        # 2 workers still ~2x slower than 1). Blocking tasks keep their
        # concurrency — each worker runs pipelined tasks on an 8-thread
        # pool — and RT_MAX_LEASES_PER_SHAPE raises the ceiling.
        self.max_leases_per_shape = int(
            os.environ.get("RT_MAX_LEASES_PER_SHAPE", 0)) or \
            (os.cpu_count() or 2)

    @staticmethod
    def shape_key(resources: Dict[str, float], strategy,
                  runtime_env_hash: str = "") -> tuple:
        extra = ()
        if strategy is not None and strategy.kind == "PLACEMENT_GROUP":
            extra = (strategy.placement_group_id.hex(), strategy.bundle_index)
        elif strategy is not None and strategy.kind == "NODE_AFFINITY":
            # Affinity leases must not be reused for other targets.
            extra = ("aff", strategy.node_id, strategy.soft)
        elif strategy is not None and strategy.kind == "NODE_LABEL":
            extra = ("label",
                     tuple(sorted((strategy.hard_labels or {}).items())),
                     tuple(sorted((strategy.soft_labels or {}).items())))
        elif strategy is not None and strategy.kind == "SPREAD":
            extra = ("spread",)
        if runtime_env_hash:
            # Workers are dedicated per runtime env (reference: worker
            # pool keyed by serialized runtime env).
            extra = extra + ("env", runtime_env_hash)
        return tuple(sorted(resources.items())) + extra


class CoreWorker:
    _current: Optional["CoreWorker"] = None

    def __init__(self, session_dir: str, head_sock, mode: str,
                 config: Optional[Config] = None,
                 worker_id: Optional[WorkerID] = None,
                 job_id: Optional[JobID] = None,
                 listen_tcp: bool = False,
                 node_id: Optional[str] = None,
                 shm_domain: Optional[str] = None):
        self.mode = mode  # "driver" | "worker"
        self.session_dir = session_dir
        self.head_sock = head_sock  # UDS path or (host, port) tuple
        self.config = config or Config()
        self.worker_id = worker_id or WorkerID.from_random()
        self.job_id = job_id or JobID.from_random()
        self.node_id = node_id
        # Same shm_domain == objects exchangeable via host shared memory;
        # different domains ship bytes over the wire (cross-node transfer).
        from .._private.utils import session_shm_domain

        # Session-scoped default (see session_shm_domain): all of one
        # session's host-local processes agree, distinct sessions never
        # collide on segment names. Spawned workers get it explicitly.
        self.shm_domain = shm_domain or session_shm_domain(session_dir)
        self.listen_tcp = listen_tcp
        self.memory_store = MemoryStore()
        self.shm_store = SharedMemoryStore(
            self.config.object_store_memory, self.config.spill_directory,
            domain=self.shm_domain)
        self.serde = get_context()
        self.sock_path = os.path.join(
            session_dir, "workers", f"{self.worker_id.hex()[:16]}.sock")
        # Advertised owner address: UDS path, or (host, port) once the TCP
        # server is up (set in _async_start).
        self.address: Any = self.sock_path
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_ready = threading.Event()
        self._io_thread: Optional[threading.Thread] = None
        self._server: Optional[rpc.RpcServer] = None
        self._head: Optional[rpc.Connection] = None
        self._conns: Dict[Any, rpc.Connection] = {}
        self._conn_locks: Dict[Any, asyncio.Lock] = {}
        self._leases = _LeaseCache()
        self._lease_requests_inflight: Dict[tuple, int] = defaultdict(int)
        self._exported_functions: set = set()
        self._function_cache: Dict[str, Any] = {}
        self._actor_seq: Dict[bytes, int] = defaultdict(int)
        self._actor_send_locks: Dict[bytes, asyncio.Lock] = {}
        # Wire batching for actor calls (same idea as the normal-task
        # burst path): per-actor FIFO of pending specs drained by one
        # pump coroutine into multi-spec push_task_batch RPCs.
        self._actor_batch: Dict[bytes, deque] = {}
        self._actor_pump_active: Dict[bytes, bool] = {}
        self._actor_direct_inflight: Dict[bytes, int] = defaultdict(int)
        self._actor_send_sems: Dict[bytes, asyncio.Semaphore] = {}
        # Caller threads announce actors with queued calls here; the
        # loop-side drain pops it instead of scanning every actor ever
        # seen. The struct lock guards append-vs-prune on _actor_batch
        # and the direct-inflight counter (user thread += vs loop -=).
        self._actor_wake_queue: deque = deque()
        self._actor_struct_lock = threading.Lock()
        self._actor_state: Dict[bytes, dict] = {}
        # worker-mode execution state
        self._actors_local: Dict[bytes, Any] = {}  # actor_id -> instance
        # Tombstones: actors that USED to live here (restarted away /
        # reaped) — routing misses for them fail fast instead of
        # waiting out the registration-grace window.
        self._actors_gone: set = set()
        self._actor_executors: Dict[bytes, Any] = {}
        # actor -> {group name -> dedicated ThreadPoolExecutor}
        self._actor_group_executors: Dict[bytes, Dict[str, Any]] = {}
        # actor -> {group name -> asyncio.Semaphore} (async methods)
        self._actor_group_sems: Dict[bytes, Dict[str, Any]] = {}
        self._actor_order: Dict[bytes, dict] = {}
        self._exec_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(8, (os.cpu_count() or 1) * 4),
            thread_name_prefix="rt-exec")
        self._task_events: deque = deque(maxlen=10000)
        self._shutdown = False
        self._pubsub_handlers: Dict[str, List] = defaultdict(list)
        self._subscribed_topics: set = set()
        self._next_task_index = 0
        self.refs = ReferenceCounter(self)
        self._pulls_inflight: set = set()
        # streaming-generator state (owner side): task_id -> {count, error}
        self._generators: Dict[bytes, dict] = {}
        # generators whose handle died mid-stream: late items are freed on
        # arrival instead of stored (entry removed on generator_done)
        self._dropped_generators: set = set()
        # ObjectRefGenerator.__del__ parks here; the sweeper frees items
        self._dropped_gen_pending: deque = deque()
        # actor-handle GC: per-actor local handle counts; 0↔1 transitions
        # push actor_handle_change to the head (deque+drain — __del__ may
        # fire inside a locked region, same hazard as ObjectRef GC)
        self._handle_counts: Dict[bytes, int] = defaultdict(int)
        self._handle_pending: deque = deque()
        self._handle_lock = threading.Lock()
        self._capture_tls = threading.local()  # nested-ref capture stack
        self._prepared_envs: Dict[str, dict] = {}  # env hash → wire form
        self._applied_envs: set = set()  # env hashes live in this process
        # Burst submission: one loop wake drains many queued submissions
        # (run_coroutine_threadsafe per task costs ~0.3ms of loop churn).
        self._submit_queue: deque = deque()
        self._task_batch_queue: deque = deque()
        self._submit_wake_scheduled = False
        self._batch_deferred = False
        # Lineage-based object recovery (see _record_lineage).
        self._lineage_enabled = (
            os.environ.get("RT_DISABLE_LINEAGE", "") != "1")
        self._lineage_lock = threading.Lock()
        self._lineage: Dict[bytes, TaskSpec] = {}
        self._lineage_pins: Dict[bytes, int] = {}
        self._lineage_live: Dict[bytes, int] = {}
        self._lineage_done: set = set()
        self._lineage_freed: set = set()
        self._recoveries: Dict[bytes, Any] = {}
        self._registered_copies: set = set()
        # oid binary -> asyncio.Event: one chunked pull per object per
        # process; concurrent getters wait and then read the copy.
        self._inflight_pulls: Dict[bytes, asyncio.Event] = {}
        # TCP channel endpoints (see chan_write/chan_read).
        self._chan_lock = threading.Lock()
        self._chan_in: Dict[str, dict] = {}
        self._chan_out: Dict[str, dict] = {}
        self._actor_gc_enabled = (
            os.environ.get("RT_DISABLE_ACTOR_GC", "") != "1")

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def current(cls) -> "CoreWorker":
        if cls._current is None:
            raise RuntimeError("ray_tpu_torch not initialized — call ray_tpu_torch.init()")
        return cls._current

    def start(self):
        self._io_thread = threading.Thread(
            target=self._run_loop, name="rt-io", daemon=True)
        self._io_thread.start()
        self._loop_ready.wait(timeout=30)
        CoreWorker._current = self

        # Nested-ref protocol (reference: contained-in borrow tracking,
        # ``reference_count.h``): SERIALIZING a nested ref charges one
        # borrow owned by the *container* (captured via _capture_tls and
        # recorded against the container object / task spec — released
        # when that container is freed). DESERIALIZING acquires a fresh
        # borrow for the new counted ref, which its own death pays back —
        # so repeated get() cycles are net-zero and can never consume the
        # container's borrow.
        def _ser(ref):
            self.refs.on_serialized(ref)
            lst = getattr(self._capture_tls, "lst", None)
            if lst is not None:
                lst.append((ref.object_id, ref.owner_address))
            return (ref.object_id, ref.owner_address)

        # The deserializer must be module-level: the reduce tuple embeds
        # it in the pickle stream, and a closure over `self` would drag
        # the whole CoreWorker (locks and all) into every message.
        self.serde.register_serializer(
            ObjectRef, serializer=_ser,
            deserializer=_deserialize_object_ref)
        return self

    class _CaptureRefs:
        def __init__(self, core):
            self.core = core
            self.lst: list = []

        def __enter__(self):
            self._prev = getattr(self.core._capture_tls, "lst", None)
            self.core._capture_tls.lst = self.lst
            return self.lst

        def __exit__(self, *exc):
            self.core._capture_tls.lst = self._prev
            return False

    def capture_nested_refs(self) -> "_CaptureRefs":
        """Context manager collecting refs serialized within the block."""
        return CoreWorker._CaptureRefs(self)

    def free_object(self, object_id: ObjectID):
        """Drop an owned object from the local stores (GC endpoint) and
        release the borrows of any refs its bytes contain."""
        self.memory_store.delete(object_id)
        self.shm_store.delete(object_id)
        for oid, owner in self.refs.pop_containment(object_id):
            self.refs.release_borrow(oid, owner)
        self.on_object_freed(object_id)
        # Retract this process's copy from the object directory (other
        # holders keep theirs; dead-worker entries are pruned head-side).
        # Guarded by the registered set so the common tiny-object free
        # path never pays a head push.
        if object_id.binary() not in self._registered_copies:
            return
        self._registered_copies.discard(object_id.binary())
        self._push_to_head("object_loc_del",
                           {"object_id": object_id.hex(),
                            "address": self.address})

    def _run_loop(self):
        # RT_WORKER_PROFILE=/dir: cProfile THIS thread (the IO loop —
        # where RPC framing, batch pumps, and ingest run) and dump
        # pstats on shutdown. cProfile is per-thread, so this is the
        # one thread worth instrumenting for runtime hot spots.
        prof_dir = os.environ.get("RT_WORKER_PROFILE")
        prof = None
        if prof_dir and self.mode == "worker":
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._async_start())
        self._loop_ready.set()
        try:
            self._loop.run_forever()
        finally:
            if prof is not None:
                prof.disable()
                try:
                    os.makedirs(prof_dir, exist_ok=True)
                    prof.dump_stats(os.path.join(
                        prof_dir, f"loop-{os.getpid()}.pstats"))
                except OSError:
                    pass
            try:
                self._loop.run_until_complete(self._async_stop())
            except Exception:
                pass
            self._loop.close()

    async def _async_start(self):
        if self.listen_tcp:
            self._server = rpc.RpcServer(self._handle, host="0.0.0.0")
            await self._server.start()
            self.address = (os.environ.get("RT_NODE_IP", "127.0.0.1"),
                            self._server._port)
        else:
            self._server = rpc.RpcServer(self._handle, path=self.sock_path)
            await self._server.start()
        await self._connect_head()
        if self.listen_tcp and isinstance(self.head_sock, tuple) and \
                "RT_NODE_IP" not in os.environ:
            # Remote client with no node daemon to export RT_NODE_IP:
            # advertise the interface that actually reaches the head
            # (getsockname of the head connection), else cluster workers
            # dial 127.0.0.1 — their own host — to pull driver objects.
            try:
                sock = self._head._writer.get_extra_info("socket")
                local_ip = sock.getsockname()[0]
                if local_ip and local_ip != "0.0.0.0":
                    self.address = (local_ip, self._server._port)
            except Exception:  # noqa: BLE001 - keep the env/loopback default
                pass
        self._reaper = asyncio.get_running_loop().create_task(
            self._lease_reaper())
        self._gc_sweeper = asyncio.get_running_loop().create_task(
            self._ref_gc_sweeper())

    async def _connect_head(self):
        self._head = await rpc.connect(self.head_sock, self._handle)
        self._head.on_close = self._on_head_lost

    def _on_head_lost(self):
        """The head connection dropped. A crashed head restarts against
        the same session (same UDS path / TCP port); reconnect within a
        grace window instead of dying with it (reference: workers
        reconnect after GCS failover, ``gcs_failover_worker_reconnect_
        timeout``)."""
        if self._shutdown:
            return
        try:
            rpc.spawn(self._reconnect_head(), self._loop)
        except RuntimeError:
            pass

    async def _reconnect_head(self):
        grace = float(os.environ.get("RT_HEAD_RECONNECT_TIMEOUT_S", "60"))
        deadline = time.time() + grace
        while not self._shutdown and time.time() < deadline:
            try:
                await self._connect_head()
                if self.mode == "worker":
                    meta = await self._head.call_simple(
                        "register_worker", {
                            "worker_id": self.worker_id.hex(),
                            "address": self.address,
                            "node_id": self.node_id,
                            "pid": os.getpid(),
                            "hosting_actors": [
                                ActorID(k).hex()
                                for k in self._actors_local],
                        })
                    stale = meta.get("stale_actors") or ()
                    if stale and all(
                            ActorID.from_hex(h).binary() in
                            self._actors_local for h in stale) and \
                            len(stale) == len(self._actors_local):
                        # Every actor we host was restarted elsewhere
                        # while we were disconnected: this process is a
                        # zombie — exit rather than run duplicates.
                        os._exit(0)
                    for h in stale:
                        key = ActorID.from_hex(h).binary()
                        self._actors_local.pop(key, None)
                        self._actors_gone.add(key)
                for topic in list(self._subscribed_topics):
                    await self._head.call_simple(
                        "subscribe", {"topic": topic})
                return
            except Exception:  # noqa: BLE001 - head still down
                await asyncio.sleep(0.5)
        if self.mode == "worker" and not self._shutdown:
            # No head within the grace window: this worker is orphaned.
            os._exit(1)

    async def _ref_gc_sweeper(self):
        """Backstop drain for ref-dec events parked while a lock was busy."""
        while not self._shutdown:
            await asyncio.sleep(0.1)
            if self.refs._pending:
                self.refs._drain()
            if self._handle_pending:
                self._drain_handle_events()
            while self._dropped_gen_pending:
                task_id, idx = self._dropped_gen_pending.popleft()
                try:
                    self.generator_dropped(task_id, idx)
                except Exception:  # noqa: BLE001 - missed free only leaks
                    pass

    async def _lease_reaper(self):
        """Return leases idle past the TTL so other clients aren't starved."""
        ttl = getattr(self.config, "lease_idle_ttl_s", 2.0)
        while not self._shutdown:
            await asyncio.sleep(min(0.25, ttl / 2))
            now = time.time()
            for shape, leases in list(self._leases.by_shape.items()):
                for lease in list(leases):
                    if (lease["inflight"] == 0
                            and now - lease.get("last_used", now) > ttl):
                        await self._drop_lease(shape, lease)

    async def _async_stop(self):
        if getattr(self, "_reaper", None):
            self._reaper.cancel()
        if getattr(self, "_gc_sweeper", None):
            self._gc_sweeper.cancel()
        if self._server:
            await self._server.stop()
        for c in self._conns.values():
            await c.close()
        if self._head:
            await self._head.close()

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        if self._loop and self._loop.is_running():
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._io_thread:
            self._io_thread.join(timeout=5)
        self._exec_pool.shutdown(wait=False)
        self.shm_store.shutdown()
        if CoreWorker._current is self:
            CoreWorker._current = None
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass

    def run_sync(self, coro, timeout=None):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    def _enqueue_submission(self, coro) -> None:
        """Fire-and-forget a submission coroutine with batched loop wakes:
        deque.append per call, call_soon_threadsafe only when no drain is
        pending — a 5000-task burst costs ~1 wake, not 5000."""
        self._submit_queue.append(coro)
        try:
            self._wake_drain()
        except RuntimeError:
            try:
                self._submit_queue.remove(coro)
            except ValueError:
                pass
            coro.close()
            raise

    def _enqueue_batchable(self, shape, spec, borrowed) -> None:
        """Normal tasks group per shape into multi-spec RPCs (reference:
        the lease/push pipelining of the direct task submitter, taken one
        step further — a burst shares wire messages, not just workers)."""
        item = (shape, spec, borrowed)
        self._task_batch_queue.append(item)
        try:
            self._wake_drain()
        except RuntimeError:
            try:
                self._task_batch_queue.remove(item)
            except ValueError:
                pass
            raise

    def _wake_drain(self) -> None:
        if not self._submit_wake_scheduled:
            self._submit_wake_scheduled = True
            try:
                self._loop.call_soon_threadsafe(self._drain_submissions)
            except RuntimeError:
                # Loop closed (shutdown race): the submission can never
                # run — surface it instead of returning dead refs.
                self._submit_wake_scheduled = False
                raise RuntimeError(
                    "cannot submit: core worker is shutting down")

    def _drain_submissions(self) -> None:
        # Reset the flag BEFORE draining: a concurrent append that sees
        # False schedules a (harmless) extra wake instead of stranding.
        self._submit_wake_scheduled = False
        while self._submit_queue:
            rpc.spawn(self._submit_queue.popleft(), self._loop)
        # Actor wire batches: one pump per announced actor (a whole
        # burst costs one wake + one pump task, not one per call; no
        # scan over every actor ever used).
        woken = set()
        while self._actor_wake_queue:
            actor_id = self._actor_wake_queue.popleft()
            key = actor_id.binary()
            if key in woken or self._actor_pump_active.get(key):
                continue
            woken.add(key)
            rpc.spawn(self._pump_actor_batches(actor_id), self._loop)
        if not self._task_batch_queue:
            return
        # Coalesce: a submitting thread mid-burst appends faster than the
        # loop wakes, but the first wake often catches only a handful of
        # specs — shipping them as a tiny chunk wastes a whole RPC. Defer
        # ONE loop iteration (bounded latency) to let the burst land.
        if len(self._task_batch_queue) < 32 and not self._batch_deferred:
            self._batch_deferred = True
            self._submit_wake_scheduled = True
            self._loop.call_soon(self._drain_submissions)
            return
        self._batch_deferred = False
        by_shape: Dict[tuple, list] = {}
        while self._task_batch_queue:
            shape, spec, borrowed = self._task_batch_queue.popleft()
            by_shape.setdefault(shape, []).append((spec, borrowed))
        for shape, items in by_shape.items():
            if len(items) == 1:
                spec, borrowed = items[0]
                rpc.spawn(self._submit_normal(spec, borrowed), self._loop)
            else:
                rpc.spawn(self._submit_group(shape, items), self._loop)

    _BATCH_CHUNK = 64

    async def _submit_group(self, shape, items) -> None:
        """Submit many same-shape specs as chunked multi-spec RPCs,
        spreading chunks over the lease pool."""
        chunks = [items[i:i + self._BATCH_CHUNK]
                  for i in range(0, len(items), self._BATCH_CHUNK)]
        await asyncio.gather(
            *(self._submit_chunk(shape, c) for c in chunks))

    async def _submit_chunk(self, shape, chunk) -> None:
        lease = None
        try:
            lease = await self._acquire_lease(shape, chunk[0][0])
            lease["inflight"] += len(chunk)
            try:
                metas = [self._spec_meta(spec) for spec, _ in chunk]
                reply, bufs = await lease["conn"].call(
                    "push_task_batch", {"specs": metas})
            finally:
                lease["inflight"] -= len(chunk)
                lease["last_used"] = time.time()
            offset = 0
            for (spec, _), res in zip(chunk, reply["results"]):
                n = res["nbufs"]
                self._ingest_results(spec, res,
                                     bufs[offset:offset + n])
                offset += n
            for _, borrowed in chunk:
                self._release_borrows_later(borrowed)
        except Exception as e:  # noqa: BLE001 - degrade to per-task path
            # Per-task execution errors never surface here (the worker
            # packages them into results) — this is transport/placement
            # failure. Mark a lost connection's lease dead so the retries
            # don't re-pick it, then re-run each spec via the retrying
            # single-task path, which owns the borrow release.
            if isinstance(e, rpc.ConnectionLost) and lease is not None:
                lease["dead"] = True
                await self._drop_lease(shape, lease, kill=True)
            for spec, borrowed in chunk:
                rpc.spawn(self._submit_normal(spec, borrowed), self._loop)

    # ------------------------------------------------------------- connections
    async def _get_conn(self, address) -> rpc.Connection:
        conn = self._conns.get(address)
        if conn is not None and not conn._closed:
            return conn
        lock = self._conn_locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._conns.get(address)
            if conn is not None and not conn._closed:
                return conn
            conn = await rpc.connect(address, self._handle)
            self._conns[address] = conn
            return conn

    # ------------------------------------------------------------- objects
    def put(self, value: Any) -> ObjectRef:
        object_id = ObjectID.from_random()
        with self.capture_nested_refs() as contained:
            frames = self.serde.serialize(value)
        self._store_frames(object_id, frames)
        self.refs.add_containment(object_id, contained)
        return ObjectRef(object_id, self.address)

    def _store_frames(self, object_id: ObjectID, frames: List[bytes]):
        total = sum(len(f) for f in frames)
        if total > self.config.max_inline_object_size:
            self.shm_store.create(object_id, frames)
            self.memory_store.put(object_id, None)  # marker: lives in shm
        else:
            # Snapshot to bytes: zero-copy serialization leaves raw
            # frames ALIASING the caller's arrays — storing the views
            # would let the putter (or a getter, via the shared buffer)
            # mutate the stored value. bytes() also makes every later
            # zero-copy deserialize read-only, matching the shm tier.
            self.memory_store.put(object_id, [
                f if isinstance(f, bytes) else bytes(f) for f in frames])

    def _load_frames(self, object_id: ObjectID) -> Optional[List[bytes]]:
        frames = self.memory_store.get(object_id, timeout=0)
        if frames is not None:
            return frames
        if self.memory_store.contains(object_id):  # marker: in shm
            return self.shm_store.get(object_id)
        return self.shm_store.get(object_id)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        deadline = None if timeout is None else time.time() + timeout
        # Bulk fast path: snapshot everything already in the memory
        # store under ONE lock — in a burst most results have landed by
        # the time the caller collects, and a per-ref lock round-trip
        # is measurable at tens of thousands of gets/s.
        ready = {}
        if len(refs) > 4:
            ready = self.memory_store.get_many(
                [r.object_id for r in refs])
        out = []
        deser = self.serde.deserialize
        for ref in refs:
            frames = ready.get(ref.object_id)
            if frames is not None:
                value = deser(frames)
                if isinstance(value, (TaskError, ActorDiedError,
                                      WorkerCrashedError, ObjectLostError)):
                    raise value
                out.append(value)
                continue
            t = None if deadline is None else max(0.0, deadline - time.time())
            out.append(self._get_one(ref, t))
        return out[0] if single else out

    def _get_one(self, ref: ObjectRef, timeout: Optional[float]):
        frames = self._wait_local(ref, timeout)
        value = self.serde.deserialize(frames)
        if isinstance(value, TaskError):
            raise value
        if isinstance(value, (ActorDiedError, WorkerCrashedError, ObjectLostError)):
            raise value
        return value

    def _wait_local(self, ref: ObjectRef, timeout: Optional[float]):
        # Fast path: already local.
        frames = self._load_frames(ref.object_id)
        if frames is not None:
            return frames
        if ref.owner_address == self.address:
            # We own it; it is pending (task not finished). Block on store.
            frames = self.memory_store.get(ref.object_id, timeout)
            if frames is None and self.memory_store.contains(ref.object_id):
                frames = self.shm_store.get(ref.object_id)
            if frames is None:
                frames = self.shm_store.get(ref.object_id)
            if frames is None:
                # We own it but never held the bytes (they live in the
                # producing worker's shm domain) or lost them: fetch
                # from a registered copy, then fall back to lineage
                # re-execution.
                try:
                    frames = self.run_sync(
                        self._fetch_owned_from_copies(ref.object_id),
                        timeout=None if timeout is None else timeout + 1)
                    if frames is None:
                        frames = self.run_sync(
                            self._recover_and_load(ref.object_id),
                            timeout=None if timeout is None
                            else timeout + 1)
                except concurrent.futures.TimeoutError:
                    raise GetTimeoutError(
                        f"timed out recovering {ref}") from None
            if frames is None:
                raise GetTimeoutError(f"timed out waiting for {ref}")
            return frames
        # Remote owner: pull.
        try:
            meta, bufs = self.run_sync(
                self._pull_remote(ref), timeout=timeout)
        except concurrent.futures.TimeoutError:
            raise GetTimeoutError(f"timed out pulling {ref}") from None
        if meta.get("in_shm"):
            frames = self.shm_store.get(ref.object_id)
            if frames is None:
                # Our shm attach failed though the owner believes the
                # segment exists — re-pull forcing a byte transfer; the
                # owner recovers from lineage if its copy is gone too.
                try:
                    meta, bufs = self.run_sync(
                        self._pull_remote(ref, force_bytes=True),
                        timeout=timeout)
                except concurrent.futures.TimeoutError:
                    raise GetTimeoutError(
                        f"timed out re-pulling {ref}") from None
                if not meta.get("found"):
                    raise ObjectLostError(
                        f"shm segment for {ref} vanished")
                if not meta.get("stored"):
                    self.memory_store.put(ref.object_id, bufs)
                return bufs
            return frames
        if not meta.get("found"):
            raise ObjectLostError(f"object {ref} not found at owner")
        if not meta.get("stored"):
            self.memory_store.put(ref.object_id, bufs)
        return bufs

    async def _pull_remote(self, ref: ObjectRef, force_bytes: bool = False):
        conn = await self._get_conn(ref.owner_address)
        meta, bufs = await conn.call(
            "get_object",
            {"object_id": ref.object_id.hex(),
             # force_bytes: pretend to be cross-domain so the owner
             # ships frames instead of an shm attach hint.
             "shm_domain": None if force_bytes else self.shm_domain,
             "wait": True})
        if meta.get("chunked"):
            frames = await self._pull_chunked(ref, meta["frame_sizes"],
                                              meta.get("sources"))
            # _pull_chunked stored the copy locally and registered it;
            # callers must not re-store the frames.
            return {"found": True, "in_shm": False, "stored": True}, frames
        return meta, bufs

    async def _pull_chunked(self, ref: ObjectRef, frame_sizes,
                            source_hint=None):
        """Stream a big object as pipelined byte-range requests spread
        over every registered copy (reference: multi-source chunked pull,
        ``pull_manager.h:52`` + ``ownership_based_object_directory.h``).
        Stores the result locally and registers this process as a new
        copy so later pullers fan out further (broadcast becomes a
        distribution tree under concurrency, not N hits on the owner)."""
        total = sum(frame_sizes)
        chunk = self._TRANSFER_CHUNK
        oid_hex = ref.object_id.hex()
        # In-process dedup: N tasks getting the same big ref must not
        # race N transfers (and two pending segments under one name
        # would corrupt seal bookkeeping). Late waiters whose puller
        # failed fall through and pull themselves.
        key = ref.object_id.binary()
        loop = asyncio.get_running_loop()
        while True:
            inflight = self._inflight_pulls.get(key)
            if inflight is None:
                break
            await inflight.wait()
            frames = await loop.run_in_executor(
                None, self.shm_store.get, ref.object_id)
            if frames is not None:
                return frames
        done = asyncio.Event()
        self._inflight_pulls[key] = done
        try:
            return await self._pull_chunked_inner(
                ref, frame_sizes, source_hint, total, chunk, oid_hex)
        finally:
            done.set()
            self._inflight_pulls.pop(key, None)

    async def _pull_chunked_inner(self, ref: ObjectRef, frame_sizes,
                                  source_hint, total, chunk, oid_hex):
        # Domain dedup: if a peer in our shm domain is already pulling
        # this object, wait for its copy and attach instead of moving
        # the same bytes again.
        try:
            claim = await self._head.call_simple(
                "object_pull_claim",
                {"object_id": oid_hex, "shm_domain": self.shm_domain,
                 "address": self.address})
        except Exception:  # noqa: BLE001 - head unreachable: pull anyway
            claim = {"granted": True}
        if not claim.get("granted"):
            loop = asyncio.get_running_loop()
            deadline = time.time() + 120.0
            last_reclaim = time.time()
            while time.time() < deadline:
                frames = await loop.run_in_executor(
                    None, self.shm_store.get, ref.object_id)
                if frames is not None:
                    return frames
                await asyncio.sleep(0.05)
                if time.time() - last_reclaim > 2.0:
                    # The claim is released when the claimer registers
                    # its copy (or dies): re-request periodically so a
                    # freed claim promotes us without waiting out the
                    # whole deadline.
                    last_reclaim = time.time()
                    try:
                        claim = await self._head.call_simple(
                            "object_pull_claim",
                            {"object_id": oid_hex,
                             "shm_domain": self.shm_domain,
                             "address": self.address})
                        if claim.get("granted"):
                            break
                    except Exception:  # noqa: BLE001
                        pass
            else:
                # Deadline expired: take over regardless.
                try:
                    await self._head.call_simple(
                        "object_pull_claim",
                        {"object_id": oid_hex,
                         "shm_domain": self.shm_domain,
                         "address": self.address, "force": True})
                except Exception:  # noqa: BLE001
                    pass
        sources = []
        for addr in (source_hint or []):
            addr = tuple(addr) if isinstance(addr, list) else addr
            if addr != self.address and addr not in sources:
                sources.append(addr)
        if not sources:
            try:
                locs = (await self._head.call_simple(
                    "object_loc_get", {"object_id": oid_hex}))["locations"]
                for loc in locs:
                    addr = loc["address"]
                    addr = tuple(addr) if isinstance(addr, list) else addr
                    if addr != self.address and addr not in sources:
                        sources.append(addr)
            except Exception:  # noqa: BLE001 - directory is advisory
                pass
        if not sources:
            sources = [ref.owner_address]
        # Chunks land DIRECTLY in the destination shm segment (size
        # table written up front, frame count sealed last): a GiB-scale
        # staging bytearray would be a second giant fresh allocation,
        # and first-touch page faults at that size are the dominant
        # cost on large transfers.
        dview = self.shm_store.create_pending(ref.object_id, frame_sizes)
        if dview is None:
            # A segment already exists in this domain: a peer landed the
            # copy (read it) or is mid-write (count still 0 — poll until
            # it seals). After a grace period a still-count-0 segment is
            # a crashed puller's leftover: clear it and take over.
            loop = asyncio.get_running_loop()
            deadline = time.time() + 10.0
            while dview is None:
                frames = await loop.run_in_executor(
                    None, self.shm_store.get, ref.object_id)
                if frames is not None:
                    return frames
                await asyncio.sleep(0.05)
                if time.time() > deadline:
                    self.shm_store.clear_stale_segment(ref.object_id)
                    dview = self.shm_store.create_pending(
                        ref.object_id, frame_sizes)
                    if dview is None:
                        deadline = time.time() + 10.0  # recreated: rewait
        sem = asyncio.Semaphore(4)  # admission: chunks in flight

        async def fetch(i: int, off: int):
            length = min(chunk, total - off)
            payload = {"object_id": oid_hex, "offset": off,
                       "length": length}
            last_exc = None
            # Stripe sources per chunk; then every other copy; the owner
            # (which may need a lineage re-execution) is the last resort.
            first = sources[i % len(sources)]
            order = [first] + [s for s in sources if s != first]
            if ref.owner_address not in order and \
                    ref.owner_address != self.address:
                order.append(ref.owner_address)
            async with sem:
                for src in order:
                    try:
                        conn = await self._get_conn(src)
                        m, bufs = await conn.call("object_chunk", payload)
                        if m.get("found"):
                            dview[off:off + length] = bufs[0]
                            return
                    except Exception as e:  # noqa: BLE001 - try next src
                        last_exc = e
            raise ObjectLostError(
                f"chunk {off}..{off + length} of {ref} unavailable "
                f"from any copy ({last_exc})")

        try:
            await asyncio.gather(*(
                fetch(i, off)
                for i, off in enumerate(range(0, total, chunk))))
        except BaseException:
            # view-guarded: if our reservation was TTL-swept and a
            # retrying writer re-created it, leave THEIRS alone.
            self.shm_store.abort_pending(ref.object_id, view=dview)
            raise
        self.shm_store.seal(ref.object_id, view=dview)
        self.memory_store.put(ref.object_id, None)  # marker: lives in shm
        self._register_object_copy(ref.object_id, frame_sizes)
        return self.shm_store.get(ref.object_id)

    def _push_to_head(self, method: str, payload: dict):
        """Best-effort fire-and-forget push to the head from ANY thread
        (socket writes only ever happen on the IO loop)."""
        def _do():
            try:
                self._head.push(method, payload)
            except Exception:  # noqa: BLE001 - advisory traffic
                pass

        try:
            if threading.current_thread() is self._io_thread:
                _do()
            else:
                self._loop.call_soon_threadsafe(_do)
        except RuntimeError:
            pass

    def _register_object_copy(self, object_id: ObjectID, frame_sizes):
        """Tell the head we hold a copy (with the frame layout, so the
        owner can hand pullers a chunk plan for bytes it never held
        itself)."""
        self._registered_copies.add(object_id.binary())
        self._push_to_head("object_loc_add",
                           {"object_id": object_id.hex(),
                            "address": self.address,
                            "shm_domain": self.shm_domain,
                            "frame_sizes": list(frame_sizes)})

    async def _async_get_one(self, ref: ObjectRef):
        """Non-blocking get used by async actors (awaitable refs)."""
        loop = asyncio.get_running_loop()
        frames = self._load_frames(ref.object_id)
        if frames is None:
            if ref.owner_address == self.address:
                frames = await loop.run_in_executor(
                    None, lambda: self._wait_local(ref, None))
            else:
                meta, bufs = await self._pull_remote(ref)
                if meta.get("in_shm"):
                    frames = self.shm_store.get(ref.object_id)
                else:
                    frames = bufs
        value = self.serde.deserialize(frames)
        if isinstance(value, Exception):
            raise value
        return value

    # ----------------------------------------------------------- generators
    def generator_next(self, task_id: TaskID, index: int,
                       owner_address) -> ObjectRef:
        """Block until streamed item ``index`` exists (or the stream ended
        before it — StopIteration)."""
        if owner_address != self.address:
            raise RuntimeError(
                "an ObjectRefGenerator is only consumable in the process "
                "that submitted the task (its items' owner)")
        oid = ObjectID.for_task_return(task_id, index)
        key = task_id.binary()
        # Event-driven park: item arrival fires the watcher; stream
        # end/error isn't signalled through the store, so cap the wait to
        # re-check the generator state.
        ev = threading.Event()
        self.memory_store.add_watcher(oid, ev)
        try:
            while True:
                if self.memory_store.contains(oid):
                    return ObjectRef(oid, self.address)
                st = self._generators.get(key)
                if st is not None:
                    if st.get("error") is not None and \
                            st.get("count") is None:
                        self._generators.pop(key, None)
                        raise st["error"]
                    count = st.get("count")
                    if count is not None and index >= count:
                        self._generators.pop(key, None)
                        raise StopIteration
                if self._shutdown:
                    raise RuntimeError("core worker shut down")
                ev.wait(0.05)
                ev.clear()
        finally:
            self.memory_store.remove_watcher(oid, ev)

    def generator_dropped(self, task_id: TaskID, from_index: int):
        """Generator handle died: free unconsumed streamed items, and mark
        the stream dropped so still-in-flight items are freed on arrival
        instead of leaking into the memory store."""
        key = task_id.binary()
        st = self._generators.pop(key, None)
        count = (st or {}).get("count")
        if count is None:
            # Producer may still be running; generator_done cleans this up.
            self._dropped_generators.add(key)
        i = from_index
        while True:
            oid = ObjectID.for_task_return(task_id, i)
            if count is not None and i >= count:
                break
            if count is None and not self.memory_store.contains(oid):
                break
            self.free_object(oid)
            i += 1

    def wait(self, refs: List[ObjectRef], num_returns=1, timeout=None,
             fetch_local=True):
        """Event-driven wait (reference: ``core_worker.cc:1735``): parks on
        a single event wired to the memory store instead of polling; refs
        owned remotely get one long-poll pull each whose arrival fires the
        same event."""
        deadline = None if timeout is None else time.time() + timeout
        ready, not_ready = [], []
        for ref in refs:
            (ready if self._is_ready_local(ref) else not_ready).append(ref)
        if len(ready) >= num_returns or not not_ready:
            return ready, not_ready
        ev = threading.Event()
        watched = []
        try:
            for ref in not_ready:
                self.memory_store.add_watcher(ref.object_id, ev)
                watched.append(ref)
            while True:
                still = []
                for ref in not_ready:
                    if self._is_ready_local(ref):
                        ready.append(ref)
                    else:
                        # Re-issue failed pulls each pass (the inflight
                        # set dedups) so a transiently unreachable owner
                        # doesn't turn wait(timeout=None) into a hang.
                        if ref.owner_address != self.address:
                            self._ensure_pull(ref)
                        still.append(ref)
                not_ready = still
                if len(ready) >= num_returns or not not_ready:
                    return ready, not_ready
                remaining = None if deadline is None else                     deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return ready, not_ready
                # Cap the park so shm-only arrivals (segments created by
                # another process on this host) are still noticed.
                ev.wait(timeout=min(0.2, remaining)
                        if remaining is not None else 0.2)
                ev.clear()
        finally:
            for ref in watched:
                self.memory_store.remove_watcher(ref.object_id, ev)

    def _is_ready_local(self, ref: ObjectRef) -> bool:
        return (self.memory_store.contains(ref.object_id)
                or self.shm_store.contains(ref.object_id))

    def _ensure_pull(self, ref: ObjectRef):
        """Start (once) a background pull of a remote-owned ref; the result
        lands in the memory store, firing any wait() watchers."""
        key = ref.object_id.binary()
        if key in self._pulls_inflight:
            return
        self._pulls_inflight.add(key)

        async def _pull():
            try:
                meta, bufs = await self._pull_remote(ref)
                if meta.get("found") and not meta.get("stored"):
                    if meta.get("in_shm"):
                        frames = self.shm_store.get(ref.object_id)
                        if frames is not None:
                            self.memory_store.put(ref.object_id, None)
                    else:
                        self.memory_store.put(ref.object_id, bufs)
            except Exception:  # noqa: BLE001 - wait() deadline handles it
                pass
            finally:
                self._pulls_inflight.discard(key)

        asyncio.run_coroutine_threadsafe(_pull(), self._loop)

    async def _probe_remote(self, ref: ObjectRef):
        conn = await self._get_conn(ref.owner_address)
        return await conn.call("get_object",
                               {"object_id": ref.object_id.hex(),
                                "shm_domain": self.shm_domain,
                                "wait": False})

    # ------------------------------------------------------------- functions
    def export_function(self, fn) -> str:
        pickled = cloudpickle.dumps(fn)
        key = "fn:" + hashlib.sha1(pickled).hexdigest()
        if key not in self._exported_functions:
            self.run_sync(self._kv_put_buf("functions", key, pickled), 30)
            self._exported_functions.add(key)
        return key

    async def _kv_put_buf(self, ns, key, data: bytes):
        return await self._head.call(
            "kv_put", {"ns": ns, "key": key, "overwrite": False}, [data])

    def fetch_function(self, key: str):
        if key in self._function_cache:
            return self._function_cache[key]
        meta, bufs = self.run_sync(
            self._head.call("kv_get", {"ns": "functions", "key": key}), 30)
        if not meta.get("found"):
            raise RuntimeError(f"function {key} not found in KV store")
        fn = cloudpickle.loads(bufs[0])
        self._function_cache[key] = fn
        return fn

    # ------------------------------------------------------------- submission
    def _serialize_args(self, args, kwargs) -> Tuple[list, list, list]:
        """Inline small args; pass refs through; promote big args to shm.

        Every "ref" arg charges one borrow at its owner — the borrow
        belongs to the *task spec* (it must survive retries), so the
        caller releases it when the submission finally completes (normal
        tasks) or never (actor creation specs, which the head keeps for
        restarts). Returns (ser_args, kw_keys, borrowed) with borrowed =
        [(ObjectID, owner_address), ...].
        """
        out, borrowed = [], []
        kw_keys = list(kwargs.keys())
        for v in list(args) + [kwargs[k] for k in kw_keys]:
            if isinstance(v, ObjectRef):
                self.refs.acquire_borrow(v.object_id, v.owner_address)
                borrowed.append((v.object_id, v.owner_address))
                out.append(("ref", (v.object_id.binary(), v.owner_address)))
            else:
                # Refs nested inside pickled args borrow for the whole
                # submission (incl. retries), same as top-level ref args.
                with self.capture_nested_refs() as nested:
                    frames = self.serde.serialize(v)
                borrowed.extend(nested)
                total = sum(len(f) for f in frames)
                if total > self.config.max_inline_object_size:
                    oid = ObjectID.from_random()
                    self.shm_store.create(oid, frames)
                    self.memory_store.put(oid, None)
                    self.refs.acquire_borrow(oid, self.address)
                    borrowed.append((oid, self.address))
                    out.append(("ref", (oid.binary(), self.address)))
                else:
                    # materialize out-of-band buffers: inline frames ride
                    # the pickled payload, which can't carry memoryviews
                    out.append(("inline", [bytes(f) for f in frames]))
        return out, kw_keys, borrowed

    def submit_task(self, fn_key: str, args, kwargs, *, num_returns=1,
                    resources=None, max_retries=None, strategy=None,
                    name="", runtime_env=None):
        task_id = TaskID.from_random()
        streaming = num_returns == "streaming"
        wire_env = self._prepare_runtime_env(runtime_env)
        ser_args, kw_keys, borrowed = self._serialize_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id, task_type=TaskType.NORMAL,
            function_ref=("kv", fn_key), args=ser_args, kwargs_keys=kw_keys,
            num_returns=0 if streaming else num_returns,
            resources=resources or {"CPU": 1.0},
            max_retries=0 if streaming else (
                self.config.task_max_retries
                if max_retries is None else max_retries),
            scheduling_strategy=strategy or SchedulingStrategy(),
            name=name, owner_address=self.address,
            is_generator=streaming,
            runtime_env=wire_env,
            trace_ctx=tracing.on_submit(name or fn_key),
        )
        # Refs MUST exist before the submission is scheduled: a fast task
        # completing on the IO thread hits on_result_stored, and with no
        # live ref counted the result would be GC'd before the caller ever
        # holds it.
        if streaming:
            out = ObjectRefGenerator(task_id, self.address)
        else:
            out = [ObjectRef(oid, self.address)
                   for oid in spec.return_object_ids()]
        # Tasks whose args carry ObjectRefs must NOT share a batch: a
        # chunk's results ingest only when the whole chunk replies, so a
        # task waiting on a sibling's pending result would deadlock the
        # chunk until the pull times out. Non-DEFAULT strategies (SPREAD,
        # affinity, PG bundles) place per task — a shared chunk would
        # collapse them onto one lease.
        has_ref_args = any(kind == "ref" for kind, _ in ser_args) \
            or bool(borrowed)  # borrowed ⊇ refs nested in pickled args
        if not streaming:
            self._record_lineage(spec)
        if streaming or has_ref_args or \
                spec.scheduling_strategy.kind != "DEFAULT":
            self._enqueue_submission(self._submit_normal(spec, borrowed))
        else:
            from .._private.runtime_env import env_hash

            shape = _LeaseCache.shape_key(spec.resources,
                                          spec.scheduling_strategy,
                                          env_hash(spec.runtime_env))
            self._enqueue_batchable(shape, spec, borrowed)
        return out

    async def _submit_normal(self, spec: TaskSpec, borrowed=()):
        try:
            await self._submit_normal_inner(spec)
        except Exception as e:  # noqa: BLE001 - surface via result objects
            self._store_error(spec, e)
        finally:
            self._release_borrows_later(borrowed)

    def _release_borrows_later(self, borrowed):
        """Pay back a submission's arg borrows after a grace period.

        The executing worker's own deserialize-time ref_inc rides a
        different connection than the task reply; releasing immediately
        could zero the count before that inc lands and free an object the
        worker still holds. The grace window covers the in-flight inc
        (same approach as actor-handle GC)."""
        if not borrowed:
            return

        async def _later():
            await asyncio.sleep(
                getattr(self.config, "borrow_release_grace_s", 2.0))
            for oid, owner in borrowed:
                self.refs.release_borrow(oid, owner)

        try:
            rpc.spawn(_later(), self._loop)
        except RuntimeError:  # loop gone (shutdown): leak, don't crash
            pass

    # ----------------------------------------------------------- lineage
    # Owner-side object recovery (reference capability:
    # ``src/ray/core_worker/object_recovery_manager.h:41`` and the
    # lineage resubmission path ``task_manager.h:208``): the owner keeps
    # the producing TaskSpec of every normal-task result while the
    # result — or any downstream lineage that consumes it — may still
    # need it, and re-executes the task when the stored value is lost
    # (shm segment gone, spill file lost, executing node dead). ``put``
    # objects and actor-task results are not reconstructable, matching
    # the reference's defaults.

    def _record_lineage(self, spec: TaskSpec):
        # num_returns == 0 would pin args forever (the release cascade
        # fires from the last RETURN being dropped — with no returns it
        # never fires).
        if not self._lineage_enabled or \
                spec.task_type != TaskType.NORMAL or spec.num_returns < 1:
            return
        with self._lineage_lock:
            for oid in spec.return_object_ids():
                self._lineage[oid.binary()] = spec
            self._lineage_live[spec.task_id.binary()] = spec.num_returns
            # Pin arg lineage: recovering this task re-pulls its ref
            # args, which may themselves need re-execution after being
            # freed.
            for kind, payload in spec.args:
                if kind == "ref":
                    key = payload[0]
                    self._lineage_pins[key] = \
                        self._lineage_pins.get(key, 0) + 1

    def _lineage_mark_done(self, key: bytes):
        if self._lineage_enabled and key in self._lineage:
            self._lineage_done.add(key)

    def on_object_freed(self, object_id: ObjectID):
        """Ref-count GC freed the value. Its lineage entry survives while
        some downstream task's lineage still pins it (a recovery may need
        to rebuild this object as an argument)."""
        key = object_id.binary()
        if key not in self._lineage:
            return
        with self._lineage_lock:
            self._lineage_freed.add(key)
            self._maybe_drop_lineage_locked(key)

    def _maybe_drop_lineage_locked(self, key: bytes):
        """Caller holds ``_lineage_lock`` — record/drop race on the pin
        counts would otherwise lose updates and drop lineage a live
        downstream task still depends on."""
        if key not in self._lineage_freed or \
                self._lineage_pins.get(key, 0) > 0:
            return
        spec = self._lineage.pop(key, None)
        self._lineage_freed.discard(key)
        self._lineage_done.discard(key)
        if spec is None:
            return
        tkey = spec.task_id.binary()
        live = self._lineage_live.get(tkey, 0) - 1
        if live > 0:
            self._lineage_live[tkey] = live
            return
        self._lineage_live.pop(tkey, None)
        # Last return of this spec gone: release its arg pins, cascading
        # drops for upstream lineage that was only held for us.
        for kind, payload in spec.args:
            if kind == "ref":
                akey = payload[0]
                n = self._lineage_pins.get(akey, 0) - 1
                if n > 0:
                    self._lineage_pins[akey] = n
                else:
                    self._lineage_pins.pop(akey, None)
                    self._maybe_drop_lineage_locked(akey)

    async def _recover_and_load(self, oid: ObjectID, timeout: float = 300.0):
        """Re-execute the producing task of a lost-but-owned object and
        return its frames, or None if unrecoverable. Concurrent losses of
        the same object share one re-execution."""
        key = oid.binary()
        spec = self._lineage.get(key)
        if spec is None or key not in self._lineage_done:
            return None
        fut = self._recoveries.get(key)
        if fut is None:
            if spec.recovery_count >= max(1, spec.max_retries):
                return None
            spec.recovery_count += 1
            fut = self._loop.create_future()
            for roid in spec.return_object_ids():
                self._recoveries[roid.binary()] = fut
            rpc.spawn(self._run_recovery(spec, fut), self._loop)
        try:
            await asyncio.wait_for(asyncio.shield(fut), timeout)
        except asyncio.TimeoutError:
            return None
        frames = self._load_frames(oid)
        if frames is None:
            # The re-executed task ran on another node: its result is a
            # marker here, bytes in the executing worker's domain —
            # fetch them through the copy directory.
            frames = await self._fetch_owned_from_copies(oid)
        return frames

    async def _run_recovery(self, spec: TaskSpec, fut):
        try:
            from .._private.metrics import core_metrics

            core_metrics()["objects_recovered"].inc(spec.num_returns)
            # _submit_normal pushes, awaits the reply, and re-ingests the
            # results under the ORIGINAL object ids — watchers parked on
            # the lost object wake with the rebuilt value.
            await self._submit_normal(spec, ())
        except Exception:  # noqa: BLE001 - loss surfaces at the getter
            pass
        finally:
            for roid in spec.return_object_ids():
                self._recoveries.pop(roid.binary(), None)
            if not fut.done():
                fut.set_result(True)

    def _store_error(self, spec: TaskSpec, exc: Exception):
        if isinstance(exc, TaskError):
            err = exc
        else:
            err = TaskError(type(exc).__name__, str(exc),
                            traceback.format_exc())
        if spec.is_generator:
            st = self._generators.setdefault(spec.task_id.binary(), {})
            st["error"] = err
            return
        frames = self.serde.serialize(err)
        for oid in spec.return_object_ids():
            self.memory_store.put(oid, frames)
            self._lineage_mark_done(oid.binary())

    def _prepare_runtime_env(self, runtime_env):
        """Driver-side runtime-env packaging (upload via KV, dedup).

        Cached by env CONTENT hash — identity would alias recycled dict
        addresses to stale environments."""
        if not runtime_env:
            return None
        from .._private import runtime_env as renv

        key = renv.env_hash(renv.validate(dict(runtime_env)))
        cached = self._prepared_envs.get(key)
        if cached is not None:
            return cached
        wire = renv.prepare(runtime_env,
                            lambda k, blob: self.kv_put(k, blob))
        self._prepared_envs[key] = wire
        return wire

    def _ensure_runtime_env(self, wire_env):
        """Worker-side: materialize the env once (this worker is dedicated
        to the env via the lease shape key)."""
        if not wire_env:
            return
        from .._private import runtime_env as renv

        h = renv.env_hash(wire_env)
        if h in self._applied_envs:
            return
        scratch = os.path.join(self.session_dir, "runtime_envs")
        os.makedirs(scratch, exist_ok=True)
        renv.apply(wire_env, lambda k: self.kv_get(k), scratch)
        self._applied_envs.add(h)

    async def _submit_normal_inner(self, spec: TaskSpec):
        from .._private.runtime_env import env_hash

        shape = _LeaseCache.shape_key(spec.resources,
                                      spec.scheduling_strategy,
                                      env_hash(spec.runtime_env))
        while True:
            lease = await self._acquire_lease(shape, spec)
            lease["inflight"] += 1
            try:
                meta, bufs = await lease["conn"].call(
                    "push_task", self._spec_meta(spec))
            except rpc.ConnectionLost:
                lease["dead"] = True
                await self._drop_lease(shape, lease, kill=True)
                if spec.retry_count < spec.max_retries:
                    spec.retry_count += 1
                    continue
                raise WorkerCrashedError(
                    f"worker died running task {spec.name or spec.task_id}")
            finally:
                lease["inflight"] -= 1
                lease["last_used"] = time.time()
            self._ingest_results(spec, meta, bufs)
            return

    def _spec_meta(self, spec: TaskSpec) -> dict:
        # Wire form. Default-valued fields are omitted (receivers read
        # them with .get) and actor fields ride only on actor tasks —
        # burst submission pickles thousands of these, so every key
        # costs real time.
        meta = {
            "task_id": spec.task_id.binary(),
            "job_id": spec.job_id.binary(),
            "type": spec.task_type.value,
            "function_ref": spec.function_ref,
            "args": spec.args,
            "kwargs_keys": spec.kwargs_keys,
            "num_returns": spec.num_returns,
            "owner_address": spec.owner_address,
        }
        if spec.actor_id is not None:
            meta["actor_id"] = spec.actor_id.binary()
            meta["method_name"] = spec.method_name
            meta["seq_no"] = spec.seq_no
            if spec.concurrency_group:
                meta["concurrency_group"] = spec.concurrency_group
        if spec.name:
            meta["name"] = spec.name
        if spec.max_concurrency != 1:
            meta["max_concurrency"] = spec.max_concurrency
        if spec.is_generator:
            meta["is_generator"] = True
        if spec.runtime_env is not None:
            meta["runtime_env"] = spec.runtime_env
        if spec.trace_ctx is not None:
            meta["trace_ctx"] = spec.trace_ctx
        return meta

    def _ingest_results(self, spec: TaskSpec, meta, bufs):
        """Store task results announced in a push_task reply."""
        offset = 0
        for i, oid in enumerate(spec.return_object_ids()):
            r = meta["returns"][i]
            contained = [(ObjectID(ob), owner)
                         for ob, owner in r.get("contained", ())]
            self.refs.add_containment(oid, contained)
            if r["where"] == "inline":
                n = r["nframes"]
                self.memory_store.put(oid, bufs[offset:offset + n])
                offset += n
            else:  # shm
                self.memory_store.put(oid, None)
            self._lineage_mark_done(oid.binary())
            # If every ref died while the task ran, drop the result now.
            self.refs.on_result_stored(oid)

    async def _acquire_lease(self, shape, spec: TaskSpec) -> dict:
        """Pick a leased worker, growing the lease set without stampeding.

        At most 2 lease requests per resource shape are ever in flight; when
        the cluster is saturated, tasks pipeline onto existing leases instead
        of queueing 30s lease requests at the head (the reference solves this
        the same way: one pending lease request per scheduling class,
        ``direct_task_transport.cc:353``).
        """
        leases = self._leases.by_shape[shape]
        cap = self._leases.max_inflight_per_worker
        while True:
            live = [l for l in leases if not l.get("dead")]
            best = min(live, key=lambda l: l["inflight"], default=None)
            want_more = (best is None or best["inflight"] >= cap) and \
                len(live) < self._leases.max_leases_per_shape
            if want_more and self._lease_requests_inflight[shape] < 2:
                if best is None:
                    # No worker yet: this task must wait for the grant.
                    try:
                        lease = await self._request_lease(shape, spec, 30.0)
                    except rpc.RpcError:
                        live = [l for l in leases if not l.get("dead")]
                        best = min(live, key=lambda l: l["inflight"],
                                   default=None)
                        if best is not None:
                            return best
                        raise
                    if lease is not None:
                        return lease
                    continue
                # Saturated but serviceable: grow the pool in the
                # background and pipeline this task onto the least-loaded
                # lease NOW (a blocking grant here would serialize burst
                # submission behind ~0.5s worker spawns). Count the request
                # HERE — create_task runs later, and the gate above must
                # see it immediately or a 500-task burst floods the head.
                self._lease_requests_inflight[shape] += 1
                rpc.spawn(self._request_lease_quiet(shape, spec), self._loop)
                return best
            if best is not None:
                return best
            await asyncio.sleep(0.001)  # first lease request is in flight

    async def _request_lease(self, shape, spec: TaskSpec, timeout: float,
                             pre_counted: bool = False):
        strategy = spec.scheduling_strategy
        payload = {
            "resources": spec.resources,
            "timeout": timeout,
            "strategy": None if strategy.kind == "DEFAULT" else {
                "kind": strategy.kind,
                "pg_id": strategy.placement_group_id.hex()
                if strategy.placement_group_id else None,
                "bundle_index": strategy.bundle_index,
                "node_id": strategy.node_id,
                "soft": strategy.soft,
                "hard_labels": strategy.hard_labels,
                "soft_labels": strategy.soft_labels,
            }}
        if not pre_counted:
            self._lease_requests_inflight[shape] += 1
        try:
            meta = await self._head.call_simple("lease_worker", payload)
        finally:
            self._lease_requests_inflight[shape] -= 1
        conn = await self._get_conn(meta["address"])
        # Stamp last_used at birth: a background-grown lease that never
        # receives a task must still age out, or its charge leaks forever.
        lease = {"worker_id": meta["worker_id"],
                 "address": meta["address"],
                 "conn": conn, "inflight": 0, "last_used": time.time()}
        self._leases.by_shape[shape].append(lease)
        return lease

    async def _request_lease_quiet(self, shape, spec: TaskSpec):
        try:
            await self._request_lease(shape, spec, 2.0, pre_counted=True)
        except Exception:  # noqa: BLE001 - growth is best-effort
            pass

    async def _drop_lease(self, shape, lease, kill=False):
        try:
            self._leases.by_shape[shape].remove(lease)
        except ValueError:
            return
        # Runtime-env workers mutated their process state (env vars, cwd,
        # sys.path) — they must never rejoin the shared idle pool.
        if "env" in shape:
            kill = True
        try:
            await self._head.call_simple(
                "return_lease",
                {"worker_id": lease["worker_id"], "kill": kill})
        except Exception:
            pass

    def release_all_leases(self):
        """Return every cached lease (called before shutdown / tests)."""
        async def _go():
            for shape, leases in list(self._leases.by_shape.items()):
                for lease in list(leases):
                    await self._drop_lease(shape, lease)
        self.run_sync(_go(), timeout=10)

    # ------------------------------------------------------------- actors
    def create_actor(self, cls, args, kwargs, *, resources=None, name="",
                     max_restarts=0, max_concurrency=1, strategy=None,
                     lifetime=None, runtime_env=None,
                     concurrency_groups=None) -> "ActorID":
        actor_id = ActorID.from_random()
        wire_env = self._prepare_runtime_env(runtime_env)
        cls_key = self.export_function(cls)
        # Creation-spec borrows are deliberately never released: the head
        # keeps the spec for actor restarts, so its args must stay alive
        # for the actor's whole life.
        ser_args, kw_keys, _creation_borrows = self._serialize_args(
            args, kwargs)
        spec_meta = {
            "actor_id": actor_id.binary(),
            "cls_ref": ("kv", cls_key),
            "args": ser_args,
            "kwargs_keys": kw_keys,
            "max_concurrency": max_concurrency,
            "owner_address": self.address,
            "name": name,
            "runtime_env": wire_env,
        }
        if concurrency_groups:
            spec_meta["concurrency_groups"] = {
                str(k): int(v) for k, v in concurrency_groups.items()}
        strategy = strategy or SchedulingStrategy()
        payload = {
            "actor_id": actor_id.hex(),
            "name": name,
            "lifetime": lifetime,
            "resources": resources or {"CPU": 1.0},
            "max_restarts": max_restarts,
            "spec_meta": spec_meta,
            "strategy": None if strategy.kind == "DEFAULT" else {
                "kind": strategy.kind,
                "pg_id": strategy.placement_group_id.hex()
                if strategy.placement_group_id else None,
                "bundle_index": strategy.bundle_index,
                "node_id": strategy.node_id,
                "soft": strategy.soft,
                "hard_labels": strategy.hard_labels,
                "soft_labels": strategy.soft_labels,
            },
        }
        st = {"state": "PENDING", "address": None, "error": None,
              "event": threading.Event(),
              # group actors bypass wire batching (see submit_actor_task)
              "groups": bool(concurrency_groups)}
        self._actor_state[actor_id.binary()] = st
        registered = threading.Event()
        reg_err: list = []

        async def _create():
            try:
                await self._head.call_simple(
                    "subscribe", {"topic": f"actor:{actor_id.hex()}"})
                self._subscribed_topics.add(f"actor:{actor_id.hex()}")
                # Synchronous registration (reference: RegisterActor is a
                # blocking GCS call, gcs_actor_manager.cc:311) so named
                # actors and list_actors see the actor as soon as
                # .remote() returns; placement stays async.
                await self._head.call_simple("register_actor", payload)
            except Exception as e:  # noqa: BLE001
                reg_err.append(e)
                st["state"] = "DEAD"
                st["error"] = str(e)
                st["event"].set()
                registered.set()
                return
            registered.set()
            try:
                meta = await self._head.call_simple("create_actor", payload)
                st["address"] = meta["address"]
                st["state"] = "ALIVE"
            except Exception as e:  # noqa: BLE001
                st["state"] = "DEAD"
                st["error"] = str(e)
            finally:
                st["event"].set()

        create_fut = asyncio.run_coroutine_threadsafe(_create(), self._loop)
        timeout = self.config.worker_lease_timeout_s
        if not registered.wait(timeout=timeout):
            # Cancel the in-flight coroutine and best-effort kill so a
            # merely-slow head cannot later create an orphan actor that
            # pins its name and resources with no live handle.
            create_fut.cancel()
            st["state"] = "DEAD"
            st["error"] = "registration timed out"
            st["event"].set()
            try:
                self.kill_actor(actor_id)
            except Exception:
                pass
            raise ActorDiedError(
                f"actor registration timed out (head unresponsive for "
                f"{timeout}s)")
        if reg_err:
            raise ActorDiedError(f"actor registration failed: {reg_err[0]}")
        return actor_id

    def wait_actor_ready(self, actor_id: ActorID, timeout=None):
        st = self._actor_state[actor_id.binary()]
        if not st["event"].wait(timeout):
            raise GetTimeoutError("actor creation timed out")
        if st["state"] == "DEAD":
            raise ActorDiedError(st["error"] or "creation failed")

    def actor_address(self, actor_id: ActorID, timeout=30.0):
        st = self._actor_state.get(actor_id.binary())
        if st is None:
            # Handle deserialized in another process: resolve via head.
            meta = self.run_sync(self._head.call_simple(
                "get_actor", {"actor_id": actor_id.hex()}), timeout)
            if meta["state"] == "DEAD":
                raise ActorDiedError(meta.get("death_cause", ""))
            # The head assigns a worker before the constructor finishes;
            # only an ALIVE actor's address is safe to push to — a PENDING
            # address races the instance registration on the worker.
            addr = meta["address"] if meta["state"] == "ALIVE" else None
            st = {"state": meta["state"], "address": addr,
                  "error": None, "event": threading.Event(),
                  "groups": bool(meta.get("has_concurrency_groups"))}
            st["event"].set()
            self._actor_state[actor_id.binary()] = st

            async def _sub():
                await self._head.call_simple(
                    "subscribe", {"topic": f"actor:{actor_id.hex()}"})
                self._subscribed_topics.add(f"actor:{actor_id.hex()}")
            asyncio.run_coroutine_threadsafe(_sub(), self._loop)
        st["event"].wait(timeout)
        if st["state"] == "DEAD":
            raise ActorDiedError(st["error"] or "")
        if st["address"] is None:
            # restarting: poll head
            deadline = time.time() + timeout
            while time.time() < deadline:
                meta = self.run_sync(self._head.call_simple(
                    "get_actor", {"actor_id": actor_id.hex()}), 10)
                if meta["state"] == "ALIVE":
                    st["address"] = meta["address"]
                    return st["address"]
                if meta["state"] == "DEAD":
                    st["state"] = "DEAD"
                    raise ActorDiedError(meta.get("death_cause", ""))
                time.sleep(0.05)
            raise ActorDiedError("actor not reachable")
        return st["address"]

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args,
                          kwargs, num_returns=1, concurrency_group=None):
        task_id = TaskID.from_random()
        streaming = num_returns == "streaming"
        ser_args, kw_keys, borrowed = self._serialize_args(args, kwargs)
        trace_ctx = tracing.on_submit(method_name)
        key = actor_id.binary()
        # Wire batching: consecutive calls to the same actor share one
        # push_task_batch RPC (receiver-side seq streams keep ordering,
        # so concurrency semantics are unchanged). A 1:1 async-call
        # burst goes from one round-trip per call to one per chunk.
        #
        # The seq assignment MUST be atomic with the queue decision:
        # concurrent submitting threads (a worker's exec pool fanning
        # out actor calls) racing the unlocked read-increment would mint
        # duplicate seq_nos, and the receiver's ordered stream then
        # waits forever for the gap — a hang, not a perf bug.
        # Group actors take the per-call direct path: a chunked RPC's
        # reply waits for its SLOWEST call, which would let a long call
        # in one group delay another group's result delivery — the
        # isolation groups exist to provide. (A foreign handle's very
        # first burst may still batch before the head metadata arrives;
        # routing stays correct, only that burst shares a reply.)
        group_actor = concurrency_group is not None or bool(
            (self._actor_state.get(key) or {}).get("groups"))
        with self._actor_struct_lock:
            seq = self._actor_seq[key]
            self._actor_seq[key] = seq + 1
            spec = TaskSpec(
                task_id=task_id, job_id=self.job_id,
                task_type=TaskType.ACTOR_TASK,
                function_ref=("method", method_name), args=ser_args,
                kwargs_keys=kw_keys,
                num_returns=0 if streaming else num_returns,
                actor_id=actor_id, method_name=method_name, seq_no=seq,
                concurrency_group=concurrency_group,
                owner_address=self.address, is_generator=streaming,
                trace_ctx=trace_ctx,
            )
            if streaming:
                direct = None  # enqueue outside the lock
            else:
                q = self._actor_batch.setdefault(key, deque())
                if group_actor or (
                        not q and not self._actor_pump_active.get(key) and
                        not self._actor_direct_inflight[key]):
                    # Idle actor (the sync-call pattern): skip the
                    # queue+pump layer. The in-flight counter makes a
                    # burst's SECOND call take the batching path —
                    # without it every call of a burst would see an idle
                    # actor and degrade to per-call RPCs. Wire order vs
                    # the direct call is fixed up by the receiver's seq
                    # stream.
                    self._actor_direct_inflight[key] += 1
                    direct = True
                else:
                    q.append((spec, borrowed, actor_id))
                    self._actor_wake_queue.append(actor_id)
                    direct = False
        # Refs before scheduling — same GC race as submit_task.
        if streaming:
            out = ObjectRefGenerator(task_id, self.address)
            # Streaming replies ride a dedicated per-call exchange.
            self._enqueue_submission(self._submit_actor_task(spec, borrowed))
            return out
        out = [ObjectRef(oid, self.address)
               for oid in spec.return_object_ids()]
        if direct:
            self._enqueue_submission(
                self._submit_actor_direct(spec, borrowed))
        else:
            self._wake_drain()
        return out

    async def _submit_actor_direct(self, spec: TaskSpec, borrowed=()):
        key = spec.actor_id.binary()
        try:
            await self._submit_actor_task(spec, borrowed)
        finally:
            with self._actor_struct_lock:
                self._actor_direct_inflight[key] -= 1
                pending = bool(self._actor_batch.get(key))
                if pending:
                    self._actor_wake_queue.append(spec.actor_id)
                else:
                    # Actors used only via the direct sync path never
                    # run a pump, so prune their state here too.
                    self._prune_actor_state_locked(key)
            if pending:
                # Anything queued behind this direct call needs a pump.
                self._wake_drain()

    def _prune_actor_state_locked(self, key: bytes):
        """Drop per-actor batching state once fully idle (empty queue,
        no pump, no direct call in flight). Caller holds the struct
        lock; a concurrent submitter re-creates entries via setdefault."""
        if self._actor_batch.get(key):
            return
        if self._actor_pump_active.get(key):
            return
        if self._actor_direct_inflight.get(key):
            return
        self._actor_batch.pop(key, None)
        self._actor_pump_active.pop(key, None)
        self._actor_send_sems.pop(key, None)
        self._actor_direct_inflight.pop(key, None)

    _ACTOR_BATCH_CHUNK = 128

    # Chunks in flight per actor: >1 so round-trips overlap (an async
    # actor's concurrency would otherwise be capped by send serialism);
    # bounded so a million-call burst doesn't explode into tasks.
    _ACTOR_CHUNKS_IN_FLIGHT = 4

    async def _pump_actor_batches(self, actor_id: ActorID):
        """Single drainer per actor (loop-side, so the active flag is
        race-free): pops pending specs in FIFO chunks and PIPELINES the
        chunk RPCs (semaphore-bounded) — the receiver's seq streams give
        ordered actors FIFO regardless of wire interleaving. Extra pump
        wakes for an already-active actor return immediately."""
        key = actor_id.binary()
        if self._actor_pump_active.get(key):
            return
        self._actor_pump_active[key] = True
        sem = self._actor_send_sems.setdefault(
            key, asyncio.Semaphore(self._ACTOR_CHUNKS_IN_FLIGHT))
        loop = asyncio.get_running_loop()
        try:
            q = self._actor_batch.get(key)
            while q:
                chunk = [q.popleft()[:2]
                         for _ in range(min(len(q),
                                            self._ACTOR_BATCH_CHUNK))]
                await sem.acquire()

                async def ship(chunk=chunk):
                    try:
                        if len(chunk) == 1:
                            # Lone call: the single-task RPC skips batch
                            # packaging overhead.
                            await self._submit_actor_task(*chunk[0])
                        else:
                            await self._send_actor_chunk(actor_id, chunk)
                    finally:
                        sem.release()

                rpc.spawn(ship(), loop)
        finally:
            with self._actor_struct_lock:
                self._actor_pump_active.pop(key, None)
                # Close the strand race: an append that saw pump-active
                # just before this flag flip would otherwise sit unwoken.
                stranded = bool(self._actor_batch.get(key))
                if stranded:
                    self._actor_wake_queue.append(actor_id)
                else:
                    # Prune: short-lived actors must not accumulate
                    # empty per-actor state forever. Safe under the
                    # struct lock — a concurrent caller re-creates the
                    # entries via setdefault.
                    self._prune_actor_state_locked(key)
            if stranded:
                self._wake_drain()

    async def _actor_request(self, actor_id: ActorID, method: str,
                             payload: dict):
        """Resolve the actor's worker (cached-ALIVE fast path) and issue
        one RPC. Writes must hit the socket in seq order, so resolve +
        write happen under the per-actor lock; the reply is awaited
        outside it. Shared by the single-call and chunked send paths."""
        key = actor_id.binary()
        lock = self._actor_send_locks.setdefault(key, asyncio.Lock())
        async with lock:
            st = self._actor_state.get(key)
            if st is not None and st["state"] == "ALIVE" and \
                    st["address"] is not None:
                addr = st["address"]  # hot path: no executor hop
            else:
                addr = await asyncio.get_running_loop().run_in_executor(
                    None, lambda: self.actor_address(actor_id))
            try:
                conn = await self._get_conn(addr)
                fut = conn.send_request(method, payload)
            except (OSError, rpc.ConnectionLost) as e:
                # Dead cached route (worker gone): invalidate so the
                # NEXT call re-resolves through the head, then fail this
                # one — a transparent in-place resend here could write
                # behind newer seq numbers on the replacement worker and
                # break the actor's FIFO ordering.
                if st is not None and st.get("address") == addr:
                    st["address"] = None
                raise
        try:
            return await fut
        except rpc.RpcError as e:
            if ACTOR_NOT_ON_WORKER in str(e):
                # Stale route (actor restarted elsewhere / not yet
                # registered beyond the server-side grace): invalidate
                # the cache; retries belong to the caller's layer (task
                # retries, serve router) for the same FIFO reason.
                if st is not None and st.get("address") == addr:
                    st["address"] = None
            raise

    def _store_actor_failure(self, actor_id: ActorID, specs, e):
        """Map a transport/execution failure onto every spec's result
        (ConnectionLost → ActorDiedError with the recorded cause)."""
        if isinstance(e, rpc.ConnectionLost):
            st = self._actor_state.get(actor_id.binary())
            e = ActorDiedError(
                (st or {}).get("error") or "worker connection lost")
        for spec in specs:
            self._store_error(spec, e)

    async def _send_actor_chunk(self, actor_id: ActorID, chunk):
        # Packed fast path: the common burst shape (positional args, one
        # return, no borrowed refs, not streaming) ships per-call state
        # as bare tuples instead of 16-key meta dicts — building and
        # pickling those dicts is the dominant per-call submit cost at
        # tens of thousands of calls/s (reference capability:
        # ``direct_actor_task_submitter.cc`` pipelining, taken further).
        if all(not borrowed and not s.kwargs_keys and s.num_returns == 1
               and not s.is_generator and not s.concurrency_group
               for s, borrowed in chunk):
            return await self._send_actor_chunk_packed(actor_id, chunk)
        try:
            reply, bufs = await self._actor_request(
                actor_id, "push_task_batch",
                {"specs": [self._spec_meta(s) for s, _ in chunk]})
            results = reply["results"]
            offset = 0
            for (spec, _), res in zip(chunk, results):
                n = res["nbufs"]
                self._ingest_results(spec, res, bufs[offset:offset + n])
                offset += n
            # A short reply (version skew / receiver bug) must fail the
            # unmatched specs, never leave their refs hanging forever.
            for spec, _ in chunk[len(results):]:
                self._store_error(spec, RuntimeError(
                    f"actor batch reply had {len(results)} results for "
                    f"{len(chunk)} tasks; task dropped by receiver"))
        except Exception as e:  # noqa: BLE001 - mapped onto every spec
            self._store_actor_failure(actor_id, [s for s, _ in chunk], e)
        finally:
            for _, borrowed in chunk:
                self._release_borrows_later(borrowed)

    async def _send_actor_chunk_packed(self, actor_id: ActorID, chunk):
        specs = [s for s, _ in chunk]
        try:
            m0 = specs[0].method_name
            payload = {
                "actor_id": actor_id.binary(),
                "owner_address": self.address,
                # One method string when the burst is homogeneous (the
                # overwhelmingly common case), else one per call.
                "methods": m0 if all(
                    s.method_name == m0 for s in specs)
                else [s.method_name for s in specs],
                "calls": [(s.task_id.binary(), s.seq_no, s.args)
                          for s in specs],
            }
            reply, bufs = await self._actor_request(
                actor_id, "push_task_packed", payload)
            results = reply["results"]
            offset = 0
            store_batch = []
            for spec, res in zip(specs, results):
                if type(res) is int:
                    # Simple inline result: res == frame count.
                    oid = spec.return_object_ids()[0]
                    store_batch.append((oid, bufs[offset:offset + res]))
                    offset += res
                else:
                    n = res["nbufs"]
                    self._ingest_results(spec, res,
                                         bufs[offset:offset + n])
                    offset += n
            if store_batch:
                self.memory_store.put_many(store_batch)
                self.refs.on_results_stored(
                    [oid for oid, _ in store_batch])
            for spec in specs[len(results):]:
                self._store_error(spec, RuntimeError(
                    f"packed reply had {len(results)} results for "
                    f"{len(specs)} tasks; task dropped by receiver"))
        except Exception as e:  # noqa: BLE001 - mapped onto every spec
            self._store_actor_failure(actor_id, specs, e)

    async def _submit_actor_task(self, spec: TaskSpec, borrowed=()):
        try:
            reply, bufs = await self._actor_request(
                spec.actor_id, "push_task", self._spec_meta(spec))
            self._ingest_results(spec, reply, bufs)
        except Exception as e:  # noqa: BLE001 - mapped onto the result
            self._store_actor_failure(spec.actor_id, [spec], e)
        finally:
            self._release_borrows_later(borrowed)

    # -------------------------------------------------- actor handle GC
    def on_actor_handle_created(self, actor_id: ActorID):
        if not self._actor_gc_enabled:
            return
        self._handle_pending.append((actor_id.binary(), +1))
        self._drain_handle_events()

    def on_actor_handle_deleted(self, actor_id: ActorID):
        """Called from ``ActorHandle.__del__`` — never blocks."""
        if not self._actor_gc_enabled:
            return
        self._handle_pending.append((actor_id.binary(), -1))
        self._drain_handle_events()

    def _drain_handle_events(self):
        while self._handle_pending:
            if not self._handle_lock.acquire(blocking=False):
                return  # a later create/delete (or the sweeper) re-drains
            notify = []
            try:
                while True:
                    try:
                        key, delta = self._handle_pending.popleft()
                    except IndexError:
                        break
                    before = self._handle_counts[key]
                    after = before + delta
                    self._handle_counts[key] = after
                    if before == 0 and after == 1:
                        notify.append((key, +1))
                    elif before == 1 and after == 0:
                        self._handle_counts.pop(key, None)
                        notify.append((key, -1))
            finally:
                self._handle_lock.release()
            for key, delta in notify:
                self._push_handle_change(key, delta)

    def _push_handle_change(self, key: bytes, delta: int):
        if self._loop is None or not self._loop.is_running() or \
                self._shutdown:
            return

        async def _send():
            try:
                await self._head.call_simple(
                    "actor_handle_change",
                    {"actor_id": ActorID(key).hex(), "delta": delta})
            except Exception:  # noqa: BLE001 - a lost dec only delays GC
                pass

        asyncio.run_coroutine_threadsafe(_send(), self._loop)

    def kill_actor(self, actor_id: ActorID, no_restart=True):
        self.run_sync(self._head.call_simple(
            "kill_actor", {"actor_id": actor_id.hex(),
                           "no_restart": no_restart}), 30)
        st = self._actor_state.get(actor_id.binary())
        if st:
            st["state"] = "DEAD"
            st["error"] = "killed"

    # ------------------------------------------------------------- execution
    async def _handle(self, method, payload, bufs, conn):
        if method == "push_task":
            return await self._exec_push_task(payload, bufs, conn)
        if method == "push_task_batch":
            return await self._exec_push_task_batch(payload, conn)
        if method == "push_task_packed":
            return await self._exec_push_task_packed(payload, conn)
        if method == "get_object":
            return await self._exec_get_object(payload)
        if method == "object_chunk":
            return await self._exec_object_chunk(payload)
        if method == "chan_item":
            st = self._chan_in_state(payload["name"])
            writer = payload["writer"]
            if isinstance(writer, list):
                writer = tuple(writer)
            st["writer"] = writer
            st["items"].append((payload["seq"], writer, bufs[0]))
            st["event"].set()
            return {}
        if method == "chan_ack":
            st = self._chan_out_state(payload["name"])
            st["acks"][payload["reader"]] = max(
                st["acks"].get(payload["reader"], 0), payload["seq"])
            st["event"].set()
            return {}
        if method == "chan_close":
            st_in = self._chan_in.get(payload["name"])
            for reg in (self._chan_in, self._chan_out):
                st = reg.get(payload["name"])
                if st is not None:
                    st["closed"] = True
                    st["event"].set()
            # Forward once to the writer we have seen (the closer only
            # knows reader addresses): a producer blocked in chan_write
            # waiting for acks must observe the close, not a 30s
            # timeout.
            if st_in is not None and not payload.get("fwd"):
                writer = st_in.get("writer")
                if writer is not None and writer != self.address:
                    self._push_to_addr(writer, "chan_close",
                                       {"name": payload["name"],
                                        "fwd": True})
            return {}
        if method == "ref_inc":
            self.refs.on_borrow_change(
                ObjectID.from_hex(payload["object_id"]), +1)
            return {}
        if method == "ref_dec":
            self.refs.on_borrow_change(
                ObjectID.from_hex(payload["object_id"]), -1)
            return {}
        if method == "generator_item":
            key = payload["task_id"]
            oid = ObjectID.for_task_return(TaskID(key), payload["index"])
            self.refs.add_containment(oid, [
                (ObjectID(ob), owner)
                for ob, owner in payload.get("contained", ())])
            if key in self._dropped_generators:
                self.free_object(oid)  # consumer gone: drop, don't store
            else:
                self.memory_store.put(oid, [bytes(b) for b in bufs])
            return {}
        if method == "generator_done":
            key = payload["task_id"]
            if key in self._dropped_generators:
                self._dropped_generators.discard(key)
                self._generators.pop(key, None)
            else:
                st = self._generators.setdefault(key, {})
                st["count"] = payload["count"]
            return {}
        if method == "create_actor":
            return await self._exec_create_actor(payload, bufs)
        if method == "pubsub":
            self._on_pubsub(payload["topic"], payload["msg"])
            return {}
        if method == "ping":
            return {"ok": True}
        if method == "shutdown":
            asyncio.get_running_loop().call_soon(
                lambda: os._exit(0))
            return {}
        raise rpc.RpcError(f"core worker: unknown method {method}")

    def _on_pubsub(self, topic: str, msg: Any):
        if topic.startswith("actor:"):
            actor_hex = topic.split(":", 1)[1]
            key = ActorID.from_hex(actor_hex).binary()
            st = self._actor_state.get(key)
            if st is not None:
                if msg["state"] == "ALIVE":
                    st["address"] = msg["address"]
                    st["state"] = "ALIVE"
                elif msg["state"] == "RESTARTING":
                    st["address"] = None
                    st["state"] = "RESTARTING"
                elif msg["state"] == "DEAD":
                    st["state"] = "DEAD"
                    st["error"] = msg.get("cause", "")
        for h in self._pubsub_handlers.get(topic, []):
            try:
                h(msg)
            except Exception:
                traceback.print_exc()

    def subscribe(self, topic: str, handler):
        self._pubsub_handlers[topic].append(handler)
        self._subscribed_topics.add(topic)
        self.run_sync(self._head.call_simple("subscribe", {"topic": topic}), 30)

    def publish(self, topic: str, msg):
        self.run_sync(self._head.call_simple(
            "publish", {"topic": topic, "msg": msg}), 30)

    async def _exec_get_object(self, payload):
        oid = ObjectID.from_hex(payload["object_id"])
        # Same shm domain (same host): answer with an attach hint so the
        # requester maps the segment zero-copy. Cross-domain (another node):
        # read the frames locally and ship bytes over the wire (reference:
        # object manager chunked pull, ``object_manager.h:117``).
        same_domain = payload.get("shm_domain", self.shm_domain) == \
            self.shm_domain
        if payload.get("wait"):
            frames = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.memory_store.get(oid, timeout=300))
        else:
            frames = self.memory_store.get(oid, timeout=0)
        if frames is None:
            if self.memory_store.contains(oid) or self.shm_store.contains(oid):
                if same_domain:
                    return {"found": True, "in_shm": True}
                frames = self.shm_store.get(oid)
                if frames is None:
                    # The bytes live on the producing/pulling workers,
                    # not here (we only hold the marker): hand the
                    # puller the copy directory instead of proxying.
                    hint = await self._locate_copies(
                        oid, payload.get("shm_domain"))
                    if hint is not None:
                        return hint
                    frames = await self._recover_and_load(oid)
                if frames is None:
                    return {"found": False}
                return self._whole_or_chunk_hint(frames)
            # Not stored here (any more): another copy, then lineage
            # recovery, are the last resorts before ObjectLostError.
            hint = await self._locate_copies(oid, payload.get("shm_domain"))
            if hint is not None:
                return hint
            frames = await self._recover_and_load(oid)
            if frames is None:
                return {"found": False}
            return self._whole_or_chunk_hint(frames)
        return self._whole_or_chunk_hint(frames)

    async def _fetch_owned_from_copies(self, oid: ObjectID):
        """Owner-side byte fetch for an object whose frames live only on
        other workers (marker-only ownership): attach if a copy shares
        our domain, else chunk-pull and keep a local copy."""
        hint = await self._locate_copies(oid, self.shm_domain)
        if hint is None:
            return None
        if hint.get("in_shm"):
            return self.shm_store.get(oid)
        ref = ObjectRef(oid, self.address, _counted=False)
        try:
            return await self._pull_chunked(
                ref, hint["frame_sizes"], hint.get("sources"))
        except ObjectLostError:
            return None

    async def _locate_copies(self, oid: ObjectID, puller_domain):
        """Build a redirect hint from the head's object directory: an
        shm-attach hint when a copy already sits in the puller's domain,
        else a chunk plan whose sources are every live copy."""
        try:
            locs = (await self._head.call_simple(
                "object_loc_get", {"object_id": oid.hex()}))["locations"]
        except Exception:  # noqa: BLE001 - directory is advisory
            return None
        locs = [l for l in locs if l.get("frame_sizes")]
        if not locs:
            return None
        if puller_domain is not None and any(
                l["domain"] == puller_domain for l in locs):
            return {"found": True, "in_shm": True}
        return {"found": True, "chunked": True,
                "frame_sizes": locs[0]["frame_sizes"],
                "sources": [l["address"] for l in locs]}

    _TRANSFER_CHUNK = int(os.environ.get("RT_TRANSFER_CHUNK_BYTES", 0)) \
        or 64 * 1024 * 1024

    def _whole_or_chunk_hint(self, frames):
        """Small objects ship inline in the get_object reply; big ones
        answer with a chunk plan (frame sizes) so the puller streams
        ``object_chunk`` requests — possibly from several copies — and
        a multi-GB frame never materializes in one RPC write (reference:
        64MiB chunked pull, ``object_manager/pull_manager.h:52``,
        ``object_buffer_pool.h``)."""
        sizes = [len(f) for f in frames]
        if sum(sizes) <= self._TRANSFER_CHUNK:
            return ({"found": True, "in_shm": False},
                    [bytes(f) for f in frames])
        return {"found": True, "chunked": True, "frame_sizes": sizes}

    async def _exec_object_chunk(self, payload):
        """Serve one byte range of an object's concatenated frames. The
        slicing memcpy runs off the IO loop so a 64MiB chunk cannot
        stall unrelated RPC traffic."""
        oid = ObjectID.from_hex(payload["object_id"])
        frames = self._load_frames(oid)
        if frames is None:
            frames = await self._recover_and_load(oid)
        if frames is None:
            return {"found": False}
        off, length = payload["offset"], payload["length"]

        def cut() -> bytes:
            out = bytearray()
            pos = 0
            for f in frames:
                if len(out) >= length:
                    break
                f_end = pos + len(f)
                if f_end > off:
                    lo = max(0, off - pos)
                    hi = min(len(f), off + length - pos)
                    out += memoryview(f)[lo:hi]
                pos = f_end
            return bytes(out)

        buf = await asyncio.get_running_loop().run_in_executor(None, cut)
        return {"found": True}, [buf]

    def _deserialize_args(self, ser_args, kwargs_keys):
        vals = []
        for kind, payload in ser_args:
            if kind == "inline":
                vals.append(self.serde.deserialize(payload))
            else:
                oid_b, owner = payload
                # Uncounted: the submitter's per-task borrow keeps the
                # object alive across retries; counting here would pay
                # that borrow back after the first execution.
                ref = ObjectRef(ObjectID(oid_b), owner, _counted=False)
                vals.append(self._get_one(ref, timeout=300))
        nkw = len(kwargs_keys)
        if nkw:
            args = vals[:-nkw]
            kwargs = dict(zip(kwargs_keys, vals[-nkw:]))
        else:
            args, kwargs = vals, {}
        return args, kwargs

    async def _exec_create_actor(self, payload, bufs):
        meta = payload
        actor_id_b = meta["actor_id"]
        loop = asyncio.get_running_loop()

        def _make():
            # KV fetch + arg deserialization block, so they must run off the
            # IO loop (fetch_function itself round-trips through the loop).
            self._ensure_runtime_env(meta.get("runtime_env"))
            cls = self.fetch_function(meta["cls_ref"][1])
            args, kwargs = self._deserialize_args(
                meta["args"], meta["kwargs_keys"])
            real_cls = getattr(cls, "__rt_actor_class__", cls)
            return real_cls(*args, **kwargs)

        # Clear the tombstone BEFORE construction: the head has
        # re-assigned this actor here, so tasks that race the (possibly
        # slow) constructor must take the registration grace wait, not
        # the tombstone fast-fail.
        self._actors_gone.discard(actor_id_b)
        instance = await loop.run_in_executor(self._exec_pool, _make)
        self._actors_local[actor_id_b] = instance
        maxc = meta.get("max_concurrency", 1)
        self._actor_executors[actor_id_b] = concurrent.futures.ThreadPoolExecutor(
            max_workers=maxc, thread_name_prefix="rt-actor")
        groups = meta.get("concurrency_groups")
        if groups:
            # Named concurrency groups (reference:
            # ``concurrency_group_manager.h`` — one executor per group,
            # methods bind via @method(concurrency_group=...)): a slow
            # group saturating its threads can't starve another group.
            self._actor_group_executors[actor_id_b] = {
                name: concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(1, int(n)),
                    thread_name_prefix=f"rt-actor-{name}")
                for name, n in groups.items()}
        self._actor_order[actor_id_b] = {
            # groups are inherently concurrent: no global FIFO stream
            "ordered": maxc == 1 and not groups, "streams": {}}
        return {"ok": True}

    async def _exec_push_task(self, payload, bufs, conn=None):
        t0 = time.time()
        meta = payload
        loop = asyncio.get_running_loop()
        if meta["type"] == TaskType.ACTOR_TASK.value:
            result = await self._run_actor_task(meta, conn)
        else:
            result = await loop.run_in_executor(
                self._exec_pool, lambda: self._run_normal_task(meta, conn))
        returns_meta, out_bufs = result
        end = time.time()
        self._task_events.append(
            {"task_id": meta["task_id"].hex(), "name": meta.get("name", ""),
             "start": t0, "end": end,
             "worker_id": self.worker_id.hex()})
        from .._private.metrics import core_metrics

        cm = core_metrics()
        cm["tasks_finished"].inc()
        cm["task_duration"].observe(end - t0)
        return {"returns": returns_meta}, out_bufs

    async def _exec_push_task_batch(self, payload, conn):
        """Run a chunk of same-shape normal tasks; one combined reply
        (driver slices bufs by count). A few executor threads each run a
        slice sequentially — per-task executor hops dominate trivial
        tasks, while slices keep long tasks overlapping.

        Actor-task chunks (the driver's per-actor wire batching) run as
        concurrent ``_run_actor_task`` coroutines instead: the
        receiver-side seq streams enforce FIFO for ordered actors while
        async/concurrent actors keep their parallelism."""
        loop = asyncio.get_running_loop()
        specs = payload["specs"]
        if specs and specs[0]["type"] == TaskType.ACTOR_TASK.value:
            return await self._exec_actor_batch(specs, conn)
        lanes = min(4, len(specs))

        from .._private.metrics import core_metrics

        duration = core_metrics()["task_duration"]

        def run_slice(metas):
            out = []
            for meta in metas:
                t0 = time.time()
                try:
                    res = self._run_normal_task(meta, conn)
                except Exception as e:  # noqa: BLE001 - e.g. unpicklable
                    # One task's packaging failure must not error the
                    # whole chunk (its siblings already ran side effects).
                    err = TaskError(type(e).__name__, str(e),
                                    traceback.format_exc())
                    res = self._package_returns(
                        meta, [err] * max(1, meta["num_returns"]))
                out.append(res)
                end = time.time()
                duration.observe(end - t0)
                self._task_events.append(
                    {"task_id": meta["task_id"].hex(),
                     "name": meta.get("name", ""),
                     "start": t0, "end": end,
                     "worker_id": self.worker_id.hex()})
            return out

        slices = [specs[i::lanes] for i in range(lanes)]
        lane_outs = await asyncio.gather(*(
            loop.run_in_executor(self._exec_pool, run_slice, s)
            for s in slices))
        # restitch round-robin slices back into spec order
        outs: list = [None] * len(specs)
        for lane, lane_out in enumerate(lane_outs):
            for j, res in enumerate(lane_out):
                outs[lane + j * lanes] = res
        core_metrics()["tasks_finished"].inc(len(outs))
        return self._package_batch_reply(outs)

    def _package_batch_reply(self, outs):
        results, all_bufs = [], []
        for returns_meta, out_bufs in outs:
            results.append({"returns": returns_meta,
                            "nbufs": len(out_bufs)})
            all_bufs.extend(out_bufs)
        return {"results": results}, all_bufs

    async def _exec_push_task_packed(self, payload, conn):
        """Tuple-framed actor chunk (see ``_send_actor_chunk_packed``):
        per-call state arrives as (task_id, seq_no, args) tuples and
        simple inline results return as bare frame counts — dict
        ceremony only where a call actually needs it."""
        methods = payload["methods"]
        common = isinstance(methods, str)
        base = {
            "type": TaskType.ACTOR_TASK.value,
            "actor_id": payload["actor_id"],
            "owner_address": payload["owner_address"],
            "kwargs_keys": (),
            "num_returns": 1,
        }
        specs = []
        for i, (tid, seq, args) in enumerate(payload["calls"]):
            meta = dict(base)
            meta["task_id"] = tid
            meta["seq_no"] = seq
            meta["args"] = args
            meta["method_name"] = methods if common else methods[i]
            specs.append(meta)
        return await self._exec_actor_batch(specs, conn, packed=True)

    async def _exec_actor_batch(self, specs, conn, packed=False):
        from .._private.metrics import core_metrics

        duration = core_metrics()["task_duration"]
        outs = await self._try_actor_batch_fast(specs, duration)
        if outs is None:
            async def run_one(meta):
                t0 = time.time()
                res = await self._run_actor_task(meta, conn)
                end = time.time()
                duration.observe(end - t0)
                self._task_events.append(
                    {"task_id": meta["task_id"].hex(),
                     "name": meta.get("name", ""),
                     "start": t0, "end": end,
                     "worker_id": self.worker_id.hex()})
                return res

            outs = await asyncio.gather(*(run_one(m) for m in specs))
        core_metrics()["tasks_finished"].inc(len(outs))
        if packed:
            return self._package_packed_reply(outs)
        return self._package_batch_reply(outs)

    def _package_packed_reply(self, outs):
        """Counterpart of ``_package_batch_reply`` for the packed
        protocol: a simple inline single-return result is encoded as its
        frame count alone."""
        results, all_bufs = [], []
        for returns_meta, out_bufs in outs:
            if (len(returns_meta) == 1
                    and returns_meta[0].get("where") == "inline"
                    and not returns_meta[0].get("contained")):
                results.append(len(out_bufs))
            else:
                results.append({"returns": returns_meta,
                                "nbufs": len(out_bufs)})
            all_bufs.extend(out_bufs)
        return {"results": results}, all_bufs

    async def _try_actor_batch_fast(self, specs, duration):
        """Whole-chunk execution with minimal asyncio hops.

        Ordered (max_concurrency=1) actors run the chunk sequentially in
        ONE executor hop — exactly the FIFO the seq stream would enforce.
        Unordered (max_concurrency>1) actors run round-robin slices, one
        executor hop per lane, preserving their parallelism. Either way
        the per-call loop round-trips that dominate trivial actor calls
        disappear. Returns None to fall back to per-call execution
        (generators, coroutine methods, missing instance)."""
        meta0 = specs[0]
        actor_id_b = meta0["actor_id"]
        instance = self._actors_local.get(actor_id_b)
        order = self._actor_order.get(actor_id_b)
        first, last = meta0["seq_no"], specs[-1]["seq_no"]
        owner = meta0["owner_address"]
        if (instance is None or order is None
                or actor_id_b in self._actor_group_executors
                or any(m.get("is_generator") for m in specs)
                or meta0["method_name"] == "__rt_drive__"):
            # concurrency-group actors take the per-call path, which
            # routes each call to its group's executor
            return None
        for m in specs:
            method = getattr(instance, m["method_name"], None)
            if method is None or asyncio.iscoroutinefunction(method):
                return None
        if not order["ordered"]:
            return await self._actor_batch_lanes(
                actor_id_b, instance, specs, duration)
        if (first < 0 or last - first + 1 != len(specs)
                or any(m["owner_address"] != owner for m in specs)):
            return None
        loop = asyncio.get_running_loop()
        stream = order["streams"].setdefault(
            owner, {"next": None, "events": {}})
        if stream["next"] is None:
            stream["next"] = first
        if first > stream["next"]:
            ev = stream["events"].setdefault(first, asyncio.Event())
            await ev.wait()
            stream["events"].pop(first, None)

        def run_all():
            return [self._run_actor_call_sync(instance, meta, duration)
                    for meta in specs]

        try:
            return await loop.run_in_executor(
                self._actor_executors[actor_id_b], run_all)
        finally:
            if last >= stream["next"]:
                stream["next"] = last + 1
                nxt = stream["events"].get(last + 1)
                if nxt is not None:
                    nxt.set()

    def _run_actor_call_sync(self, instance, meta, duration):
        """One actor call, fully in the calling thread: deserialize,
        invoke, split, package. Failures (including unpicklable results
        in packaging) become TaskError results — one bad call must not
        sink a chunk whose siblings already ran side effects."""
        t0 = time.time()
        try:
            args, kwargs = self._deserialize_args(
                meta["args"], meta["kwargs_keys"])
            with tracing.execute_span(meta, meta["method_name"]):
                out = getattr(instance, meta["method_name"])(*args, **kwargs)
            values = self._split_returns(out, meta["num_returns"])
            res = self._package_returns(meta, values)
        except Exception as e:  # noqa: BLE001
            err = TaskError(type(e).__name__, str(e),
                            traceback.format_exc())
            res = self._package_returns(
                meta, [err] * max(1, meta["num_returns"]))
        end = time.time()
        duration.observe(end - t0)
        self._task_events.append(
            {"task_id": meta["task_id"].hex(),
             "name": meta.get("name", ""),
             "start": t0, "end": end,
             "worker_id": self.worker_id.hex()})
        return res

    async def _actor_batch_lanes(self, actor_id_b, instance, specs,
                                 duration):
        """Unordered-actor chunk: round-robin slices over the actor's
        thread pool (size == max_concurrency) — the parallelism degree
        of the per-call path at a fraction of the asyncio traffic (one
        executor hop per LANE, not per call; a 128-call chunk on a
        max_concurrency=4 actor costs 4 hops instead of 128). Trade-off
        vs true per-call scheduling: a blocking call delays the later
        calls of its own slice (not other slices); chunks are bursts of
        trivial calls in practice, where hop overhead dominates."""
        loop = asyncio.get_running_loop()
        ex = self._actor_executors[actor_id_b]
        lanes = min(getattr(ex, "_max_workers", 4), len(specs))

        def run_slice(metas):
            return [self._run_actor_call_sync(instance, m, duration)
                    for m in metas]

        if lanes <= 1:
            return await loop.run_in_executor(ex, run_slice, list(specs))
        slices = [specs[i::lanes] for i in range(lanes)]
        lane_outs = await asyncio.gather(*(
            loop.run_in_executor(ex, run_slice, s) for s in slices))
        outs: list = [None] * len(specs)
        for lane, lane_out in enumerate(lane_outs):
            for j, res in enumerate(lane_out):
                outs[lane + j * lanes] = res
        return outs

    def _execute_function(self, meta):
        """Fetch + run the task function; returns its raw result."""
        # Env failures flow through the normal error channels (including
        # the streamed-error path for generators).
        self._ensure_runtime_env(meta.get("runtime_env"))
        kind, ref = meta["function_ref"]
        if kind != "kv":
            raise RuntimeError(f"bad function ref {kind}")
        fn = self.fetch_function(ref)
        fn = getattr(fn, "__rt_function__", fn)
        args, kwargs = self._deserialize_args(meta["args"],
                                              meta["kwargs_keys"])
        if meta.get("is_generator"):
            return self._traced_gen(meta, lambda: fn(*args, **kwargs))
        # Runs on the executor thread, so user code inherits the span
        # context: nested tracing.span()/submissions become children.
        with tracing.execute_span(meta, meta.get("name") or "task"):
            return fn(*args, **kwargs)

    @staticmethod
    def _traced_gen(meta, make):
        """Generator tasks produce lazily: the execute span must cover
        the ITERATION of the body (where user code actually runs), not
        the call that merely constructs the generator object."""
        name = meta.get("name") or meta.get("method_name") or "task"
        with tracing.execute_span(meta, name):
            yield from make()

    @staticmethod
    def _split_returns(out, num_returns):
        if num_returns == 1:
            return [out]
        if not isinstance(out, (tuple, list)) or len(out) != num_returns:
            raise ValueError(
                f"task declared num_returns={num_returns} but returned "
                f"{type(out).__name__}")
        return list(out)

    def _package_returns(self, meta, values) -> Tuple[list, list]:
        """Serialize return values: small inline, large to shm.

        Refs nested in a return value charge borrows here (serializer
        side); their (oid, owner) pairs ride the reply so the RESULT'S
        owner records the containment and releases the borrows when it
        frees the result object.
        """
        returns_meta, out_bufs = [], []
        owner_is_remote = meta["owner_address"] != self.address
        for i, v in enumerate(values):
            with self.capture_nested_refs() as contained:
                frames = self.serde.serialize(v)
            total = sum(len(f) for f in frames)
            oid = ObjectID.for_task_return(TaskID(meta["task_id"]), i)
            ent = {"contained": [(o.binary(), owner)
                                 for o, owner in contained]}
            if total > self.config.max_inline_object_size and owner_is_remote:
                ent["where"] = "shm"
            else:
                ent["where"] = "inline"
                ent["nframes"] = len(frames)
                out_bufs.extend(bytes(f) for f in frames)
            if ent["where"] == "shm":
                self.shm_store.create(oid, frames)
                # Announce this copy so location-aware pulls can read it
                # from here (not just via the owner).
                self._register_object_copy(oid, [len(f) for f in frames])
            returns_meta.append(ent)
        return returns_meta, out_bufs

    def _run_normal_task(self, meta, conn=None):
        if meta.get("is_generator"):
            # Arg fetch/deserialize happens inside _run_generator's try so
            # failures stream back as an error item, not a protocol error.
            return self._run_generator(meta, conn,
                                       lambda: self._execute_function(meta))
        try:
            values = self._split_returns(self._execute_function(meta),
                                         meta["num_returns"])
        except Exception as e:  # noqa: BLE001
            err = TaskError(type(e).__name__, str(e), traceback.format_exc())
            values = [err] * meta["num_returns"]
        return self._package_returns(meta, values)

    def _run_generator(self, meta, conn, produce):
        """Stream yielded items back to the owner as they are produced
        (reference: ``core_worker.proto:462`` ReportGeneratorItemReturns).
        Runs on an executor thread; item pushes hop to the IO loop in call
        order, so indices arrive monotonically."""
        task_id_b = meta["task_id"]
        idx = 0

        def push(method, payload, bufs=()):
            self._loop.call_soon_threadsafe(
                lambda: self._push_quiet(conn, method, payload, list(bufs)))

        try:
            out = produce()
            for item in out:
                with self.capture_nested_refs() as contained:
                    frames = self.serde.serialize(item)
                push("generator_item",
                     {"task_id": task_id_b, "index": idx,
                      "contained": [(o.binary(), owner)
                                    for o, owner in contained]},
                     [bytes(f) for f in frames])
                idx += 1
                if idx >= 65535:
                    raise ValueError("streaming generator exceeded 65535 "
                                     "items (object-id index space)")
        except Exception as e:  # noqa: BLE001
            err = TaskError(type(e).__name__, str(e), traceback.format_exc())
            frames = self.serde.serialize(err)
            push("generator_item", {"task_id": task_id_b, "index": idx},
                 [bytes(f) for f in frames])
            idx += 1
        push("generator_done", {"task_id": task_id_b, "count": idx})
        return {"returns": [], "generator_count": idx}, []

    @staticmethod
    def _push_quiet(conn, method, payload, bufs):
        try:
            conn.push(method, payload, bufs)
        except Exception:  # noqa: BLE001 - owner died; nothing to stream to
            pass

    def _actor_group_name(self, actor_id_b, meta, instance):
        """Resolve a call's concurrency group: explicit per-call group >
        the method's @method(concurrency_group=...) binding > None.
        Unknown names error — including on actors that declared NO
        groups, so a typo'd override never passes silently."""
        groups = self._actor_group_executors.get(actor_id_b)
        g = meta.get("concurrency_group")
        if g is None and groups:
            m = getattr(type(instance), meta.get("method_name", ""), None)
            g = getattr(m, "__rt_concurrency_group__", None)
        if g is not None and (not groups or g not in groups):
            raise rpc.RpcError(
                f"unknown concurrency group {g!r}; declared: "
                f"{sorted(groups) if groups else '(none)'}")
        return g

    def _actor_executor_for(self, actor_id_b, meta, instance):
        """Thread pool for one sync call (reference:
        ``concurrency_group_manager.h`` GetExecutor)."""
        g = self._actor_group_name(actor_id_b, meta, instance)
        if g is not None:
            return self._actor_group_executors[actor_id_b][g]
        return self._actor_executors[actor_id_b]

    def _actor_group_semaphore(self, actor_id_b, g):
        """Async methods can't run on a thread pool; their group limit
        is an asyncio semaphore of the same width (reference: async
        actors bound concurrency per group the same way)."""
        sems = self._actor_group_sems.setdefault(actor_id_b, {})
        sem = sems.get(g)
        if sem is None:
            width = getattr(
                self._actor_group_executors[actor_id_b][g],
                "_max_workers", 1)
            sem = sems[g] = asyncio.Semaphore(width)
        return sem

    async def _run_actor_task(self, meta, conn=None):
        actor_id_b = meta["actor_id"]
        instance = self._actors_local.get(actor_id_b)
        if instance is None:
            # The head routes tasks here the moment it ASSIGNS the
            # actor; the instance lands in _actors_local only when the
            # constructor finishes on another thread. Waiting briefly
            # turns that registration race into a short stall instead
            # of a spurious routing failure. A TOMBSTONED actor
            # (known to have left) usually means a stale route — but
            # the head may also be restarting the actor on THIS worker
            # and its create can land after the task (observed in
            # suite runs: the error's host list contained the very
            # actor it rejected). So tombstoned actors get a short
            # grace instead of none, extended to the full grace the
            # moment the create clears the tombstone.
            now = asyncio.get_running_loop().time
            tombstoned = actor_id_b in self._actors_gone
            deadline = now() + (1.0 if tombstoned else 5.0)
            while instance is None and now() < deadline:
                await asyncio.sleep(0.02)
                gone = actor_id_b in self._actors_gone
                if tombstoned and not gone:
                    tombstoned = False   # create arrived: full grace
                    deadline = now() + 5.0
                elif gone and not tombstoned:
                    break                # died mid-wait: fail fast
                instance = self._actors_local.get(actor_id_b)
        if instance is None:
            local = [ActorID(a).hex()[:12] for a in self._actors_local]
            raise rpc.RpcError(
                f"{ACTOR_NOT_ON_WORKER} actor "
                f"{ActorID(actor_id_b).hex()[:12]} not on worker "
                f"{self.sock_path} (hosts: {local})")
        order = self._actor_order[actor_id_b]
        seq = meta["seq_no"]
        loop = asyncio.get_running_loop()
        if meta["method_name"] == "__rt_drive__":
            # Compiled-DAG drive loop (see ray_tpu_torch/dag.py): pins this
            # actor to a channel-read → method → channel-write loop until
            # the channels close. Bypasses the ordered stream — the loop
            # intentionally occupies the actor.
            return await self._run_channel_drive(instance, meta, loop)
        method = getattr(instance, meta["method_name"])

        def _args_are_light():
            # Tiny inline args deserialize in ~us: do it on the loop and
            # skip two thread-pool hops on the hot path.
            total = 0
            for kind, payload in meta["args"]:
                if kind != "inline":
                    return False
                total += sum(len(f) for f in payload)
            return total < 8192

        async def _invoke():
            if meta.get("is_generator"):
                # Deserialize inside the generator runner's try: a lost
                # arg ref streams back as an error item instead of
                # crashing the reply protocol (num_returns == 0 here).
                def produce():
                    args, kwargs = self._deserialize_args(
                        meta["args"], meta["kwargs_keys"])
                    return self._traced_gen(
                        meta, lambda: method(*args, **kwargs))

                ex = self._actor_executor_for(actor_id_b, meta, instance)
                return await loop.run_in_executor(
                    ex, lambda: self._run_generator(meta, conn, produce))
            light = _args_are_light()
            if light:
                args, kwargs = self._deserialize_args(meta["args"],
                                                      meta["kwargs_keys"])
            else:
                args, kwargs = await loop.run_in_executor(
                    self._exec_pool,
                    lambda: self._deserialize_args(meta["args"],
                                                   meta["kwargs_keys"]))
            if asyncio.iscoroutinefunction(method):
                g = self._actor_group_name(actor_id_b, meta, instance)
                if g is not None:
                    sem = self._actor_group_semaphore(actor_id_b, g)
                    async with sem:
                        with tracing.execute_span(meta,
                                                  meta["method_name"]):
                            out = await method(*args, **kwargs)
                else:
                    with tracing.execute_span(meta, meta["method_name"]):
                        out = await method(*args, **kwargs)
            else:
                ex = self._actor_executor_for(actor_id_b, meta, instance)

                def _call_traced():
                    with tracing.execute_span(meta, meta["method_name"]):
                        return method(*args, **kwargs)

                out = await loop.run_in_executor(ex, _call_traced)
            return self._split_returns(out, meta["num_returns"])

        # FIFO per submitting client for max_concurrency == 1 actors, like
        # the reference's per-handle sequence numbers
        # (``direct_actor_task_submitter.cc:391``). A fresh worker (post
        # restart) adopts the first seq it sees — earlier seqs died with the
        # previous instance.
        stream = None
        if order["ordered"] and seq >= 0:
            # Per-seq events, not a shared Condition: notify_all on a
            # condition wakes EVERY queued call per completion (O(n^2)
            # wakeups across a deep pipeline); here each completion wakes
            # exactly its successor.
            stream = order["streams"].setdefault(
                meta["owner_address"], {"next": None, "events": {}})
            if stream["next"] is None:
                stream["next"] = seq
            if seq > stream["next"]:
                ev = stream["events"].setdefault(seq, asyncio.Event())
                await ev.wait()
                stream["events"].pop(seq, None)
        try:
            values = await _invoke()
        except Exception as e:  # noqa: BLE001
            err = TaskError(type(e).__name__, str(e), traceback.format_exc())
            values = [err] * max(1, meta["num_returns"])
        finally:
            if stream is not None and seq >= stream["next"]:
                stream["next"] = seq + 1
                nxt = stream["events"].get(seq + 1)
                if nxt is not None:
                    nxt.set()
        if meta.get("is_generator"):
            if isinstance(values, tuple):
                return values  # _run_generator built the (meta, bufs)
            # _invoke failed before the stream started: surface the error
            # as the stream's only item.
            frames = self.serde.serialize(values[0])
            self._push_quiet(conn, "generator_item",
                             {"task_id": meta["task_id"], "index": 0},
                             [bytes(f) for f in frames])
            self._push_quiet(conn, "generator_done",
                             {"task_id": meta["task_id"], "count": 1})
            return {"returns": [], "generator_count": 1}, []
        if all(_small_value(v) for v in values):
            return self._package_returns(meta, values)
        return await loop.run_in_executor(
            self._exec_pool, lambda: self._package_returns(meta, values))

    async def _run_channel_drive(self, instance, meta, loop):
        """Execute a compiled-DAG drive loop on this actor's executor.

        Multi-arg form: one value is read from EACH input channel per
        iteration (fan-in joins on item index — GPipe-style lockstep),
        the method is called with them positionally, and the result is
        written to the output channel."""
        args, _ = self._deserialize_args(meta["args"], meta["kwargs_keys"])
        if len(args) == 3:  # legacy single-input shape
            method_name, in_ch, out_ch = args
            in_chs, reader_idxs = [in_ch], [0]
        else:
            method_name, in_chs, reader_idxs, out_ch = args
        fn = getattr(instance, method_name)

        def drive():
            from ray_tpu_torch.experimental.channel import ChannelClosed

            while True:
                values = []
                try:
                    for ch, ridx in zip(in_chs, reader_idxs):
                        values.append(ch.read(ridx, timeout=3600.0))
                except ChannelClosed:
                    return "closed"
                err = next((v for v in values
                            if isinstance(v, TaskError)), None)
                if err is not None:
                    out = err  # upstream failure passes through intact
                else:
                    try:
                        out = fn(*values)
                    except Exception as e:  # noqa: BLE001 - ship downstream
                        out = TaskError(type(e).__name__, str(e),
                                        traceback.format_exc())
                try:
                    out_ch.write(out)
                except ChannelClosed:
                    return "closed"

        ex = self._actor_executors[meta["actor_id"]]
        result = await loop.run_in_executor(ex, drive)
        return self._package_returns(meta, [result])

    # -------------------------------------------------- TCP channels
    # Cross-domain mutable-object channels (experimental/channel.py
    # TcpChannel): items push writer→readers, acks push back. State is
    # per-process; any thread may call write/read (pushes marshal onto
    # the IO loop).

    def _chan_in_state(self, name: str):
        with self._chan_lock:
            return self._chan_in.setdefault(
                name, {"items": deque(), "event": threading.Event(),
                       "closed": False})

    def _chan_out_state(self, name: str):
        with self._chan_lock:
            return self._chan_out.setdefault(
                name, {"acks": {}, "event": threading.Event(),
                       "seq": 0, "closed": False})

    def _push_to_addr(self, addr, method: str, payload, bufs=()):
        """Best-effort fire-and-forget push to any peer address."""
        async def _do():
            try:
                conn = await self._get_conn(addr)
                conn.push(method, payload, list(bufs))
            except Exception:  # noqa: BLE001 - peer gone
                pass

        try:
            asyncio.run_coroutine_threadsafe(_do(), self._loop)
        except RuntimeError:
            pass

    def chan_write(self, chan, value, timeout: float = 30.0):
        import pickle as _pickle

        from ..experimental.channel import ChannelClosed

        st = self._chan_out_state(chan.name)
        seq = st["seq"]
        deadline = time.time() + timeout
        while any(st["acks"].get(i, 0) < seq
                  for i in range(chan.num_readers)):
            if st["closed"]:
                raise ChannelClosed
            if time.time() > deadline:
                raise TimeoutError("channel readers lagging")
            st["event"].wait(0.05)
            st["event"].clear()
        blob = _pickle.dumps(value, protocol=5)
        for i, addr in enumerate(chan.reader_addresses):
            self._push_to_addr(addr, "chan_item",
                               {"name": chan.name, "seq": seq + 1,
                                "writer": self.address}, [blob])
        st["seq"] = seq + 1

    def chan_read(self, name: str, reader_idx: int,
                  timeout: float = 30.0):
        import pickle as _pickle

        from ..experimental.channel import ChannelClosed

        st = self._chan_in_state(name)
        deadline = time.time() + timeout
        while not st["items"]:
            if st["closed"]:
                raise ChannelClosed
            if time.time() > deadline:
                raise TimeoutError("channel writer idle")
            st["event"].wait(0.05)
            st["event"].clear()
        seq, writer, blob = st["items"].popleft()
        value = _pickle.loads(blob)
        self._push_to_addr(writer, "chan_ack",
                           {"name": name, "reader": reader_idx,
                            "seq": seq})
        return value

    def chan_close(self, chan):
        for addr in chan.reader_addresses:
            self._push_to_addr(addr, "chan_close", {"name": chan.name})
        for reg in (self._chan_in, self._chan_out):
            st = reg.get(chan.name)
            if st is not None:
                st["closed"] = True
                st["event"].set()

    # ------------------------------------------------------------- misc
    def head_call(self, method: str, payload=None, timeout=30.0):
        return self.run_sync(self._head.call_simple(method, payload), timeout)

    def kv_put(self, key: str, value: bytes, ns: str = "default",
               overwrite: bool = True) -> bool:
        meta = self.run_sync(self._head.call(
            "kv_put", {"ns": ns, "key": key, "overwrite": overwrite},
            [bytes(value)]), 30)[0]
        return bool(meta.get("added"))

    def kv_get(self, key: str, ns: str = "default"):
        meta, bufs = self.run_sync(
            self._head.call("kv_get", {"ns": ns, "key": key}), 30)
        if not meta.get("found"):
            return None
        return bufs[0] if bufs else b""

    def kv_del(self, key: str, ns: str = "default") -> bool:
        return bool(self.head_call("kv_del", {"ns": ns, "key": key})
                    .get("deleted"))

    def kv_keys(self, prefix: str = "", ns: str = "default"):
        return self.head_call("kv_keys", {"ns": ns, "prefix": prefix})

    def flush_task_events(self):
        if self._task_events:
            evs = list(self._task_events)
            self._task_events.clear()
            try:
                self.head_call("report_task_events", evs)
            except Exception:
                pass
        spans = tracing.drain()
        dropped = tracing.take_dropped()
        if spans or dropped:
            me = self.worker_id.hex()
            for s in spans:
                s.setdefault("process", me)
            try:
                self.head_call("report_spans",
                               {"spans": spans, "dropped": dropped})
            except Exception:
                # Head unreachable (e.g. crash-restart window): put the
                # spans back for the next flush — traces covering a
                # failure window are the ones worth keeping. The deque
                # bound caps memory if the head stays gone.
                tracing.requeue(spans)
                tracing.add_dropped(dropped)
        self.flush_metrics()

    def flush_metrics(self):
        """Ship this process's metric snapshot to the head."""
        from .._private.metrics import core_metrics, global_registry

        cm = core_metrics()
        cm["objects_stored"].set(self.memory_store.size())
        cm["shm_bytes"].set(self.shm_store.used_bytes())
        try:
            self.head_call("report_metrics", {
                "component": self.worker_id.hex(),
                "pid": os.getpid(),
                "snapshot": global_registry().snapshot()})
        except Exception:  # noqa: BLE001 - metrics are best-effort
            pass
