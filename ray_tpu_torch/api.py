"""Public API: init/shutdown, @remote tasks & actors, get/put/wait.

The port's copy of ``ray_tpu/api.py`` (reference: Ray's
``python/ray/_private/worker.py:1216`` ``ray.init``,
``remote_function.py:266`` and ``actor.py`` for ``@ray.remote``), with
``GPU`` as the accelerator resource: ``init(num_gpus=)`` and the
``num_gpus`` option take the places of ``num_tpus``, and a node counts
its cards from ``CUDA_VISIBLE_DEVICES`` or ``/dev/nvidia*``
(``_private/accelerators.py``). Sessions live under
``$TMPDIR/ray_tpu_torch/``.

Not ported yet (ROADMAP Queue 1): ``address="auto"`` (it finds sessions
through ``cli.py``, item 1) and ``.bind()`` on functions and actor
methods (``workflow/`` and ``dag.py``, item 6). Both raise
``NotImplementedError``.
"""
from __future__ import annotations

import asyncio
import atexit
import functools
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

from ._private.accelerators import detect_num_gpus, gang_resources
from ._private.config import Config, set_global_config
from ._private.head import HeadService
from ._private.ids import ActorID, PlacementGroupID
from ._private.task_spec import SchedulingStrategy
from .core.worker import CoreWorker, ObjectRef
from .exceptions import RayTpuError

_init_lock = threading.Lock()
_global_state: Dict[str, Any] = {"core": None, "head_thread": None}


class _HeadThread:
    """Runs the head service on a dedicated asyncio loop thread."""

    def __init__(self, session_dir: str, config: Config,
                 resources: Dict[str, float]):
        self.session_dir = session_dir
        self.config = config
        self.resources = resources
        self.head: Optional[HeadService] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, name="rt-head",
                                        daemon=True)

    def start(self):
        self._thread.start()
        self._ready.wait(timeout=30)
        return self

    def _run(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self.head = HeadService(self.session_dir, self.config, self.resources)
        self._loop.run_until_complete(self.head.start())
        self._ready.set()
        try:
            self._loop.run_forever()
        finally:
            self._loop.run_until_complete(self.head.stop())
            self._loop.close()

    def stop(self):
        if self._loop and self._loop.is_running():
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)


def is_initialized() -> bool:
    return _global_state["core"] is not None


def init(address: Optional[str] = None, *, num_cpus: Optional[int] = None,
         num_gpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: Optional[int] = None,
         system_config: Optional[Dict[str, Any]] = None,
         namespace: str = "default", ignore_reinit_error: bool = False):
    """Start (or connect to) a cluster and attach this process as driver."""
    if address == "auto":
        # Session discovery goes through cli.py, not ported yet.
        raise NotImplementedError(
            "address='auto' is not ported yet (ROADMAP Queue 1 item 1: "
            "cli.py); pass the head's socket path or host:port, or call "
            "init() with no address")
    with _init_lock:
        if _global_state["core"] is not None:
            if ignore_reinit_error:
                return _global_state["core"]
            raise RayTpuError("ray_tpu_torch.init() already called "
                              "(use ignore_reinit_error=True)")
        cfg_overrides = dict(system_config or {})
        if object_store_memory is not None:
            cfg_overrides["object_store_memory"] = object_store_memory
        config = Config(cfg_overrides)
        set_global_config(config)

        listen_tcp = False
        if address is None:
            session_dir = os.path.join(
                os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch",
                f"session_{int(time.time() * 1000)}_{os.getpid()}")
            os.makedirs(session_dir, exist_ok=True)
            total = dict(resources or {})
            total.setdefault("CPU", float(num_cpus if num_cpus is not None
                                          else max(8, os.cpu_count() or 1)))
            if num_gpus is not None:
                total.setdefault("GPU", float(num_gpus))
            else:
                total.setdefault("GPU", float(detect_num_gpus()))
            total.setdefault("memory", float(
                os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")))
            # The accelerator label (reference: Ray's
            # accelerators/nvidia_gpu.py); no slice anchor on a GPU host.
            for k, v in gang_resources(total.get("GPU", 0.0)).items():
                total.setdefault(k, v)
            head_thread = _HeadThread(session_dir, config, total).start()
            head_sock = head_thread.head.sock_path
            _global_state["head_thread"] = head_thread
        else:
            # Remote client: "host:port" (or "[v6::addr]:port") → TCP
            # attach; this driver must itself serve over TCP so workers
            # on the cluster can pull objects it owns (reference: Ray
            # Client / ``ray.init("ray://host:port")``). Anything that
            # doesn't match host:port exactly is treated as a UDS path —
            # a colon-bearing or not-yet-created socket path must not
            # fall into int(port).
            tcp_m = isinstance(address, str) and not os.path.exists(
                address) and re.match(
                    # [v6::addr]:port (incl. v4-mapped "::ffff:1.2.3.4"),
                    # bare-v6:port ("::1:6379" — last colon splits, as
                    # rpartition did), or plain host:port.
                    r"^(?:\[(?P<v6>[0-9a-fA-F:.]+)\]"
                    r"|(?P<v6bare>[0-9a-fA-F:.]*:[0-9a-fA-F:.]*)"
                    r"|(?P<host>[^/:\[\]]+))"
                    r":(?P<port>\d{1,5})$", address)
            if tcp_m:
                host = (tcp_m.group("v6") or tcp_m.group("v6bare")
                        or tcp_m.group("host"))
                head_sock = (host, int(tcp_m.group("port")))
                session_dir = os.path.join(
                    os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch",
                    f"client_{int(time.time() * 1000)}_{os.getpid()}")
                os.makedirs(session_dir, exist_ok=True)
                listen_tcp = True
            else:
                head_sock = address
                session_dir = os.path.dirname(address)

        core = CoreWorker(session_dir=session_dir, head_sock=head_sock,
                          mode="driver", config=config,
                          listen_tcp=listen_tcp)
        core.start()
        _global_state["core"] = core
        atexit.register(_atexit_shutdown)
        from ._private.usage_stats import record_feature

        record_feature("core_init")
        return core


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:
        pass


def shutdown():
    with _init_lock:
        core: CoreWorker = _global_state.get("core")
        if core is not None:
            try:
                from ._private.usage_stats import write_report

                write_report(core.session_dir)
            except Exception:
                pass
            try:
                core.release_all_leases()
            except Exception:
                pass
            core.shutdown()
            _global_state["core"] = None
        ht = _global_state.get("head_thread")
        if ht is not None:
            ht.stop()
            _global_state["head_thread"] = None


def _core() -> CoreWorker:
    return CoreWorker.current()


def put(value: Any) -> ObjectRef:
    return _core().put(value)


def get(refs, timeout: Optional[float] = None):
    return _core().get(refs, timeout=timeout)


def wait(refs: List[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    return _core().wait(refs, num_returns=num_returns, timeout=timeout,
                        fetch_local=fetch_local)


def kill(actor_handle: "ActorHandle", *, no_restart: bool = True):
    _core().kill_actor(actor_handle._actor_id, no_restart=no_restart)


def cluster_resources() -> Dict[str, float]:
    return _core().head_call("cluster_resources")


def available_resources() -> Dict[str, float]:
    return _core().head_call("available_resources")


def nodes() -> List[dict]:
    """Cluster node table (reference: ``ray.nodes()``)."""
    return _core().head_call("list_nodes")


class NodeAffinitySchedulingStrategy:
    """Pin a task/actor to one node (reference:
    ``ray.util.scheduling_strategies.NodeAffinitySchedulingStrategy``)."""

    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class NodeLabelSchedulingStrategy:
    """Schedule onto nodes by label (reference:
    ``ray.util.scheduling_strategies.NodeLabelSchedulingStrategy``):
    ``hard`` pairs are required, ``soft`` pairs preferred among the
    hard-feasible nodes. Node labels come from ``cluster_utils.Cluster
    .add_node(labels=...)`` / ``node_main --labels``."""

    def __init__(self, hard: Optional[Dict[str, str]] = None,
                 soft: Optional[Dict[str, str]] = None):
        if not hard and not soft:
            raise ValueError("NodeLabelSchedulingStrategy needs at least "
                             "one hard or soft label")
        self.hard = dict(hard or {})
        self.soft = dict(soft or {})


def _resources_from_options(opts: Dict[str, Any]) -> Dict[str, float]:
    res = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    num_gpus = opts.get("num_gpus")
    res["CPU"] = float(1 if num_cpus is None else num_cpus)
    if num_gpus:
        res["GPU"] = float(num_gpus)
    res = {k: v for k, v in res.items() if v}
    return res


def _strategy_from_options(opts) -> Optional[SchedulingStrategy]:
    s = opts.get("scheduling_strategy")
    if s is None or s == "DEFAULT":
        return SchedulingStrategy()
    if s == "SPREAD":
        return SchedulingStrategy(kind="SPREAD")
    if isinstance(s, NodeAffinitySchedulingStrategy):
        return SchedulingStrategy(kind="NODE_AFFINITY", node_id=s.node_id,
                                  soft=s.soft)
    if isinstance(s, NodeLabelSchedulingStrategy):
        return SchedulingStrategy(kind="NODE_LABEL", hard_labels=s.hard,
                                  soft_labels=s.soft)
    if isinstance(s, PlacementGroupSchedulingStrategy):
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            placement_group_id=s.placement_group._id,
            bundle_index=s.placement_group_bundle_index,
            capture_child_tasks=s.placement_group_capture_child_tasks)
    if isinstance(s, SchedulingStrategy):
        return s
    raise ValueError(f"bad scheduling_strategy {s!r}")


class RemoteFunction:
    def __init__(self, fn, options: Dict[str, Any]):
        self._fn = fn
        self._options = options
        self._fn_key: Optional[str] = None
        self._call_template: Optional[Dict[str, Any]] = None
        functools.update_wrapper(self, fn)

    def __call__(self, *a, **kw):
        raise TypeError(
            "remote functions cannot be called directly; use .remote()")

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(opts)
        rf = RemoteFunction(self._fn, merged)
        rf._fn_key = self._fn_key
        return rf

    def bind(self, *args, **kwargs):
        """A workflow DAG node in the reference (``workflow/``), which
        is not ported yet."""
        raise NotImplementedError(
            ".bind() is not ported yet (ROADMAP Queue 1 item 6: "
            "dag.py and workflow/)")

    def remote(self, *args, **kwargs):
        core = _core()
        if self._fn_key is None:
            self._fn_key = core.export_function(self._fn)
        # Options are immutable after construction (``options()`` builds
        # a new RemoteFunction), so resolve them once: a burst of
        # ``fn.remote()`` calls must not re-derive resources/strategy
        # dicts per call.
        tmpl = self._call_template
        if tmpl is None:
            tmpl = self._call_template = {
                "num_returns": self._options.get("num_returns", 1),
                "resources": _resources_from_options(self._options),
                "max_retries": self._options.get("max_retries"),
                "strategy": _strategy_from_options(self._options),
                "name": self._options.get("name") or self._fn.__name__,
                "runtime_env": self._options.get("runtime_env"),
            }
        num_returns = tmpl["num_returns"]
        refs = core.submit_task(
            self._fn_key, args, kwargs,
            num_returns=num_returns,
            resources=tmpl["resources"],
            max_retries=tmpl["max_retries"],
            strategy=tmpl["strategy"],
            name=tmpl["name"],
            runtime_env=tmpl["runtime_env"],
        )
        if num_returns == "streaming":
            return refs  # an ObjectRefGenerator
        return refs[0] if num_returns == 1 else refs


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1,
                 concurrency_group: Optional[str] = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(self, num_returns=None,
                concurrency_group: Optional[str] = None):
        # unset fields inherit from THIS instance so chained
        # .options() calls compose instead of resetting
        return ActorMethod(
            self._handle, self._name,
            self._num_returns if num_returns is None else num_returns,
            self._concurrency_group if concurrency_group is None
            else concurrency_group)

    def bind(self, *upstreams):
        """A compiled-DAG node in the reference (``dag.py``), which is
        not ported yet."""
        raise NotImplementedError(
            ".bind() is not ported yet (ROADMAP Queue 1 item 6: "
            "dag.py and workflow/)")

    def remote(self, *args, **kwargs):
        core = _core()
        refs = core.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=self._num_returns,
            concurrency_group=self._concurrency_group)
        if self._num_returns == "streaming":
            return refs  # an ObjectRefGenerator
        return refs[0] if self._num_returns == 1 else refs


class ActorHandle:
    def __init__(self, actor_id: ActorID):
        self._actor_id = actor_id
        # Handle GC: per-process 0↔1 transitions reach the head, which
        # kills non-detached actors when every process's count is zero
        # (reference: handle-out-of-scope actor death). CoreWorker._current
        # (not _global_state) so handles held inside worker processes —
        # e.g. a controller actor owning replica handles — count too.
        core = CoreWorker._current
        if core is not None and not core._shutdown:
            core.on_actor_handle_created(actor_id)

    def __del__(self):
        try:
            core = CoreWorker._current
        except Exception:  # interpreter teardown: module globals gone
            return
        if core is not None and not core._shutdown:
            try:
                core.on_actor_handle_deleted(self._actor_id)
            except Exception:  # noqa: BLE001 - never raise from __del__
                pass

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:14]}…)"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id,))

    def _wait_ready(self, timeout=None):
        _core().wait_actor_ready(self._actor_id, timeout)
        return self


class ActorClass:
    def __init__(self, cls, options: Dict[str, Any]):
        self._cls = cls
        self._options = options
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *a, **kw):
        raise TypeError("actor classes must be instantiated with .remote()")

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._options)
        merged.update(opts)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        core = _core()
        actor_id = core.create_actor(
            self._cls, args, kwargs,
            resources=_resources_from_options(self._options),
            name=self._options.get("name") or "",
            max_restarts=self._options.get("max_restarts", 0),
            max_concurrency=self._options.get("max_concurrency", 1),
            strategy=_strategy_from_options(self._options),
            lifetime=self._options.get("lifetime"),
            runtime_env=self._options.get("runtime_env"),
            concurrency_groups=self._options.get("concurrency_groups"),
        )
        return ActorHandle(actor_id)


def method(*, concurrency_group: Optional[str] = None):
    """``@method`` decorator binding an actor method to a named
    concurrency group (reference: ``ray.method(concurrency_group=)``,
    ``concurrency_group_manager.h``). Declare the groups on the class:
    ``@remote(concurrency_groups={"io": 2, "compute": 4})``; calls to a
    bound method run on that group's dedicated thread pool, and
    ``handle.m.options(concurrency_group="io")`` overrides per call.
    (Per-call return counts use ``handle.m.options(num_returns=N)``.)

    NOTE: declaring any concurrency group makes the actor THREADED —
    per-owner FIFO ordering is no longer guaranteed, for ungrouped
    methods too (reference semantics: threaded actors drop ordering).
    Keep strictly order-dependent methods on a separate plain actor."""

    def decorate(fn):
        if concurrency_group is not None:
            fn.__rt_concurrency_group__ = concurrency_group
        return fn

    return decorate


def remote(*args, **options):
    """``@remote`` decorator for functions and classes."""

    def decorate(obj):
        if isinstance(obj, type):
            return ActorClass(obj, options)
        return RemoteFunction(obj, options)

    if len(args) == 1 and not options and callable(args[0]):
        return decorate(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return decorate


def get_actor(name: str, timeout: float = 5.0) -> ActorHandle:
    """Look up a named actor; retries briefly since registration is async."""
    deadline = time.time() + timeout
    while True:
        try:
            meta = _core().head_call("get_named_actor", {"name": name})
            return ActorHandle(ActorID.from_hex(meta["actor_id"]))
        except Exception:
            if time.time() >= deadline:
                raise
            time.sleep(0.05)


def list_actors() -> List[dict]:
    return _core().head_call("list_actors")


def timeline(format: str = "raw") -> List[dict]:
    """Task timeline. ``format="chrome"`` returns chrome://tracing 'X'
    events (one mapping, shared with the dashboard's /api/timeline)."""
    _core().flush_task_events()
    if format == "raw":
        return _core().head_call("get_task_events", {"limit": 100000})
    if format != "chrome":
        raise ValueError(f"unknown timeline format {format!r}")
    return _core().head_call("chrome_trace")


def metrics_text() -> str:
    """Cluster-merged prometheus text exposition (also at the dashboard's
    ``/metrics`` endpoint)."""
    _core().flush_metrics()
    return _core().head_call("metrics_text")["text"]


def dashboard_url() -> Optional[str]:
    """URL of the head's observability HTTP endpoint."""
    return _core().head_call("dashboard_url")["url"]


def state(kind: str = "summary"):
    """State API listing: summary|nodes|workers|actors|placement_groups|
    tasks|objects (reference: ``ray.util.state`` list_* API)."""
    _core().flush_task_events()
    return _core().head_call("state", {"kind": kind})


# --------------------------------------------------------------- placement
class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[dict]):
        self._id = pg_id
        self.bundle_specs = bundles

    def ready(self, timeout: float = 30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = _core().head_call("pg_state", {"pg_id": self._id.hex()})
            if st["state"] == "CREATED":
                return True
            if st["state"] == "REMOVED":
                raise RayTpuError("placement group removed")
            time.sleep(0.02)
        raise TimeoutError("placement group not ready")

    def __reduce__(self):
        return (PlacementGroup, (self._id, self.bundle_specs))


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group: PlacementGroup,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = (
            placement_group_capture_child_tasks)


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime=None) -> PlacementGroup:
    pg_id = PlacementGroupID.from_random()
    payload = {"pg_id": pg_id.hex(), "bundles": bundles, "strategy": strategy,
               "name": name}
    core = _core()

    def _create():
        try:
            core.head_call("create_placement_group", payload, timeout=120)
        except Exception:
            pass

    threading.Thread(target=_create, daemon=True).start()
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup):
    _core().head_call("remove_placement_group", {"pg_id": pg._id.hex()})
