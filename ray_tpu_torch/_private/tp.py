"""Tensor-parallel decode groups: the port's counterpart of the
reference's ``decode_mesh`` (``ray_tpu/_private/jax_compat.py:36-58``)
and ``_tp_mesh`` (``ray_tpu/models/gpt_decode.py:221-237``).

The reference keeps one controller and builds every decode program for
a ``("tp",)`` mesh with ``shard_map``. The port follows Megatron and
vLLM instead: one process per rank, the calling process is rank 0 and
the only controller.

- :func:`decode_group` starts a :class:`DecodeGroup` and caches it per
  ``tp``, as the reference caches its meshes. Ranks 1..tp-1 are follower
  processes (``spawn``, daemonic). The ranks share a backend object of
  their own (gloo, or NCCL with one card per rank) on a ``FileStore`` in
  a temporary directory, never the default process group, so several
  groups live in one process and no port can collide.
- A group call (:meth:`Shards.call`) sends a header down a pipe to each
  follower: the op, the engine id and the call's host inputs (tokens,
  masks, page tables, keys, prompts, drafts, handoff pages), each
  follower's own head slices where :class:`Heads` marks them. Then every
  rank runs the same :mod:`~ray_tpu_torch.models.gpt_decode` function
  over its shard, and the ranks meet in its collectives. Only
  ``broadcast`` and ``all_reduce`` are used: gloo supports no other
  collective on CUDA tensors. Rank 0 returns the replicated result.
- Followers keep each engine's sharded params and pool under the
  engine's id (:class:`Shards`) and drop them when the engine shuts
  down. One lock on rank 0 serialises group calls, and a call from a
  driver whose epoch was retired is refused before anything is sent.
- Every collective has a timeout, so a group that falls out of step
  raises instead of hanging. A follower exits when the group closes
  (at exit, through ``atexit``) and when its parent's end of the pipe
  closes, which is also what happens when the parent dies.
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import inspect
import itertools
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence)

import numpy as np
import torch
import torch.distributed as dist

from ..models import gpt_decode
from ..models.gpt import GPTConfig, Params
from ..ops import paged_attention
from .device import DeviceLike, resolve_device, set_matmul_precision

#: Seconds a collective, and a group's rendezvous, waits before raising.
TIMEOUT_S = 120.0
#: Seconds a follower may take to start (spawn, import torch, reach its
#: device) before it joins the rendezvous; several test processes may
#: be starting at once.
START_TIMEOUT_S = 300.0
#: Intra-op threads of a follower: several test processes share a host.
FOLLOWER_THREADS = 2
BACKENDS = ("gloo", "nccl")

_GROUPS: Dict[int, "DecodeGroup"] = {}
_GROUPS_LOCK = threading.Lock()
_ENGINE_IDS = itertools.count(1)


class GroupCallRefused(RuntimeError):
    """A group call from a driver whose epoch was retired, or from an
    engine that shut down: refused before any rank saw it."""


class Heads(NamedTuple):
    """A host array in the canonical layout whose axis ``axis`` holds
    every head: each rank receives only its own ``n_head / tp`` heads."""

    array: np.ndarray
    axis: int

    def rank_slice(self, rank: int, size: int) -> np.ndarray:
        a = np.asarray(self.array)
        n = a.shape[self.axis] // size
        idx = [slice(None)] * a.ndim
        idx[self.axis] = slice(rank * n, (rank + 1) * n)
        return np.ascontiguousarray(a[tuple(idx)])


# ------------------------------------------------------------ validation
def tp_validate(cfg: GPTConfig, tp: int, device: DeviceLike = None) -> int:
    """Check a (cfg, tp) pairing (``gpt_decode.py:221``) and return
    ``tp``. tp=1 needs nothing. Otherwise MoE configs and widths that
    ``tp`` does not divide raise ``ValueError``; given the engine's
    ``device``, a CUDA one with fewer visible cards than ranks raises
    ``RuntimeError``, unless a group for ``tp`` was registered with
    explicit devices."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return tp
    if cfg.n_experts > 0:
        raise ValueError(
            f"tensor-parallel decode (tp={tp}) does not support MoE "
            f"configs (n_experts={cfg.n_experts}): moe_ffn is not "
            f"tp-aware")
    if cfg.n_head % tp or cfg.d_ff % tp or cfg.d_model % tp:
        raise ValueError(
            f"tp={tp} must divide n_head={cfg.n_head}, d_ff={cfg.d_ff} "
            f"and d_model={cfg.d_model}")
    if device is not None and torch.device(device).type == "cuda" \
            and _live(tp) is None:
        _default_cuda_devices(tp)
    return tp


def _default_cuda_devices(tp: int) -> tuple:
    n = torch.cuda.device_count()
    if n < tp:
        raise RuntimeError(
            f"tp={tp} needs {tp} CUDA devices but only {n} are visible; "
            f"to place several ranks on one card, register the group "
            f"first: decode_group({tp}, devices=('cuda:0',) * {tp}, "
            f"backend='gloo')")
    return tuple(f"cuda:{i}" for i in range(tp))


def _live(tp: int) -> Optional["DecodeGroup"]:
    g = _GROUPS.get(tp)
    return None if g is None or g.closed else g


# ----------------------------------------------------------------- groups
def decode_group(tp: int, devices: Optional[Sequence[DeviceLike]] = None,
                 backend: Optional[str] = None, *,
                 device: DeviceLike = None) -> "DecodeGroup":
    """The started group for ``tp`` ranks, cached per ``tp``.

    ``devices`` are the ranks' devices, rank 0's first; by default
    ``cuda:0..tp-1`` with NCCL, or all ``"cpu"`` with gloo when
    ``device`` (the engine's) is the CPU. A caller may register a group
    first, e.g. ``decode_group(2, devices=("cuda:0", "cuda:0"),
    backend="gloo")`` (NCCL refuses two ranks on one card); an engine
    asking for ``tp=2`` then finds it here. A cached group that closed
    is replaced by one on the same devices."""
    tp = int(tp)
    if tp < 2:
        raise ValueError(f"a decode group has at least 2 ranks, got {tp}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}")
    with _GROUPS_LOCK:
        g = _GROUPS.get(tp)
        want = None if devices is None else \
            tuple(str(torch.device(d)) for d in devices)
        if g is not None and not g.closed:
            if want not in (None, g.devices) or \
                    backend not in (None, g.backend):
                raise ValueError(
                    f"a tp={tp} group on {g.devices} ({g.backend}) is "
                    f"already running")
            return g
        if want is None and g is not None:
            want, backend = g.devices, g.backend
        elif want is None:
            want = ("cpu",) * tp if resolve_device(device).type == "cpu" \
                else _default_cuda_devices(tp)
        if len(want) != tp:
            raise ValueError(f"tp={tp} needs {tp} devices, got {want}")
        cuda = [torch.device(d).type == "cuda" for d in want]
        if backend is None:
            backend = "nccl" if all(cuda) and len(set(want)) == tp \
                else "gloo"
        if backend == "nccl" and not (all(cuda) and len(set(want)) == tp):
            raise ValueError("nccl needs one distinct CUDA device per rank")
        g = _GROUPS[tp] = DecodeGroup(want, backend, TIMEOUT_S)
        return g


def _new_backend(path: str, rank: int, size: int, backend: str,
                 timeout: datetime.timedelta):
    """This rank's backend object on the group's own ``FileStore``."""
    store = dist.FileStore(path, size)
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = timeout
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        return dist.ProcessGroupGloo(store, rank, size, opts)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    return dist.ProcessGroupNCCL(store, rank, size, opts)


class _Collectives:
    """The two collectives of one rank, each bounded by the timeout."""

    def __init__(self, pg, rank: int, size: int, device: torch.device,
                 timeout: datetime.timedelta):
        self.pg, self.rank, self.size = pg, rank, size
        self.device, self.timeout = device, timeout

    def _wait(self, work) -> None:
        work.wait()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; every rank gets the
        same result."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        opts.timeout = self.timeout
        self._wait(self.pg.allreduce([t], opts))
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` into every rank's ``t``, in place, as
        bytes (exact, and any dtype)."""
        if not t.is_contiguous():
            raise ValueError("broadcast needs a contiguous tensor")
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = src, 0
        opts.timeout = self.timeout
        self._wait(self.pg.broadcast([t.reshape(-1).view(torch.uint8)],
                                     opts))
        return t

    def gather_heads(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's head slice ``t``, concatenated on ``axis`` in rank
        order: one broadcast per rank, exact."""
        t = t.contiguous()
        parts = [self.broadcast(t if r == self.rank else torch.empty_like(t),
                                r) for r in range(self.size)]
        return torch.cat(parts, dim=axis)

    def broadcast_object(self, obj, src: int):
        """A picklable object from rank ``src`` to every rank."""
        data = pickle.dumps(obj) if self.rank == src else b""
        n = self.broadcast(torch.tensor([len(data)], dtype=torch.int64,
                                        device=self.device), src)
        buf = torch.zeros(int(n.item()), dtype=torch.uint8,
                          device=self.device)
        if self.rank == src:
            buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        return pickle.loads(self.broadcast(buf, src).cpu().numpy()
                            .tobytes())


class DecodeGroup(_Collectives):
    """Rank 0 of a started group: this process's backend object, the
    follower processes and a pipe to each. ``lock`` serialises group
    calls. Made by :func:`decode_group`; closed at exit."""

    def __init__(self, devices: Sequence[str], backend: str,
                 timeout_s: float):
        self.devices, self.backend = tuple(devices), backend
        self.lock = threading.Lock()
        self.closed = False
        self._procs: list = []
        self._conns: list = []
        self._dir = tempfile.mkdtemp(prefix="rt-torch-tp-")
        timeout = datetime.timedelta(seconds=timeout_s)
        path = os.path.join(self._dir, "store")
        size = len(self.devices)
        ctx = multiprocessing.get_context("spawn")
        try:
            for r in range(1, size):
                here, there = ctx.Pipe()
                p = ctx.Process(
                    target=_follower_main, daemon=True,
                    name=f"rt-torch-tp{size}-rank{r}",
                    args=(path, r, self.devices, backend, timeout_s, there))
                p.start()
                there.close()
                self._procs.append(p)
                self._conns.append(here)
            # Rendezvous only once every follower runs, so that the
            # collective timeout need not cover a process's start.
            for r, conn in enumerate(self._conns, start=1):
                try:
                    ready = pickle.loads(conn.recv_bytes()) \
                        if conn.poll(START_TIMEOUT_S) else "no sign of life"
                except EOFError:
                    ready = "it exited"
                if ready != "ready":
                    raise RuntimeError(f"follower {r} did not start within "
                                       f"{START_TIMEOUT_S:.0f} s: {ready}")
            super().__init__(_new_backend(path, 0, size, backend, timeout),
                             0, size, torch.device(self.devices[0]), timeout)
        except BaseException:
            self.close()
            raise
        atexit.register(self.close)

    @property
    def pids(self) -> List[int]:
        """The followers' process ids."""
        return [p.pid for p in self._procs]

    def _wait(self, work) -> None:
        try:
            work.wait()
        except RuntimeError as e:
            self._fail(e)

    def _send(self, msg) -> None:
        """One header to every follower; ``msg`` is the header or a
        function of the follower's rank that makes it. The caller holds
        ``lock``."""
        if self.closed:
            raise RuntimeError(f"the tp={len(self.devices)} group is closed")
        for r, conn in enumerate(self._conns, start=1):
            m = msg(r) if callable(msg) else msg
            try:
                conn.send_bytes(pickle.dumps(m, pickle.HIGHEST_PROTOCOL))
            except OSError as e:
                self._fail(e)

    def _fail(self, exc: BaseException):
        """A collective or a pipe failed: gather what the followers
        reported, close the group and raise."""
        reports = []
        for conn in self._conns:
            try:
                while conn.poll():
                    reports.append(pickle.loads(conn.recv_bytes()))
            except (EOFError, OSError):
                pass
        self.close()
        raise RuntimeError(
            f"tensor-parallel group on {self.devices} failed and was "
            f"closed: {exc}" + "".join(f"\n{r}" for r in reports)) from exc

    def probe(self, reset: bool = False) -> List[dict]:
        """Each follower's report, over the group: the top-level modules
        it has imported and its K1 launch count (zeroed after reading
        with ``reset``)."""
        with self.lock:
            self._send(("probe", bool(reset)))
            return [self.broadcast_object(None, r)
                    for r in range(1, self.size)]

    def all_reduce_ms(self, shape: Sequence[int], n: int) -> float:
        """Host ms of one f32 all-reduce of ``shape`` on the group's
        devices, completion included: ``n`` back to back, every rank
        taking part, on rank 0's clock."""
        t = torch.zeros(tuple(shape), dtype=torch.float32,
                        device=self.device)
        cuda = self.device.type == "cuda"
        with self.lock:
            self._send(("reduce", tuple(shape), int(n)))
            self.all_reduce(t)                        # in step first
            if cuda:
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            for _ in range(n):
                self.all_reduce(t)
            if cuda:
                torch.cuda.synchronize(self.device)
            return (time.perf_counter() - t0) * 1e3 / n

    def close(self) -> None:
        """Stop the followers (each leaves its loop and exits; one that
        has not within 5 s is terminated) and remove the store's
        directory. Idempotent."""
        if self.closed:
            return
        self.closed = True
        # Dropping rank 0's backend ends a follower's pending collective.
        self.pg = None
        for conn in self._conns:
            try:
                conn.send_bytes(pickle.dumps(("close",)))
            except OSError:
                pass
        for p in self._procs:
            p.join(5.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)


# ----------------------------------------------------- one engine's state
def _params_of(name: str) -> Mapping[str, inspect.Parameter]:
    return inspect.signature(getattr(gpt_decode, name)).parameters


def _head(name: str) -> int:
    """How many leading arguments of ``gpt_decode.<name>`` are a rank's
    own state: ``(params, cache)``, or ``(cache,)`` for the KV
    export/import functions."""
    return 2 if next(iter(_params_of(name))) == "params" else 1


def _for_rank(x, rank: int, size: int):
    """A call argument as rank ``rank`` receives it."""
    if isinstance(x, Heads):
        return x.rank_slice(rank, size)
    if isinstance(x, torch.Tensor) and rank:
        return x.detach().cpu()          # pickled by value, moved back
    return x


@contextlib.contextmanager
def _closing_on_error(group: DecodeGroup):
    """Close ``group`` when the body raises, then re-raise. Once a call
    was sent, the followers may be waiting in a collective that rank 0
    will never join; a group used halfway must not serve the next call
    (the engine replaces a closed group at its next pool build)."""
    try:
        yield
    except BaseException:
        group.close()
        raise


class Shards:
    """Rank 0's handle on one engine's state across a group: the
    followers hold the engine's sharded params (:meth:`load`, sent by
    broadcast, each rank keeping its slice) and its pool
    (:meth:`build`) under the engine's id; rank 0 holds its own in
    ``params`` and ``cache``. :meth:`call` runs a ``gpt_decode``
    function on every rank. ``stale()`` is asked, under the group's
    lock, before each call is sent."""

    def __init__(self, group: DecodeGroup, cfg: GPTConfig, params: Params,
                 device: torch.device,
                 stale: Callable[[], bool] = lambda: False):
        if torch.device(group.devices[0]).type != device.type:
            raise ValueError(
                f"the tp={group.size} group's rank 0 runs on "
                f"{group.devices[0]}, this engine on {device}")
        self.group, self.cfg, self.device = group, cfg, device
        self.stale = stale
        self.eid: Optional[int] = None
        self.params: Optional[Params] = None
        self.cache = None
        self.load(params)

    def load(self, params: Params) -> None:
        """Send the full ``params`` to every follower, one broadcast a
        tensor, and keep rank 0's shard."""
        g = self.group
        eid = next(_ENGINE_IDS)
        specs = [(k, tuple(v.shape), v.dtype) for k, v in params.items()]
        with g.lock, _closing_on_error(g):
            g._send(("load", eid, self.cfg, specs))
            for v in params.values():
                g.broadcast(v.contiguous(), 0)
        self.params = gpt_decode.shard_params(params, self.cfg, g.size, 0)
        self.eid = eid

    def build(self, fn_name: str, **kw):
        """(Re)build the pool on every rank: ``gpt_decode.<fn_name>(...,
        tp=size)`` on each rank's device. Returns rank 0's pool."""
        g = self.group
        kw = dict(kw, tp=g.size)
        with g.lock:
            g._send(("pool", self.eid, fn_name, kw))
        self.cache = None
        self.cache = getattr(gpt_decode, fn_name)(device=self.device, **kw)
        return self.cache

    def call(self, name: str, *args, **kw):
        """``gpt_decode.<name>(*args, **kw)`` on every rank, ``args``
        as rank 0 passes them (its own params and pool first); followers
        put theirs in their place and take their :class:`Heads` slices.
        Returns rank 0's result."""
        g = self.group
        if "group" in _params_of(name):
            kw = dict(kw, group=g)
        with g.lock:
            if self.eid is None or self.stale():
                raise GroupCallRefused(
                    f"{name}: the engine shut down or its driver's epoch "
                    f"was retired")
            rest = args[_head(name):]
            with _closing_on_error(g):
                g._send(lambda r: (
                    "call", self.eid, name,
                    [_for_rank(a, r, g.size) for a in rest],
                    {k: _for_rank(v, r, g.size) for k, v in kw.items()
                     if k != "group"}))
                return getattr(gpt_decode, name)(
                    *[_for_rank(a, 0, g.size) for a in args],
                    **{k: _for_rank(v, 0, g.size) for k, v in kw.items()})

    def drop(self) -> None:
        """The followers forget this engine (params and pool)."""
        g = self.group
        with g.lock:
            if self.eid is not None and not g.closed:
                g._send(("drop", self.eid))
            self.eid = None


# -------------------------------------------------------------- followers
class _Engine:
    def __init__(self, params: Params):
        self.params, self.cache = params, None


def _follower_main(path: str, rank: int, devices: Sequence[str],
                   backend: str, timeout_s: float, conn) -> None:
    """A follower's life: join the group, then serve headers until the
    group closes or the parent's end of the pipe does. A failing op is
    reported on the pipe and ends the follower, which unblocks rank 0's
    pending collective."""
    torch.set_num_threads(FOLLOWER_THREADS)
    dev = torch.device(devices[rank])
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        set_matmul_precision(dev)
    except Exception:  # noqa: BLE001 - reported to rank 0, then exit
        conn.send_bytes(pickle.dumps(traceback.format_exc()))
        return
    conn.send_bytes(pickle.dumps("ready"))
    timeout = datetime.timedelta(seconds=timeout_s)
    size = len(devices)
    member = _Collectives(_new_backend(path, rank, size, backend, timeout),
                          rank, size, dev, timeout)
    engines: Dict[int, _Engine] = {}
    while True:
        try:
            msg = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            return                       # the parent closed or died
        if msg[0] == "close":
            return
        try:
            _serve(msg, engines, member)
        except Exception:  # noqa: BLE001 - reported to rank 0, then exit
            try:
                conn.send_bytes(pickle.dumps(
                    f"rank {rank}: {traceback.format_exc()}"))
            except OSError:
                pass
            return


def _serve(msg, engines: Dict[int, _Engine], member: _Collectives) -> None:
    op, dev = msg[0], member.device
    if op == "load":
        _, eid, cfg, specs = msg
        params = {}
        for name, shape, dtype in specs:
            full = member.broadcast(torch.empty(shape, dtype=dtype,
                                                device=dev), 0)
            params[name] = gpt_decode.shard_tensor(name, full, member.size,
                                                   member.rank)
        engines[eid] = _Engine(params)
    elif op == "pool":
        _, eid, fn_name, kw = msg
        eng = engines[eid]
        eng.cache = None                 # free the old pool first
        eng.cache = getattr(gpt_decode, fn_name)(device=dev, **kw)
    elif op == "call":
        _, eid, name, args, kw = msg
        eng = engines[eid]
        args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in args]
        kw = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
        head = (eng.params, eng.cache)[2 - _head(name):]
        if "group" in _params_of(name):
            kw = dict(kw, group=member)
        getattr(gpt_decode, name)(*head, *args, **kw)
    elif op == "drop":
        engines.pop(msg[1], None)
    elif op == "reduce":
        t = torch.zeros(msg[1], dtype=torch.float32, device=dev)
        for _ in range(msg[2] + 1):
            member.all_reduce(t)
    elif op == "probe":
        report = {"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "k1_launches": paged_attention.launches}
        if msg[1]:
            paged_attention.launches = 0
        for r in range(1, member.size):
            member.broadcast_object(report if r == member.rank else None, r)
    else:
        raise ValueError(f"unknown group op {op!r}")
