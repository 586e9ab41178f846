"""Collective communication API: the port of
``ray_tpu/collective/collective.py``.

The reference's hot backend, ``XlaMeshGroup`` (``collective.py:64-193``),
is one mesh axis addressed by a single controller. The port is
multi-controller, as PyTorch trains: every rank is a process and calls
the same op with its own tensor (the reference's ``StoreGroup``
semantics, ``collective.py:195``). :class:`MeshGroup` wraps a
``torch.distributed`` process group: the whole world, or the ranks of a
mesh that differ only along some of its axes
(:meth:`ray_tpu_torch.parallel.mesh.Mesh.group`).

Transport (decided here and nowhere else): NCCL runs every op natively.
gloo runs every op natively on CPU tensors, but on CUDA tensors it
carries only ``all_reduce`` and ``broadcast``; there the other ops are
built from those two (all-gather and all-to-all as one broadcast per
rank, reduce-scatter as an all-reduce and a slice) and point-to-point
ops are staged through host memory. ``stats["built"]`` counts each such
op. Nothing moves a tensor to a device its caller did not choose: the
result lies where the input did.

Every group has a timeout (:data:`TIMEOUT_S`, or the caller's): an op
that a rank never joins raises on the others instead of hanging.

:class:`StoreGroup` (``collective.py:195-500``, ``backend="store"``) is
the cross-actor group over the port's runtime: the head's KV and the
object store, with no process group at all. It carries host-side and
control data between actors (rendezvous, weight broadcast), numpy arrays
and torch tensors alike.
"""
from __future__ import annotations

import datetime
import threading
import time
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

#: Seconds a group's ops wait for every rank before raising.
TIMEOUT_S = 120.0

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}

# Keyed by (group_name, rank), as the reference's registry.
_groups: Dict[tuple, "BaseGroup"] = {}
_lock = threading.Lock()

# The two names torch has used for the flat-tensor collectives.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class BaseGroup:
    """The reference's group surface (``collective.py:33-61``)."""

    def __init__(self, name: str, world_size: int, rank: int):
        self.name = name
        self.world_size = world_size
        self.rank = rank

    def allreduce(self, x, op="sum"):
        raise NotImplementedError

    def allgather(self, x):
        raise NotImplementedError

    def reducescatter(self, x, op="sum"):
        raise NotImplementedError

    def alltoall(self, x):
        raise NotImplementedError

    def broadcast(self, x, src_rank=0):
        raise NotImplementedError

    def barrier(self):
        raise NotImplementedError

    def send(self, x, dst_rank: int, tag: int = 0):
        raise NotImplementedError

    def recv(self, shape=None, dtype=None, src_rank: int = 0, tag: int = 0):
        raise NotImplementedError

    def destroy(self, local_only: bool = False):
        pass


def new_process_group(ranks: Sequence[int],
                      timeout_s: float = TIMEOUT_S):
    """A process group over the global ``ranks`` (sorted), made by its
    members only, with ``timeout_s`` on every op."""
    return dist.new_group(sorted(ranks),
                          timeout=datetime.timedelta(seconds=timeout_s),
                          use_local_synchronization=True)


class MeshGroup(BaseGroup):
    """SPMD group over a ``torch.distributed`` process group: each rank
    passes its own tensor. ``ranks`` are the members' global ranks in
    group order (sorted); ``rank`` is this process's index among them.
    Results are new tensors on the input's device; inputs are not
    modified.

    - ``allreduce(x, op)``: ``op`` in sum/max/min over the ranks.
    - ``allgather(x)``: every rank's ``x`` concatenated on dim 0.
    - ``reducescatter(x, op)``: the reduction of ``x`` split into
      ``world_size`` pieces on dim 0, this rank's piece.
    - ``alltoall(x)``: ``x [world_size, ...]``; row ``j`` of the result
      is row ``rank`` of rank ``j``'s ``x``.
    - ``broadcast(x, src_rank)``: rank ``src_rank``'s ``x``, exact bytes.
    - ``permute(x, shift)``: rank ``(rank - shift) % world_size``'s
      ``x`` (each rank sends to ``rank + shift``): the ring step
      (``lax.ppermute``).
    - ``send``/``recv``: point to point; ``recv`` needs shape and dtype.
    """

    def __init__(self, name: str, pg, ranks: Sequence[int],
                 device: torch.device):
        ranks = tuple(int(r) for r in ranks)
        if list(ranks) != sorted(ranks):
            raise ValueError(f"group ranks must be sorted, got {ranks}")
        super().__init__(name, len(ranks), ranks.index(dist.get_rank()))
        self.pg, self.ranks, self.device = pg, ranks, torch.device(device)
        self.backend = dist.get_backend(pg)
        self.stats = {"ops": 0, "built": 0, "bytes": 0}

    # -- transport --------------------------------------------------------
    def _native(self, x: torch.Tensor) -> bool:
        return self.backend != "gloo" or x.device.type == "cpu"

    def _count(self, x: torch.Tensor, built: bool = False) -> None:
        self.stats["ops"] += 1
        self.stats["built"] += int(built)
        self.stats["bytes"] += x.numel() * x.element_size()

    @staticmethod
    def _flat(x: torch.Tensor) -> torch.Tensor:
        return x.detach().contiguous()

    def _bcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """In-place broadcast of ``t`` from group rank ``src``, as bytes."""
        dist.broadcast(t.view(-1).view(torch.uint8), src=self.ranks[src],
                       group=self.pg)
        return t

    # -- collectives ------------------------------------------------------
    def allreduce(self, x, op="sum"):
        out = self._flat(x).clone()
        self._count(out)
        dist.all_reduce(out, op=_OPS[op], group=self.pg)
        return out

    def allgather(self, x):
        x = self._flat(x)
        n = self.world_size
        if self._native(x):
            self._count(x)
            out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            _all_gather(out, x, group=self.pg)
            return out
        self._count(x, built=True)
        return torch.cat([self._bcast(x.clone() if r == self.rank else
                                      torch.empty_like(x), r)
                          for r in range(n)])

    def reducescatter(self, x, op="sum"):
        x = self._flat(x)
        n = self.world_size
        if x.shape[0] % n:
            raise ValueError(f"dim 0 ({x.shape[0]}) is not divisible by "
                             f"the group's {n} ranks")
        if self._native(x) and op == "sum":
            self._count(x)
            out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            _reduce_scatter(out, x, op=_OPS[op], group=self.pg)
            return out
        # No max/min reduce-scatter in torch, and none on gloo's CUDA
        # path: reduce everywhere, keep this rank's piece.
        full = self._flat(x).clone()
        self._count(full, built=True)
        dist.all_reduce(full, op=_OPS[op], group=self.pg)
        return full.chunk(n)[self.rank].clone()

    def alltoall(self, x):
        x = self._flat(x)
        n = self.world_size
        if x.shape[0] != n:
            raise ValueError(f"alltoall needs dim 0 == {n} ranks, got "
                             f"{tuple(x.shape)}")
        if self._native(x):
            self._count(x)
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.pg)
            return out
        self._count(x, built=True)
        rows = []
        for r in range(n):
            buf = self._bcast(x.clone() if r == self.rank else
                              torch.empty_like(x), r)
            rows.append(buf[self.rank])
        return torch.stack(rows)

    def broadcast(self, x, src_rank=0):
        out = self._flat(x).clone()
        self._count(out)
        return self._bcast(out, src_rank)

    def barrier(self):
        self.allreduce(torch.zeros(1, device=self.device))

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the host when gloo must carry it there."""
        return x if self._native(x) else x.cpu()

    def permute(self, x, shift: int = 1):
        x = self._flat(x)
        n = self.world_size
        if n == 1 or shift % n == 0:
            return x.clone()
        built = not self._native(x)
        self._count(x, built=built)
        send = self._staged(x)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send,
                          self.ranks[(self.rank + shift) % n], self.pg),
               dist.P2POp(dist.irecv, recv,
                          self.ranks[(self.rank - shift) % n], self.pg)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(x.device) if built else recv

    def send(self, x, dst_rank: int, tag: int = 0):
        x = self._flat(x)
        self._count(x, built=not self._native(x))
        dist.send(self._staged(x), dst=self.ranks[dst_rank], group=self.pg,
                  tag=tag)

    def recv(self, shape=None, dtype=None, src_rank: int = 0, tag: int = 0):
        if shape is None or dtype is None:
            raise ValueError("recv needs the shape and dtype it receives")
        out = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        self._count(out, built=not self._native(out))
        buf = self._staged(out)
        dist.recv(buf, src=self.ranks[src_rank], group=self.pg, tag=tag)
        return out.copy_(buf) if buf is not out else out

    def destroy(self, local_only: bool = False):
        """Drop this rank's handle on the process group (never the
        default group, which its owner destroys)."""
        if self.pg is not None and self.pg is not dist.group.WORLD:
            dist.destroy_process_group(self.pg)
        self.pg = None


class StoreGroup(BaseGroup):
    """Cross-actor SPMD group over the head KV and the object store
    (``collective.py:195``): every member calls the same op with its own
    data; slots rendezvous through the KV.

    Payloads up to :data:`INLINE_MAX` bytes ride the KV inline; larger
    ones go into the object store once and only the (object id, owner)
    pair crosses the KV, receivers pulling the object (torch tensors out
    of band, as the runtime's serialization carries them). Every
    :data:`SYNC_EVERY` generations the ranks rendezvous, which bounds
    their skew, and each rank deletes its own publications
    :data:`GC_LAG` generations behind.

    A group name is single-incarnation: destroy it before re-creating a
    same-named group. The group instance must outlive in-flight
    consumption (its held refs keep published objects alive): create
    groups through :func:`init_collective_group`, whose registry owns
    them until :func:`destroy_collective_group`.

    Results: numpy for numpy (or scalar) inputs, READ-ONLY zero-copy
    views when they came through the store (copy before mutating in
    place); a tensor on the input's device for a tensor input.
    """

    #: inline-in-KV threshold; larger payloads ride the object store
    INLINE_MAX = 4096
    #: full rendezvous every N generations
    SYNC_EVERY = 8
    #: publications are retained this many generations
    GC_LAG = 16
    #: default wait for a peer's publication (``fetch_timeout_s``)
    DEFAULT_FETCH_TIMEOUT_S = 120.0

    def __init__(self, name: str, world_size: int, rank: int,
                 fetch_timeout_s: Optional[float] = None):
        super().__init__(name, world_size, rank)
        from ..core.worker import CoreWorker

        self.fetch_timeout_s = (self.DEFAULT_FETCH_TIMEOUT_S
                                if fetch_timeout_s is None
                                else float(fetch_timeout_s))
        self._core = CoreWorker.current()
        self._gen = 0
        self._p2p_seq: Dict[tuple, int] = {}
        self._own_slots: Dict[int, list] = {}   # gen -> [kv keys]
        self._held: Dict[int, list] = {}        # gen -> [ObjectRefs]
        # kv bytes / store transfer counts
        self.stats = {"kv_bytes_out": 0, "kv_bytes_in": 0,
                      "store_puts": 0, "store_gets": 0}

    # -- KV helpers -------------------------------------------------------
    def _kv_put(self, key: str, value: bytes):
        self._core.kv_put(key, value, ns="collective")

    def _kv_get(self, key: str, timeout: Optional[float] = None) -> bytes:
        timeout = self.fetch_timeout_s if timeout is None else timeout
        deadline = time.time() + timeout
        while time.time() < deadline:
            out = self._core.kv_get(key, ns="collective")
            if out is not None:
                return out
            time.sleep(0.002)
        raise TimeoutError(f"collective kv wait: {key}")

    def _slot(self, gen: int, what: str, rank: int, tag: int = 0) -> str:
        return f"__coll__/{self.name}/{gen}/{what}/{tag}/{rank}"

    # -- generation / GC --------------------------------------------------
    def _next_gen(self) -> int:
        """Claim the next generation; every SYNC_EVERY generations all
        ranks rendezvous, which bounds skew below SYNC_EVERY and lets
        :meth:`_gc` run without per-op acknowledgements."""
        gen = self._gen
        self._gen += 1
        if gen and gen % self.SYNC_EVERY == 0:
            key = self._slot(gen, "sy", self.rank)
            self._kv_put(key, b"1")
            self._own_slots.setdefault(gen, []).append(key)
            for r in range(self.world_size):
                self._kv_get(self._slot(gen, "sy", r))
            self._gc(gen)
        return gen

    def _gc(self, gen: int):
        """Delete this rank's publications older than GC_LAG generations
        and drop their held refs (every peer is past them)."""
        horizon = gen - self.GC_LAG
        for g in [g for g in self._own_slots if g <= horizon]:
            for key in self._own_slots.pop(g):
                try:
                    self._core.kv_del(key, ns="collective")
                except Exception:  # noqa: BLE001 - hygiene only
                    pass
            self._held.pop(g, None)

    # -- payload transport ------------------------------------------------
    def _publish(self, gen: int, what: str, x, tag: int = 0):
        """This rank's payload for (gen, what): inline in the KV when
        small, else one object in the store whose id crosses the KV."""
        import pickle

        nbytes = _nbytes(x)
        raw = _encode(x) if nbytes is None or nbytes <= self.INLINE_MAX \
            else None
        if raw is not None and len(raw) <= self.INLINE_MAX:
            payload = pickle.dumps(("inline", raw))
        else:
            ref = self._core.put(x)
            self._held.setdefault(gen, []).append(ref)
            self.stats["store_puts"] += 1
            payload = pickle.dumps(
                ("ref", ref.object_id.binary(), ref.owner_address))
        key = self._slot(gen, what, self.rank, tag)
        self._kv_put(key, payload)
        self.stats["kv_bytes_out"] += len(payload)
        self._own_slots.setdefault(gen, []).append(key)

    def _fetch(self, gen: int, what: str, rank: int, tag: int = 0,
               timeout: Optional[float] = None):
        import pickle

        from .._private.ids import ObjectID
        from ..core.worker import ObjectRef

        blob = self._kv_get(self._slot(gen, what, rank, tag), timeout)
        self.stats["kv_bytes_in"] += len(blob)
        rec = pickle.loads(blob)
        if rec[0] == "inline":
            return _decode(rec[1])
        _, oid_bytes, owner = rec
        oid = ObjectID(oid_bytes)
        # A remote owner's object: borrow before materialising the
        # counted ref, whose death pays the borrow back; the publisher's
        # held ref keeps the object alive GC_LAG generations. Own
        # objects skip the borrow (an owner's ref deaths never pay one).
        if owner != self._core.address:
            self._core.refs.acquire_borrow(oid, owner)
        self.stats["store_gets"] += 1
        return self._core.get(ObjectRef(oid, owner))

    # -- collectives ------------------------------------------------------
    def allreduce(self, x, op="sum"):
        """Binomial-tree reduce to rank 0, then a store broadcast down:
        at most log2(W) + 1 payload transfers a rank."""
        gen = self._next_gen()
        part = _array(x, x)
        mask = 1
        while mask < self.world_size:
            if self.rank & mask:
                # lowest set bit: hand the partial to the peer with that
                # bit clear, then await the broadcast
                self._publish(gen, "rd", part)
                break
            peer = self.rank | mask
            if peer < self.world_size:
                part = _combine(part, _array(self._fetch(gen, "rd", peer),
                                             x), op)
            mask <<= 1
        if self.rank == 0:
            self._publish(gen, "bc", part)
            return part
        return _array(self._fetch(gen, "bc", 0), x)

    def allgather(self, x):
        gen = self._next_gen()
        self._publish(gen, "ag", x)
        return _concat([_array(self._fetch(gen, "ag", r), x)
                        for r in range(self.world_size)])

    def reducescatter(self, x, op="sum"):
        full = self.allreduce(x, op)
        return _split(full, self.world_size)[self.rank]

    def broadcast(self, x, src_rank=0):
        """src puts the payload once; every receiver pulls it: a rank's
        KV traffic is one small ref record."""
        gen = self._next_gen()
        if self.rank == src_rank:
            self._publish(gen, "bc", x)
            return x
        out = self._fetch(gen, "bc", src_rank)
        return out if x is None else _array(out, x)

    def barrier(self):
        # the reduce tree with a scalar token: O(log W) small messages
        self.allreduce(0.0)

    def _p2p_key(self, src: int, dst: int, tag: int, seq: int) -> str:
        return f"__coll__/{self.name}/p2p/{src}>{dst}/{tag}/{seq}"

    def send(self, x, dst_rank: int, tag: int = 0):
        k = (self.rank, dst_rank, tag)
        seq = self._p2p_seq.get(k, 0)
        self._p2p_seq[k] = seq + 1
        self._kv_put(self._p2p_key(self.rank, dst_rank, tag, seq), _encode(x))

    def recv(self, shape=None, dtype=None, src_rank: int = 0, tag: int = 0):
        k = (src_rank, self.rank, tag)
        seq = self._p2p_seq.get(k, 0)
        self._p2p_seq[k] = seq + 1
        key = self._p2p_key(src_rank, self.rank, tag, seq)
        val = _decode(self._kv_get(key))
        self._core.kv_del(key, ns="collective")  # consume
        return val

    def _is_own_key(self, key: str) -> bool:
        """Keys of this rank's lifecycle: slots it published (ending in
        ``/{rank}``) and p2p messages it consumes (``{src}>{rank}``); a
        message it sent belongs to its receiver."""
        parts = key.split("/")
        if len(parts) > 2 and parts[2] == "p2p":
            _src, _, dst = parts[3].partition(">")
            return dst == str(self.rank)
        return parts[-1] == str(self.rank)

    def destroy(self, local_only: bool = False):
        """Delete the group's keys (``local_only``: only this rank's) and
        drop the held refs, which frees the published objects."""
        for key in self._core.kv_keys(f"__coll__/{self.name}/",
                                      ns="collective"):
            if local_only and not self._is_own_key(key):
                continue
            try:
                self._core.kv_del(key, ns="collective")
            except Exception:  # noqa: BLE001
                pass
        self._own_slots.clear()
        self._held.clear()


def _nbytes(x) -> Optional[int]:
    """A cheap size estimate, so a large payload is not serialised just
    to learn that it is over the inline threshold."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (bytes, bytearray)):
        return len(x)
    return getattr(x, "nbytes", None)


def _encode(x) -> bytes:
    """One blob of the runtime's serialization (tensors of any dtype,
    bf16 included, bit for bit)."""
    from .._private import serialization as ser

    return ser.pack_frames(ser.get_context().serialize(x))


def _decode(b) -> Any:
    from .._private import serialization as ser

    return ser.get_context().deserialize(ser.unpack_frames(b))


def _array(v, like):
    """``v`` as ``like``'s kind: a tensor on ``like``'s device, else a
    numpy array."""
    import numpy as np

    if isinstance(like, torch.Tensor):
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        return v.to(like.device)
    return np.asarray(v)


def _concat(parts):
    import numpy as np

    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


def _split(full, n: int):
    import numpy as np

    if isinstance(full, torch.Tensor):
        return full.chunk(n)
    return np.split(full, n)


def _combine(a, b, op: str):
    import numpy as np

    if isinstance(a, torch.Tensor):
        fns = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}
    else:
        fns = {"sum": np.add, "max": np.maximum, "min": np.minimum}
    if op not in fns:
        raise ValueError(op)
    return fns[op](a, b)


# ---------------------------------------------------------------- module API
def init_collective_group(world_size: int, rank: int, *,
                          backend: Optional[str] = None,
                          group_name: str = "default",
                          mesh=None, axis: str = "dp",
                          fetch_timeout_s: Optional[float] = None,
                          device=None) -> BaseGroup:
    """Join/declare a collective group (reference ``collective.py:503``).

    ``backend="store"`` makes a :class:`StoreGroup` of ``world_size``
    ranks over the runtime (no process group; ``fetch_timeout_s`` bounds
    each wait for a peer). Otherwise (the default; the reference's
    default is ``"store"``) a :class:`MeshGroup` over ``torch.distributed``.
    With ``mesh``: the ranks of ``mesh`` that differ from this one only
    along ``axis``; ``world_size`` must be that axis's size. Without: the
    whole initialised process group (``initialize_multihost``), whose
    world size and rank must be ``world_size`` and ``rank``. ``backend``
    names the process group's backend where the caller wants to check it
    (``"nccl"``/``"gloo"``). ``fetch_timeout_s`` (the reference's name)
    bounds each op; default :data:`TIMEOUT_S`. ``device`` is where
    ``recv`` and ``barrier`` allocate (default the mesh's device, else
    the card)."""
    with _lock:
        key = (group_name, rank)
        if key in _groups:
            g = _groups[key]
            if g.world_size != world_size:
                raise ValueError(
                    f"group {group_name!r} rank {rank} already exists "
                    f"with world_size={g.world_size}; destroy it before "
                    f"re-creating with different membership")
            if fetch_timeout_s is not None and hasattr(g, "fetch_timeout_s"):
                g.fetch_timeout_s = float(fetch_timeout_s)
            return g
        if backend == "store":
            g = StoreGroup(group_name, world_size, rank,
                           fetch_timeout_s=fetch_timeout_s)
            _groups[key] = g
            return g
        if not dist.is_initialized():
            raise RuntimeError("no process group is initialised: call "
                               "ray_tpu_torch.parallel.initialize_multihost "
                               "first")
        timeout = TIMEOUT_S if fetch_timeout_s is None \
            else float(fetch_timeout_s)
        if mesh is not None:
            ranks = mesh.axis_ranks((axis,))
            if device is None:
                device = mesh.device
        else:
            ranks = list(range(dist.get_world_size()))
        if len(ranks) != world_size or ranks.index(dist.get_rank()) != rank:
            raise ValueError(
                f"world_size={world_size}, rank={rank} do not match the "
                f"process group: {len(ranks)} ranks, this one "
                f"{ranks.index(dist.get_rank())}")
        if backend is not None and backend != dist.get_backend():
            raise ValueError(f"the process group runs "
                             f"{dist.get_backend()!r}, not {backend!r}")
        if device is None:
            from .._private.device import resolve_device

            device = resolve_device(None)
        g = MeshGroup(group_name, new_process_group(ranks, timeout), ranks,
                      device)
        _groups[key] = g
        return g


def get_group(group_name: str = "default",
              rank: Optional[int] = None) -> BaseGroup:
    """Look up a joined group (``collective.py:572``)."""
    with _lock:
        if rank is not None:
            g = _groups.get((group_name, rank))
            if g is None:
                raise KeyError(f"collective group {group_name!r} rank "
                               f"{rank} not initialized")
            return g
        local = [g for (n, _r), g in _groups.items() if n == group_name]
    if not local:
        raise KeyError(f"collective group {group_name!r} not initialized")
    if len(local) > 1:
        raise KeyError(
            f"collective group {group_name!r} has {len(local)} ranks in "
            f"this process; pass rank= to disambiguate")
    return local[0]


def destroy_collective_group(group_name: str = "default",
                             rank: Optional[int] = None):
    """Leave a group: every local rank of it, or only ``rank`` (which
    removes only that rank's own state, so co-located ranks go on)."""
    with _lock:
        keys = [k for k in _groups
                if k[0] == group_name and (rank is None or k[1] == rank)]
        dropped = [_groups.pop(k) for k in keys]
    for i, g in enumerate(dropped):
        # full destroy: the first group wipes the shared state
        g.destroy(local_only=rank is not None or i > 0)


def allreduce(x, op: str = "sum", group_name: str = "default",
              rank: Optional[int] = None):
    return get_group(group_name, rank).allreduce(x, op)


def allgather(x, group_name: str = "default",
              rank: Optional[int] = None):
    return get_group(group_name, rank).allgather(x)


def reducescatter(x, op: str = "sum", group_name: str = "default",
                  rank: Optional[int] = None):
    return get_group(group_name, rank).reducescatter(x, op)


def alltoall(x, group_name: str = "default", rank: Optional[int] = None):
    return get_group(group_name, rank).alltoall(x)


def broadcast(x, src_rank: int = 0, group_name: str = "default",
              rank: Optional[int] = None):
    return get_group(group_name, rank).broadcast(x, src_rank)


def barrier(group_name: str = "default", rank: Optional[int] = None):
    return get_group(group_name, rank).barrier()


def send(x, dst_rank: int, group_name: str = "default", tag: int = 0,
         rank: Optional[int] = None):
    return get_group(group_name, rank).send(x, dst_rank, tag)


def recv(shape=None, dtype=None, src_rank: int = 0,
         group_name: str = "default", tag: int = 0,
         rank: Optional[int] = None):
    return get_group(group_name, rank).recv(shape, dtype, src_rank, tag)
