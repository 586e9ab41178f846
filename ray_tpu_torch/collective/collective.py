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

``StoreGroup`` rides the reference's runtime (its head KV and object
store) and is not ported.
"""
from __future__ import annotations

import datetime
import threading
from typing import Dict, Optional, Sequence

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


# ---------------------------------------------------------------- module API
def init_collective_group(world_size: int, rank: int, *,
                          backend: Optional[str] = None,
                          group_name: str = "default",
                          mesh=None, axis: str = "dp",
                          fetch_timeout_s: Optional[float] = None,
                          device=None) -> BaseGroup:
    """Join/declare a collective group (reference ``collective.py:503``).

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
    """Leave a group: every local rank of it, or only ``rank``."""
    with _lock:
        keys = [k for k in _groups
                if k[0] == group_name and (rank is None or k[1] == rank)]
        dropped = [_groups.pop(k) for k in keys]
    for g in dropped:
        g.destroy(local_only=rank is not None)


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
