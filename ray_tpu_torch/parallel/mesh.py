"""Device meshes and multi-process initialisation: the port of
``ray_tpu/parallel/mesh.py``.

The reference's mesh is a ``jax.sharding.Mesh`` that one controller
addresses. The port follows PyTorch: one process per rank, every rank
running the same program (``torchrun``'s model), joined by
:func:`initialize_multihost` (``torch.distributed.init_process_group``,
the counterpart of ``jax.distributed.initialize``). :class:`Mesh` lays
the ranks out row-major over its named axes, in :data:`AXIS_ORDER` with
``tp`` innermost, as ``create_mesh`` lays out devices, and hands out the
process subgroup of the ranks that differ from this one only along
given axes (:meth:`Mesh.group`).

Axis conventions (any subset may be present, sizes multiply to the
ranks): ``dp`` data parallel, ``fsdp`` fully-sharded data parallel,
``tp`` tensor parallel, ``sp`` sequence parallel, ``ep`` expert parallel
(an MoE model's experts), ``pp`` pipeline (stages of layers).
"""
from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .._private.device import DeviceLike

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")
# tp innermost: tensor-parallel collectives are per-matmul (latency
# bound), so neighbouring ranks (one host's cards, NVLink) carry them.


@dataclass
class MeshConfig:
    """Declarative mesh shape; -1 on one axis means "fill remaining"."""

    axes: Dict[str, int] = field(default_factory=dict)

    def resolve(self, n_devices: int) -> Dict[str, int]:
        axes = dict(self.axes)
        if not axes:
            return {"dp": n_devices}
        fill = [k for k, v in axes.items() if v == -1]
        if len(fill) > 1:
            raise ValueError(f"only one axis may be -1, got {fill}")
        fixed = math.prod(v for v in axes.values() if v != -1)
        if fill:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by {fixed}")
            axes[fill[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes {axes} use {fixed} devices, have {n_devices}")
        return axes


class Mesh:
    """Named axes over a set of ranks (global ``torch.distributed``
    ranks, row-major in ``axis_names`` order), seen from this rank.

    ``shape`` maps each axis to its size, ``size`` is the rank count,
    ``rank`` this process's index in ``ranks``, ``device`` where its
    tensors live. :meth:`group` returns the
    :class:`~ray_tpu_torch.collective.collective.MeshGroup` of the ranks
    that differ from this one only along the given axes; every member
    must ask for it at the same point of the program (SPMD), and it is
    cached. A one-rank mesh needs no process group."""

    def __init__(self, shape: Dict[str, int], ranks: Sequence[int],
                 rank: int, device: torch.device):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.shape: Dict[str, int] = dict(shape)
        self.ranks: Tuple[int, ...] = tuple(ranks)
        self.size = len(self.ranks)
        self.rank = rank
        self.device = torch.device(device)
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Rank ``rank``'s (default this rank's) coordinate on each axis."""
        i = self.rank if rank is None else rank
        out = {}
        for name in reversed(self.axis_names):
            i, out[name] = divmod(i, self.shape[name])
        return {n: out[n] for n in self.axis_names}

    def size_of(self, axes: Iterable[str]) -> int:
        """The product of ``axes``' sizes (axes absent from the mesh
        count 1)."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """Rank ``rank``'s position along ``axes`` taken together, the
        first axis major (a dim sharded over ``("dp", "fsdp")`` puts
        shard ``index`` there)."""
        c = self.coords(rank)
        i = 0
        for a in axes:
            if a in self.shape:
                i = i * self.shape[a] + c[a]
        return i

    def axis_ranks(self, axes: Sequence[str],
                   rank: Optional[int] = None) -> List[int]:
        """The global ranks that differ from ``rank`` (default this one)
        only along ``axes``, sorted."""
        c = self.coords(rank)
        fixed = {a: v for a, v in c.items() if a not in axes}
        return sorted(self.ranks[r] for r in range(self.size)
                      if all(self.coords(r)[a] == v
                             for a, v in fixed.items()))

    def group(self, axes):
        """The collective group along ``axes`` (a name or a tuple)."""
        from ..collective.collective import MeshGroup, new_process_group

        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            ranks = self.axis_ranks(key)
            self._groups[key] = MeshGroup("/".join(key) or "self",
                                          new_process_group(ranks), ranks,
                                          self.device)
        return self._groups[key]


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _default_device(device: DeviceLike) -> torch.device:
    """The caller's device, else this process's current card (the launcher
    set it, one card per rank); no card is an error."""
    if device is not None:
        return torch.device(device)
    from .._private.device import resolve_device

    resolve_device(None)
    return torch.device("cuda", torch.cuda.current_device())


def create_mesh(axes: Optional[Dict[str, int]] = None, *,
                ranks: Optional[Sequence[int]] = None,
                device: DeviceLike = None) -> Mesh:
    """A :class:`Mesh` with named parallelism axes over ``ranks`` (default
    every rank of the process group; one rank without one), laid out in
    :data:`AXIS_ORDER` (``mesh.py:57``). Every rank of the mesh calls
    this with the same arguments; ``device`` is this rank's (default the
    current card)."""
    world, me = _world()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if me not in ranks:
        raise ValueError(f"rank {me} is not among the mesh's ranks {ranks}")
    if any(not 0 <= r < world for r in ranks) or \
            len(set(ranks)) != len(ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of a "
                         f"world of {world}")
    shape = MeshConfig(dict(axes or {})).resolve(len(ranks))
    names = sorted(shape, key=lambda a: AXIS_ORDER.index(a)
                   if a in AXIS_ORDER else len(AXIS_ORDER))
    return Mesh({n: shape[n] for n in names}, ranks, ranks.index(me),
                _default_device(device))


def single_device_mesh(axis: str = "dp", *,
                       device: DeviceLike = None) -> Mesh:
    """A one-rank mesh of this process alone."""
    return create_mesh({axis: 1}, ranks=[_world()[1]], device=device)


def mesh_shape(mesh: Mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         timeout_s: float = 1800.0) -> None:
    """Join this process into the job's process group (``mesh.py:88``;
    ``jax.distributed.initialize`` there, ``init_process_group`` here).

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://``);
    without it the environment ``torchrun`` sets is read (``env://``).
    ``backend`` defaults to NCCL where a card is visible, else gloo. With
    NCCL, the process's card is ``LOCAL_RANK`` (default the process id
    modulo the visible cards)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if coordinator_address:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        pid = int(process_id if process_id is not None
                  else os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) if local is not None
                              else pid % torch.cuda.device_count())
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def local_chip_count() -> int:
    """The cards this process may use, from ``CUDA_VISIBLE_DEVICES`` when
    set, else as the driver counts them."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return len([c for c in env.split(",") if c.strip()])
    return torch.cuda.device_count()
