"""Partition-rule based parameter sharding: the port of
``ray_tpu/parallel/sharding.py``.

Ordered regex rules map a leaf's path to a :class:`PartitionSpec` with
the reference's exact semantics (:func:`spec_for`). A
:class:`Placement` is the spec on a :class:`~.mesh.Mesh` (the
reference's ``NamedSharding``): it cuts a full tensor to a rank's shard,
gathers the shards back, and reduces a full-size tensor summed over
every rank of the mesh to this rank's shard, through the mesh's groups.

Paths are the reference's pytree paths (``block/wq/kernel``,
``embed/kernel``): the port's flat parameter dict reaches them through
:func:`ray_tpu_torch.models.gpt.params_tree`.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .._private import tree as _tree

PartitionRule = Tuple[str, Tuple[Optional[str], ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``None`` (replicated), an axis name, or a
    tuple of names (first major); trailing dims replicated. Prints as
    ``jax.sharding.PartitionSpec`` does, and a one-name tuple is that
    name, as there."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


path_str = _tree.path_str


def _sizes(mesh) -> Dict[str, int]:
    """Axis sizes of a :class:`~.mesh.Mesh` or of a plain mapping."""
    return dict(getattr(mesh, "shape", mesh))


def spec_for(path: str, shape: Sequence[int],
             rules: Sequence[PartitionRule], mesh) -> PartitionSpec:
    """First matching rule wins; axes absent from the mesh degrade to
    None; a dim that the axes' product does not divide is replicated;
    trailing Nones are trimmed (``sharding.py:31-59``). ``mesh`` is a
    :class:`~.mesh.Mesh` or a mapping of axis sizes."""
    sizes = _sizes(mesh)
    for pattern, spec in rules:
        if re.search(pattern, path):
            out: List[Any] = []
            for dim, ax in enumerate(spec):
                if ax is None or dim >= len(shape):
                    out.append(None)
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                axes = tuple(a for a in axes if a in sizes)
                if not axes:
                    out.append(None)
                    continue
                size = math.prod(sizes[a] for a in axes)
                if shape[dim] % size != 0:
                    out.append(None)  # indivisible -> replicate this dim
                    continue
                out.append(axes if len(axes) > 1 else axes[0])
            while out and out[-1] is None:
                out.pop()
            return P(*out)
    return P()


class Placement:
    """A :class:`PartitionSpec` on a mesh: where each rank's shard of a
    tensor lies (``NamedSharding``)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self):
        return f"Placement({self.spec})"

    def _dims(self):
        """``[(dim, axes tuple), ...]`` for every sharded dim."""
        return [(d, ax if isinstance(ax, tuple) else (ax,))
                for d, ax in enumerate(self.spec) if ax is not None]

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis that shards the tensor."""
        return tuple(a for _, axes in self._dims() for a in axes)

    def shard(self, full: torch.Tensor,
              rank: Optional[int] = None) -> torch.Tensor:
        """Rank ``rank``'s (default this rank's) shard of ``full``, a
        contiguous copy."""
        out = full
        for d, axes in self._dims():
            n = self.mesh.size_of(axes)
            out = out.chunk(n, dim=d)[self.mesh.index(axes, rank)]
        return out.clone(memory_format=torch.contiguous_format)

    def _check_order(self, axes) -> None:
        names = self.mesh.axis_names
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"{self.spec}: a dim sharded over several "
                             f"axes must name them in mesh order {names}")

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (all-gathers along
        each sharded dim; every rank of the mesh calls this)."""
        out = local
        for d, axes in self._dims():
            if self.mesh.size_of(axes) == 1:
                continue
            self._check_order(axes)
            g = self.mesh.group(axes)
            out = g.allgather(out.movedim(d, 0)).movedim(0, d)
        return out

    def without(self, axes: Sequence[str]) -> "Placement":
        """This placement with ``axes`` taken out of its spec: the layout
        of a rank's piece that keeps its shard along ``axes`` and is whole
        along the other sharded dims (a pipeline stage's layers, an
        expert rank's experts). A dim split over one of ``axes`` together
        with another axis cannot be kept apart and raises."""
        parts = []
        for ax in self.spec:
            names = ax if isinstance(ax, tuple) else (ax,)
            rest = tuple(a for a in names if a is not None and a not in axes)
            if ax is not None and rest and len(rest) != len(names):
                raise ValueError(f"{self.spec}: a dim split over {names} "
                                 f"cannot keep its shard along {axes} alone")
            parts.append(rest or None)
        return Placement(self.mesh, P(*parts))

    def reduce(self, full: torch.Tensor, skip: Sequence[str] = ()
               ) -> torch.Tensor:
        """This rank's shard of ``full`` summed over every rank of the
        mesh: a reduce-scatter along each sharded dim, then an all-reduce
        over the axes that do not shard the tensor, except ``skip`` (axes
        along which each rank holds a different piece, summed by none)."""
        out = full
        for d, axes in self._dims():
            if self.mesh.size_of(axes) == 1:
                continue
            self._check_order(axes)
            g = self.mesh.group(axes)
            out = g.reducescatter(out.movedim(d, 0)).movedim(0, d)
        rest = tuple(a for a in self.mesh.axis_names
                     if a not in self.axes and a not in skip
                     and self.mesh.shape[a] > 1)
        if rest:
            out = self.mesh.group(rest).allreduce(out)
        return out.contiguous()


def tree_shardings(params, mesh, rules: Sequence[PartitionRule]):
    """A :class:`Placement` for every leaf of ``params`` (a nested tree
    whose paths the rules match; leaves need only ``.shape``)."""
    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        return Placement(mesh, spec_for(path_str(path), shape, rules, mesh))

    return _tree.map_with_path(one, params)


def replicated(tree, mesh):
    return _tree.map_with_path(lambda _p, _x: Placement(mesh, P()), tree)


def shard_tree(tree, shardings):
    """Every leaf cut to this rank's shard (full tensor -> rank slice; the
    reference's host -> mesh ``device_put``)."""
    return _tree.map_with_path(lambda _p, x, s: s.shard(x), tree, shardings)


def gather_tree(tree, shardings):
    """Every leaf gathered from the ranks' shards (the inverse of
    :func:`shard_tree`; every rank of the mesh calls it)."""
    return _tree.map_with_path(lambda _p, x, s: s.gather(x), tree,
                               shardings)


# Default rule set for transformer LMs (``sharding.py:91``): the leaves
# are stacked [L, ...], so ``fsdp`` shards the layer dim and ``tp`` the
# next one; biases and norms replicated.
LM_RULES: List[PartitionRule] = [
    (r"embed/kernel", (("fsdp",), "tp")),          # [vocab, d] row-shard
    (r"(wq|wk|wv)/kernel", (("fsdp",), "tp")),     # [d, heads*hd] col-shard
    (r"wo/kernel", ("tp", ("fsdp",))),             # [heads*hd, d]
    (r"router/kernel", (("fsdp",),)),              # [L, d, E] small, L-shard
    (r"w_up/kernel", (("fsdp",), "ep", None, "tp")),   # [L, E, d, f]
    (r"w_down/kernel", (("fsdp",), "ep", "tp")),       # [L, E, f, d]
    (r"(w1|wi|up|gate)/kernel", (("fsdp",), "tp")),
    (r"(w2|wo_ff|down)/kernel", ("tp", ("fsdp",))),
    (r"head/kernel", (("fsdp",), "tp")),
    (r"pos_embed", (None, ("fsdp",))),
    (r"(bias|scale|norm)", (None,)),
    (r".*", ()),                                   # replicate the rest
]

# Pipeline parallel: stacked block layers sharded over pp on the layer
# (leading) dim, everything else replicated.
PP_LM_RULES: List[PartitionRule] = [
    (r"block/", ("pp",)),
    (r".*", ()),
]

# Pure data-parallel: everything replicated.
DP_RULES: List[PartitionRule] = [(r".*", ())]

# Activation/batch sharding used by train steps.
BATCH_SPEC = ("dp", "fsdp")  # batch dim sharded over dp x fsdp


def batch_sharding(mesh, extra_seq_axis: Optional[str] = None) -> Placement:
    """The :class:`Placement` of ``[batch, seq, ...]`` activations: batch
    over the ``dp`` x ``fsdp`` axes present, seq over ``extra_seq_axis``
    when the mesh has it."""
    names = set(_sizes(mesh))
    b = tuple(a for a in BATCH_SPEC if a in names)
    s = extra_seq_axis if (extra_seq_axis in names) else None
    return Placement(mesh, P(b if b else None, s))
