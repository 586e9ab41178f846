"""Multislice data parallelism: a mesh inside each slice, a host-side
collective group across slices; the port of
``ray_tpu/parallel/multislice.py``.

The reference's slices are TPU slices: traffic inside one rides ICI
through XLA's collectives, traffic between slices crosses the data-centre
network through the runtime's store group. In the port a slice is a set
of ranks with a ``{dp: n}`` :class:`~ray_tpu_torch.parallel.mesh.Mesh`
(NCCL or gloo), and the group across slices is the ranks that hold the
same index in their slice, over gloo on host tensors, in the role of the
DCN. One step's gradients cross it once, as one flattened f32 vector
(:func:`dcn_allreduce_tree`).

:func:`run_multislice_dryrun` proves the composition: one process per
rank on a :class:`~ray_tpu_torch._private.ranks.RankPool`, each slice
takes one step of the nano GPT on its own tokens, the gradients are
averaged inside the slice and then across slices, and every rank checks
that all applied the same update. The pool and its gloo groups take
the place of the reference's runtime and store group; the port has both
now (``collective.StoreGroup``), and the group across slices may move
onto it (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._private import tree as _tree
from .._private.device import DeviceLike

#: SGD step of the dryrun (``multislice.py:108``).
LR = 0.1


def dcn_allreduce_tree(tree: Any, group) -> Any:
    """``tree`` (nested dicts/lists of tensors or arrays) averaged over
    ``group`` (``multislice.py:31-52``): ONE flattened f32 host vector a
    call, not one per leaf (the link's latency dominates); the sum is
    divided by the world size out of place; each leaf comes back in its
    own shape, dtype and (for a tensor) device."""
    leaves = _tree.leaves(tree)
    flat = torch.cat([torch.as_tensor(x).detach().cpu().float().reshape(-1)
                      for x in leaves]) if leaves else torch.zeros(0)
    mean = group.allreduce(flat) / group.world_size
    out, off = [], 0
    for x in leaves:
        shape = tuple(np.shape(x))
        n = math.prod(shape)
        piece = mean[off:off + n].reshape(shape)
        if isinstance(x, torch.Tensor):
            out.append(piece.to(device=x.device, dtype=x.dtype))
        else:
            out.append(piece.numpy().astype(np.asarray(x).dtype))
        off += n
    return _tree.unflatten(tree, out)


def _cross_slice_group(n_slices: int, per_slice: int, index: int):
    """The gloo group of the ranks at ``index`` in their slice; every
    rank makes every such group, in the same order."""
    from ..collective.collective import MeshGroup

    mine = None
    for i in range(per_slice):
        ranks = [s * per_slice + i for s in range(n_slices)]
        pg = dist.new_group(ranks, backend="gloo")
        if i == index:
            mine = MeshGroup(f"dcn{i}", pg, ranks, torch.device("cpu"))
    return mine


def slice_rank(n_slices: int, per_slice: int,
               device: Optional[DeviceLike] = None) -> dict:
    """One rank of the dryrun (the reference's ``slice_main``,
    ``multislice.py:55-125``): rank ``w`` is index ``w % per_slice`` of
    slice ``w // per_slice``. The slice's ranks form a ``{dp:
    per_slice}`` mesh; nano (``init_params(cfg, 0)``, the reference's
    draw) takes tokens ``[8, 33]`` from ``default_rng(1000 + slice)``,
    each dp rank its rows; the gradients are averaged over the slice
    (all-reduce over dp) and then across slices
    (:func:`dcn_allreduce_tree`), and SGD at :data:`LR` updates the f32
    weights. The checksum (the sum of every updated weight) is
    all-gathered over every rank. Returns ``{"slice", "loss" (the
    slice's mean), "checksum", "agree"}``."""
    from ..models import gpt
    from .mesh import create_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_slices * per_slice:
        raise ValueError(f"{n_slices} slices of {per_slice} ranks need "
                         f"{n_slices * per_slice} ranks, the world has "
                         f"{world}")
    sl, index = divmod(rank, per_slice)
    mesh = create_mesh({"dp": per_slice},
                       ranks=range(sl * per_slice, (sl + 1) * per_slice),
                       device=device)
    dcn = _cross_slice_group(n_slices, per_slice, index)
    cfg = gpt.CONFIGS["nano"]
    params = {k: v.requires_grad_(True)
              for k, v in gpt.init_params(cfg, 0, mesh.device).items()}
    rng = np.random.default_rng(1000 + sl)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 33)))
    rows = tokens.chunk(per_slice)[mesh.coords()["dp"]].to(mesh.device)
    logits = gpt.forward(params, rows[:, :-1], cfg)
    loss = gpt._ce_from_logits(logits, rows[:, 1:])
    loss.backward()
    loss = loss.detach()
    names = sorted(params)
    dp = mesh.group("dp") if per_slice > 1 else None
    grads = {n: params[n].grad.float() for n in names}
    if dp is not None:                       # inside the slice
        grads = {n: dp.allreduce(g) / per_slice for n, g in grads.items()}
        loss = dp.allreduce(loss) / per_slice
    avg = dcn_allreduce_tree(grads, dcn)     # across slices
    with torch.no_grad():
        new = {n: params[n].float() - LR * avg[n] for n in names}
    checksum = float(sum(float(new[n].double().sum()) for n in names))
    every = _world_gather(checksum)
    agree = all(abs(c - checksum) < 1e-3 * max(1.0, abs(checksum))
                for c in every)
    return {"slice": sl, "loss": float(loss), "checksum": checksum,
            "agree": bool(agree)}


def _world_gather(value: float) -> list:
    """``value`` from every rank of the world, over a host gloo group
    (every rank calls this at the same point)."""
    n = dist.get_world_size()
    pg = dist.new_group(list(range(n)), backend="gloo")
    parts = [torch.zeros(1, dtype=torch.float64) for _ in range(n)]
    dist.all_gather(parts, torch.tensor([value], dtype=torch.float64),
                    group=pg)
    return [float(p) for p in parts]


def run_multislice_dryrun(n_slices: int = 2, devices_per_slice: int = 2,
                          device: Optional[DeviceLike] = None) -> dict:
    """Start one rank process per (slice, index) on a
    :class:`~ray_tpu_torch._private.ranks.RankPool`, run
    :func:`slice_rank` on each and return ``{"slices": [one report per
    slice]}`` (``multislice.py:128-176``); raises if any rank's checksum
    disagrees. ``device``: every rank's device (``"cpu"``, or
    ``"cuda:0"`` for every rank on one card over gloo); default one card
    per rank (NCCL inside a slice)."""
    from .._private.ranks import RankPool

    n = n_slices * devices_per_slice
    devices = None if device is None else (str(device),) * n
    with RankPool(n, devices=devices) as pool:
        reports = pool.run(slice_rank, n_slices, devices_per_slice,
                           None if device is None else device)
    if not all(r["agree"] for r in reports):
        raise AssertionError(f"slices disagree: {reports}")
    return {"slices": reports[::devices_per_slice]}
