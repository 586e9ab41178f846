"""Pipeline parallelism: a GPipe microbatch schedule over the ``pp`` mesh
axis, the port of ``ray_tpu/parallel/pipeline.py``.

Stage ``s`` of ``P`` holds layers ``[s*L/P, (s+1)*L/P)`` (what
``PP_LM_RULES`` stores on its ranks). The reference runs ``M + P - 1``
steps of ``ppermute`` and a stage scan inside ``shard_map`` and masks
the padding steps; the port runs the schedule itself, one process per
rank, with point-to-point sends over the pp group
(:meth:`~ray_tpu_torch.collective.collective.MeshGroup.send`/``recv``):

- forward: each stage runs its ``M`` microbatches in order, receiving
  each input from stage ``p - 1`` (stage 0 slices its own) and sending
  its output to ``p + 1``; it keeps every input and output with their
  graphs. No stage runs a padding step.
- backward: each stage takes its microbatches in reverse, receives the
  output's gradient from ``p + 1`` (the last stage has it from the loss),
  backpropagates it through its layers and sends the input's gradient
  to ``p - 1``.

The schedule is one ``torch.autograd.Function``, so ``loss.backward()``
drives it, and no collective sits inside the autograd graph itself: a
stage whose input needs no gradient still sends and receives, because
the schedule, not the graph, decides what moves. Every rank of a stage
must enter the backward; a stage that computes no loss backpropagates
the 0-dim tensor :func:`pipeline_apply` gives it (``to_all=False``).

Composition as in the reference: ``dp``/``fsdp`` split the rows outside
(each stage sees its rows), ``tp`` inside a stage (the block does its own
Megatron collectives over the tp group), ``sp`` inside a stage (each
rank holds a sequence chunk and the block's attention is a ring over
the sp group); a stage sends to the rank of the next stage with the
same dp/tp/sp coordinates.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch

Params = Dict[str, torch.Tensor]


def check_mesh(mesh, pp_axis: str = "pp", tp_axis: Optional[str] = None,
               sp_axis: Optional[str] = None) -> None:
    """The reference's refusals (``pipeline.py:72-83``): a mesh with no
    pp axis, or with an sp or tp axis the caller's block does not
    handle."""
    names = set(mesh.axis_names)
    if pp_axis not in names:
        raise ValueError(f"mesh has no {pp_axis!r} axis: {mesh.axis_names}")
    if "sp" in names and sp_axis is None:
        raise ValueError(
            "mesh has an sp axis: pass sp_axis= with an sp-aware "
            "block_fn (ring attention over sp — see gpt's pp x sp "
            "branch)")
    if "tp" in names and tp_axis is None:
        raise ValueError(
            "mesh has a tp axis: pass tp_axis= and param_specs= with a "
            "tp-aware block_fn (see gpt.forward's pp branch)")


def _microbatches(batch: int, num_microbatches: int, pp_size: int) -> int:
    """The microbatch count (default ``2 * pp``, ``pipeline.py:85``);
    the rows of a shard must split into it evenly."""
    num_mb = num_microbatches or 2 * pp_size
    if batch % num_mb:
        raise ValueError(f"per-shard batch {batch} not divisible by "
                         f"num_microbatches={num_mb}")
    return num_mb


class _Schedule:
    """One call's pipeline: the stage's layers, its pp group and where
    it stands in it."""

    def __init__(self, block_fn: Callable, names: List[str], group,
                 num_mb: int):
        self.block_fn, self.names, self.group = block_fn, names, group
        self.stage, self.stages = group.rank, group.world_size
        self.num_mb = num_mb

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def layers(self, act: torch.Tensor, weights) -> torch.Tensor:
        stacked = dict(zip(self.names, weights))
        for i in range(stacked[self.names[0]].shape[0]):
            act = self.block_fn(act, {n: t[i] for n, t in stacked.items()})
        return act

    def forward(self, x: torch.Tensor, weights, keep: bool):
        """Every microbatch through this stage; with ``keep`` each input
        (a leaf that takes its gradient) and output with its graph."""
        mb = x.shape[0] // self.num_mb
        shape = (mb,) + tuple(x.shape[1:])
        ins, outs = [], []
        for m in range(self.num_mb):
            if self.first:
                a = x[m * mb:(m + 1) * mb].detach()
            else:
                a = self.group.recv(shape, x.dtype, src_rank=self.stage - 1)
            if keep:
                a.requires_grad_(not self.first or x.requires_grad)
            y = self.layers(a, weights)
            if not self.last:
                self.group.send(y, self.stage + 1)
            ins.append(a)
            outs.append(y)
        return ins, outs


class _GPipe(torch.autograd.Function):
    """The schedule as one autograd node: its inputs are this rank's
    activations and the stage's weights; its output is the last stage's
    activations (elsewhere a 0-dim zero whose gradient is ignored: the
    backward takes its gradients from the next stage)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, *weights):
        ws = [w.detach().requires_grad_(w.requires_grad) for w in weights]
        with torch.enable_grad():
            ins, outs = sched.forward(x, ws, keep=True)
        ctx.sched, ctx.ins, ctx.outs, ctx.ws = sched, ins, outs, ws
        ctx.x_grad = x.requires_grad
        if sched.last:
            return torch.cat([o.detach() for o in outs])
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        sched, ins, outs, ws = ctx.sched, ctx.ins, ctx.outs, ctx.ws
        dx: List[Optional[torch.Tensor]] = [None] * sched.num_mb
        gs = g.chunk(sched.num_mb) if sched.last else None
        for m in reversed(range(sched.num_mb)):
            out = outs[m]
            gm = gs[m] if sched.last else sched.group.recv(
                out.shape, out.dtype, src_rank=sched.stage + 1)
            leaves = [w for w in ws if w.requires_grad]
            if ins[m].requires_grad:
                leaves.append(ins[m])
            torch.autograd.backward(out, gm, inputs=leaves)
            if not sched.first:
                sched.group.send(ins[m].grad, sched.stage - 1)
            elif ctx.x_grad:
                dx[m] = ins[m].grad
            ins[m] = outs[m] = None          # free this microbatch's graph
        gx = torch.cat(dx) if sched.first and ctx.x_grad else None
        return (None, gx, *[w.grad for w in ws])


class _FromLast(torch.autograd.Function):
    """The last stage's activations on every pp rank (the reference's
    masked ``psum``); the backward sums the gradients over the stages
    onto the last one, as the ``psum``'s transpose does."""

    @staticmethod
    def forward(ctx, y, x, group):
        ctx.group, ctx.shape = group, y.shape
        last = group.world_size - 1
        buf = y if group.rank == last else x.new_empty(x.shape)
        return group.broadcast(buf, src_rank=last)

    @staticmethod
    def backward(ctx, g):
        total = ctx.group.allreduce(g)
        if ctx.group.rank == ctx.group.world_size - 1:
            return total, None, None
        return total.new_zeros(ctx.shape), None, None


def pipeline_apply(block_fn: Callable, stacked_params: Mapping[str,
                   torch.Tensor], x: torch.Tensor, *, mesh,
                   pp_axis: str = "pp", num_microbatches: int = 0,
                   tp_axis: Optional[str] = None,
                   sp_axis: Optional[str] = None, param_specs=None,
                   to_all: bool = True) -> torch.Tensor:
    """Run ``x`` through the stacked layers pipelined over ``pp_axis``
    (``pipeline.py:46``), on every rank of ``mesh`` with its own share.

    ``block_fn(act, layer_params) -> act`` is one block; ``layer_params``
    maps each name of ``stacked_params`` to one layer's tensor.
    ``stacked_params`` is THIS rank's stage: each leaf's leading dim is
    the stage's ``L/P`` layers, in the layout ``block_fn`` computes with
    (under tp this rank's slices: :func:`ray_tpu_torch.models.gpt.
    compute_params` cuts them from the full stack by
    ``_pp_tp_param_specs``). ``param_specs`` is accepted for the
    reference's signature; the leaves already are this rank's.

    ``x`` is this rank's ``[B, S, d]`` activations (rows over dp/fsdp,
    the sequence chunk under sp); only stage 0 reads its values, the
    other stages pass any tensor of its shape and dtype. Returns the
    pipelined output on every pp rank (``to_all``, the reference's
    result), or with ``to_all=False`` on the last stage only, the other
    stages getting a 0-dim zero: backpropagating it from there (with any
    gradient) runs their share of the backward schedule.

    Raises as the reference does for a mesh without the pp axis, an sp
    or tp axis without ``sp_axis``/``tp_axis``, and rows that
    ``num_microbatches`` (default ``2 * pp``) does not divide."""
    del param_specs
    check_mesh(mesh, pp_axis, tp_axis, sp_axis)
    num_mb = _microbatches(x.shape[0], num_microbatches, mesh.shape[pp_axis])
    group = mesh.group(pp_axis)
    names = sorted(stacked_params)
    weights = [stacked_params[n] for n in names]
    sched = _Schedule(block_fn, names, group, num_mb)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            w.requires_grad for w in weights)):
        y = _GPipe.apply(sched, x, *weights)
    else:
        outs = sched.forward(x, weights, keep=False)[1]
        y = torch.cat(outs) if sched.last else x.new_zeros(())
    if not to_all:
        return y
    return _FromLast.apply(y, x, group)
