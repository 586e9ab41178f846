"""Mixture-of-Experts FFN: the port of ``ray_tpu/models/moe.py``.

A router scores each token per expert; each token goes to its top-k
experts, renormalised over those k; every expert has a static capacity
of C slots, handed out first come, first served across the flattened
token dimension (choice 0 of every token first, then choice 1, ...), and
a token past capacity is dropped from that expert (its residual carries
it). The load-balance term is Switch's ``E * sum_e f_e * p_e`` over the
top-1 assignment.

The reference writes dispatch and combine as dense one-hot ``[T, E, C]``
tensors and four einsums (``moe.py:37-112``). :func:`top_k_gating` keeps
that interface. :func:`moe_ffn` routes by index instead, the "sort-based
scatter variant" the reference's docstring names: each (token, choice)
pair's expert, slot, keep flag and gate come from :func:`route` once
(which :func:`top_k_gating` also uses, so the two cannot drift); the
kept tokens are gathered into ``[E, C, d]``, the experts run as two
batched products, and each token gathers its k outputs back. The values
are the dense form's: a one-hot dispatch copies rows exactly, and the
combine sums k products that are exact in f32 (two terms sum in either
order alike). Autograd reaches the same gradients. The dense form cannot
run at the training shape (T = 32768, C = 10240: one f32 ``[T, E, C]``
tensor is 10.7 GB per layer), and it spreads a non-finite row to every
token through ``0 * NaN``; index routing does neither.

Casts follow the reference: router logits are an f32 product of f32
operands; the gates are rounded to the compute dtype before the combine;
each expert product accumulates in f32 and is cast once; GELU is the
tanh form.

**On a mesh** (:func:`moe_ffn`'s ``ep``, ``tp`` and ``data`` groups,
what the reference's GSPMD step computes over ``dp``/``fsdp``/``ep``/
``tp``/``sp``): rows are split over the data axes and, under sequence
parallelism, each rank holds a sequence chunk of each of its rows; rows
are replicated over ``ep`` and ``tp``. Capacity counts the GLOBAL batch,
and slots are handed out first come, first served over the global
token order, the reference's flat ``[B * S]`` (row-major: under sp the
ranks' chunks interleave row by row, so a per-rank offset would be
wrong): each rank all-gathers its per-row expert counts ``[k, rows,
E]`` over the routing group (data axes and sp) and offsets its local
slots by them (:func:`route`), so every rank drops exactly the pairs
one card would. Each ep rank holds ``E/ep`` experts and runs them on the
kept pairs that land on them; each tp rank holds ``d_ff/tp`` columns of
every local expert's ``w_up`` and the same rows of ``w_down`` (Megatron
expert slices), and the f32 partials of the down product are summed
over tp before their one cast, where the reference's single
``einsum(...).astype(dtype)`` rounds. The gated ep partial outputs are
then summed over ep in f32 before the one cast (with top-2 the sum of a
value and zeros is exact in any order). Rows are identical across ep
and tp ranks, so nothing needs an all-to-all: the rows enter the expert
products through an identity whose backward sums over ep and tp, the
gates through one over ep only (they weight ep partials; the tp sum
comes before the combine), and the partials leave through a sum whose
backward is the identity (Megatron's pair). The
balance term sums its ``[E]`` statistics over the routing group before
the product, as the global means it is made of.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .gpt import _CopyToTP, _gelu, _ReduceFromTP


def capacity(tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Static per-expert slot count, padded to a multiple of 8
    (``moe.py:30``)."""
    c = int(math.ceil(capacity_factor * top_k * tokens / n_experts))
    return max(8, ((c + 7) // 8) * 8)


class Routes(NamedTuple):
    """Where each (choice j, token t) pair goes, ``[k, T]`` each, choice
    major (the order capacity is handed out in)."""

    expert: torch.Tensor    # int64 expert index
    slot: torch.Tensor      # int64 position in that expert's buffer
    keep: torch.Tensor      # bool: slot < capacity
    gate: torch.Tensor      # renormalised top-k probability, probs dtype


def route(probs: torch.Tensor, top_k: int, cap: int, group=None,
          rows: int = 1, blocks: Optional[Sequence[Tuple[int, int]]] = None
          ) -> Routes:
    """``probs [T, E]`` → :class:`Routes`. Top-k by a stable descending
    sort, so equal probabilities take the lower expert index first, as
    ``lax.top_k`` does (``torch.topk`` promises no order among ties).
    Slots are one cumulative count over the choice-major concatenation
    ``[k * T]``, which is the reference's loop over j with its running
    ``counts`` offset (``moe.py:52-62``). The count runs along the last
    axis of an ``[E, k * T]`` one-hot: a scan down the long axis of a
    ``[k * T, E]`` tensor runs E lanes serially on the card (12 ms a
    layer at T = 32768 on an H100 80GB HBM3 at 700 W).

    With ``group`` (the routing ranks) the slots are the global ones, in
    the reference's flat token order ``[B * S]``: row-major, a whole row
    before the next. ``probs`` is this rank's ``rows`` rows (``T / rows``
    columns each, row-major), and ``blocks[i]`` says where group rank
    ``i``'s tokens lie: its chunk of the batch rows and its chunk of the
    sequence (default ``(i, 0)``: the data ranks, whole rows each). Each
    rank's per-row counts ``[k, rows, E]`` are all-gathered, and pair
    ``(j, b, s)`` of expert e sits after every token's choices ``j' <
    j`` for e, then choice ``j`` for e on every earlier row of the batch
    (all its sequence chunks), then on row b in the earlier sequence
    chunks, then in this rank's earlier columns of row b."""
    T, E = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    expert = idx[:, :top_k].t().reshape(-1)                   # [k*T]
    hot = F.one_hot(expert, E)                                # [k*T, E]
    seen = hot.t().cumsum(1)                                  # [E, k*T]
    slot = seen.gather(0, expert[None])[0] - 1
    expert, slot = expert.view(top_k, T), slot.view(top_k, T)
    if group is not None and group.world_size > 1:
        offset = _offsets(hot.view(top_k, rows, T // rows, E).sum(2),
                          group, blocks)                      # [k, rows, E]
        row = torch.arange(T, device=probs.device) // (T // rows)
        at = (torch.arange(top_k, device=probs.device)[:, None] * rows
              + row) * E + expert
        slot = slot + offset.view(-1).take(at)
    return Routes(expert, slot, slot < cap, gates.t())


def _offsets(counts: torch.Tensor, group, blocks) -> torch.Tensor:
    """The global slot of each (choice j, local row b, expert e) pair
    minus its local one (:func:`route`), from this rank's per-row
    counts ``[k, rows, E]`` and every group rank's, all-gathered."""
    every = group.allgather(counts[None])                     # [n, k, B, E]
    n = every.shape[0]
    blocks = list(blocks) if blocks is not None else \
        [(i, 0) for i in range(n)]
    row_blk, seq_blk = blocks[group.rank]
    dev = counts.device
    before = torch.tensor([b < row_blk for b, _ in blocks], device=dev)
    same = torch.tensor([b == row_blk for b, _ in blocks], device=dev)
    left = torch.tensor([b == row_blk and s < seq_blk for b, s in blocks],
                        device=dev)

    def excl(t, dim):                    # exclusive cumulative sum
        return t.cumsum(dim) - t

    per_j = every.sum((0, 2))                                 # [k, E]
    mine_j = counts.sum(1)
    on_row = every[same].sum(0)                               # [k, B, E]
    return ((excl(per_j, 0) - excl(mine_j, 0)
             + every[before].sum((0, 2)))[:, None]
            + excl(on_row, 1) - excl(counts, 1) + every[left].sum(0))


class _SumOver(torch.autograd.Function):
    """An all-reduce (sum) over ``group`` whose backward is one too: each
    rank's copy of a global statistic passes its gradient to every
    rank's share of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.allreduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.allreduce(g), None


def balance_loss(probs: torch.Tensor, routes: Routes, group=None
                 ) -> torch.Tensor:
    """Switch's load-balance term ``E * sum_e f_e * p_e``: ``f_e`` the
    share of tokens whose top-1 expert is e, ``p_e`` the mean router
    probability of e (``moe.py:64-68``). With ``group`` (the routing
    ranks, equal tokens each) both are means over the global batch:
    their ``[E]`` sums are all-reduced before the product."""
    E = probs.shape[-1]
    top1 = F.one_hot(routes.expert[0], E).to(probs.dtype)
    if group is None or group.world_size == 1:
        return E * (top1.mean(0) * probs.mean(0)).sum()
    n = probs.shape[0] * group.world_size
    frac = group.allreduce(top1.sum(0)) / n
    return E * (frac * _SumOver.apply(probs.sum(0), group) / n).sum()


def top_k_gating(probs: torch.Tensor, top_k: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """probs ``[T, E]`` → (dispatch ``[T, E, C]``, combine ``[T, E, C]``,
    aux scalar), the reference's dense one-hot form (``moe.py:37``);
    dropped pairs have no entry. Differentiable in ``probs`` as the
    reference is (through the gates and the aux term)."""
    T, E = probs.shape
    r = route(probs, top_k, cap)
    tok = torch.arange(T, device=probs.device).expand(top_k, T)
    at = (tok[r.keep], r.expert[r.keep], r.slot[r.keep])
    zeros = probs.new_zeros(T, E, cap)
    dispatch = zeros.index_put(at, probs.new_ones(()).expand(len(at[0])))
    combine = zeros.index_put(at, r.gate[r.keep])
    return dispatch, combine, balance_loss(probs, r)


def _run(fn: Callable, *args):
    return fn(*args)


def _router(xt: torch.Tensor, router_kernel: torch.Tensor) -> torch.Tensor:
    """f32 router probabilities ``[T, E]`` (an f32 product of f32
    operands, ``moe.py:84-86``)."""
    return torch.softmax(torch.matmul(xt.float(), router_kernel.float()),
                         dim=-1)


def _experts(xt: torch.Tensor, src: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, dtype: torch.dtype, partial: bool
             ) -> torch.Tensor:
    """The expert FFN on the rows ``src`` points at (``T``: the zero
    row) → ``ye [E_local * C, d]``: the compute dtype, or with
    ``partial`` (``w_up``/``w_down`` a tp rank's ``d_ff`` slice) the f32
    product of the compute-dtype operands, before its sum over tp."""
    n, _, f = w_up.shape
    d = xt.shape[-1]
    xz = torch.cat([xt.to(dtype), xt.new_zeros(1, d, dtype=dtype)])
    xe = xz.index_select(0, src).view(n, -1, d)
    h = _gelu(torch.matmul(xe, w_up.to(dtype)).to(dtype))
    if partial:
        ye = torch.matmul(h.float(), w_down.to(dtype).float())
    else:
        ye = torch.matmul(h, w_down.to(dtype)).to(dtype)
    return ye.view(-1, d)


def _combine(ye: torch.Tensor, flat: torch.Tensor, gate: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Each token's k expert outputs gathered back and summed in f32 with
    the gates rounded to the compute dtype first → ``[T, d]`` f32."""
    k, T = flat.shape
    yz = torch.cat([ye, ye.new_zeros(1, ye.shape[-1])])
    picked = yz.index_select(0, flat.view(-1)).view(k, T, -1)
    return (gate.to(dtype).float()[..., None] * picked.float()).sum(0)


def moe_ffn(x: torch.Tensor, router_kernel: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float, dtype: torch.dtype, aux: bool = True,
            ep=None, tp=None, data=None,
            blocks: Optional[Sequence[Tuple[int, int]]] = None,
            piece: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x ``[B, S, d]`` → (y ``[B, S, d]`` in ``dtype``, aux f32 scalar)
    (``moe.py:72``), routed by index. ``router_kernel [d, E]``, ``w_up
    [E, d, f]``, ``w_down [E, f, d]``. Capacity counts all ``B * S``
    rows, so every row of the batch competes for it. ``aux=False`` skips
    the load-balance term (the decode paths discard it) and returns
    ``None`` in its place.

    On a mesh (see the module notes): ``data`` is the routing group, over
    the data axes and the sequence axis (``x`` this rank's rows and
    sequence chunk, placed by ``blocks`` as :func:`route` reads it;
    capacity, slots and the balance term count every rank's tokens);
    ``ep`` the expert group, ``w_up``/``w_down`` holding this rank's
    ``E/ep`` experts ``[ep.rank * E/ep, ...)``, ``y`` then the sum over
    ep of every rank's experts' share; ``tp`` the tensor group,
    ``w_up``/``w_down`` this rank's ``d_ff/tp`` columns/rows of each
    expert, the down product's f32 partials summed over tp before its
    one cast. ``piece(fn, *args)`` (default: a plain call) runs each of
    the three pieces between collectives (the router, the expert
    products, the combine): the caller's remat policy."""
    piece = piece or _run
    B, S, d = x.shape
    E = router_kernel.shape[-1]
    T = B * S
    xt = x.reshape(T, d)
    probs = piece(_router, xt, router_kernel)
    cap = capacity(T * (data.world_size if data is not None else 1), E,
                   top_k, capacity_factor)
    r = route(probs, top_k, cap) if data is None else \
        route(probs, top_k, cap, data, B, blocks)
    gate = r.gate
    n_loc = w_up.shape[0]                # this rank's experts
    e0 = ep.rank * n_loc if ep is not None else 0
    keep = r.keep if ep is None else \
        r.keep & (r.expert >= e0) & (r.expert < e0 + n_loc)
    for g in (ep, tp):                   # replicated rows into local slices
        if g is not None:
            xt = _CopyToTP.apply(xt, g)
    if ep is not None:                   # the combine is an ep partial
        gate = _CopyToTP.apply(gate, ep)
    # Buffer slot e * cap + c of each pair; a dropped pair points at the
    # zero row past the last slot. Both gathers are ``index_select``,
    # whose backward adds with atomics: an empty slot's row and a dropped
    # pair's share one index, and the sorted accumulation of plain
    # indexing runs such a repeated index serially (0.56 s of a training
    # step at T = 32768 on an H100 80GB HBM3 at 700 W). A real row takes
    # at most k adds, which sum alike in any order for k = 2.
    flat = torch.where(keep, (r.expert - e0) * cap + r.slot, n_loc * cap)
    tok = torch.arange(T, device=x.device).expand(top_k, T)
    src = torch.full((n_loc * cap + 1,), T, dtype=torch.long,
                     device=x.device)
    src[flat] = tok                     # row T of xz is zero
    ye = piece(_experts, xt, src[:-1], w_up, w_down, dtype, tp is not None)
    if tp is not None:
        ye = _ReduceFromTP.apply(ye, tp).to(dtype)
    y = piece(_combine, ye, flat, gate, dtype)
    if ep is not None:
        y = _ReduceFromTP.apply(y, ep)
    return (y.to(dtype).view(B, S, d),
            balance_loss(probs, r, data) if aux else None)
