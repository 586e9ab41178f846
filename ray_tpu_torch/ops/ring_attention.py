"""Sequence-parallel attention, ring (point to point) and Ulysses
(all-to-all): the port of ``ray_tpu/ops/ring_attention.py``.

Both run on this rank's sequence chunk ``[B, S/n, H, hd]`` over a
:class:`~ray_tpu_torch.collective.collective.MeshGroup` along the ``sp``
axis (the reference calls them inside ``shard_map`` over that axis), and
both are plain PyTorch, as the reference's are plain einsums with no
Pallas kernel. The collectives are ``torch.autograd.Function``s whose
backward is the transposed exchange, so gradients come through autograd.

**Ring** (:func:`ring_attention`): the K/V chunks travel round the ring
(each rank sends to ``rank + 1``) while every rank keeps an online
softmax over its own queries. Under ``causal`` a chunk from a later rank
is skipped and the rank's own chunk takes the triangular mask.

**Ulysses** (:func:`ulysses_attention`): an all-to-all swaps the sequence
shard for a head shard, each rank attends over the whole sequence for
``H/n`` heads, and a second all-to-all swaps back.

Rounding follows the reference: q is scaled in its dtype, logits and the
softmax state are f32, p is cast to v's dtype before ``p . v``, and the
output is cast once. ``group=None`` (or a one-rank group) is the local
case.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


class _Permute(torch.autograd.Function):
    """Rank ``r`` receives rank ``r - shift``'s tensor; the backward sends
    each gradient the other way."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return group.permute(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.permute(g, -ctx.shift), None, None


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``tied`` tensors as extra inputs that get
    zero gradients: a K/V chunk this rank skips still takes part in the
    backward's ring, whose exchanges every rank must join."""

    @staticmethod
    def forward(ctx, out, *tied):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tied]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.like))


class _SeqToHeads(torch.autograd.Function):
    """``[B, S/n, H, hd]`` → ``[B, S, H/n, hd]``: rank j receives head
    block j of every rank's chunk (``all_to_all(split_axis=2,
    concat_axis=1)``); the backward is :class:`_HeadsToSeq`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


def _seq_to_heads(x, group):
    n = group.world_size
    B, Sl, H, hd = x.shape
    parts = group.alltoall(torch.stack(x.chunk(n, dim=2)))  # [n, B, Sl, H/n, hd]
    return torch.cat(parts.unbind(0), dim=1)


def _heads_to_seq(x, group):
    n = group.world_size
    parts = group.alltoall(torch.stack(x.chunk(n, dim=1)))  # [n, B, S/n, H/n, hd]
    return torch.cat(parts.unbind(0), dim=2)


def _size(group) -> int:
    return 1 if group is None else group.world_size


def ring_attention(q, k, v, *, group=None, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``group`` (``ring_attention.py:44``).

    q, k, v: this rank's chunks ``[B, S_loc, H, hd]`` of a sequence
    sharded over the group in rank order. Returns this rank's output
    ``[B, S_loc, H, hd]``."""
    n = _size(group)
    r = 0 if group is None else group.rank
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    Sq, Sk = q.shape[1], k.shape[1]
    tril = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
    qf = (q * torch.tensor(sm_scale, dtype=q.dtype)).float()
    o = m = l = None
    kv = torch.cat([k, v], dim=-1)
    hd = k.shape[-1]
    skipped = []
    for t in range(n):
        src = (r - t) % n
        if t:
            kv = _Permute.apply(kv, group, 1)
        if causal and src > r:
            skipped.append(kv)
            continue
        kc, vc = kv[..., :hd], kv[..., hd:]
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float())
        if causal and src == r:
            logits = torch.where(tril, logits, NEG_INF)
        if m is None:
            m_new = logits.amax(-1)
            p = torch.exp(logits - m_new[..., None])
            l = p.sum(-1)
            o = torch.einsum("bhqk,bkhd->bqhd", p.to(vc.dtype).float(),
                             vc.float())
        else:
            m_new = torch.maximum(m, logits.amax(-1))          # [B,H,Sq]
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vc.dtype).float(),
                              vc.float())
            o = o * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    return _Tie.apply(out, *skipped) if skipped else out


def ulysses_attention(q, k, v, *, group=None, causal: bool = True,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses attention over ``group`` (``ring_attention.py:111``): q, k,
    v ``[B, S_loc, H, hd]`` chunks; needs ``H % n == 0``."""
    n = _size(group)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"ulysses needs n_head ({H}) % axis size ({n}) "
                         f"== 0")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if n > 1:
        q, k, v = (_SeqToHeads.apply(t, group) for t in (q, k, v))
    S = q.shape[1]
    logits = torch.einsum(
        "bqhd,bkhd->bhqk",
        (q * torch.tensor(sm_scale, dtype=q.dtype)).float(), k.float())
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                     v.float()).to(q.dtype)
    return _HeadsToSeq.apply(o, group) if n > 1 else o
