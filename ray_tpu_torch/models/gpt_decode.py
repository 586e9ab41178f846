"""Paged continuous-batching decode for the GPT model: the port of the
paged half of ``ray_tpu/models/gpt_decode.py``.

The device half of :class:`~ray_tpu_torch.serve.engine.DecodeEngine`:

- a pool of fixed-size KV pages ``[L, n_pages, page_size, H, hd]``
  (:func:`init_paged_cache`), fp in the compute dtype or int8 codes with
  one f32 scale per (layer, page, head) per side;
- each slot owns a page-table row (``[max_pages]`` int32, padded with
  :data:`PT_SENTINEL`) that maps its virtual sequence onto pages;
- :func:`prefill_into_slot_paged` runs a prompt suffix over the cached
  prefix read through the page table, with the copy-on-write fork of a
  mid-page prefix fused in, and returns the first (greedy) token;
- :func:`decode_chunk_slots_paged` runs k greedy decode steps over every
  slot; attention goes through :func:`paged_attention`, i.e. the CUDA
  kernel (``attn_kernel="cuda"``) or the plain gather version.

How the port differs from the reference, and why:

- **In-place pools.** The pool tensors are updated in place; that is
  what the reference's donated jit arguments achieve on the TPU
  (``gpt_decode.py:1455``, ``:1495``). Functions return only what the
  host needs.
- **Masked writes are decided on the host.** JAX scatters with
  ``mode="drop"`` and uses ``PT_SENTINEL`` as a discard target; torch has
  no drop mode and that index raises. Every write target depends only on
  host data the engine already holds (page table, active mask, the
  slot's position), so the index math runs in numpy and a dropped write
  is simply never issued. The pool itself never leaves the device.
- **Clamped reads are explicit.** Where JAX clamps an out-of-range gather
  or ``dynamic_slice`` start, the port clamps with ``clamp``/``np.clip``.
- **f32 where the reference accumulates in f32.** Every product feeding
  a softmax or the logits is formed from operands upcast to f32.
- **One host transfer per chunk** for tokens and done flags (and one for
  the first token of a prefill), as the reference's ``np.asarray`` syncs.
- **Greedy only.** Sampling at temperature > 0 needs the reference's
  threefry PRNG stream for parity and is a later slice.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from ..ops.paged_attention import (deq_page as _deq_page,
                                   paged_attention_cuda,
                                   paged_attention_gather
                                   as _paged_attention_gather,
                                   softmax_scale)
from .gpt import (GPTConfig, Params, _gelu, _mm, _project_vocab, _rmsnorm,
                  layer_params)

Cache = Dict[str, torch.Tensor]

#: Page-table padding value. Positive and far beyond any real pool size:
#: a write aimed at it is dropped, a read clamps to a real page whose
#: garbage the attention mask hides, and the kernel skips the column.
PT_SENTINEL = 2 ** 30

#: KV-pool storage dtypes: ``"fp"`` pages in the model compute dtype;
#: ``"int8"`` symmetric codes plus one f32 scale per (layer, page, head)
#: per side.
KV_DTYPES = ("fp", "int8")

#: Decode attention implementations: ``"gather"`` is the plain PyTorch
#: page-table gather + masked softmax; ``"cuda"`` the hand-written kernel
#: (its plain version on CPU tensors).
ATTN_KERNELS = ("gather", "cuda")

#: Quantization scale floor: an all-zero page quantizes to exact zeros.
_KV_EPS = 1e-8


def _to_device(a, device: torch.device) -> torch.Tensor:
    """Host array → tensor on ``device`` (a copy). To a card the copy
    goes through pinned memory without a stream sync, so the host keeps
    launching while the device works."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


def _block_kv(x, p, cfg: GPTConfig):
    """Training block up to attention: returns (q, k, v), ``[B, S, H, hd]``
    each."""
    B, S, _ = x.shape
    h = _rmsnorm(x, p["ln1_scale"])
    q = _mm(h, p["wq"], cfg.dtype).reshape(B, S, -1, cfg.head_dim)
    k = _mm(h, p["wk"], cfg.dtype).reshape(B, S, -1, cfg.head_dim)
    v = _mm(h, p["wv"], cfg.dtype).reshape(B, S, -1, cfg.head_dim)
    return q, k, v


def _ffn(x, p, cfg: GPTConfig):
    h = _rmsnorm(x, p["ln2_scale"])
    h = _gelu(_mm(h, p["w1"], cfg.dtype))
    return x + _mm(h, p["w2"], cfg.dtype)


def _sample_slots(logits: torch.Tensor) -> torch.Tensor:
    """Greedy per-slot sampling: first index of the maximum, as
    ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def kv_bytes_per_page(cfg: GPTConfig, page_size: int,
                      kv_dtype: str = "fp") -> int:
    """Device bytes ONE physical page costs across all layers, K and V
    together: ``page_size * H * hd`` elements of the compute dtype per
    side for ``"fp"``, the same count of 1-byte codes plus one f32 scale
    per head per side for ``"int8"``."""
    elems = page_size * cfg.n_head * cfg.head_dim
    if kv_dtype == "int8":
        per_layer = 2 * (elems + 4 * cfg.n_head)
    else:
        per_layer = 2 * elems * cfg.dtype.itemsize
    return cfg.n_layer * per_layer


def init_paged_cache(cfg: GPTConfig, slots: int, n_pages: int,
                     page_size: int, kv_dtype: str = "fp",
                     device: DeviceLike = None) -> Cache:
    """Zeroed paged KV pool: ``k``/``v`` ``[L, n_pages, page_size, H,
    hd]``, per-slot virtual positions ``pos [slots]`` int32, and for int8
    the ``ks``/``vs`` ``[L, n_pages, H]`` f32 scales."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    dev = resolve_device(device)
    shape = (cfg.n_layer, n_pages, page_size, cfg.n_head, cfg.head_dim)
    quant = kv_dtype == "int8"
    dt = torch.int8 if quant else cfg.dtype
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev),
             "pos": torch.zeros(slots, dtype=torch.int32, device=dev)}
    if quant:
        sshape = (cfg.n_layer, n_pages, cfg.n_head)
        cache["ks"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
        cache["vs"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
    return cache


class _SpanPlan(NamedTuple):
    """The touched pages of one span write (:func:`_span_plan`), on the
    pool's device. N = number of (slot, page) pairs the span touches."""

    rows: torch.Tensor      # [N] slot of each touched page
    page: torch.Tensor      # [N] physical page
    src: torch.Tensor       # [N, ps] source row in ``vals`` (clamped)
    write: torch.Tensor     # [N, ps] position takes a new row
    keep: torch.Tensor      # [N, ps] position keeps its old code
    has_old: torch.Tensor   # [N] page holds valid old content


def _span_plan(pt, start, count: int, active, page_size: int, S: int,
               n_pages: int, device: torch.device) -> _SpanPlan:
    """Host half of :func:`_merge_span_int8`: which pages a span write of
    ``count`` rows at each slot's ``start`` touches, and which of their
    positions take new rows, keep old codes, or become canonical zeros.
    Pages the reference's drop-mode scatter would discard (inactive
    slots, columns past the table, unmapped targets) are left out. The
    plan depends on no K/V values, so one plan serves every layer and
    both sides."""
    pt = np.asarray(pt, np.int64)
    start = np.asarray(start, np.int64).reshape(-1)
    active = np.asarray(active, bool).reshape(-1)
    ps = page_size
    max_pages = pt.shape[1]
    T = (S - 1) // ps + 2       # pages a span of S rows can straddle
    vp = start[:, None] // ps + np.arange(T)[None, :]             # [B, T]
    page_idx = np.take_along_axis(pt, np.clip(vp, 0, max_pages - 1), 1)
    pstart = vp * ps
    o = np.arange(ps)
    src = pstart[:, :, None] + o - start[:, None, None]          # [B,T,ps]
    wmask = (src >= 0) & (src < count)
    touched = (wmask.any(axis=2) & (vp < max_pages) & (page_idx >= 0)
               & (page_idx < n_pages) & active[:, None])
    bi, ti = np.nonzero(touched)
    ps_ = pstart[bi, ti]
    packed = np.concatenate([
        np.stack([bi, page_idx[bi, ti], ps_ < start[bi]], axis=1),
        np.clip(src[bi, ti], 0, S - 1),
        wmask[bi, ti],
        (ps_[:, None] + o) < start[bi][:, None],
    ], axis=1).astype(np.int64)
    d = _to_device(packed, device)
    return _SpanPlan(rows=d[:, 0], page=d[:, 1], has_old=d[:, 2].bool(),
                     src=d[:, 3:3 + ps], write=d[:, 3 + ps:3 + 2 * ps].bool(),
                     keep=d[:, 3 + 2 * ps:].bool())


def _merge_span_int8(codes: torch.Tensor, scales: torch.Tensor,
                     vals: torch.Tensor, plan: _SpanPlan) -> None:
    """Scatter a contiguous span of fp K (or V) rows ``vals [B, S, H,
    hd]`` into int8 pages, in place (``gpt_decode.py:906``).

    Scales are page-granular, so every touched page is read, its
    surviving old codes requantized, the new rows inserted, and the page
    written back. The reference's three invariants hold:

    - **Monotone scales**: a touched page's scale becomes
      ``max(s_old, absmax(new) / 127)`` (floored at :data:`_KV_EPS`), so
      an unchanged scale requantizes old codes to themselves;
    - **Fresh pages reset**: a page with no valid old content for the
      slot takes ``s_old = 0`` and drops a previous tenant's codes;
    - **Canonical zeros**: positions past the span in a touched page are
      zero, so a page's bytes depend only on the tokens it holds.

    ``plan`` (:func:`_span_plan`) names the touched pages; nothing else
    is written."""
    if plan.page.numel() == 0:
        return
    new = vals.float()[plan.rows[:, None], plan.src]
    new = torch.where(plan.write[..., None, None], new, 0.0)
    old_c = codes[plan.page]                         # [N, ps, H, hd]
    old_s = scales[plan.page]                        # [N, H]
    s_base = torch.where(plan.has_old[:, None], old_s, 0.0)
    s_new = torch.maximum(s_base, new.abs().amax(dim=(1, 3)) / 127.0
                          ).clamp_min(_KV_EPS)
    ratio = (s_base / s_new)[:, None, :, None]
    old_rq = torch.where(plan.keep[..., None, None],
                         torch.round(old_c.float() * ratio), 0.0)
    merged = torch.where(plan.write[..., None, None],
                         torch.round(new / s_new[:, None, :, None]),
                         old_rq).clamp(-127, 127).to(torch.int8)
    codes[plan.page] = merged
    scales[plan.page] = s_new


def paged_attention(q, kc, vc, pt, pos, *, page_size: int,
                    kernel: str = "gather", ks=None, vs=None
                    ) -> torch.Tensor:
    """One decode step of paged attention (``gpt_decode.py:1019``): each
    slot's query ``q [B, 1, H, hd]`` attends over the pages mapped by
    ``pt [B, max_pages]`` (int32, on q's device), valid at positions
    ``<= pos[b]``. ``kernel="cuda"`` is the hand-written kernel (its
    plain version for CPU tensors), ``"gather"`` the plain version."""
    if kernel == "cuda":
        return paged_attention_cuda(q, kc, vc, pt, pos, page_size, ks, vs)
    if kernel == "gather":
        return _paged_attention_gather(q, kc, vc, pt, pos, page_size, ks,
                                       vs)
    raise ValueError(f"unknown attention kernel {kernel!r}; expected one "
                     f"of {ATTN_KERNELS}")


def prefill_into_slot_paged(params: Params, cache: Cache, tokens,
                            length: int, hist_len: int, pt_row,
                            cow_src: int, slot: int, *, cfg: GPTConfig,
                            page_size: int, kv_dtype: str = "fp") -> int:
    """Prefill one prompt **suffix** into its pages, fused with the
    optional copy-on-write fork; returns the greedy first token
    (``gpt_decode.py:1199``).

    ``tokens [1, S_bucket]`` is the prompt minus its cached prefix,
    right-padded; ``length`` its true length; ``hist_len`` the cached
    prefix length; ``pt_row [max_pages]`` the slot's page table (shared
    prefix pages first, :data:`PT_SENTINEL` beyond); ``cow_src`` the page
    to fork into ``pt_row[hist_len // page_size]`` before writing (a
    prefix that ends mid-page), or :data:`PT_SENTINEL` for none. All of
    these are host values. The pool and ``pos[slot]`` are updated in
    place; pad positions are never written.

    Suffix tokens sit at positions ``hist_len + i`` and attend over the
    history read through the page table (valid ``< hist_len``) and over
    themselves, causally. With int8 pools the history dequantizes
    through :func:`_deq_page` and the suffix K/V land through
    :func:`_merge_span_int8`; the block math itself runs on the exact fp
    K/V, so the first token does not depend on the quantizer."""
    dev = cache["k"].device
    tokens = np.asarray(tokens, np.int64).reshape(1, -1)
    S = tokens.shape[1]
    length, hist_len = int(length), int(hist_len)
    cow_src, slot = int(cow_src), int(slot)
    pt_row = np.asarray(pt_row, np.int64).reshape(-1)
    max_pages = pt_row.shape[0]
    n_pages = cache["k"].shape[1]
    ps, hd = page_size, cfg.head_dim
    quant = kv_dtype == "int8"
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    scale = softmax_scale(hd)

    positions = np.clip(hist_len + np.arange(S), 0, cfg.max_seq - 1)
    idx = _to_device(np.stack([tokens[0], positions]), dev)
    x = params["embed"].to(cfg.dtype)[idx[0]][None]
    x = x + params["pos_embed"][idx[1]].to(cfg.dtype)[None]

    # COW fork first: the page holding position hist_len takes cow_src's
    # contents (codes and scales) across every layer.
    dst = int(pt_row[min(max(hist_len // ps, 0), max_pages - 1)])
    if 0 <= cow_src < n_pages and 0 <= dst < n_pages:
        for name in names:
            cache[name][:, dst] = cache[name][:, cow_src]

    # History: only the pages covering [0, hist_len) are read.
    n_hist = min(-(-hist_len // ps), max_pages)
    hist_pages = _to_device(np.clip(pt_row[:n_hist], 0, n_pages - 1), dev)
    hist_valid = torch.arange(n_hist * ps, device=dev) < hist_len
    self_mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()

    # Suffix write targets: token i lands at (pt_row[vpos // ps],
    # vpos % ps), vpos = hist_len + i; pad rows and unmapped targets are
    # dropped.
    if quant:
        plan = _span_plan(pt_row[None], [hist_len], length, [True], ps, S,
                          n_pages, dev)
    else:
        wpos = hist_len + np.arange(S)
        vp = wpos // ps
        page_idx = pt_row[np.clip(vp, 0, max_pages - 1)]
        ok = ((np.arange(S) < length) & (vp < max_pages) & (page_idx >= 0)
              & (page_idx < n_pages))
        rows = np.flatnonzero(ok)
        w = _to_device(np.stack([rows, page_idx[rows], wpos[rows] % ps]),
                       dev)

    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        q, k, v = _block_kv(x, p, cfg)                  # [1, S, H, hd]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * scale
        logits = torch.where(self_mask, logits, -1e30)
        vv = v
        if n_hist:
            hk = cache["k"][i][hist_pages]              # [n_hist, ps, H, hd]
            hv = cache["v"][i][hist_pages]
            if quant:
                hk = _deq_page(hk, cache["ks"][i][hist_pages], cfg.dtype)
                hv = _deq_page(hv, cache["vs"][i][hist_pages], cfg.dtype)
            hk = hk.reshape(n_hist * ps, -1, hd)
            hv = hv.reshape(n_hist * ps, -1, hd)
            lg_h = torch.einsum("bqhd,khd->bhqk", q.float(),
                                hk.float()) * scale
            lg_h = torch.where(hist_valid, lg_h, -1e30)
            logits = torch.cat([lg_h, logits], dim=-1)
            vv = torch.cat([hv[None].to(q.dtype), v], dim=1)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        att = torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                           vv.float()).to(q.dtype).reshape(1, S, -1)
        x = x + _mm(att, p["wo"], cfg.dtype)
        x = _ffn(x, p, cfg)
        # This layer's history was read above; its writes come after.
        if quant:
            _merge_span_int8(cache["k"][i], cache["ks"][i], k, plan)
            _merge_span_int8(cache["v"][i], cache["vs"][i], v, plan)
        else:
            cache["k"][i][w[1], w[2]] = k[0, w[0]]
            cache["v"][i][w[1], w[2]] = v[0, w[0]]

    x = _rmsnorm(x, params["ln_f_scale"])
    last = min(max(length - 1, 0), S - 1)
    logits = _project_vocab(x[:, last:last + 1], params["embed"], cfg)
    cache["pos"][slot] = hist_len + length
    # One transfer per admission: the TTFT token.
    return int(_sample_slots(logits[:, 0])[0])


def _slot_decode_step_paged(params: Params, cache: Cache,
                            token: torch.Tensor, active, pt, pos,
                            cfg: GPTConfig, page_size: int,
                            kv_dtype: str = "fp",
                            attn_kernel: str = "gather") -> torch.Tensor:
    """One decode step over every slot (``gpt_decode.py:1334``): each
    active slot writes its new K/V at ``(pt[b, pos[b] // ps], pos[b] %
    ps)`` (int8 pools merge through :func:`_merge_span_int8`), attends
    over its virtual sequence valid ``<= pos[b]``, and advances ``pos``.
    Inactive slots neither write nor advance; their logits rows are
    garbage the host ignores.

    ``token [B]`` is on the pool's device; ``active [B]``, ``pt [B,
    max_pages]`` and ``pos [B]`` are host arrays (``pos`` mirrors
    ``cache["pos"]``). Returns f32 logits ``[B, vocab]``."""
    dev = cache["k"].device
    B = token.shape[0]
    ps = page_size
    n_pages = cache["k"].shape[1]
    quant = kv_dtype == "int8"
    active = np.asarray(active, bool)
    pt = np.asarray(pt, np.int32)
    pos = np.asarray(pos, np.int64)
    pos_d = cache["pos"]
    x = params["embed"].to(cfg.dtype)[token.long()][:, None]
    x = x + params["pos_embed"][pos_d.long().clamp(0, cfg.max_seq - 1)
                                ].to(cfg.dtype)[:, None]
    pt_d = _to_device(pt, dev)
    if quant:
        plan = _span_plan(pt, pos, 1, active, ps, 1, n_pages, dev)
    else:
        vp = pos // ps
        page_idx = pt[np.arange(B), np.clip(vp, 0, pt.shape[1] - 1)]
        ok = (active & (vp < pt.shape[1]) & (page_idx >= 0)
              & (page_idx < n_pages))
        rows = np.flatnonzero(ok)
        w = _to_device(np.stack([rows, page_idx[rows], pos[rows] % ps]),
                       dev)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        q, k, v = _block_kv(x, p, cfg)                  # [B, 1, H, hd]
        kc, vc = cache["k"][i], cache["v"][i]
        ksc = vsc = None
        if quant:
            ksc, vsc = cache["ks"][i], cache["vs"][i]
            _merge_span_int8(kc, ksc, k, plan)
            _merge_span_int8(vc, vsc, v, plan)
        else:
            kc[w[1], w[2]] = k[w[0], 0]
            vc[w[1], w[2]] = v[w[0], 0]
        att = paged_attention(q, kc, vc, pt_d, pos_d, page_size=ps,
                              kernel=attn_kernel, ks=ksc, vs=vsc)
        x = x + _mm(att.reshape(B, 1, -1), p["wo"], cfg.dtype)
        x = _ffn(x, p, cfg)
    pos_d += _to_device(active.astype(np.int32), dev)
    x = _rmsnorm(x, params["ln_f_scale"])
    return _project_vocab(x, params["embed"], cfg)[:, 0]


def decode_chunk_slots_paged(params: Params, cache: Cache, token, active,
                             pt, *, cfg: GPTConfig, k: int, page_size: int,
                             eos_token: int = -1, kv_dtype: str = "fp",
                             attn_kernel: str = "gather"
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """k greedy decode steps over the whole pool, the page table held
    constant through the chunk (``gpt_decode.py:1405``; the engine maps
    pages covering ``pos + k`` first, or parks the slot out of
    ``active``). The reference's ``lax.scan`` is a Python loop; the pool
    is updated in place.

    ``token [B]`` (each slot's last token), ``active [B]`` and ``pt [B,
    max_pages]`` are host arrays. EOS lanes mask-and-carry: once a lane
    samples ``eos_token`` it keeps emitting it. Returns host arrays
    ``(tokens [B, k] int32, done [B] bool)``, fetched in ONE transfer;
    rows of inactive slots are garbage."""
    dev = cache["k"].device
    active = np.asarray(active, bool)
    pt = np.asarray(pt, np.int32)
    # At a chunk boundary the device queue is already drained (the last
    # chunk's tokens were read), so this read costs no stall.
    pos = cache["pos"].cpu().numpy().astype(np.int64)
    tok = _to_device(np.asarray(token, np.int32), dev)
    act_d = _to_device(active, dev)
    done = (act_d & (tok == eos_token)) if eos_token >= 0 else \
        torch.zeros_like(act_d)
    toks = []
    for _ in range(k):
        logits = _slot_decode_step_paged(params, cache, tok, active, pt,
                                         pos, cfg, page_size, kv_dtype,
                                         attn_kernel)
        nxt = _sample_slots(logits)
        if eos_token >= 0:
            nxt = torch.where(done, eos_token, nxt).to(torch.int32)
            done = done | (act_d & (nxt == eos_token))
        toks.append(nxt)
        tok = nxt
        pos = pos + active
    out = torch.cat([torch.stack(toks, dim=1),
                     done[:, None].to(torch.int32)], dim=1).cpu().numpy()
    return out[:, :k].copy(), out[:, k].astype(bool)
