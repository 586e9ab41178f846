"""KV-cache decoding for the GPT model: the port of
``ray_tpu/models/gpt_decode.py`` (flat pool, paged pool, speculative
verify, KV handoff).

The device half of :class:`~ray_tpu_torch.serve.engine.DecodeEngine`:

- **Flat pools** (``gpt_decode.py:292-852``): :func:`init_cache` /
  :func:`prefill` / :func:`decode_step` / :func:`decode_chunk` drive one
  batch at a shared depth (:func:`generate`, :func:`generate_chunked`);
  :func:`init_slot_cache` reserves ``max_len`` positions per slot with a
  per-slot ``pos``, filled by :func:`prefill_into_slot` and advanced by
  :func:`decode_chunk_slots`.
- **Paged pools**: fixed-size KV pages ``[L, n_pages, page_size, H,
  hd]`` (:func:`init_paged_cache`), fp in the compute dtype or int8
  codes with one f32 scale per (layer, page, head) per side; each slot
  owns a page-table row (``[max_pages]`` int32, padded with
  :data:`PT_SENTINEL`). :func:`prefill_into_slot_paged` runs a prompt
  suffix over the cached prefix, with the copy-on-write fork of a
  mid-page prefix fused in; :func:`decode_chunk_slots_paged` runs k
  decode steps over every slot, attention through
  :func:`paged_attention` (the CUDA kernel, ``attn_kernel="cuda"``, or
  the plain gather version).
- **Speculative verify** (``gpt_decode.py:1549-1780``):
  :func:`verify_chunk_slots` / :func:`verify_chunk_slots_paged` score a
  drafter's k proposals per slot in one batched forward and commit the
  accepted prefix plus a correction/bonus token (:func:`_spec_accept`).
- **KV handoff** (``gpt_decode.py:1781-1876``): :func:`export_slot_kv` /
  :func:`export_slot_kv_paged` copy one slot's K/V out of a pool (with
  ``length``, trimmed and page-gathered on the device, so only the
  shipped bytes reach the host) and :func:`import_slot_kv` /
  :func:`import_slot_kv_paged` write a shipped prefill back, dropping
  unmapped pages; :func:`kv_to_host` / :func:`kv_from_host` carry bf16
  K/V as ``np.uint16`` bits, the reference's bytes without
  ``ml_dtypes``.
- **Sampling**: greedy (first-index argmax) at temperature 0, else
  ``categorical(sub, logits / temperature)`` with a per-slot key chain
  split exactly like the reference's, through the port's threefry
  (:mod:`ray_tpu_torch._private.prng`), so seeded streams are the
  reference's token for token. Host PRNG lanes are ``np.uint32 [slots,
  2]``; a chunk's lanes come back in the same transfer as its tokens.

How the port differs from the reference, and why:

- **In-place pools.** The pool tensors are updated in place; that is
  what the reference's donated jit arguments achieve on the TPU
  (``gpt_decode.py:1455``, ``:1495``). Functions return only what the
  host needs. ``lax.scan`` is a Python loop; the ``jit_*`` wrappers have
  no counterpart.
- **Masked writes are decided on the host.** JAX scatters with
  ``mode="drop"`` and uses ``PT_SENTINEL`` as a discard target; torch has
  no drop mode and that index raises. Every write target depends only on
  host data the engine already holds (page table, active mask, the
  slot's position, read once per chunk), so the index math runs in
  numpy and a dropped write is simply never issued. The pool itself
  never leaves the device.
- **Clamped reads are explicit.** Where JAX clamps an out-of-range gather
  or ``dynamic_slice`` start, the port clamps with ``clamp``/``np.clip``.
- **f32 where the reference accumulates in f32.** Every product feeding
  a softmax or the logits is formed from operands upcast to f32.
- **One host transfer per chunk** for tokens, done flags and PRNG lanes
  (and one for the first token of a prefill), as the reference's
  ``np.asarray`` syncs.
- Tensor parallelism (``shard_params``, ``_tp_*``) is a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._private import prng
from .._private.device import (DeviceLike, resolve_device,
                               set_matmul_precision)
from ..ops.paged_attention import (deq_page as _deq_page,
                                   paged_attention_cuda,
                                   paged_attention_gather
                                   as _paged_attention_gather,
                                   softmax_scale)
from .gpt import GPTConfig, Params
from .gpt import _ffn as _block_ffn
from .gpt import _mm, _project_vocab, _rmsnorm, layer_params

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
    """The block's FFN with its residual (``gpt_decode.py:317``): dense,
    or the MoE FFN with its load-balance term discarded. Every row of
    ``x`` competes for the experts' capacity, inactive slots' and pad
    rows included, as in the reference."""
    y, _ = _block_ffn(_rmsnorm(x, p["ln2_scale"]), p, cfg, aux=False)
    return x + y


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    """Token ids, a host array or a tensor, as a tensor on ``device``."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device)
    return _to_device(np.asarray(tokens, np.int64), device)


def _keys(rng, device: torch.device) -> torch.Tensor:
    """Host PRNG words (``np.uint32 [..., 2]``, as the reference's host
    lanes) or a key tensor → int64 key tensor on ``device``."""
    if isinstance(rng, torch.Tensor):
        return rng.to(device=device, dtype=torch.int64)
    return _to_device(np.asarray(rng, np.uint32).astype(np.int64), device)


def _to_host(*tensors: torch.Tensor):
    """Several small device tensors → host int64 arrays in ONE
    transfer."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
    flat = flat.cpu().numpy()
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


def _sample(logits: torch.Tensor, temperature: float, key: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sampling decision over ``logits [B, vocab]`` with ONE key
    (``gpt_decode.py:443``): greedy iff ``temperature == 0``, else the
    key splits into (carry, sub) and ``sub`` draws one Gumbel block over
    the whole batch. Returns ``(token [B] int32, key')``."""
    if temperature > 0.0:
        key, sub = prng.split(key).unbind(0)
        token = prng.categorical(sub, logits / temperature)
    else:
        token = torch.argmax(logits, dim=-1)
    return token.to(torch.int32), key


def _sample_slots(logits: torch.Tensor, temperature: float = 0.0,
                  keys: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-slot sampling with independent PRNG lanes
    (``gpt_decode.py:737``): each slot's key ``keys [B, 2]`` splits
    exactly like :func:`_sample`'s and draws from ``categorical(sub,
    logits[b] / temperature)``, so a slot's stream depends only on its
    seed. At temperature 0 the first-index argmax, keys unchanged."""
    if temperature > 0.0:
        keys, subs = prng.split(keys).unbind(1)
        token = prng.categorical(subs, logits / temperature)
    else:
        token = torch.argmax(logits, dim=-1)
    return token.to(torch.int32), keys


def _attend(q: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor, valid,
            scale: float) -> torch.Tensor:
    """Masked softmax attention of ``q [B, Sq, H, hd]`` over ``kk``/``vv
    [B, Sk, H, hd]`` (``valid`` broadcasts to ``[B, H, Sq, Sk]``): f32
    logits, probs cast to the compute dtype, f32 accumulation, one cast
    — the reference's ``preferred_element_type=f32`` einsums. Returns
    ``[B, Sq, H * hd]``."""
    B, Sq = q.shape[:2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), vv.float()
                        ).to(q.dtype).reshape(B, Sq, -1)


# --------------------------------------------------------------- flat pool
def init_cache(cfg: GPTConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Cache:
    """Zeroed flat cache for one batch at a shared depth
    (``gpt_decode.py:292``): ``k``/``v`` ``[L, batch, max_len, H, hd]``
    in the compute dtype and a scalar int32 ``pos``."""
    dev = resolve_device(device)
    shape = (cfg.n_layer, batch, max_len, cfg.n_head, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def init_slot_cache(cfg: GPTConfig, slots: int, max_len: int,
                    device: DeviceLike = None) -> Cache:
    """Zeroed flat slot pool (``gpt_decode.py:619``): ``max_len``
    positions reserved per slot and a per-slot ``pos [slots]``, so every
    slot decodes at its own depth."""
    cache = init_cache(cfg, slots, max_len, device)
    cache["pos"] = torch.zeros(slots, dtype=torch.int32,
                               device=cache["k"].device)
    return cache


def _embed(params: Params, tokens: torch.Tensor, positions: torch.Tensor,
           cfg: GPTConfig) -> torch.Tensor:
    """Token plus (clamped) position embeddings in the compute dtype."""
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    return x + params["pos_embed"][positions.long().clamp(
        0, cfg.max_seq - 1)].to(cfg.dtype)


def prefill(params: Params, tokens, cfg: GPTConfig, cache: Cache
            ) -> torch.Tensor:
    """Run the prompt ``tokens [B, S]`` once, filling positions ``[0,
    S)`` of the flat cache and setting ``pos = S`` (``gpt_decode.py:332``).
    Returns the last position's f32 logits ``[B, vocab]``."""
    dev = cache["k"].device
    tok = _tokens(tokens, dev)
    B, S = tok.shape
    x = _embed(params, tok, torch.arange(S, device=dev)[None], cfg)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    scale = softmax_scale(cfg.head_dim)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        q, k, v = _block_kv(x, p, cfg)
        x = x + _mm(_attend(q, k, v, mask, scale), p["wo"], cfg.dtype)
        x = _ffn(x, p, cfg)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    cache["pos"].fill_(S)
    x = _rmsnorm(x, params["ln_f_scale"])
    return _project_vocab(x[:, -1:], params["embed"], cfg)[:, 0]


def _decode_step(params: Params, cache: Cache, token: torch.Tensor,
                 cfg: GPTConfig, pos: int) -> torch.Tensor:
    """:func:`decode_step` at the host-known depth ``pos``."""
    dev = cache["k"].device
    max_len = cache["k"].shape[2]
    # dynamic_update_slice clamps its start: a write past the end lands
    # on the last position (only tokens the host discards get there).
    w = min(pos, max_len - 1)
    x = _embed(params, token[:, None],
               torch.full((1, 1), pos, device=dev), cfg)
    valid = torch.arange(max_len, device=dev) <= pos
    scale = softmax_scale(cfg.head_dim)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        q, k, v = _block_kv(x, p, cfg)                  # [B, 1, H, hd]
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, w] = k[:, 0]
        vc[:, w] = v[:, 0]
        x = x + _mm(_attend(q, kc, vc, valid, scale), p["wo"], cfg.dtype)
        x = _ffn(x, p, cfg)
    cache["pos"] += 1
    x = _rmsnorm(x, params["ln_f_scale"])
    return _project_vocab(x, params["embed"], cfg)[:, 0]


def decode_step(params: Params, cache: Cache, token,
                cfg: GPTConfig) -> torch.Tensor:
    """One autoregressive step over a flat cache (``gpt_decode.py:374``):
    ``token [B]`` is written at ``pos`` and attends over ``<= pos``;
    ``pos`` advances by one. Returns f32 logits ``[B, vocab]``."""
    return _decode_step(params, cache, _tokens(token, cache["k"].device),
                        cfg, int(cache["pos"]))


def _on_device(params: Params, device: DeviceLike) -> Params:
    dev = resolve_device(device)
    set_matmul_precision(dev)
    return {k: v.to(dev) for k, v in params.items()}


def generate(params: Params, prompt, cfg: GPTConfig, max_new_tokens: int,
             max_len: int = 0, temperature: float = 0.0, rng=None, *,
             device: DeviceLike = None) -> Iterator[np.ndarray]:
    """Greedy/sampled generation over a flat cache
    (``gpt_decode.py:413``); yields one host ``[B]`` int32 token array
    per step. ``rng`` is a key (``np.uint32 [2]``), by default
    ``PRNGKey(0)``, split once per sampled step."""
    params = _on_device(params, device)
    dev = params["embed"].device
    B, S = np.shape(prompt)
    max_len = max_len or cfg.max_seq
    if S + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"cache length {max_len}")
    key = _keys(prng.PRNGKey(0) if rng is None else rng, dev)
    cache = init_cache(cfg, B, max_len, dev)
    logits = prefill(params, prompt, cfg, cache)
    for i in range(max_new_tokens):
        token, key = _sample(logits, temperature, key)
        yield token.cpu().numpy()
        if i + 1 < max_new_tokens:
            logits = _decode_step(params, cache, token, cfg, S + i)


def decode_chunk(params: Params, cache: Cache, token, rng=None, *,
                 cfg: GPTConfig, k: int, temperature: float = 0.0,
                 eos_token: int = -1):
    """k autoregressive steps over a flat cache (``gpt_decode.py:454``),
    the reference's ``lax.scan`` as a loop with no host sync inside.
    ``token [B]`` is the last emitted token. Returns device tensors
    ``(tokens [B, k] int32, done [B] bool, rng')``; finished lanes
    (``eos_token`` sampled or fed in) mask-and-carry."""
    dev = cache["k"].device
    tok = _tokens(token, dev)
    key = _keys(prng.PRNGKey(0) if rng is None else rng, dev)
    pos = int(cache["pos"])
    done = (tok == eos_token) if eos_token >= 0 else \
        torch.zeros(tok.shape, dtype=torch.bool, device=dev)
    toks = []
    for j in range(k):
        logits = _decode_step(params, cache, tok, cfg, pos + j)
        nxt, key = _sample(logits, temperature, key)
        if eos_token >= 0:
            nxt = torch.where(done, eos_token, nxt).to(torch.int32)
            done = done | (nxt == eos_token)
        toks.append(nxt)
        tok = nxt
    return torch.stack(toks, dim=1), done, key


def decode_until(step: Callable, params: Params, cache: Cache, token,
                 max_new: int, *, eos_token: int = -1, rng=None
                 ) -> Iterator[np.ndarray]:
    """Drive a chunk ``step(params, cache, token, rng) -> (tokens, done,
    rng')`` (e.g. :func:`decode_chunk` with its knobs bound) until
    ``max_new`` tokens are out or every stream sampled ``eos_token``
    (``gpt_decode.py:539``). Yields one host int32 ``[B, j]`` slice per
    chunk, cut at the first position where every lane is done."""
    dev = cache["k"].device
    rng = _keys(prng.PRNGKey(0) if rng is None else rng, dev)
    done = np.zeros((np.shape(token)[0],), bool)
    if eos_token >= 0:
        done |= np.asarray(token.cpu() if isinstance(token, torch.Tensor)
                           else token) == eos_token
    remaining = max_new
    while remaining > 0 and not done.all():
        toks_dev, _, rng = step(params, cache, token, rng)
        toks = toks_dev.cpu().numpy()          # ONE transfer per chunk
        j = min(toks.shape[1], remaining)
        if eos_token >= 0:
            cum = np.logical_or.accumulate(toks == eos_token, axis=1) \
                | done[:, None]
            all_done = np.all(cum, axis=0)
            if all_done.any():
                j = min(j, int(all_done.argmax()) + 1)
            done = cum[:, j - 1].copy()
        yield toks[:, :j]
        remaining -= j
        token = toks_dev[:, -1]                # stays on the device


def generate_chunked(params: Params, prompt, cfg: GPTConfig,
                     max_new_tokens: int, *, chunk: int = 8,
                     max_len: int = 0, temperature: float = 0.0, rng=None,
                     eos_token: int = -1, device: DeviceLike = None
                     ) -> Iterator[np.ndarray]:
    """Chunked twin of :func:`generate` (``gpt_decode.py:573``): yields
    host int32 ``[B, j]`` slices, first the prefill's token alone, then
    one per k-step chunk. The key chain matches :func:`generate`'s."""
    params = _on_device(params, device)
    dev = params["embed"].device
    B, S = np.shape(prompt)
    max_len = max_len or cfg.max_seq
    if max_new_tokens <= 0:
        return
    if S + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"cache length {max_len}")
    cache = init_cache(cfg, B, max_len, dev)
    logits = prefill(params, prompt, cfg, cache)
    key = _keys(prng.PRNGKey(0) if rng is None else rng, dev)
    token, key = _sample(logits, temperature, key)
    first = token.cpu().numpy()[:, None]
    yield first
    if max_new_tokens <= 1 or (eos_token >= 0
                               and (first == eos_token).all()):
        return

    def step(params, cache, token, rng):
        return decode_chunk(params, cache, token, rng, cfg=cfg, k=chunk,
                            temperature=temperature, eos_token=eos_token)

    yield from decode_until(step, params, cache, token, max_new_tokens - 1,
                            eos_token=eos_token, rng=key)


def prefill_into_slot(params: Params, cache: Cache, tokens, length: int,
                      slot: int, rng, *, cfg: GPTConfig,
                      temperature: float = 0.0) -> Tuple[int, np.ndarray]:
    """Run one right-padded prompt ``tokens [1, S_bucket]`` (true length
    ``length``) and write its K/V into slot ``slot`` of a flat pool
    (``gpt_decode.py:637``); ``pos[slot] = length``. The first token is
    sampled from position ``length - 1`` with the slot's key ``rng``
    (``np.uint32 [2]``). Returns ``(first_token, rng')`` in one
    transfer. Pad positions' K/V land beyond ``pos`` and are overwritten
    before any query reads them."""
    dev = cache["k"].device
    tokens = np.asarray(tokens, np.int64).reshape(1, -1)
    S = tokens.shape[1]
    length, slot = int(length), int(slot)
    x = _embed(params, _to_device(tokens, dev),
               torch.arange(S, device=dev)[None], cfg)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    scale = softmax_scale(cfg.head_dim)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        q, k, v = _block_kv(x, p, cfg)
        x = x + _mm(_attend(q, k, v, mask, scale), p["wo"], cfg.dtype)
        x = _ffn(x, p, cfg)
        cache["k"][i, slot, :S] = k[0]
        cache["v"][i, slot, :S] = v[0]
    last = min(max(length - 1, 0), S - 1)
    x = _rmsnorm(x[:, last:last + 1], params["ln_f_scale"])
    logits = _project_vocab(x, params["embed"], cfg)[:, 0]
    token, key = _sample(logits, temperature, _keys(rng, dev))
    cache["pos"][slot] = length
    tok, key = _to_host(token, key)
    return int(tok[0]), key.astype(np.uint32)


def _slot_decode_step(params: Params, cache: Cache, token: torch.Tensor,
                      active: np.ndarray, pos: np.ndarray,
                      cfg: GPTConfig) -> torch.Tensor:
    """One decode step over a flat slot pool (``gpt_decode.py:691``):
    each active slot writes its K/V at its own ``pos[b]`` (host mirror of
    ``cache["pos"]``; a write at ``max_len`` or beyond is dropped) and
    attends over ``<= pos[b]``; inactive slots neither write nor advance.
    Returns f32 logits ``[B, vocab]``."""
    dev = cache["k"].device
    max_len = cache["k"].shape[2]
    pos_d = cache["pos"]
    x = _embed(params, token[:, None], pos_d[:, None], cfg)
    valid = (torch.arange(max_len, device=dev)[None, :]
             <= pos_d[:, None].long())[:, None, None, :]
    rows = np.flatnonzero(active & (pos < max_len))
    w = _to_device(np.stack([rows, pos[rows]]), dev)
    scale = softmax_scale(cfg.head_dim)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        q, k, v = _block_kv(x, p, cfg)                  # [B, 1, H, hd]
        kc, vc = cache["k"][i], cache["v"][i]
        kc[w[0], w[1]] = k[w[0], 0]
        vc[w[0], w[1]] = v[w[0], 0]
        x = x + _mm(_attend(q, kc, vc, valid, scale), p["wo"], cfg.dtype)
        x = _ffn(x, p, cfg)
    pos_d += _to_device(active.astype(np.int32), dev)
    x = _rmsnorm(x, params["ln_f_scale"])
    return _project_vocab(x, params["embed"], cfg)[:, 0]


def _chunk_slots(step: Callable, cache: Cache, token, rngs, active, *,
                 k: int, temperature: float, eos_token: int):
    """The k-step loop shared by the flat and paged slot pools:
    ``step(tok, pos) -> logits`` runs one decode step; sampling, EOS
    mask-and-carry and the PRNG lanes are the same for both. Returns
    host ``(tokens [B, k] int32, done [B] bool, rngs' [B, 2] uint32)``
    in ONE transfer."""
    dev = cache["k"].device
    active = np.asarray(active, bool)
    # At a chunk boundary the device queue is already drained (the last
    # chunk's tokens were read), so this read costs no stall.
    pos = cache["pos"].cpu().numpy().astype(np.int64)
    tok = _to_device(np.asarray(token, np.int32), dev)
    keys = _keys(rngs, dev)
    act_d = _to_device(active, dev)
    done = (act_d & (tok == eos_token)) if eos_token >= 0 else \
        torch.zeros_like(act_d)
    toks = []
    for _ in range(k):
        logits = step(tok, pos)
        nxt, keys = _sample_slots(logits, temperature, keys)
        if eos_token >= 0:
            nxt = torch.where(done, eos_token, nxt).to(torch.int32)
            done = done | (act_d & (nxt == eos_token))
        toks.append(nxt)
        tok = nxt
        pos = pos + active
    toks, done, keys = _to_host(torch.stack(toks, dim=1), done, keys)
    return (toks.astype(np.int32), done.astype(bool),
            keys.astype(np.uint32))


def decode_chunk_slots(params: Params, cache: Cache, token, rngs, active,
                       *, cfg: GPTConfig, k: int, temperature: float = 0.0,
                       eos_token: int = -1
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """k decode steps over a flat slot pool (``gpt_decode.py:752``),
    decoding only slots where ``active`` is set. ``token [B]`` (each
    slot's last token), ``rngs [B, 2]`` (its PRNG lane, ``np.uint32``)
    and ``active [B]`` are host arrays. Returns host ``(tokens [B, k],
    done [B], rngs')`` in ONE transfer; rows of inactive slots are
    garbage. EOS lanes mask-and-carry."""
    active = np.asarray(active, bool)

    def step(tok, pos):
        return _slot_decode_step(params, cache, tok, active, pos, cfg)

    return _chunk_slots(step, cache, token, rngs, active, k=k,
                        temperature=temperature, eos_token=eos_token)


# -------------------------------------------------------------- paged pool
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
                            cow_src: int, slot: int, rng, *,
                            cfg: GPTConfig, page_size: int,
                            temperature: float = 0.0,
                            kv_dtype: str = "fp") -> Tuple[int, np.ndarray]:
    """Prefill one prompt **suffix** into its pages, fused with the
    optional copy-on-write fork and the first-token sample
    (``gpt_decode.py:1199``); returns ``(first_token, rng')`` in one
    transfer, the token sampled with the slot's key ``rng``
    (``np.uint32 [2]``) as :func:`_sample` does.

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
    token, key = _sample(logits[:, 0], temperature, _keys(rng, dev))
    cache["pos"][slot] = hist_len + length
    # One transfer per admission: the TTFT token and the slot's key.
    tok, key = _to_host(token, key)
    return int(tok[0]), key.astype(np.uint32)


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


def decode_chunk_slots_paged(params: Params, cache: Cache, token, rngs,
                             active, pt, *, cfg: GPTConfig, k: int,
                             page_size: int, temperature: float = 0.0,
                             eos_token: int = -1, kv_dtype: str = "fp",
                             attn_kernel: str = "gather"
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """k decode steps over the whole paged pool, the page table held
    constant through the chunk (``gpt_decode.py:1405``; the engine maps
    pages covering ``pos + k`` first, or parks the slot out of
    ``active``). Sampling, PRNG lanes and EOS mask-and-carry are the
    flat pool's (:func:`decode_chunk_slots`).

    ``token [B]`` (each slot's last token), ``rngs [B, 2]`` (``np.uint32``
    PRNG lanes), ``active [B]`` and ``pt [B, max_pages]`` are host
    arrays. Returns host ``(tokens [B, k] int32, done [B] bool, rngs')``,
    fetched in ONE transfer; rows of inactive slots are garbage."""
    active = np.asarray(active, bool)
    pt = np.asarray(pt, np.int32)

    def step(tok, pos):
        return _slot_decode_step_paged(params, cache, tok, active, pt, pos,
                                       cfg, page_size, kv_dtype,
                                       attn_kernel)

    return _chunk_slots(step, cache, token, rngs, active, k=k,
                        temperature=temperature, eos_token=eos_token)


# ------------------------------------------------------ speculative verify
def _spec_accept(logits: torch.Tensor, draft: torch.Tensor,
                 keys: torch.Tensor, temperature: float, k: int):
    """Acceptance and correction for the verify step
    (``gpt_decode.py:1549``). ``logits [B, k+1, vocab]`` are the
    target's rows over ``[last, d_1..d_k]`` (row i scores ``d_{i+1}``,
    row k samples the bonus); ``draft [B, k]`` the proposals; ``keys
    [B, 2]`` the slots' PRNG lanes.

    - temperature 0: ``d_{i+1}`` is accepted iff it is row i's argmax;
      the correction/bonus is ``argmax(row_{n_acc})``, so the committed
      tokens are the greedy target stream for any drafter.
    - temperature > 0: ``d`` is accepted with probability ``p_t(d)``
      (drafts are point proposals); a rejection samples the residual,
      ``p_t`` with ``d``'s mass removed; full acceptance samples the
      bonus from row k. Each slot's key splits into ``k + 2`` (carry
      plus one per row), each row's key into (uniform, sample): the
      consumption is static, so a seeded stream replays through any
      acceptance pattern.

    Returns device tensors ``(committed [B, k+1] int32, n_acc [B] int32,
    keys')``: ``committed[b, :n_acc[b]]`` are accepted drafts,
    ``committed[b, n_acc[b]]`` the correction/bonus, later entries
    repeat it."""
    draft = draft.long()
    am = torch.argmax(logits, dim=-1)                          # [B, k+1]
    if temperature <= 0.0:
        acc = am[:, :k] == draft
        samples = am
    else:
        ks = prng.split(keys, k + 2)                           # [B, k+2, 2]
        keys = ks[:, 0]
        ukeys, skeys = prng.split(ks[:, 1:]).unbind(2)         # [B, k+1, 2]
        scaled = logits / temperature
        p = torch.softmax(scaled[:, :k], dim=-1)
        pd = p.gather(2, draft[..., None])[..., 0]             # [B, k]
        acc = prng.uniform(ukeys[:, :k]) < pd
        residual = scaled[:, :k].scatter(2, draft[..., None], -1e30)
        corr = prng.categorical(skeys[:, :k], residual)        # [B, k]
        bonus = prng.categorical(skeys[:, k], scaled[:, k])    # [B]
        samples = torch.cat([corr, bonus[:, None]], dim=1)
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    c = samples.gather(1, n_acc[:, None])                      # [B, 1]
    committed = torch.where(
        torch.arange(k + 1, device=logits.device)[None, :] < n_acc[:, None],
        torch.cat([draft, c], dim=1), c)
    return committed.to(torch.int32), n_acc.to(torch.int32), keys


def _verify(params: Params, cache: Cache, token, draft, rngs, active, *,
            cfg: GPTConfig, k: int, temperature: float, plan: Callable):
    """The verify step shared by both pools: feeds ``[last, d_1..d_k]``
    at each slot's ``pos..pos+k`` (host ``pos``, read once at the round
    boundary), runs the layers with ``plan(active, pos, positions,
    pos_d) -> attend(layer, q, k, v)`` writing and attending the pool,
    scores all k+1 rows (:func:`_spec_accept`), advances ``pos`` by ``1 +
    n_acc`` on active slots, and returns host ``(committed, n_acc,
    rngs')`` in ONE transfer."""
    dev = cache["k"].device
    active = np.asarray(active, bool)
    pos = cache["pos"].cpu().numpy().astype(np.int64)
    draft = np.asarray(draft, np.int32)
    seq = np.concatenate([np.asarray(token, np.int32)[:, None], draft], 1)
    positions = pos[:, None] + np.arange(k + 1)[None, :]          # [B, S]
    seq_d, pos_d = _to_device(np.stack([seq, positions]), dev)
    x = _embed(params, seq_d, pos_d, cfg)
    attend = plan(active, pos, positions, pos_d)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        q, kk, vv = _block_kv(x, p, cfg)                # [B, S, H, hd]
        x = x + _mm(attend(i, q, kk, vv), p["wo"], cfg.dtype)
        x = _ffn(x, p, cfg)
    x = _rmsnorm(x, params["ln_f_scale"])
    logits = _project_vocab(x, params["embed"], cfg)           # [B, S, V]
    committed, n_acc, keys = _spec_accept(
        logits, _to_device(draft, dev), _keys(rngs, dev), temperature, k)
    cache["pos"] += ((1 + n_acc)
                     * _to_device(active.astype(np.int32), dev)
                     ).to(torch.int32)
    committed, n_acc, keys = _to_host(committed, n_acc, keys)
    return (committed.astype(np.int32), n_acc.astype(np.int32),
            keys.astype(np.uint32))


def verify_chunk_slots(params: Params, cache: Cache, token, draft, rngs,
                       active, *, cfg: GPTConfig, k: int,
                       temperature: float = 0.0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ONE batched target forward verifying k drafted tokens per active
    slot of a flat pool (``gpt_decode.py:1606``). Feeds ``[last,
    d_1..d_k]`` at each slot's ``pos..pos+k``, writes their K/V there
    (inactive slots and positions past ``max_len`` are dropped), each
    query attending ``<= pos + i``; then :func:`_spec_accept` and ``pos
    += 1 + n_acc``. The rejected positions' K/V lie past the new ``pos``
    and are overwritten before any query reads them.

    ``token [B]``, ``draft [B, k]``, ``rngs [B, 2]`` and ``active [B]``
    are host arrays. Returns host ``(committed [B, k+1], n_acc [B],
    rngs')`` in ONE transfer; rows of inactive slots are garbage."""
    max_len = cache["k"].shape[2]
    scale = softmax_scale(cfg.head_dim)

    def plan(active, pos, positions, pos_d):
        dev = pos_d.device
        valid = (torch.arange(max_len, device=dev)[None, None, None, :]
                 <= pos_d[:, None, :, None])                  # [B,1,S,T]
        bi, si = np.nonzero(active[:, None] & (positions < max_len))
        w = _to_device(np.stack([bi, si, positions[bi, si]]), dev)

        def attend(i, q, kk, vv):
            kc, vc = cache["k"][i], cache["v"][i]
            kc[w[0], w[2]] = kk[w[0], w[1]]
            vc[w[0], w[2]] = vv[w[0], w[1]]
            return _attend(q, kc, vc, valid, scale)
        return attend

    return _verify(params, cache, token, draft, rngs, active, cfg=cfg, k=k,
                   temperature=temperature, plan=plan)


def verify_chunk_slots_paged(params: Params, cache: Cache, token, draft,
                             rngs, active, pt, *, cfg: GPTConfig, k: int,
                             page_size: int, temperature: float = 0.0,
                             kv_dtype: str = "fp"
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paged twin of :func:`verify_chunk_slots` (``gpt_decode.py:1680``):
    K/V of ``pos + i`` land at ``(pt[b, (pos+i) // ps], (pos+i) % ps)``
    (unmapped, past-the-table or inactive targets are dropped) and each
    query attends its virtual sequence gathered through its page-table
    row, valid ``<= pos + i``. int8 pools merge the k+1 rows through
    :func:`_merge_span_int8` and attend the dequantised pages, so the
    decision sees exactly the K/V a later decode step will. ``pt [B,
    max_pages]`` is a host array; the rest as in the flat version."""
    pt = np.asarray(pt, np.int64)
    ps, hd = page_size, cfg.head_dim
    n_pages = cache["k"].shape[1]
    max_pages = pt.shape[1]
    S = k + 1
    scale = softmax_scale(hd)

    def plan(active, pos, positions, pos_d):
        dev = pos_d.device
        B = pt.shape[0]
        ptc = _to_device(np.clip(pt, 0, n_pages - 1), dev)
        valid = (torch.arange(max_pages * ps, device=dev)
                 [None, None, None, :] <= pos_d[:, None, :, None])
        if kv_dtype == "int8":
            span = _span_plan(pt, pos, S, active, ps, S, n_pages, dev)
        else:
            vp = positions // ps
            page_idx = np.take_along_axis(pt, np.clip(vp, 0, max_pages - 1),
                                          1)
            ok = (active[:, None] & (vp < max_pages) & (page_idx >= 0)
                  & (page_idx < n_pages))
            bi, si = np.nonzero(ok)
            w = _to_device(np.stack([bi, si, page_idx[bi, si],
                                     positions[bi, si] % ps]), dev)

        def attend(i, q, kk, vv):
            kc, vc = cache["k"][i], cache["v"][i]
            if kv_dtype == "int8":
                ksc, vsc = cache["ks"][i], cache["vs"][i]
                _merge_span_int8(kc, ksc, kk, span)
                _merge_span_int8(vc, vsc, vv, span)
                hk = _deq_page(kc[ptc], ksc[ptc], q.dtype)
                hv = _deq_page(vc[ptc], vsc[ptc], q.dtype)
            else:
                kc[w[2], w[3]] = kk[w[0], w[1]]
                vc[w[2], w[3]] = vv[w[0], w[1]]
                hk, hv = kc[ptc], vc[ptc]
            return _attend(q, hk.reshape(B, max_pages * ps, -1, hd),
                           hv.reshape(B, max_pages * ps, -1, hd), valid,
                           scale)
        return attend

    return _verify(params, cache, token, draft, rngs, active, cfg=cfg, k=k,
                   temperature=temperature, plan=plan)


# ------------------------------------------------------- KV handoff (ship)
def kv_to_host(*tensors: torch.Tensor):
    """Device K/V (and scales) → host arrays for a handoff payload, the
    reference's bytes: float32, int8 and float16 by value; bfloat16,
    which numpy lacks, as its ``np.uint16`` bit patterns (the same bytes
    the reference's ``ml_dtypes.bfloat16`` arrays hold, so the payload
    digest is the same)."""
    out = []
    for t in tensors:
        if t.dtype == torch.bfloat16:
            out.append(t.view(torch.int16).cpu().numpy().view(np.uint16))
        else:
            out.append(t.cpu().numpy())
    return tuple(out)


def kv_from_host(a, dtype: torch.dtype, device: torch.device
                 ) -> torch.Tensor:
    """A payload's host K/V → a tensor of the pool's ``dtype`` on
    ``device``. A 2-byte array that is not float16 (the port's
    ``np.uint16`` wire form, or the reference's ``ml_dtypes.bfloat16``,
    recognised by its dtype name without importing it) holds bfloat16
    bit patterns and is viewed, not converted; anything else converts by
    value, as the reference's import casts to the pool dtype."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize == 2 and a.dtype != np.float16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.clone()
    return t.to(dtype)


def export_slot_kv(cache: Cache, slot: int, *, cfg: GPTConfig,
                   length: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot's K/V rows from a FLAT pool for a prefill → decode
    handoff (``gpt_decode.py:1782``): ``(k, v)``, each ``[L, max_len, H,
    hd]``, copies on the pool's device. ``length`` trims them to ``[L,
    length, H, hd]`` on the device, so only the shipped positions cross
    to the host (the reference copies the whole row and trims there: the
    shipped bytes are the same). ``slot`` clamps like the reference's
    ``dynamic_slice`` start."""
    B, M = cache["k"].shape[1:3]
    slot = min(max(int(slot), 0), B - 1)
    n = M if length is None else int(length)
    return (cache["k"][:, slot, :n].clone(),
            cache["v"][:, slot, :n].clone())


def export_slot_kv_paged(cache: Cache, pt_row, *, cfg: GPTConfig,
                         page_size: int, kv_dtype: str = "fp",
                         length: Optional[int] = None):
    """Paged twin of :func:`export_slot_kv` (``gpt_decode.py:1803``): the
    slot's pages gathered through its page-table row ``pt_row
    [max_pages]`` (host) into virtual order, ``(k, v)`` each ``[L,
    max_pages * page_size, H, hd]``; sentinel entries clamp to a real
    page whose garbage lies past ``pos``. int8 pools also return the
    per-page scales, ``(k, v, ks, vs)`` with ``ks``/``vs`` ``[L,
    max_pages, H]``. ``length`` gathers only the ``ceil(length /
    page_size)`` covering pages and trims K/V to ``length`` positions
    on the device: the bytes the reference ships after trimming on the
    host."""
    pt = np.asarray(pt_row, np.int64).reshape(-1)
    if length is not None:
        pt = pt[:-(-int(length) // page_size)]
    L, n_pages = cache["k"].shape[:2]
    idx = _to_device(np.clip(pt, 0, n_pages - 1), cache["k"].device)
    H, hd = cache["k"].shape[3:]
    n = pt.shape[0] * page_size if length is None else int(length)
    k = cache["k"][:, idx].reshape(L, -1, H, hd)[:, :n]
    v = cache["v"][:, idx].reshape(L, -1, H, hd)[:, :n]
    if kv_dtype == "int8":
        return k, v, cache["ks"][:, idx], cache["vs"][:, idx]
    return k, v


def import_slot_kv(cache: Cache, k_row, v_row, slot: int, length: int, *,
                   cfg: GPTConfig) -> None:
    """Scatter a shipped prefill's K/V into slot ``slot`` of a FLAT pool,
    in place, and set ``pos[slot] = length`` (``gpt_decode.py:1828``).
    ``k_row``/``v_row`` are ``[L, n, H, hd]`` host arrays (a payload's,
    see :func:`kv_from_host`) or tensors with ``n <= max_len``: positions
    ``[0, n)`` take them and ``[n, max_len)`` become zeros, as the
    reference's host-padded full row leaves them. Only the ``n`` shipped
    positions are uploaded."""
    B, M = cache["k"].shape[1:3]
    slot = min(max(int(slot), 0), B - 1)
    dev, dt = cache["k"].device, cache["k"].dtype
    for name, row in (("k", k_row), ("v", v_row)):
        row = row.to(dev, dt) if isinstance(row, torch.Tensor) else \
            kv_from_host(row, dt, dev)
        n = row.shape[1]
        cache[name][:, slot, :n] = row
        cache[name][:, slot, n:] = 0
    cache["pos"][slot] = int(length)


def import_slot_kv_paged(cache: Cache, k_pages, v_pages, pt_row,
                         slot: int, length: int, *, cfg: GPTConfig,
                         page_size: int, ks_pages=None, vs_pages=None
                         ) -> None:
    """Paged twin of :func:`import_slot_kv` (``gpt_decode.py:1849``):
    scatter shipped K/V into the pool pages mapped by ``pt_row
    [max_pages]`` (host), in place, and set ``pos[slot] = length``.

    ``k_pages``/``v_pages`` are ``[L, n_ship, page_size, H, hd]`` (the
    reference pads to ``n_ship = max_pages`` on the host) or ``[L, n, H,
    hd]`` positions, which are uploaded as they are and padded with
    zeros to whole pages on the device. Table column ``j < n_ship`` is
    written only if ``j * page_size < length`` and ``pt_row[j]`` is a
    real page: sentinel and out-of-range entries are DROPPED, never
    clamped into another slot's page. int8 pools take the per-page
    scales ``ks_pages``/``vs_pages`` ``[L, n_ship, H]`` under the same
    mask."""
    dev = cache["k"].device
    L, n_pages, ps, H, hd = cache["k"].shape
    pt = np.asarray(pt_row, np.int64).reshape(-1)
    length = int(length)

    def pages(a, dt):
        t = a.to(dev, dt) if isinstance(a, torch.Tensor) else \
            kv_from_host(a, dt, dev)
        if t.dim() == 4:                        # [L, n, H, hd] positions
            n = t.shape[1]
            padded = torch.zeros((L, -(-n // ps) * ps, H, hd), dtype=dt,
                                 device=dev)
            padded[:, :n] = t
            t = padded.reshape(L, -1, ps, H, hd)
        return t

    k = pages(k_pages, cache["k"].dtype)
    v = pages(v_pages, cache["v"].dtype)
    n_ship = k.shape[1]
    cols = np.arange(min(n_ship, pt.shape[0]))
    tgt = pt[cols]
    ok = (cols * ps < length) & (tgt >= 0) & (tgt < n_pages)
    w = _to_device(np.stack([cols[ok], tgt[ok]]), dev)
    cache["k"][:, w[1]] = k[:, w[0]]
    cache["v"][:, w[1]] = v[:, w[0]]
    if ks_pages is not None:
        for name, s in (("ks", ks_pages), ("vs", vs_pages)):
            s = s.to(dev, torch.float32) if isinstance(s, torch.Tensor) \
                else _to_device(np.asarray(s, np.float32), dev)
            cache[name][:, w[1]] = s[:, w[0]]
    cache["pos"][int(slot)] = length
