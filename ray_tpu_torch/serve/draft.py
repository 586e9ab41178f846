"""Drafters for speculative decoding in the port's
:class:`~ray_tpu_torch.serve.engine.DecodeEngine`: the port's own copy of
``ray_tpu/serve/draft.py``.

A drafter proposes ``draft_k`` candidate tokens per active slot at every
round; the target model verifies all of them in ONE batched forward
(:func:`~ray_tpu_torch.models.gpt_decode.verify_chunk_slots`) and
commits the accepted prefix plus its own correction/bonus token. Because
acceptance is exact (greedy match at temperature 0, lossless rejection
sampling above it), a drafter can never change the committed stream,
only how many target forwards it takes to produce it.

Contract every drafter keeps (the engine's replay leans on it):

- **Determinism**: proposals are a pure function of the slot's
  committed history (prompt + delivered tokens), so a recompute replay
  takes the same acceptance pattern and the same PRNG chain.
- **Per-slot isolation**: no state shared across slots.
- **Driver-thread only**: every method is called from the engine's
  driver thread, between device dispatches.

Two implementations:

- :class:`NGramDrafter`: a host-side n-gram table per slot, built from
  the prompt and committed tokens (prompt-lookup decoding). No device
  work.
- :class:`ModelDrafter`: a small GPT (by default sharing the target's
  embedding, :func:`tied_drafter_params`) decoding greedily into its own
  flat slot pool that mirrors the engine's slots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from ..models import gpt, gpt_decode


class Drafter:
    """Protocol for speculative-decoding proposal sources.

    Lifecycle per slot: :meth:`admit` when the engine prefills a prompt
    into it, :meth:`propose` + :meth:`observe` once per verify round
    while the lane runs, :meth:`free` when the lane ends for any reason
    (EOS, max_new, deadline, abandonment, failure). :meth:`configure`
    is called by the engine before any traffic."""

    name = "base"

    def configure(self, *, slots: int, max_len: int,
                  prompt_buckets: Sequence[int], draft_k: int):
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.prompt_buckets = tuple(prompt_buckets)
        self.draft_k = int(draft_k)

    def admit(self, slot: int, prompt: np.ndarray, first_token: int):
        """A prompt was prefilled into ``slot``; ``first_token`` is the
        target's fused first sample (already delivered)."""

    def propose(self, active: np.ndarray, last: np.ndarray) -> np.ndarray:
        """``[slots, draft_k]`` int32 proposals; rows of inactive slots
        are ignored. ``last`` is each slot's last delivered token."""
        raise NotImplementedError

    def observe(self, slot: int, tokens: np.ndarray, accepted: int):
        """``tokens`` were committed to ``slot`` this round (the
        accepted drafts plus the target's correction/bonus);
        ``accepted`` of this drafter's proposals were accepted, or
        ``-1`` when the round ran the plain chunk path (adaptive
        speculation parked this slot, so nothing was proposed —
        only drafters with an :meth:`estimate` ever see ``-1``).
        Called only for lanes that keep running — ended lanes get
        :meth:`free` instead."""

    def estimate(self, slot: int) -> Optional[float]:
        """Expected accepted proposals for a verify round on ``slot``
        right now, or None for "no self-assessment" — the engine then
        always speculates the slot (``None`` is treated as +inf
        against ``spec_threshold``). Must be a deterministic function
        of the slot's committed history: the engine's per-slot
        speculate-or-chunk decision feeds the PRNG consumption
        pattern, so a recompute replay depends on it."""
        return None

    def free(self, slot: int):
        """The lane in ``slot`` ended; drop its state."""

    def reset(self):
        """Drop ALL per-slot state."""


class NGramDrafter(Drafter):
    """Host-side prompt-lookup drafter: per slot, an n-gram table from
    the prompt + committed tokens maps each trailing context of length
    ``min_n..max_n`` to its observed continuations; proposals extend
    the history with the MOST FREQUENT continuation of the longest
    matching context (ties break to the smallest token id — the whole
    proposal is deterministic). With no match the last token repeats
    (self-loops are the most common attractor). No device work.
    """

    name = "ngram"

    #: EMA smoothing for the per-slot hit self-assessment.
    EMA_ALPHA = 0.5

    def __init__(self, max_n: int = 4, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"[{min_n}, {max_n}]")
        self.max_n = int(max_n)
        self.min_n = int(min_n)
        self._hist: Dict[int, List[int]] = {}
        #: slot -> {(n, ctx tuple) -> {token -> count}}
        self._tab: Dict[int, Dict[Tuple, Dict[int, int]]] = {}
        #: slot -> EMA of per-round would-have-hit counts (the
        #: adaptive-speculation signal; deterministic from history).
        self._ema: Dict[int, float] = {}

    def _index(self, slot: int, start: int):
        """Count the continuations introduced by hist[start:]."""
        h = self._hist[slot]
        tab = self._tab[slot]
        for t in range(max(start, self.min_n), len(h)):
            for n in range(self.min_n, min(self.max_n, t) + 1):
                key = (n, tuple(h[t - n:t]))
                bucket = tab.setdefault(key, {})
                bucket[h[t]] = bucket.get(h[t], 0) + 1

    def admit(self, slot: int, prompt: np.ndarray, first_token: int):
        self._hist[slot] = [int(t) for t in prompt] + [int(first_token)]
        self._tab[slot] = {}
        self._ema[slot] = 0.0
        self._index(slot, 0)

    def _propose_one(self, slot: int, k: int) -> List[int]:
        """k deterministic proposals extending slot's history: most
        frequent continuation of the longest matching context, ties to
        the smallest token, last-token self-loop as fallback."""
        out: List[int] = []
        tail = list(self._hist[slot][-self.max_n:])
        extra: Dict[Tuple, Dict[int, int]] = {}
        tab = self._tab[slot]
        empty: Dict[int, int] = {}
        for _ in range(k):
            nxt = None
            for n in range(min(self.max_n, len(tail)),
                           self.min_n - 1, -1):
                key = (n, tuple(tail[-n:]))
                base = tab.get(key, empty)
                ext = extra.get(key, empty)
                if not base and not ext:
                    continue
                # Max by (count, -token) over base+ext WITHOUT copying
                # base (this is the propose hot loop): ext tokens get
                # their combined count, pure-base tokens their own.
                best = None
                for tok, c in base.items():
                    if tok not in ext:
                        cand = (c, -tok)
                        if best is None or cand > best:
                            best = cand
                for tok, c in ext.items():
                    cand = (c + base.get(tok, 0), -tok)
                    if best is None or cand > best:
                        best = cand
                nxt = -best[1]
                break
            if nxt is None:
                nxt = tail[-1]
            out.append(nxt)
            # Count the hypothetical extension too, so a proposal that
            # starts a repeat immediately reinforces itself.
            for n in range(self.min_n, min(self.max_n, len(tail)) + 1):
                key = (n, tuple(tail[-n:]))
                b = extra.setdefault(key, {})
                b[nxt] = b.get(nxt, 0) + 1
            tail.append(nxt)
            tail = tail[-self.max_n:]
        return out

    def observe(self, slot: int, tokens: np.ndarray, accepted: int):
        h = self._hist.get(slot)
        if h is None:
            return
        # Self-assessment BEFORE indexing the new tokens: how many of
        # this round's committed tokens would this table have proposed?
        # Verify rounds already measured it — ``accepted`` IS that
        # count; chunk rounds (accepted == -1, nothing was proposed)
        # replay the proposal against the committed row. Either way the
        # EMA is a pure function of the committed history, which
        # adaptive mode leans on for deterministic replay.
        if accepted >= 0:
            hit = accepted
        else:
            hyp = self._propose_one(slot, min(self.draft_k, len(tokens)))
            hit = 0
            for want, got in zip(tokens, hyp):
                if int(want) != got:
                    break
                hit += 1
        self._ema[slot] = ((1.0 - self.EMA_ALPHA) * self._ema[slot]
                           + self.EMA_ALPHA * hit)
        start = len(h)
        h.extend(int(t) for t in tokens)
        self._index(slot, start)

    def estimate(self, slot: int) -> Optional[float]:
        return self._ema.get(slot, 0.0)

    def propose(self, active: np.ndarray, last: np.ndarray) -> np.ndarray:
        out = np.zeros((self.slots, self.draft_k), np.int32)
        for i in range(self.slots):
            if not active[i] or i not in self._hist:
                continue
            out[i, :] = self._propose_one(i, self.draft_k)
        return out

    def free(self, slot: int):
        self._hist.pop(slot, None)
        self._tab.pop(slot, None)
        self._ema.pop(slot, None)

    def reset(self):
        self._hist.clear()
        self._tab.clear()
        self._ema.clear()


class ModelDrafter(Drafter):
    """Device drafter: a small GPT decoding greedily into its OWN flat
    slot pool whose slots mirror the engine's 1:1 (same ``max_len``,
    same prompt buckets, so positions track the target exactly).

    Per verify round it runs one k-step greedy chunk
    (:func:`~ray_tpu_torch.models.gpt_decode.decode_chunk_slots` of its
    own model) to propose, and after the verify rolls its write cursor
    back past rejected positions: the host-authoritative ``pos`` is
    uploaded wholesale each round, and K/V beyond it is overwritten
    before it is ever attended. A fully accepted round leaves one
    committed token (``d_k``) without K/V in the drafter's pool; a
    1-token chunk ingests it before the next proposal.

    ``params`` are moved to ``device``, which defaults to the card
    (``device="cpu"`` runs the plain PyTorch path)."""

    name = "model"

    def __init__(self, params, cfg, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.cfg = cfg

    def configure(self, *, slots: int, max_len: int,
                  prompt_buckets: Sequence[int], draft_k: int):
        super().configure(slots=slots, max_len=max_len,
                          prompt_buckets=prompt_buckets, draft_k=draft_k)
        if max_len > self.cfg.max_seq:
            raise ValueError(
                f"drafter max_seq {self.cfg.max_seq} cannot mirror "
                f"engine max_len {max_len}")
        self.reset()

    def reset(self):
        self._cache = gpt_decode.init_slot_cache(self.cfg, self.slots,
                                                 self.max_len, self.device)
        self._pos = np.zeros((self.slots,), np.int32)
        self._pending = np.full((self.slots,), -1, np.int64)
        self._rngs = np.zeros((self.slots, 2), np.uint32)

    def admit(self, slot: int, prompt: np.ndarray, first_token: int):
        S = int(prompt.shape[0])
        bucket = next(b for b in self.prompt_buckets if b >= S)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :S] = prompt
        # The first-token sample is the TARGET's job; the drafter's is
        # discarded: only the prompt K/V matters here.
        gpt_decode.prefill_into_slot(self.params, self._cache, padded, S,
                                     slot, self._rngs[slot], cfg=self.cfg)
        self._pos[slot] = S
        self._pending[slot] = -1

    def propose(self, active: np.ndarray, last: np.ndarray) -> np.ndarray:
        # Host-authoritative write cursor: rejected draft positions were
        # rolled back in observe(), so upload pos wholesale.
        self._cache["pos"].copy_(torch.from_numpy(self._pos))
        pend = active & (self._pending >= 0)
        if pend.any():
            ptok = np.where(pend, self._pending, 0).astype(np.int32)
            gpt_decode.decode_chunk_slots(self.params, self._cache, ptok,
                                          self._rngs, pend, cfg=self.cfg,
                                          k=1)
            self._pos[pend] += 1
            self._pending[pend] = -1
        toks, _done, _rngs = gpt_decode.decode_chunk_slots(
            self.params, self._cache, np.asarray(last, np.int32),
            self._rngs, active, cfg=self.cfg, k=self.draft_k)
        self._pos[active] += self.draft_k
        return toks

    def observe(self, slot: int, tokens: np.ndarray, accepted: int):
        k = self.draft_k
        if accepted < 0:
            # Cannot happen: this drafter has no estimate(), so the
            # engine always speculates its slots.
            raise RuntimeError(
                "ModelDrafter saw a chunk-round observe; its KV cache "
                "cannot ingest unproposed tokens")
        if accepted >= k:
            # Every proposal accepted: the draft chunk wrote K/V for
            # [last, d_1..d_{k-1}], all committed, but d_k's is missing.
            self._pending[slot] = int(tokens[k - 1])
        else:
            # Roll the cursor back past the rejected positions: valid
            # K/V runs through [last, d_1..d_a] at pos0..pos0+a.
            self._pos[slot] += accepted + 1 - k
            self._pending[slot] = -1

    def free(self, slot: int):
        self._pos[slot] = 0
        self._pending[slot] = -1


def tied_drafter_params(target_params, target_cfg, *, n_layer: int = 1,
                        seed: int = 0):
    """Build ``(params, cfg)`` for a :class:`ModelDrafter` that SHARES
    the target's embedding and position tables (the same tensors) over a
    fresh ``n_layer``-deep trunk, on the target's device and in its
    storage dtype. Deterministic for a given seed.

    The trunk comes from the port's own
    :func:`~ray_tpu_torch.models.gpt.init_params` (a seeded
    ``torch.Generator``), so it is NOT the reference's trunk for the
    same seed (that one is drawn with ``jax.random``). At temperature 0
    no committed token depends on the drafter; to reproduce the
    reference's acceptance pattern, load the reference drafter's weights
    through :func:`~ray_tpu_torch.models.gpt.params_from_numpy` into a
    :class:`ModelDrafter` instead."""
    embed = target_params["embed"]
    dcfg = dataclasses.replace(target_cfg, n_layer=int(n_layer))
    params = gpt.init_params(dcfg, int(seed), device=embed.device,
                             dtype=target_params["wq"].dtype)
    params["embed"] = embed
    params["pos_embed"] = target_params["pos_embed"]
    return params, dcfg


def make_drafter(spec, params=None, cfg=None) -> Optional[Drafter]:
    """Resolve the engine/config-plane ``spec_decode`` knob:

    - ``None``/``False`` → no drafter (speculative decoding off);
    - ``True`` / ``"ngram"`` → a fresh :class:`NGramDrafter`;
    - ``"model"`` → a :class:`ModelDrafter` over
      :func:`tied_drafter_params` of the engine's own weights;
    - a :class:`Drafter` instance → used as-is.
    """
    if spec is None or spec is False:
        return None
    if isinstance(spec, Drafter):
        return spec
    if spec is True or spec == "ngram":
        return NGramDrafter()
    if spec == "model":
        if params is None or cfg is None:
            raise ValueError(
                "spec_decode='model' needs the engine's params/cfg to "
                "build the tied-embedding drafter")
        return ModelDrafter(*tied_drafter_params(params, cfg),
                            device=params["embed"].device)
    raise ValueError(
        f"spec_decode must be False, True, 'ngram', 'model', or a "
        f"Drafter instance, got {spec!r}")
