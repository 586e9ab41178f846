"""Continuous-batching decode engine: the port of
``ray_tpu/serve/engine.py`` (one device; paged or flat pool; greedy or
seeded sampling; optional speculative decoding).

One driver thread owns every device dispatch; ``submit``/``stream`` only
enqueue and are safe from any thread. The design is the reference's:

- ONE long-lived KV pool. Paged (the port's default): fixed-size pages
  (:func:`~ray_tpu_torch.models.gpt_decode.init_paged_cache`) handed out
  by a host allocator (:class:`_PagePool`), each slot carrying a
  page-table row the device code reads through. Flat (``paged=False``):
  ``max_len`` positions reserved per slot
  (:func:`~ray_tpu_torch.models.gpt_decode.init_slot_cache`).
- Admission happens at **chunk boundaries**: the prompt (paged: its
  uncached suffix) is prefilled into a free slot, right-padded to a
  prompt bucket, and its first token streams out at once; then every
  active slot decodes ``chunk`` tokens per dispatch.
- **Sampling**: greedy at temperature 0; above it each request samples
  from its own PRNG lane, seeded with ``PRNGKey(seed)`` at admission,
  uploaded with each dispatch and read back with its tokens, so a
  stream depends only on its prompt, knobs and seed.
- Pages are allocated **on advance**. Out of pages is a defined
  backpressure path: admission defers (FIFO kept), a running slot parks
  out of the dispatch mask, and if every occupied slot is parked the
  youngest lane is preempted **by recompute**: its pages free, its
  request requeues at the head, and the replay (the same seeded
  stream) suppresses the tokens it already delivered.
- A **prefix cache** (:class:`_PrefixCache`) maps a resident prompt
  prefix into the new slot's table (refcounted); a prefix that ends
  mid-page forks that page copy-on-write inside the prefill.
- **Speculative decoding** (``spec_decode``): a drafter
  (:mod:`~ray_tpu_torch.serve.draft`) proposes ``draft_k`` tokens per
  slot, one batched verify commits the accepted prefix plus a
  correction/bonus token; the committed stream is the non-speculative
  one. With ``spec_threshold > 0`` a round whose drafters expect little
  falls back to one plain chunk.

At temperature 0 each stream is token-identical to the reference's
``generate_chunked`` for the same prompt, and at temperature > 0 to the
reference engine's stream for the same seed (f32 compute; asserted in
``tests/test_torch_engine.py`` and ``tests/test_torch_engine_spec.py``).
Left for later slices: prefill/decode roles and KV handoff, tensor
parallelism, and the serve front (driver supervision, epochs, tracing
and metrics).
"""
from __future__ import annotations

import collections
import functools
import hashlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .._private import prng
from .._private.device import (DeviceLike, resolve_device,
                               set_matmul_precision)
from ..models import gpt_decode
from .draft import make_drafter
from ._stream import (_STREAM_END, RequestDeadlineExceeded, _EngineStream,
                      _StreamLane, deadline_expired, default_buckets)


def default_prompt_buckets(max_len: int) -> List[int]:
    """Powers of two from 8 up to (and including) max_len."""
    return sorted(b for b in default_buckets(max_len) if b >= 8) \
        or [max_len]


@dataclass
class _EngineRequest:
    """One queued admission."""

    prompt: np.ndarray            # [S] int32
    bucket: int                   # padded prompt length
    max_new: int
    lane: _StreamLane
    deadline_s: Optional[float]
    seed: int = 0                 # PRNG lane seed (temperature > 0)
    #: Tokens already delivered (before a recompute preemption, or by
    #: the caller's ``resume_from``): the replay regenerates them (the
    #: seeded stream is deterministic) and suppresses this many.
    skip: int = 0


@dataclass
class _Slot:
    """Host-side state of one occupied slot between chunk boundaries."""

    lane: _StreamLane
    remaining: int                # tokens still owed to the caller
    deadline_s: Optional[float]
    req: _EngineRequest           # for recompute preemption
    emitted: int = 1              # tokens DELIVERED to the lane
    admitted_t: float = field(default_factory=time.time)
    pos: int = 0                  # virtual write position (mirrors device)
    pages: List[int] = field(default_factory=list)
    parked: bool = False          # out of pages: excluded from dispatch
    skip: int = 0                 # replay tokens left to suppress


class EngineShutdownError(RuntimeError):
    """The engine stopped while this request was queued or decoding."""


class _PagePool:
    """Host-side page allocator: a free list plus per-page refcounts.
    Shared-prefix pages are mapped into several page tables at once (and
    pinned by prefix-cache entries); a page returns to the free list
    when its LAST reference drops. Driver-thread only — no locking."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.refs = [0] * n_pages
        # Pop from the end → low page indices hand out first.
        self.free = list(range(n_pages - 1, -1, -1))

    def available(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None (caller defers/parks)."""
        if n > len(self.free):
            return None
        out = [self.free.pop() for _ in range(n)]
        for p in out:
            self.refs[p] = 1
        return out

    def ref(self, pages: Sequence[int]):
        for p in pages:
            self.refs[p] += 1

    def unref(self, pages: Sequence[int]):
        for p in pages:
            self.refs[p] -= 1
            if self.refs[p] < 0:
                raise RuntimeError(f"page {p} over-freed")
            if self.refs[p] == 0:
                self.free.append(p)


class _PrefixCache:
    """Prompt-prefix → resident-pages map, page-granular with an
    exact-length tail entry.

    Keys are content hashes of the token prefix at every page boundary
    plus the full prompt length; entries pin their pages with a pool
    reference so a cached prefix survives the lane that produced it.
    Lookup probes the query's page boundaries longest-first (plus its
    exact length), verifies tokens byte-for-byte (hashes only index),
    and returns ``(hist_len, pages)`` — ``hist_len`` capped one token
    short of the query so the suffix prefill always has a token to
    sample from. Page-aligned hits share pages directly; an exact-length
    hit ends mid-page and the engine forks that page copy-on-write.
    LRU: entries are evicted (unpinning their pages) when the allocator
    runs dry."""

    def __init__(self, pool: _PagePool, page_size: int):
        self._pool = pool
        self._ps = page_size
        # key -> (n_tokens, prefix_bytes, pages tuple)
        self._entries: "collections.OrderedDict[bytes, Tuple[int, bytes, Tuple[int, ...]]]" = \
            collections.OrderedDict()
        self.evictions = 0

    def __len__(self):
        return len(self._entries)

    @staticmethod
    def _key(tokens: np.ndarray, n: int) -> bytes:
        return hashlib.sha1(
            np.ascontiguousarray(tokens[:n]).tobytes()).digest()

    def lookup(self, tokens: np.ndarray) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens`` (< len(tokens)); returns
        ``(hist_len, pages_covering_hist)`` or ``(0, [])``."""
        P = len(tokens)
        probes = sorted({n for n in
                         list(range(self._ps, P + 1, self._ps)) + [P]},
                        reverse=True)
        for n in probes:
            ent = self._entries.get(self._key(tokens, n))
            if ent is None:
                continue
            n_cached, raw, pages = ent
            if n_cached != n or raw != tokens[:n].tobytes():
                continue                     # hash collision: skip
            hist = min(n, P - 1)
            if hist <= 0:
                continue
            self._entries.move_to_end(self._key(tokens, n))
            n_cover = -(-hist // self._ps)   # ceil
            return hist, list(pages[:n_cover])
        return 0, []

    def insert(self, tokens: np.ndarray, pages: Sequence[int]):
        """Register a freshly prefilled prompt's pages: one entry per
        covered page boundary plus the exact prompt length. Existing
        keys just refresh their LRU position."""
        P = len(tokens)
        bounds = list(range(self._ps, P + 1, self._ps))
        if P not in bounds:
            bounds.append(P)
        for n in bounds:
            key = self._key(tokens, n)
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            n_cover = -(-n // self._ps)
            ent_pages = tuple(pages[:n_cover])
            self._pool.ref(ent_pages)
            self._entries[key] = (n, tokens[:n].tobytes(), ent_pages)

    def evict_lru(self) -> bool:
        """Drop the oldest entry whose eviction actually FREES a page
        (some page at refcount 1 — held by the cache alone). False when
        no eviction can free anything."""
        for key, (_n, _raw, pages) in self._entries.items():
            if any(self._pool.refs[p] == 1 for p in pages):
                del self._entries[key]
                self._pool.unref(pages)
                self.evictions += 1
                return True
        return False


class DecodeEngine:
    """Slot-based continuous-batching engine over a paged or flat KV
    pool.

    Usage::

        engine = DecodeEngine(params, cfg, slots=16, chunk=8,
                              max_len=1024, page_size=16,
                              attn_kernel="cuda")
        for slice_ in engine.stream(prompt_ids, max_new=64):
            ...                       # np.int32 [j] per chunk, first j=1

    ``params`` is the port's weight dict
    (:func:`~ray_tpu_torch.models.gpt.init_params` or
    :func:`~ray_tpu_torch.models.gpt.params_from_numpy`); it is moved to
    ``device``, which defaults to the card (``device="cpu"`` runs the
    plain PyTorch path).

    - ``temperature > 0`` samples each request from its own PRNG lane
      (``submit(..., seed=)``); 0 is greedy.
    - ``paged=True`` (the port's default; the reference defaults to
      flat) pages the pool. ``attn_kernel`` picks the paged decode
      attention: ``"cuda"`` (the hand-written kernel, the default) or
      ``"gather"`` (its plain version). ``kv_dtype="int8"`` stores pages
      as int8 codes with per-(page, head) scales; the default ``n_pages``
      buys the same KV bytes as ``slots`` full-length fp sequences. A
      flat pool (``paged=False``) attends by plain einsums and takes
      neither knob.
    - ``spec_decode`` (``"ngram"``, ``"model"``, ``True`` or a
      :class:`~ray_tpu_torch.serve.draft.Drafter`) turns each dispatch
      into draft ``draft_k`` + one verify; ``spec_threshold > 0`` (greedy
      engines only) runs a plain chunk instead whenever the drafters'
      mean expected acceptance is below it."""

    def __init__(self, params, cfg, *, slots: int = 4, chunk: int = 8,
                 max_len: int = 0, temperature: float = 0.0,
                 eos_token: int = -1,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 paged: bool = True, page_size: int = 16,
                 n_pages: int = 0, prefix_cache: bool = True,
                 attn_kernel: Optional[str] = None, kv_dtype: str = "fp",
                 spec_decode=None, draft_k: int = 4,
                 spec_threshold: float = 0.0, device: DeviceLike = None,
                 auto_start: bool = True):
        self.cfg = cfg
        self.slots = int(slots)
        self.chunk = int(chunk)
        self.max_len = int(max_len or cfg.max_seq)
        self.temperature = float(temperature)
        self.eos_token = int(eos_token)
        if self.slots < 1 or self.chunk < 1:
            raise ValueError("slots and chunk must be >= 1")
        if self.max_len > cfg.max_seq:
            raise ValueError(f"max_len {self.max_len} exceeds model "
                             f"max_seq {cfg.max_seq}")
        buckets = sorted(set(int(b) for b in (
            prompt_buckets or default_prompt_buckets(self.max_len))))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"invalid prompt_buckets {buckets}")
        if buckets[-1] > self.max_len:
            raise ValueError(
                f"largest prompt bucket {buckets[-1]} exceeds cache "
                f"length {self.max_len}")
        self.prompt_buckets = buckets
        self.draft_k = int(draft_k)
        self.spec_threshold = float(spec_threshold)
        if self.draft_k < 1:
            raise ValueError("draft_k must be >= 1")
        if self.spec_threshold > 0.0 and self.temperature > 0.0:
            raise ValueError(
                "spec_threshold > 0 (adaptive speculation) requires "
                "temperature 0: the pool-wide verify-or-chunk decision "
                "depends on which lanes share the pool, and a sampled "
                "stream replayed in another pool would consume a "
                "different PRNG chain")
        if attn_kernel is not None and \
                attn_kernel not in gpt_decode.ATTN_KERNELS:
            raise ValueError(
                f"unknown attn_kernel {attn_kernel!r}; expected one of "
                f"{gpt_decode.ATTN_KERNELS}")
        if kv_dtype not in gpt_decode.KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r}; expected one of "
                f"{gpt_decode.KV_DTYPES}")
        if not paged and (attn_kernel not in (None, "gather")
                          or kv_dtype != "fp"):
            raise ValueError(
                "attn_kernel/kv_dtype are paged-pool knobs; construct "
                "the engine with paged=True")
        self.attn_kernel = attn_kernel or ("cuda" if paged else "gather")
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        set_matmul_precision(self.device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self._drafter = make_drafter(spec_decode, self.params, cfg)
        if self._drafter is not None:
            self._drafter.configure(
                slots=self.slots, max_len=self.max_len,
                prompt_buckets=self.prompt_buckets, draft_k=self.draft_k)
        self._build_pool(paged, page_size, n_pages, prefix_cache)

        # Per-slot host state; index i mirrors pool row i. ``_token`` /
        # ``_rngs`` are each slot's last token and PRNG lane, uploaded
        # with each dispatch.
        self._state: List[Optional[_Slot]] = [None] * self.slots
        self._token = np.zeros((self.slots,), np.int32)
        self._rngs = np.zeros((self.slots, 2), np.uint32)
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        # Driver-local FIFO fed from the submit queue; the head defers in
        # place when admission runs out of pages.
        self._pending: "collections.deque[_EngineRequest]" = \
            collections.deque()
        # Guards the submit-vs-final-drain race: once _fail_all flips
        # _draining under this lock, no submission can land in a queue
        # nobody will read again.
        self._admit_lock = threading.Lock()
        self._draining = False
        self._fail_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {"admitted": 0, "completed": 0, "expired": 0,
                       "abandoned": 0, "prefills": 0, "dispatches": 0,
                       "tokens": 0, "occupancy_sum": 0.0,
                       "peak_active": 0, "prefix_hits": 0,
                       "prefix_tokens_reused": 0, "cow_copies": 0,
                       "admissions_deferred": 0, "lane_parks": 0,
                       "preempted": 0, "resumed": 0, "spec_rounds": 0,
                       "spec_proposed": 0, "spec_accepted": 0,
                       "spec_fallback_rounds": 0, "spec_lanes": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self.start()

    def _build_pool(self, paged: bool, page_size: int, n_pages: int,
                    prefix_cache: bool):
        """Allocate THE pool, flat or paged (``engine.py:606``), and bind
        the chunk step ``_step(token, rngs, active)`` to it."""
        cfg = self.cfg
        self.paged = bool(paged)
        knobs = dict(cfg=cfg, k=self.chunk, temperature=self.temperature,
                     eos_token=self.eos_token)
        if not self.paged:
            self.page_size = self.n_pages = self.max_pages = 0
            self._pool = self._prefix = self._pt = None
            self._cache = gpt_decode.init_slot_cache(
                cfg, self.slots, self.max_len, self.device)
            self._step = functools.partial(
                gpt_decode.decode_chunk_slots, self.params, self._cache,
                **knobs)
            self._bind_verify()
            return
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.max_pages = -(-self.max_len // self.page_size)   # ceil
        fp_bytes = gpt_decode.kv_bytes_per_page(cfg, self.page_size)
        kv_bytes = gpt_decode.kv_bytes_per_page(cfg, self.page_size,
                                                self.kv_dtype)
        self.n_pages = int(n_pages) or \
            (self.slots * self.max_pages * fp_bytes) // kv_bytes
        if self.n_pages < self.max_pages:
            raise ValueError(
                f"n_pages {self.n_pages} cannot hold one max_len "
                f"sequence ({self.max_pages} pages of {self.page_size})")
        self._pool = _PagePool(self.n_pages)
        self._prefix = _PrefixCache(self._pool, self.page_size) \
            if prefix_cache else None
        self._pt = np.full((self.slots, self.max_pages),
                           gpt_decode.PT_SENTINEL, np.int32)
        self._cache = gpt_decode.init_paged_cache(
            cfg, self.slots, self.n_pages, self.page_size, self.kv_dtype,
            self.device)
        self._step = functools.partial(
            gpt_decode.decode_chunk_slots_paged, self.params, self._cache,
            pt=self._pt, page_size=self.page_size, kv_dtype=self.kv_dtype,
            attn_kernel=self.attn_kernel, **knobs)
        self._bind_verify()

    def _bind_verify(self):
        """Bind the verify step ``_verify(token, draft, rngs, active)``
        to the pool and ``draft_k`` (``engine.py:683``); None with
        speculation off."""
        knobs = dict(cfg=self.cfg, k=self.draft_k,
                     temperature=self.temperature)
        if self._drafter is None:
            self._verify = None
        elif self.paged:
            self._verify = functools.partial(
                gpt_decode.verify_chunk_slots_paged, self.params,
                self._cache, pt=self._pt, page_size=self.page_size,
                kv_dtype=self.kv_dtype, **knobs)
        else:
            self._verify = functools.partial(
                gpt_decode.verify_chunk_slots, self.params, self._cache,
                **knobs)

    def ensure_spec(self, spec_decode=None, draft_k: Optional[int] = None,
                    spec_threshold: Optional[float] = None):
        """Idempotently apply the speculative-decoding knobs
        (``engine.py:776``). A matching engine is a no-op; a mismatched
        one is reconfigured IF it has never admitted a request, else this
        raises: the drafter's per-slot state is not something to swap
        under live lanes."""
        if draft_k is not None and int(draft_k) < 1:
            raise ValueError("draft_k must be >= 1")
        with self._admit_lock:
            want_k = int(draft_k) if draft_k is not None else self.draft_k
            cur = self._drafter
            if spec_decode is None:
                want = cur
            elif isinstance(spec_decode, str) and cur is not None \
                    and cur.name == spec_decode:
                want = cur
            elif spec_decode is True and cur is not None:
                want = cur
            else:
                want = make_drafter(spec_decode, self.params, self.cfg)
            want_thr = float(spec_threshold) \
                if spec_threshold is not None else self.spec_threshold
            if want_thr > 0.0 and self.temperature > 0.0:
                raise ValueError(
                    "spec_threshold > 0 (adaptive speculation) "
                    "requires temperature 0 — see DecodeEngine")
            if want is cur and want_k == self.draft_k \
                    and want_thr == self.spec_threshold:
                return self
            with self._stats_lock:
                used = self._stats["admitted"]
            if used or self._queue.qsize() or self._pending or \
                    any(s is not None for s in self._state):
                raise ValueError(
                    "cannot change spec_decode/draft_k on a live "
                    "engine; construct it with the knobs or apply them "
                    "before traffic")
            self.draft_k = want_k
            self.spec_threshold = want_thr
            self._drafter = want
            if want is not None:
                want.configure(slots=self.slots, max_len=self.max_len,
                               prompt_buckets=self.prompt_buckets,
                               draft_k=self.draft_k)
            self._bind_verify()
        return self

    # ------------------------------------------------------------ admission
    def submit(self, prompt, max_new: int, *,
               deadline_s: Optional[float] = None, seed: int = 0,
               resume_from: int = 0) -> _StreamLane:
        """Enqueue one request; returns its stream lane immediately. The
        driver admits it at the next chunk boundary with a free slot.
        ``deadline_s`` is an absolute ``time.time()`` stamp; ``seed``
        seeds the request's PRNG lane (temperature > 0).

        ``resume_from=n`` says the caller already holds the first ``n``
        tokens of this exact (prompt, knobs, seed) stream: the engine
        replays the generation and suppresses those ``n`` tokens."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        S = prompt.shape[0]
        if S < 1:
            raise ValueError("empty prompt")
        bucket = next((b for b in self.prompt_buckets if b >= S), None)
        if bucket is None:
            raise ValueError(
                f"prompt length {S} exceeds largest prompt bucket "
                f"{self.prompt_buckets[-1]}")
        if S + max_new > self.max_len:
            raise ValueError(
                f"prompt ({S}) + max_new ({max_new}) exceeds cache "
                f"length {self.max_len}")
        resume_from = int(resume_from)
        if resume_from < 0 or resume_from > max_new:
            raise ValueError(
                f"resume_from {resume_from} outside [0, max_new="
                f"{max_new}]: it counts tokens this stream already "
                f"delivered")
        prng.PRNGKey(seed)            # a seed outside int64 fails here
        lane = _StreamLane()
        if max_new <= 0:
            lane.q.put((_STREAM_END, None))
            return lane
        with self._admit_lock:
            if self._draining:
                raise EngineShutdownError(
                    "engine is not accepting requests (shut down)")
            self._queue.put(_EngineRequest(
                prompt=prompt, bucket=bucket, max_new=int(max_new),
                lane=lane, deadline_s=deadline_s, seed=int(seed),
                skip=resume_from))
        if resume_from:
            self._count(resumed=1)
        return lane

    def stream(self, prompt, max_new: int, **kw) -> _EngineStream:
        """``submit`` + drain: an iterator of np.int32 ``[j]`` chunk
        slices (the first is the prefill token alone)."""
        return _EngineStream(self.submit(prompt, max_new, **kw))

    def queue_depth(self) -> int:
        """Requests accepted but not yet admitted to a slot."""
        return self._queue.qsize() + len(self._pending)

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        with self._admit_lock:
            self._draining = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True,
            name="rt-torch-decode-engine")
        self._thread.start()

    def shutdown(self, timeout_s: float = 5.0):
        """Stop the driver and fail every queued or in-flight lane with
        :class:`EngineShutdownError`. A driver that outlives the join
        still owns the slots and pages: its lanes fail, its bookkeeping
        is left to its own exit path."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        alive = self._thread is not None and self._thread.is_alive()
        self._fail_all(EngineShutdownError("engine shut down"),
                       free_state=not alive)

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["active_slots"] = sum(s is not None for s in self._state)
        out["slots"] = self.slots
        out["queue_depth"] = self.queue_depth()
        d = max(out["dispatches"], 1)
        out["avg_occupancy"] = out.pop("occupancy_sum") / d
        out["dispatches_per_token"] = (
            (out["dispatches"] + out["prefills"]) / max(out["tokens"], 1))
        out["page_size"] = self.page_size
        out["n_pages"] = self.n_pages
        if self.paged:
            out["pages_free"] = self._pool.available()
            out["pages_used"] = self.n_pages - self._pool.available()
            out["parked_slots"] = sum(
                s is not None and s.parked for s in self._state)
        if self._prefix is not None:
            out["prefix_cache_entries"] = len(self._prefix)
            out["prefix_evictions"] = self._prefix.evictions
        sp = {k: out.pop("spec_" + k) for k in
              ("rounds", "proposed", "accepted", "fallback_rounds",
               "lanes")}
        if self._drafter is not None:
            out["spec"] = dict(
                sp, drafter=self._drafter.name, draft_k=self.draft_k,
                threshold=self.spec_threshold,
                acceptance_rate=sp["accepted"] / max(sp["proposed"], 1),
                # Per lane per verify forward: a lane commits its
                # accepted prefix plus the correction/bonus token.
                mean_accept_len=sp["accepted"] / max(sp["lanes"], 1),
                accepted_per_forward=(sp["accepted"] + sp["lanes"])
                / max(sp["lanes"], 1))
        out["paged"] = self.paged
        out["attn_kernel"] = self.attn_kernel
        out["kv_dtype"] = self.kv_dtype
        ps = self.page_size or 1
        out["kv_bytes_per_token"] = gpt_decode.kv_bytes_per_page(
            self.cfg, ps, self.kv_dtype) / ps
        out["driver_alive"] = bool(self._thread is not None
                                   and self._thread.is_alive())
        return out

    def _count(self, **deltas):
        with self._stats_lock:
            for k, v in deltas.items():
                self._stats[k] += v

    # ---------------------------------------------------------- driver loop
    def _run(self, stop: threading.Event):
        try:
            while not stop.is_set():
                self._admit_pending()
                if not any(s is not None for s in self._state):
                    if self._pending:
                        # A deferred head with no running lane cannot
                        # happen (n_pages holds a max_len sequence and
                        # the prefix cache evicts first); never spin.
                        time.sleep(0.001)
                        continue
                    # Idle: block briefly for the next arrival; the
                    # timeout bounds shutdown latency.
                    try:
                        self._pending.append(self._queue.get(timeout=0.05))
                    except queue.Empty:
                        pass
                    continue
                if self._drafter is not None:
                    self._dispatch_spec()
                else:
                    self._dispatch_chunk()
            self._fail_all(EngineShutdownError("engine shut down"))
        except BaseException as e:  # noqa: BLE001 - driver died: fan out
            exc = e
            if not isinstance(e, EngineShutdownError):
                exc = EngineShutdownError(f"engine driver died: {e!r}")
                exc.__cause__ = e
            self._fail_all(exc)
            raise

    def _fail_all(self, exc: BaseException, free_state: bool = True):
        """Fail every queued / in-flight lane with ``exc``.
        ``free_state=False`` (shutdown racing a still-alive driver) only
        puts errors; slot state, the pending deque and the page pool stay
        the driver's. Serialized, so page refcounts drop once."""
        with self._fail_lock:
            with self._admit_lock:
                self._draining = True   # no put can land past this point
            for i, st in enumerate(self._state):
                if st is not None:
                    st.lane.q.put(("err", exc))
                    if free_state:
                        self._free_slot(i)
            if free_state:
                while self._pending:
                    self._pending.popleft().lane.q.put(("err", exc))
            else:
                for req in list(self._pending):
                    req.lane.q.put(("err", exc))
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
                req.lane.q.put(("err", exc))

    def _free_slot(self, i: int):
        """Release slot i: its page references drop, its page-table row
        resets to sentinel, and the drafter forgets it."""
        st = self._state[i]
        if st is not None and st.pages:
            self._pool.unref(st.pages)
            self._pt[i, :] = gpt_decode.PT_SENTINEL
        if st is not None and self._drafter is not None:
            self._drafter.free(i)
        self._state[i] = None

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate n pages, evicting LRU prefix-cache entries while
        short. None = genuinely out (every page pinned by live lanes)."""
        while self._pool.available() < n:
            if self._prefix is None or not self._prefix.evict_lru():
                return None
        return self._pool.alloc(n)

    def _admit_pending(self):
        """Chunk-boundary admission: fill every free slot in FIFO order.
        Expired or abandoned requests fail out without a prefill; an
        admission that cannot get pages DEFERS at the queue head."""
        while True:
            try:
                self._pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for _ in range(len(self._pending)):
            req = self._pending.popleft()
            if req.lane.closed:
                self._count(abandoned=1)
                continue
            if deadline_expired(req.deadline_s):
                self._count(expired=1)
                req.lane.q.put(("err", RequestDeadlineExceeded(
                    "request expired while queued for engine admission")))
                continue
            self._pending.append(req)
        if any(s is not None and s.parked for s in self._state):
            # Freed pages go to the (older) parked lanes before any new
            # admission may take them.
            return
        while self._pending and any(s is None for s in self._state):
            if not self._admit_one(self._pending[0]):
                self._count(admissions_deferred=1)
                return               # out of pages: keep FIFO, back off
            self._pending.popleft()

    def _admit_one(self, req: _EngineRequest) -> bool:
        """Prefill ``req`` into a free slot and deliver (or, on a replay,
        suppress) its first token; False defers (no pages)."""
        slot = next(i for i, s in enumerate(self._state) if s is None)
        P = req.prompt.shape[0]
        key = prng.PRNGKey(req.seed)
        if self.paged:
            admitted = self._prefill_paged(req, slot, P, key)
            if admitted is None:
                return False
            first, pages = admitted
        else:
            padded = np.zeros((1, req.bucket), np.int32)
            padded[0, :P] = req.prompt
            first, self._rngs[slot] = gpt_decode.prefill_into_slot(
                self.params, self._cache, padded, P, slot, key,
                cfg=self.cfg, temperature=self.temperature)
            pages = []
        self._count(prefills=1, admitted=1 if req.skip == 0 else 0)
        self._token[slot] = first
        skip = req.skip
        if skip > 0:
            skip -= 1            # replay: the first token was delivered
        else:
            self._count(tokens=1)
            req.lane.q.put(("item", np.asarray([first], np.int32)))
        if req.max_new <= 1 or (self.eos_token >= 0
                                and first == self.eos_token):
            req.lane.q.put((_STREAM_END, None))
            self._count(completed=1)
            if pages:
                self._pool.unref(pages)
                self._pt[slot, :] = gpt_decode.PT_SENTINEL
            return True
        self._state[slot] = _Slot(
            lane=req.lane, remaining=req.max_new - 1,
            deadline_s=req.deadline_s, req=req,
            emitted=1 if req.skip == 0 else req.skip, pos=P, pages=pages,
            skip=skip)
        if self._drafter is not None:
            # Per-slot drafter state from the prompt and first token: a
            # replay rebuilds it bit-equal.
            self._drafter.admit(slot, req.prompt, first)
        return True

    def _prefill_paged(self, req: _EngineRequest, slot: int, P: int,
                       key: np.ndarray) -> Optional[Tuple[int, List[int]]]:
        """Map the cached prefix (refcounted, COW fork if it ends
        mid-page), allocate fresh pages for the suffix, prefill ONLY the
        suffix, then register the prompt's pages in the prefix cache.
        Returns ``(first_token, pages)``, or None (nothing taken) when
        pages are unavailable even after LRU eviction."""
        ps = self.page_size
        pool = self._pool
        hist, shared_pages = (0, [])
        if self._prefix is not None:
            hist, shared_pages = self._prefix.lookup(req.prompt)
        shared_full = hist // ps
        partial = hist % ps
        cow_src = shared_pages[shared_full] if partial else \
            gpt_decode.PT_SENTINEL
        shared = shared_pages[:shared_full]
        # Pin everything we read BEFORE eviction-driven allocation can
        # free it from under us.
        pool.ref(shared)
        if partial:
            pool.ref([cow_src])
        fresh = self._alloc_pages(-(-P // ps) - shared_full)
        if fresh is None:
            pool.unref(shared)
            if partial:
                pool.unref([cow_src])
            return None
        pages = shared + fresh
        sl = P - hist
        bucket = next(b for b in self.prompt_buckets if b >= sl)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :sl] = req.prompt[hist:]
        pt_row = np.full((self.max_pages,), gpt_decode.PT_SENTINEL,
                         np.int32)
        pt_row[:len(pages)] = pages
        self._pt[slot] = pt_row
        first, self._rngs[slot] = gpt_decode.prefill_into_slot_paged(
            self.params, self._cache, padded, sl, hist, pt_row, cow_src,
            slot, key, cfg=self.cfg, page_size=ps,
            temperature=self.temperature, kv_dtype=self.kv_dtype)
        if partial:
            # The fork is enqueued ahead of any later write to cow_src on
            # the same stream; its pin is no longer needed.
            pool.unref([cow_src])
            self._count(cow_copies=1)
        if hist:
            self._count(prefix_hits=1, prefix_tokens_reused=hist)
        if self._prefix is not None:
            self._prefix.insert(req.prompt, pages)
        return first, pages

    def _cover_pages(self) -> bool:
        """Allocate-on-advance at a chunk boundary: every occupied slot
        must have pages mapped through the positions this chunk will
        write (``pos + min(chunk, remaining)``). A slot that cannot be
        covered PARKS out of the dispatch mask. Returns True if at least
        one lane can run; False means every occupied slot was parked and
        the youngest lane has been preempted by recompute."""
        ps = self.page_size
        # Cull dead PARKED lanes first: a parked slot never reaches the
        # post-dispatch closed/deadline checks and would pin its pages.
        for i, st in enumerate(self._state):
            if st is None or not st.parked:
                continue
            if st.lane.closed:
                self._free_slot(i)
                self._count(abandoned=1)
            elif deadline_expired(st.deadline_s):
                st.lane.q.put(("err", RequestDeadlineExceeded(
                    "request deadline passed while parked for pages")))
                self._free_slot(i)
                self._count(expired=1)
        if not any(s is not None for s in self._state):
            return False             # nothing left to dispatch
        runnable = 0
        for i, st in enumerate(self._state):
            if st is None:
                continue
            need = st.pos + min(self.chunk, st.remaining)
            if self._drafter is not None:
                # Verify writes K/V at pos..pos+draft_k; a dropped write
                # is safe only past what the lane can still commit. A
                # fallback round runs a chunk instead: cover both.
                need = max(need,
                           st.pos + min(self.draft_k, st.remaining) + 1)
            while len(st.pages) * ps < need:
                got = self._alloc_pages(1)
                if got is None:
                    break
                self._pt[i, len(st.pages)] = got[0]
                st.pages.extend(got)
            short = len(st.pages) * ps < need
            if short and not st.parked:
                self._count(lane_parks=1)
            st.parked = short
            runnable += not short
        if runnable:
            return True
        # Deadlock: every occupied slot is parked. Preempt the youngest
        # lane (least sunk work) BY RECOMPUTE: free its pages, requeue
        # its request at the head; the replay suppresses the delivered
        # tokens. One lane always fits (n_pages >= max_pages).
        youngest = max(
            (i for i, s in enumerate(self._state) if s is not None),
            key=lambda i: self._state[i].admitted_t)
        st = self._state[youngest]
        req = st.req
        req.skip = st.emitted
        self._free_slot(youngest)
        self._pending.appendleft(req)
        self._count(preempted=1)
        return False

    def _dispatch_chunk(self, cover: bool = True):
        """ONE k-step decode over every active slot, then per-slot
        routing/trimming and boundary frees. ``cover=False``: the spec
        dispatcher already ran this boundary's coverage pass before
        falling back to a chunk."""
        if cover and self.paged and not self._cover_pages():
            return                    # re-run admission/coverage pass
        active = np.array([s is not None and not s.parked
                           for s in self._state], bool)
        n_active = int(active.sum())
        toks_np, _done, rngs_np = self._step(self._token, self._rngs,
                                             active)
        self._count(dispatches=1, occupancy_sum=n_active / self.slots)
        self._peak(n_active)
        emitted = 0
        for i, st in enumerate(self._state):
            if st is None or st.parked:
                continue                     # parked: nothing advanced
            self._token[i] = toks_np[i, -1]
            self._rngs[i] = rngs_np[i]
            st.pos += self.chunk             # mirrors the device pos
            n, j, running = self._deliver(i, st, toks_np[i], self.chunk)
            emitted += n
            if running and self._drafter is not None:
                # Adaptive fallback round: keep the drafter's history
                # (and its self-assessment) current; -1 = nothing was
                # proposed.
                self._drafter.observe(i, toks_np[i, :j], -1)
        if emitted:
            self._count(tokens=emitted)

    def _dispatch_spec(self):
        """Draft-k-verify-once twin of :meth:`_dispatch_chunk`
        (``engine.py:2326``): the drafter proposes ``draft_k`` tokens per
        active slot, ONE batched verify scores them, and each slot
        advances by its own ``accepted + 1``, through the same
        EOS/deadline/replay delivery as the chunk path.

        ``spec_threshold > 0``: the round verifies only when the
        drafters' mean expected acceptance over the runnable lanes
        clears the threshold, else it runs ONE plain chunk for the whole
        pool (a split pool would pay for both steps)."""
        if self.paged and not self._cover_pages():
            return                    # re-run admission/coverage pass
        active = np.array([s is not None and not s.parked
                           for s in self._state], bool)
        n_active = int(active.sum())
        if not n_active:
            return
        if self.spec_threshold > 0.0:
            ests = [self._drafter.estimate(i)
                    for i in range(self.slots) if active[i]]
            if not any(e is None for e in ests) \
                    and sum(ests) / n_active < self.spec_threshold:
                self._count(spec_fallback_rounds=1)
                self._dispatch_chunk(cover=False)
                return
        draft = self._drafter.propose(active, self._token)
        com_np, acc_np, rngs_np = self._verify(self._token, draft,
                                               self._rngs, active)
        accepted = int(acc_np[active].sum())
        self._count(dispatches=1, occupancy_sum=n_active / self.slots,
                    spec_rounds=1, spec_proposed=self.draft_k * n_active,
                    spec_accepted=accepted, spec_lanes=n_active)
        self._peak(n_active)
        emitted = 0
        for i, st in enumerate(self._state):
            if st is None or not active[i]:
                continue
            na = int(acc_np[i])
            self._rngs[i] = rngs_np[i]
            st.pos += na + 1                 # mirrors the device pos
            n, j, running = self._deliver(i, st, com_np[i], na + 1)
            emitted += n
            if running:
                self._token[i] = com_np[i, j - 1]   # last delivered
                self._drafter.observe(i, com_np[i, :j], na)
        if emitted:
            self._count(tokens=emitted)

    def _peak(self, n_active: int):
        with self._stats_lock:
            self._stats["peak_active"] = max(self._stats["peak_active"],
                                             n_active)

    def _deliver(self, i: int, st: _Slot, row: np.ndarray, adv: int
                 ) -> Tuple[int, int, bool]:
        """Route the ``adv`` tokens slot ``i`` produced this round
        (``row[:adv]``): free it if its consumer left or its deadline
        passed, trim at ``remaining`` and the first EOS, suppress replay
        tokens, stream the rest, and free it when finished. Returns
        (tokens delivered, tokens consumed ``j``, lane still running)."""
        if st.lane.closed:                   # consumer left: free now
            self._free_slot(i)
            self._count(abandoned=1)
            return 0, 0, False
        if deadline_expired(st.deadline_s):
            st.lane.q.put(("err", RequestDeadlineExceeded(
                "request deadline passed mid-generation")))
            self._free_slot(i)
            self._count(expired=1)
            return 0, 0, False
        j = min(adv, st.remaining)
        finished = st.remaining <= adv
        if self.eos_token >= 0:
            hits = np.flatnonzero(row[:j] == self.eos_token)
            if hits.size:                    # free at the EOS
                j = int(hits[0]) + 1
                finished = True
        # Replay: the first ``skip`` regenerated tokens were delivered
        # before (a preemption or the caller's resume_from): suppress.
        cut = min(st.skip, j)
        st.skip -= cut
        if j > cut:
            st.lane.q.put(("item", row[cut:j].copy()))
            st.emitted += j - cut
        st.remaining -= j
        if finished:
            st.lane.q.put((_STREAM_END, None))
            self._free_slot(i)
            self._count(completed=1)
        return j - cut, j, not finished
