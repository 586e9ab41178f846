"""Continuous-batching decode engine: the port of
``ray_tpu/serve/engine.py`` (one device or a tensor-parallel group;
paged or flat pool; greedy or seeded sampling; optional speculative
decoding).

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

- **Disaggregated prefill/decode** (``role=``): a ``"prefill"`` engine's
  :meth:`DecodeEngine.handoff` prefills into a transient slot, exports
  the slot's K/V (:func:`~ray_tpu_torch.models.gpt_decode.export_slot_kv`
  and its paged twin, trimmed to the prompt on the device), frees the
  slot and returns a descriptor under an epoch-stamped lease
  (:mod:`~ray_tpu_torch.serve.handoff`); a ``"decode"`` engine's
  :meth:`DecodeEngine.admit_prefilled` byte-verifies the payload and
  imports it into a free slot, so decoding continues where the prefill
  engine stopped. Any failure to resolve or verify falls back to a
  local prefill of the descriptor's prompt and seed (token-identical by
  determinism), counted. ``"both"`` (the default) serves every path.
- **Lifecycle**: the driver stamps a heartbeat every loop and runs under
  an epoch; :meth:`DecodeEngine.supervise` restarts a dead or wedged
  driver once (its lanes fail with the retryable
  :class:`EngineRestartError`, the pool is rebuilt and the epoch moves,
  so a stale driver drops its results), :meth:`DecodeEngine.drain`
  stops admissions and lets running lanes finish, and
  :meth:`DecodeEngine.inject_fault` arms the chaos faults.
- **Tensor parallelism** (``tp=N``): the weights and the pool are
  sharded over the ``N`` ranks of a
  :func:`~ray_tpu_torch._private.tp.decode_group` (this process is rank
  0, the others are follower processes), and every pool call runs on
  every rank (:class:`~ray_tpu_torch._private.tp.Shards`), tied to the
  driver's epoch. The host side (allocator, prefix cache, drafter,
  handoff plane) is rank 0's alone, as in the reference; the drafter
  keeps the unsharded weights.
- **Config plane**: :meth:`DecodeEngine.apply_config` routes a
  deployment's ``engine:`` knobs to :meth:`DecodeEngine.ensure_paging`,
  :meth:`DecodeEngine.ensure_spec`, :meth:`DecodeEngine.ensure_role`
  and :meth:`DecodeEngine.ensure_tp`; each is a no-op when nothing
  changes and refuses a change on an engine that has served traffic.

At temperature 0 each stream is token-identical to the reference's
``generate_chunked`` for the same prompt, and at temperature > 0 to the
reference engine's stream for the same seed (f32 compute; asserted in
``tests/test_torch_engine.py``, ``tests/test_torch_engine_spec.py``,
``tests/test_torch_handoff.py``,
``tests/test_torch_engine_lifecycle.py`` and, at ``tp`` 2 and 4,
``tests/test_torch_engine_tp.py``).

- **Observability**: the engine writes the reference's flight-recorder
  events (:mod:`~ray_tpu_torch._private.events`; ``engine.admit``,
  ``engine.dispatch``, ``engine.page_alloc`` and the rest, each stamped
  with the request id from :func:`~ray_tpu_torch.serve.request.get_request_id`
  or a local ``eng-<pid hex>-<n>``) and counts the reference's serve
  instruments (:func:`~ray_tpu_torch._private.metrics.serve_metrics`),
  labelled with its ``deployment``, at the reference's sites and with
  its attributes. Every value is a host number the driver already holds:
  nothing synchronises the device to record it. Trace spans are left
  for a later slice (``trace_ctx`` is accepted and ignored).
"""
from __future__ import annotations

import collections
import functools
import hashlib
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .._private import events as _events
from .._private import prng
from .._private import tp as _tp
from .._private.events import driver_emit as _driver_emit
from .._private.metrics import serve_metrics
from .._private.device import (DeviceLike, resolve_device,
                               set_matmul_precision)
from ..models import gpt_decode
from . import handoff as _ho
from .draft import make_drafter
from ._stream import (_STREAM_END, RequestDeadlineExceeded, _EngineStream,
                      _StreamLane, deadline_expired, default_buckets,
                      remaining_s)
from .request import get_request_id

ROLES = ("both", "prefill", "decode")


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
    #: Handoff export: admission = prefill + export + free; the lane
    #: receives one item, the descriptor.
    export: bool = False
    #: Handoff import: ``{"payload": verified payload}`` scattered into
    #: the slot instead of a prefill. Kept on the request, so a recompute
    #: preemption re-imports.
    handoff: Optional[dict] = None
    #: Export-side lease TTL override (0 = the engine's default).
    ttl_s: float = 0.0
    #: Enqueue stamp (``time.time()``), reset when a preemption requeues
    #: the request: the start of its admission wait.
    enq_t: float = field(default_factory=time.time)
    #: Flight-recorder correlation id, stamped on every event of this
    #: request (:meth:`DecodeEngine._new_req_id`).
    req_id: str = ""


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
    """The engine stopped while this request was queued or decoding.
    Retryable: prompt, knobs, seed and the delivered count determine the
    stream, so a caller resubmits (mid-stream with ``resume_from``)."""

    retryable = True


class EngineRestartError(EngineShutdownError):
    """The engine's driver died or wedged; its lanes were failed and the
    driver restarted (or awaits replacement). Retryable like
    :class:`EngineShutdownError`."""


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

    def clear(self):
        """Unpin and drop every entry (cache teardown)."""
        while self._entries:
            _, (_n, _raw, pages) = self._entries.popitem(last=False)
            self._pool.unref(pages)
            self.evictions += 1


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
      mean expected acceptance is below it.
    - ``role`` (``"both"``, ``"prefill"``, ``"decode"``) gates the
      disaggregation paths; ``handoff_ttl_s`` is the default lease life
      of an exported payload.
    - ``tp`` shards the model over that many ranks: 1 runs on ``device`` alone; above it the engine joins
      the cached :func:`~ray_tpu_torch._private.tp.decode_group` for
      ``tp`` (by default one card per rank with NCCL, or gloo processes
      on the CPU; register another first). MoE configs and widths
      ``tp`` does not divide raise ``ValueError``.
    - ``wedge_timeout_s`` is the heartbeat age at which
      :meth:`supervise` calls a live driver wedged;
      ``max_driver_restarts`` how many restarts it makes before it
      reports the engine unhealthy.
    - ``deployment`` labels the engine (``stats()["deployment"]`` and
      the driver thread's name); empty means ``"engine"``."""

    def __init__(self, params, cfg, *, slots: int = 4, chunk: int = 8,
                 max_len: int = 0, temperature: float = 0.0,
                 eos_token: int = -1,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 paged: bool = True, page_size: int = 16,
                 n_pages: int = 0, prefix_cache: bool = True,
                 attn_kernel: Optional[str] = None, kv_dtype: str = "fp",
                 spec_decode=None, draft_k: int = 4,
                 spec_threshold: float = 0.0, role: str = "both",
                 handoff_ttl_s: float = 30.0,
                 wedge_timeout_s: float = 30.0,
                 max_driver_restarts: int = 1, tp: int = 1,
                 device: DeviceLike = None, deployment: str = "",
                 auto_start: bool = True):
        self.cfg = cfg
        self.deployment = deployment or "engine"
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
        if role not in ROLES:
            raise ValueError(f"unknown engine role {role!r}; expected "
                             f"'prefill', 'decode', or 'both'")
        self.role = role
        self._leases = _ho.LeaseTable(ttl_s=float(handoff_ttl_s))
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
        # Validated before anything is built: a bad (cfg, tp) pair fails
        # at construction, not at the first dispatch.
        self.tp = _tp.tp_validate(cfg, tp, self.device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self._drafter = make_drafter(spec_decode, self.params, cfg)
        if self._drafter is not None:
            self._drafter.configure(
                slots=self.slots, max_len=self.max_len,
                prompt_buckets=self.prompt_buckets, draft_k=self.draft_k)
        # Guards the submit-vs-final-drain race (once _fail_all flips
        # _draining under it, no submission can land in a queue nobody
        # reads again) and every swap of the pool structures: each
        # _build_pool call holds it.
        self._admit_lock = threading.Lock()
        # The epoch of the driver run on this thread (set in _run): a
        # group call from a retired epoch is refused (_stale_call).
        self._driver = threading.local()
        self._epoch = 0
        self._shards = self._new_shards(self.tp)
        with self._admit_lock:
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
        self._draining = False
        self._fail_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {"admitted": 0, "completed": 0, "expired": 0,
                       "abandoned": 0, "prefills": 0, "dispatches": 0,
                       "tokens": 0, "occupancy_sum": 0.0,
                       "peak_active": 0, "prefix_hits": 0,
                       "prefix_tokens_reused": 0, "cow_copies": 0,
                       "admissions_deferred": 0, "lane_parks": 0,
                       "preempted": 0, "resumed": 0, "driver_restarts": 0,
                       "spec_rounds": 0, "spec_proposed": 0,
                       "spec_accepted": 0, "spec_fallback_rounds": 0,
                       "spec_lanes": 0, "handoffs_exported": 0,
                       "handoffs_imported": 0,
                       "handoff_import_fallbacks": 0,
                       "handoff_ship_bytes": 0,
                       "attn_kernel_dispatches": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Driver supervision: the driver stamps _beat every loop;
        # supervise() reads a stale beat from a live thread as a wedge
        # and a dead thread as a crash. Each driver run has an epoch: a
        # wedged driver that wakes after a restart finds the epoch moved
        # and drops its results instead of touching the new pool.
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.max_driver_restarts = int(max_driver_restarts)
        self._beat = time.monotonic()
        self._shutdown = False
        self._supervise_lock = threading.Lock()
        #: Chaos fault armed by inject_fault() (testing only).
        self._fault: Optional[dict] = None
        self._throttle_s = 0.0
        # Local flight-recorder ids for submissions that carry none.
        self._req_uid = 0
        if auto_start:
            self.start()

    # ------------------------------------------------- tensor parallelism
    def _new_shards(self, tp: int) -> Optional[_tp.Shards]:
        """This engine's state on the ranks of the group for ``tp``
        (weights sent to the followers now), or None at tp=1."""
        if tp == 1:
            return None
        return _tp.Shards(_tp.decode_group(tp, device=self.device),
                          self.cfg, self.params, self.device,
                          stale=self._stale_call)

    def _stale_call(self) -> bool:
        """A group call from a driver run a restart retired (asked under
        the group's lock, before the call is sent)."""
        return getattr(self._driver, "epoch", self._epoch) != self._epoch

    def _fn(self, name: str):
        """``gpt_decode.<name>``, run on every rank of the group at tp >
        1 (same arguments, rank 0's state first)."""
        if self._shards is None:
            return getattr(gpt_decode, name)
        return functools.partial(self._shards.call, name)

    def _heads(self, a, axis: int):
        """A canonical payload array that each rank takes its heads of."""
        return a if self._shards is None else _tp.Heads(a, axis)

    def _new_pool(self, fn_name: str, **kw):
        """``gpt_decode.<fn_name>`` on this device, or on every rank."""
        if self._shards is None:
            return getattr(gpt_decode, fn_name)(device=self.device, **kw)
        return self._shards.build(fn_name, **kw)

    def _build_pool(self, paged: bool, page_size: int, n_pages: int,
                    prefix_cache: bool):
        """Allocate THE pool, flat or paged (``engine.py:606``), and bind
        the chunk step ``_step(token, rngs, active)`` to it, on every
        rank at tp > 1. Called at construction, by :meth:`ensure_paging`
        and :meth:`ensure_tp` on an unused engine and by
        :meth:`_restart_driver`; every caller holds ``_admit_lock``."""
        cfg = self.cfg
        self.paged = bool(paged)
        if self._shards is not None and self._shards.group.closed:
            # The group failed (a collective timed out or a follower
            # died): load the weights into a new one on its devices.
            self._shards = self._new_shards(self.tp)
        # The dispatch-side weights: rank 0's shard at tp > 1.
        self._params_dev = self.params if self._shards is None \
            else self._shards.params
        knobs = dict(cfg=cfg, k=self.chunk, temperature=self.temperature,
                     eos_token=self.eos_token)
        if not self.paged:
            self.page_size = self.n_pages = self.max_pages = 0
            self._pool = self._prefix = self._pt = None
            self._cache = self._new_pool(
                "init_slot_cache", cfg=cfg, slots=self.slots,
                max_len=self.max_len)
            self._step = functools.partial(
                self._fn("decode_chunk_slots"), self._params_dev,
                self._cache, **knobs)
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
        self._cache = self._new_pool(
            "init_paged_cache", cfg=cfg, slots=self.slots,
            n_pages=self.n_pages, page_size=self.page_size,
            kv_dtype=self.kv_dtype)
        self._step = functools.partial(
            self._fn("decode_chunk_slots_paged"), self._params_dev,
            self._cache, pt=self._pt, page_size=self.page_size,
            kv_dtype=self.kv_dtype, attn_kernel=self.attn_kernel, **knobs)
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
                self._fn("verify_chunk_slots_paged"), self._params_dev,
                self._cache, pt=self._pt, page_size=self.page_size,
                kv_dtype=self.kv_dtype, **knobs)
        else:
            self._verify = functools.partial(
                self._fn("verify_chunk_slots"), self._params_dev,
                self._cache, **knobs)

    def _used(self, exports: bool = False) -> bool:
        """The engine has admitted (``exports``: or exported) or holds
        work: its pool, knobs and role are load-bearing from then on."""
        with self._stats_lock:
            used = self._stats["admitted"] + (
                self._stats["handoffs_exported"] if exports else 0)
        return bool(used or self._queue.qsize() or self._pending or
                    any(s is not None for s in self._state))

    # ------------------------------------------------------- config plane
    def ensure_paging(self, page_size: Optional[int] = None,
                      prefix_cache: Optional[bool] = None,
                      n_pages: Optional[int] = None,
                      attn_kernel: Optional[str] = None,
                      kv_dtype: Optional[str] = None):
        """Idempotently apply paging knobs (``engine.py:700``). A
        matching engine is a no-op; a mismatched one is rebuilt IF it has
        never admitted a request, else this raises. ``prefix_cache``
        alone toggles on the host. ``attn_kernel``/``kv_dtype`` are
        paged-pool knobs, as in the constructor: a flat engine takes them
        only together with ``page_size``, and repaging a flat engine
        without ``attn_kernel`` picks the paged default, ``"cuda"``."""
        want_ps = int(page_size) if page_size is not None else None
        if want_ps is not None and want_ps < 1:
            raise ValueError("page_size must be >= 1")
        if attn_kernel is not None and \
                attn_kernel not in gpt_decode.ATTN_KERNELS:
            raise ValueError(
                f"unknown attn_kernel {attn_kernel!r}; expected one of "
                f"{gpt_decode.ATTN_KERNELS}")
        if kv_dtype is not None and kv_dtype not in gpt_decode.KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r}; expected one of "
                f"{gpt_decode.KV_DTYPES}")
        with self._admit_lock:
            if want_ps is None and not self.paged and (
                    prefix_cache or n_pages is not None or
                    (attn_kernel or "gather") != "gather" or
                    (kv_dtype or "fp") != "fp"):
                raise ValueError(
                    "prefix_cache/n_pages/attn_kernel/kv_dtype are "
                    "paged-pool knobs; this engine is flat — pass "
                    "page_size to repage it")
            knob_change = (
                (attn_kernel is not None and
                 attn_kernel != self.attn_kernel) or
                (kv_dtype is not None and kv_dtype != self.kv_dtype))
            if want_ps is None and self.paged and (
                    n_pages is not None or knob_change):
                want_ps = self.page_size   # rebuild keeps the page size
            need_rebuild = want_ps is not None and (
                not self.paged or self.page_size != want_ps or
                (n_pages is not None and int(n_pages) != self.n_pages) or
                knob_change)
            if need_rebuild:
                if self._used():
                    raise ValueError(
                        f"cannot repage a live engine (page_size="
                        f"{self.page_size or None} -> {want_ps}); "
                        f"construct it paged or apply the config "
                        f"before traffic")
                if attn_kernel is not None or not self.paged:
                    self.attn_kernel = attn_kernel or "cuda"
                if kv_dtype is not None:
                    self.kv_dtype = kv_dtype
                self._build_pool(True, want_ps, int(n_pages or 0),
                                 prefix_cache if prefix_cache is not None
                                 else self._prefix is not None)
            elif prefix_cache is not None and self.paged:
                if prefix_cache and self._prefix is None:
                    self._prefix = _PrefixCache(self._pool,
                                                self.page_size)
                elif not prefix_cache and self._prefix is not None:
                    self._prefix.clear()
                    self._prefix = None
        return self

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
            if self._used():
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

    def ensure_role(self, role: Optional[str] = None,
                    handoff_ttl_s: Optional[float] = None):
        """Idempotently apply the disaggregation knobs (``engine.py:828``).
        A matching engine is a no-op; a mismatched one is re-roled IF it
        has never admitted or exported, else this raises."""
        if role is not None and role not in ROLES:
            raise ValueError(f"unknown engine role {role!r}")
        with self._admit_lock:
            if role is not None and role != self.role:
                if self._used(exports=True):
                    raise ValueError(
                        f"cannot change engine role ({self.role} -> "
                        f"{role}) on a live engine; construct it with "
                        f"the role or apply the config before traffic")
                self.role = role
            if handoff_ttl_s is not None:
                self._leases.ttl_s = float(handoff_ttl_s)
        return self

    def ensure_tp(self, tp: Optional[int] = None):
        """Idempotently apply the tensor-parallel width
        (``engine.py:856``). A matching engine is a no-op; a mismatched
        one is rebuilt on the new width IF it has never admitted a
        request, else this raises: every rank's weights and pool are
        laid out for the width."""
        if tp is None:
            return self
        want = int(tp)
        with self._admit_lock:
            if want == self.tp:
                return self
            if self._used():
                raise ValueError(
                    f"cannot change tp ({self.tp} -> {want}) on a live "
                    f"engine; construct it with tp= or apply the config "
                    f"before traffic")
            new = self._new_shards(_tp.tp_validate(self.cfg, want,
                                                   self.device))
            if self._shards is not None:
                self._shards.drop()
            self.tp, self._shards = want, new
            self._build_pool(self.paged, self.page_size, self.n_pages,
                             self._prefix is not None)
        return self

    #: Config-plane knob split for :meth:`apply_config`.
    _PAGE_KEYS = ("page_size", "prefix_cache", "n_pages",
                  "attn_kernel", "kv_dtype")
    _SPEC_KEYS = ("spec_decode", "draft_k", "spec_threshold")
    _ROLE_KEYS = ("role", "handoff_ttl_s")
    _TP_KEYS = ("tp",)

    def apply_config(self, **knobs):
        """Route a deployment's ``engine:`` config block to the appliers
        (``engine.py:892``): ``tp`` to :meth:`ensure_tp` (first), paging
        knobs to :meth:`ensure_paging`, speculation knobs to
        :meth:`ensure_spec`, role knobs to :meth:`ensure_role`. None
        values are skipped; unknown keys raise."""
        known = set(self._PAGE_KEYS) | set(self._SPEC_KEYS) \
            | set(self._ROLE_KEYS) | set(self._TP_KEYS)
        unknown = set(knobs) - known
        if unknown:
            raise ValueError(
                f"unknown engine config keys {sorted(unknown)}; known: "
                f"{sorted(known)}")
        for keys, apply in ((self._TP_KEYS, self.ensure_tp),
                            (self._PAGE_KEYS, self.ensure_paging),
                            (self._SPEC_KEYS, self.ensure_spec),
                            (self._ROLE_KEYS, self.ensure_role)):
            sub = {k: v for k, v in knobs.items()
                   if k in keys and v is not None}
            if sub:
                apply(**sub)
        return self

    # ------------------------------------------------------------ admission
    def _validate_admission(self, prompt, max_new: int):
        """Shared by every entry point that prefills from a prompt
        (``submit`` and ``handoff``; ``engine.py:927``): the prompt as
        int32 ``[S]``, its bucket, and the generation bounded by the
        cache. Returns ``(prompt, bucket)``."""
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
        return prompt, bucket

    def _new_req_id(self) -> str:
        """Flight-recorder id of a new admission (``engine.py:947``): the
        request context's id when a serving layer set one, else a local
        ``eng-<pid hex>-<n>`` from this engine's counter."""
        rid = get_request_id()
        if rid:
            return rid
        with self._admit_lock:
            self._req_uid += 1
            return f"eng-{os.getpid():x}-{self._req_uid}"

    def _enqueue(self, req: _EngineRequest):
        with self._admit_lock:
            if self._draining:
                raise EngineShutdownError(
                    "engine is not accepting requests (draining or shut "
                    "down); resubmit on another replica")
            self._queue.put(req)

    def submit(self, prompt, max_new: int, *,
               deadline_s: Optional[float] = None,
               trace_ctx: Optional[dict] = None, seed: int = 0,
               resume_from: int = 0) -> _StreamLane:
        """Enqueue one request; returns its stream lane immediately. The
        driver admits it at the next chunk boundary with a free slot.
        ``deadline_s`` is an absolute ``time.time()`` stamp; ``seed``
        seeds the request's PRNG lane (temperature > 0); ``trace_ctx`` is
        accepted and ignored (tracing is not ported).

        ``resume_from=n`` says the caller already holds the first ``n``
        tokens of this exact (prompt, knobs, seed) stream: the engine
        replays the generation and suppresses those ``n`` tokens."""
        if self.role == "prefill":
            raise ValueError(
                "prefill-role engine only exports handoffs (use "
                "handoff()); decode streams need a decode-capable "
                "engine")
        prompt, bucket = self._validate_admission(prompt, max_new)
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
        req_id = self._new_req_id()
        self._enqueue(_EngineRequest(
            prompt=prompt, bucket=bucket, max_new=int(max_new), lane=lane,
            deadline_s=deadline_s, seed=int(seed), skip=resume_from,
            req_id=req_id))
        if resume_from:
            self._count(resumed=1)
            _events.emit("engine.resume", request=req_id,
                         resume_from=resume_from, epoch=self._epoch)
        return lane

    def stream(self, prompt, max_new: int, **kw) -> _EngineStream:
        """``submit`` + drain: an iterator of np.int32 ``[j]`` chunk
        slices (the first is the prefill token alone)."""
        return _EngineStream(self.submit(prompt, max_new, **kw))

    # ----------------------------------------------------- disaggregation
    def handoff(self, prompt, max_new: int, *, seed: int = 0,
                deadline_s: Optional[float] = None,
                trace_ctx: Optional[dict] = None,
                ttl_s: Optional[float] = None) -> dict:
        """Prefill ``prompt`` into a transient slot, sample the first
        token, export the slot's K/V and return a leased handoff
        descriptor (``engine.py:1021``); the slot frees before this
        returns. The descriptor carries the lease (``lease_id``,
        ``epoch``, ``expires_at``), the ``digest``, the inline
        ``payload`` and the replay identity (``prompt``, ``seed``,
        ``max_new``), so any decode-capable engine can import the bytes
        or, if they are bad, re-prefill the same stream.

        Blocks until the driver exports (bounded by ``deadline_s``, else
        120 s); safe from any thread."""
        if self.role == "decode":
            raise ValueError(
                "decode-role engine cannot export handoffs; use a "
                "prefill or both-role engine")
        prompt, bucket = self._validate_admission(prompt, max_new)
        if max_new < 1:
            raise ValueError("handoff needs max_new >= 1 (the first "
                             "token is sampled at prefill)")
        prng.PRNGKey(seed)
        lane = _StreamLane()
        self._enqueue(_EngineRequest(
            prompt=prompt, bucket=bucket, max_new=int(max_new), lane=lane,
            deadline_s=deadline_s, seed=int(seed), export=True,
            ttl_s=float(ttl_s or 0.0), req_id=self._new_req_id()))
        rem = remaining_s(deadline_s)
        try:
            kind, val = lane.q.get(timeout=rem if rem is not None
                                   else 120.0)
        except queue.Empty:
            lane.closed = True
            raise RequestDeadlineExceeded(
                "handoff export did not complete before the request "
                "deadline") from None
        if kind == "err":
            raise val
        if kind is _STREAM_END:
            raise EngineShutdownError(
                "handoff export lane closed without a descriptor")
        return val

    def claim_handoff(self, lease_id: str, epoch: int) -> bool:
        """Decode-side acknowledgement that a shipped payload was
        imported: releases the lease before its expiry
        (``engine.py:1081``). Unknown or stale leases return False."""
        ok = self._leases.claim(lease_id, int(epoch))
        _events.emit("handoff.claim", lease=lease_id, epoch=int(epoch),
                     released=ok)
        return ok

    def admit_prefilled(self, desc: dict, *,
                        deadline_s: Optional[float] = None,
                        trace_ctx: Optional[dict] = None,
                        resume_from: int = 0) -> _StreamLane:
        """Admit a handed-off stream (``engine.py:1092``): resolve the
        descriptor's payload, check it against the descriptor's digest,
        byte-verify it, check that it fits this engine (positions,
        shape, ``kv_dtype``/``page_size``, layout) and enqueue an import;
        the driver scatters the K/V into a free slot and decoding
        continues from the prefill engine's state. Any failure falls back
        to a LOCAL prefill of the descriptor's prompt and seed
        (token-identical by determinism), counted in
        ``stats()["handoff"]["import_fallbacks"]``. Returns the stream
        lane; safe from any thread."""
        if self.role == "prefill":
            raise ValueError(
                "prefill-role engine cannot import handoffs; use a "
                "decode or both-role engine")
        prompt = np.asarray(desc["prompt"], np.int32).reshape(-1)
        max_new = int(desc["max_new"])
        seed = int(desc["seed"])
        resume_from = int(resume_from)
        try:
            payload = self._check_payload(desc, max_new)
        except _ho.HandoffError:
            self._count(handoff_import_fallbacks=1)
            serve_metrics()["prefill_fallbacks"].inc(
                labels={"deployment": self.deployment, "where": "engine"})
            return self.submit(prompt, max_new, seed=seed,
                               deadline_s=deadline_s,
                               resume_from=resume_from)
        if resume_from < 0 or resume_from > max_new:
            raise ValueError(
                f"resume_from {resume_from} outside [0, max_new="
                f"{max_new}]")
        # The import never reads the bucket (a preempted import
        # re-imports), so a prompt past the largest bucket still imports.
        bucket = next((b for b in self.prompt_buckets
                       if b >= prompt.shape[0]), self.prompt_buckets[-1])
        lane = _StreamLane()
        self._enqueue(_EngineRequest(
            prompt=prompt, bucket=bucket, max_new=max_new, lane=lane,
            deadline_s=deadline_s, seed=seed, skip=resume_from,
            handoff={"payload": payload,
                     "created_t": desc.get("created_t")},
            req_id=self._new_req_id()))
        if resume_from:
            self._count(resumed=1)
        return lane

    def _check_payload(self, desc: dict, max_new: int) -> dict:
        """The checks that send an import to the local-prefill fallback,
        in the reference's order; raises :class:`HandoffError`."""
        payload = _ho.resolve_payload(desc)
        # The descriptor's digest first: a stale payload that is
        # internally consistent would pass verify_payload alone.
        if desc.get("digest") and payload.get("digest") != desc["digest"]:
            raise _ho.HandoffError(
                "shipped payload digest does not match the descriptor's "
                "(stale or clobbered object)")
        _ho.verify_payload(payload)
        P = int(payload["pos"])
        if P + max_new > self.max_len:
            raise _ho.HandoffError(
                f"shipped pos {P} + max_new {max_new} exceeds cache "
                f"length {self.max_len}")
        want = (self.cfg.n_layer, P, self.cfg.n_head, self.cfg.head_dim)
        if tuple(payload["k"].shape) != want \
                or tuple(payload["v"].shape) != want:
            raise _ho.HandoffError(
                f"shipped KV shape {tuple(payload['k'].shape)} does not "
                f"fit this engine's model ({want})")
        ship_dt = payload.get("kv_dtype", "fp")
        mine = self.kv_dtype if self.paged else "fp"
        if ship_dt != mine:
            raise _ho.HandoffError(
                f"shipped kv_dtype {ship_dt!r} does not match this "
                f"engine's ({mine!r})")
        if ship_dt == "int8" and \
                int(payload.get("page_size", 0)) != self.page_size:
            raise _ho.HandoffError(
                f"shipped page_size {payload.get('page_size')} does not "
                f"match this engine's ({self.page_size})")
        layout = payload.get("layout", "canonical")
        if layout != "canonical":
            raise _ho.HandoffError(
                f"shipped KV layout {layout!r} is not the canonical host "
                f"layout")
        return payload

    def queue_depth(self) -> int:
        """Requests accepted but not yet admitted to a slot."""
        return self._queue.qsize() + len(self._pending)

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        with self._admit_lock:
            self._draining = False
            if self._shards is not None and self._shards.eid is None:
                # Shut down before: the followers dropped this engine.
                self._shards.load(self.params)
                self._build_pool(self.paged, self.page_size, self.n_pages,
                                 self._prefix is not None)
        self._shutdown = False
        self._stop = threading.Event()
        self._beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop, self._epoch), daemon=True,
            name=f"rt-torch-decode-engine-{self.deployment}")
        self._thread.start()

    def shutdown(self, timeout_s: float = 5.0):
        """Stop the driver and fail every queued or in-flight lane with
        :class:`EngineShutdownError`. A driver that outlives the join
        still owns the slots and pages: its lanes fail, its bookkeeping
        is left to its own exit path."""
        self._shutdown = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        alive = self._thread is not None and self._thread.is_alive()
        self._fail_all(EngineShutdownError("engine shut down"),
                       free_state=not alive)
        if self._shards is not None:
            # The followers free this engine's weights and pool; a
            # driver that outlived the join is refused from now on.
            self._shards.drop()

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Graceful wind-down (``engine.py:1258``): admissions stop now
        (``submit`` raises :class:`EngineShutdownError`), queued requests
        that never started fail the same way, running lanes finish, and
        stragglers fail at the deadline. True when every lane finished
        within ``timeout_s``. The driver keeps running."""
        with self._admit_lock:
            self._draining = True
        deadline = time.monotonic() + max(float(timeout_s), 0.0)
        while time.monotonic() < deadline:
            if not any(s is not None for s in self._state) \
                    and not self._queue.qsize() and not self._pending:
                return True
            time.sleep(0.01)
        alive = self._thread is not None and self._thread.is_alive()
        self._fail_all(
            EngineShutdownError(
                f"engine drained with lanes still running after "
                f"{timeout_s:.1f}s; resubmit to resume"),
            free_state=not alive)
        return False

    def supervise(self) -> bool:
        """Driver health, with a one-shot recovery (``engine.py:1289``):
        True while the driver is alive and beating (or deliberately
        stopped); on a death or a wedge (heartbeat older than
        ``wedge_timeout_s``) the driver restarts, its lanes failing with
        :class:`EngineRestartError`, and this still returns True, up to
        ``max_driver_restarts`` times; after that False."""
        with self._supervise_lock:
            t = self._thread
            if t is None or self._shutdown:
                return True
            alive = t.is_alive()
            beat_age = time.monotonic() - self._beat
            wedged = alive and beat_age > self.wedge_timeout_s
            if alive and not wedged:
                return True
            with self._stats_lock:
                restarts = self._stats["driver_restarts"]
            if restarts >= self.max_driver_restarts:
                return False
            self._restart_driver(
                f"driver wedged (no heartbeat for {beat_age:.1f}s)"
                if wedged else "driver thread died")
            return True

    def _restart_driver(self, reason: str):
        """Retire the driver's epoch (a wedged driver that wakes drops
        its results at the epoch guards), fail its lanes retryably,
        rebuild every pool structure (the old driver may still hold the
        old ones), reset the drafter, and start a new driver
        (``engine.py:1318``)."""
        exc = EngineRestartError(
            f"engine driver restarted ({reason}); resubmit to resume")
        self._stop.set()
        with self._fail_lock:
            # Lanes fail; state and pages are not freed into the old
            # structures, which the rebuild replaces wholesale.
            self._fail_all_locked(exc, free_state=False)
            self._epoch += 1
            with self._admit_lock:
                self._build_pool(self.paged, self.page_size or 16,
                                 self.n_pages, self._prefix is not None)
                if self._drafter is not None:
                    self._drafter.reset()
                self._state = [None] * self.slots
                self._token = np.zeros((self.slots,), np.int32)
                self._rngs = np.zeros((self.slots, 2), np.uint32)
                self._pending = collections.deque()
                self._queue = queue.SimpleQueue()
        self._count(driver_restarts=1)
        serve_metrics()["engine_driver_restarts"].inc(
            labels={"deployment": self.deployment})
        _events.emit("engine.driver_restart", epoch=self._epoch,
                     deployment=self.deployment, reason=reason)
        self._thread = None
        self.start()

    def inject_fault(self, kind: str = "driver_die", at_tokens: int = 0,
                     wedge_s: float = 0.0):
        """Arm ONE chaos fault on the driver, triggered at the next loop
        boundary once ``at_tokens`` tokens have been delivered (testing
        only; ``engine.py:1360``):

        - ``"driver_die"``: the driver raises; lanes fail with
          :class:`EngineRestartError` and :meth:`supervise` restarts it;
        - ``"driver_wedge"``: the driver stalls ``wedge_s`` seconds
          without a heartbeat;
        - ``"kill_process"``: ``os._exit(43)``, the whole process dies;
        - ``"driver_slow"``: a persistent stall of ``wedge_s`` seconds
          per loop, heartbeat still beating."""
        if kind not in ("driver_die", "driver_wedge", "kill_process",
                        "driver_slow"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if kind == "driver_slow":
            self._throttle_s = float(wedge_s)
            return
        self._fault = {"kind": kind, "at_tokens": int(at_tokens),
                       "wedge_s": float(wedge_s)}

    def _check_fault(self):
        """The driver loop's fault point (no-op unless armed)."""
        if self._throttle_s:
            time.sleep(self._throttle_s)
        f = self._fault
        if f is None:
            return
        with self._stats_lock:
            toks = self._stats["tokens"]
        if toks < f["at_tokens"]:
            return
        self._fault = None
        if f["kind"] == "driver_wedge":
            time.sleep(f["wedge_s"])          # stall WITHOUT beating
        elif f["kind"] == "kill_process":
            os._exit(43)
        else:
            raise RuntimeError(
                f"injected engine driver death at {toks} tokens")

    def stats(self) -> dict:
        """The reference's ``stats()`` keys (``engine.py:1412``) but its
        ``sanitizer`` block; paged-pool keys only on a paged engine."""
        with self._stats_lock:
            out = dict(self._stats)
        out["active_slots"] = sum(s is not None for s in self._state)
        out["slots"] = self.slots
        out["queue_depth"] = out["queued"] = self.queue_depth()
        d = max(out["dispatches"], 1)
        out["avg_occupancy"] = out.pop("occupancy_sum") / d
        out["dispatches_per_token"] = (
            (out["dispatches"] + out["prefills"]) / max(out["tokens"], 1))
        out["paged"] = self.paged
        out["deployment"] = self.deployment
        out["tp"] = self.tp
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
        out["role"] = self.role
        ls = self._leases.stats()
        out["handoff"] = {
            "exported": out.pop("handoffs_exported"),
            "imported": out.pop("handoffs_imported"),
            "import_fallbacks": out.pop("handoff_import_fallbacks"),
            "ship_bytes": out.pop("handoff_ship_bytes"),
            "leases_outstanding": ls["outstanding"],
            "leases_claimed": ls["claimed"],
            "leases_reclaimed": ls["reclaimed"],
        }
        t = self._thread
        out["driver_alive"] = bool(t is not None and t.is_alive())
        out["heartbeat_age_s"] = round(time.monotonic() - self._beat, 3)
        out["draining"] = self._draining
        # This process's flight-recorder health: ring fill and per-kind
        # rate-cap drops.
        out["events"] = _events.stats()
        if self.paged:
            out["page_size"] = self.page_size
            out["n_pages"] = self.n_pages
            out["pages_free"] = self._pool.available()
            out["pages_used"] = self.n_pages - self._pool.available()
            out["parked_slots"] = sum(
                s is not None and s.parked for s in self._state)
            if self._prefix is not None:
                out["prefix_cache_entries"] = len(self._prefix)
                out["prefix_evictions"] = self._prefix.evictions
            out["attn_kernel"] = self.attn_kernel
            out["kv_dtype"] = self.kv_dtype
            out["kv_bytes_per_token"] = self._kv_bytes_per_token()
        else:
            for k in ("prefix_hits", "prefix_tokens_reused",
                      "cow_copies", "admissions_deferred", "lane_parks",
                      "preempted", "attn_kernel_dispatches"):
                out.pop(k, None)
        return out

    def _kv_bytes_per_token(self) -> float:
        return gpt_decode.kv_bytes_per_page(
            self.cfg, self.page_size, self.kv_dtype) / self.page_size

    def _count(self, **deltas):
        with self._stats_lock:
            for k, v in deltas.items():
                self._stats[k] += v

    # ---------------------------------------------------------- driver loop
    def _stale(self, epoch: int) -> bool:
        """A supervisor restart retired this driver run."""
        return epoch >= 0 and epoch != self._epoch

    def _run(self, stop: threading.Event, epoch: int):
        self._driver.epoch = epoch
        try:
            while not stop.is_set():
                # Heartbeat before any work: supervise() reads its age to
                # tell a wedged dispatch from an idle loop.
                self._beat = time.monotonic()
                self._check_fault()
                if stop.is_set():
                    break            # woke from a wedge past a restart
                self._admit_pending(epoch)
                self._observe_queue_depth()
                self._sweep_leases()
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
                    self._dispatch_spec(epoch)
                else:
                    self._dispatch_chunk(epoch)
            self._fail_all(EngineShutdownError("engine shut down"),
                           epoch=epoch)
        except _tp.GroupCallRefused:
            # Retired by a restart (the epoch guard makes this a no-op)
            # or shut down: nothing reached the group.
            self._fail_all(EngineShutdownError("engine shut down"),
                           epoch=epoch)
        except BaseException as e:  # noqa: BLE001 - driver died: fan out
            # The lanes' streams replay deterministically elsewhere, so
            # they fail with the retryable restart error.
            exc = e
            if not isinstance(e, EngineShutdownError):
                exc = EngineRestartError(
                    f"engine driver died: {e!r}; resubmit to resume")
                exc.__cause__ = e
            self._fail_all(exc, epoch=epoch)
            raise

    def _fail_all(self, exc: BaseException, free_state: bool = True,
                  epoch: Optional[int] = None):
        """Fail every queued / in-flight lane with ``exc``.
        ``free_state=False`` (shutdown racing a still-alive driver) only
        puts errors; slot state, the pending deque and the page pool stay
        the driver's. ``epoch`` (a driver's exit path) makes this a no-op
        once a restart retired that run. Serialized, so page refcounts
        drop once."""
        with self._fail_lock:
            if epoch is not None and epoch != self._epoch:
                return
            self._fail_all_locked(exc, free_state)

    def _fail_all_locked(self, exc: BaseException, free_state: bool):
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

    def _alloc_pages(self, n: int, pool: Optional[_PagePool] = None,
                     prefix: Optional[_PrefixCache] = None
                     ) -> Optional[List[int]]:
        """Allocate n pages, evicting LRU prefix-cache entries while
        short. None = genuinely out (every page pinned by live lanes).
        ``pool``/``prefix`` keep an admission on one snapshot across a
        restart (default: the engine's current ones)."""
        pool = self._pool if pool is None else pool
        prefix = self._prefix if prefix is None else prefix
        while pool.available() < n:
            if prefix is None or not prefix.evict_lru():
                return None
            _driver_emit("engine.page_evict", epoch=self._epoch,
                         wanted=n, free=pool.available())
        pages = pool.alloc(n)
        if pages is not None:
            _driver_emit("engine.page_alloc", epoch=self._epoch, n=n,
                         free=pool.available())
        return pages

    def _observe_pages(self, sm=None):
        """The page gauges (``engine.py:1641``), from the host's
        allocator."""
        if not self.paged:
            return
        sm = sm or serve_metrics()
        free = self._pool.available()
        labels = {"deployment": self.deployment}
        sm["engine_pages_free"].set(free, labels=labels)
        sm["engine_pages_used"].set(self.n_pages - free, labels=labels)
        sm["engine_kv_bytes_per_token"].set(self._kv_bytes_per_token(),
                                            labels=labels)

    def _sweep_leases(self):
        """Reclaim expired handoff leases, once per driver loop
        (``engine.py:1656``)."""
        if not len(self._leases):
            return
        n = self._leases.sweep()
        if n:
            serve_metrics()["handoff_leases_reclaimed"].inc(
                n, labels={"deployment": self.deployment})
            _driver_emit("handoff.reclaim", count=n, epoch=self._epoch,
                         outstanding=len(self._leases))

    def _observe_queue_depth(self):
        """The admission backlog gauge, once per driver loop
        (``engine.py:1673``)."""
        serve_metrics()["engine_queue_depth"].set(
            self.queue_depth(), labels={"deployment": self.deployment})

    def _expired(self, sm=None):
        """Count one request that the engine failed at its deadline."""
        self._count(expired=1)
        (sm or serve_metrics())["requests_expired"].inc(
            labels={"where": "engine", "deployment": self.deployment})

    def _admit_pending(self, epoch: int = -1):
        """Chunk-boundary admission: fill every free slot in FIFO order.
        Expired or abandoned requests fail out without a prefill; an
        admission that cannot get pages DEFERS at the queue head. While
        draining, requests that never started fail retryably."""
        if self._stale(epoch):
            return
        while True:
            try:
                self._pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if self._draining and self._pending:
            exc = EngineShutdownError(
                "engine draining; resubmit on another replica")
            while self._pending:
                self._pending.popleft().lane.q.put(("err", exc))
            return
        for _ in range(len(self._pending)):
            req = self._pending.popleft()
            if req.lane.closed:
                self._count(abandoned=1)
                continue
            if deadline_expired(req.deadline_s):
                self._expired()
                req.lane.q.put(("err", RequestDeadlineExceeded(
                    "request expired while queued for engine admission")))
                continue
            self._pending.append(req)
        if any(s is not None and s.parked for s in self._state):
            # Freed pages go to the (older) parked lanes before any new
            # admission may take them.
            return
        while self._pending and any(s is None for s in self._state):
            admitted = self._admit_one(self._pending[0], epoch)
            if self._stale(epoch):
                # Restarted past this driver while it admitted: the
                # deque is the new driver's now.
                return
            if not admitted:
                self._count(admissions_deferred=1)
                return               # out of pages: keep FIFO, back off
            self._pending.popleft()

    def _admit_one(self, req: _EngineRequest, epoch: int = -1) -> bool:
        """Prefill (or import) ``req`` into a free slot; False defers (no
        pages). A handoff export leaves through :meth:`_finish_export`,
        everything else through :meth:`_enter_steady_state`."""
        slot = next(i for i, s in enumerate(self._state) if s is None)
        sm = serve_metrics()
        if req.handoff is not None:
            return self._admit_import(req, slot, sm, epoch)
        P = req.prompt.shape[0]
        key = prng.PRNGKey(req.seed)
        if self.paged:
            admitted = self._prefill_paged(req, slot, P, key, sm, epoch)
            if admitted is None:
                return False
            first, pages, t_admit = admitted
        else:
            t_admit = time.time()
            padded = np.zeros((1, req.bucket), np.int32)
            padded[0, :P] = req.prompt
            first, rng = self._fn("prefill_into_slot")(
                self._params_dev, self._cache, padded, P, slot, key,
                cfg=self.cfg, temperature=self.temperature)
            if self._stale(epoch):
                return True          # stale driver: drop on the floor
            self._rngs[slot] = rng
            pages = []
        sm["engine_admission_wait"].observe(
            max(t_admit - req.enq_t, 0.0),
            labels={"deployment": self.deployment})
        self._count(prefills=1, admitted=1 if (req.skip == 0
                                              and not req.export) else 0)
        self._token[slot] = first
        if req.export:
            return self._finish_export(req, slot, P, pages, first, sm)
        return self._enter_steady_state(req, slot, first, P, pages, sm)

    def _enter_steady_state(self, req: _EngineRequest, slot: int,
                            first: int, P: int, pages: List[int],
                            sm) -> bool:
        """The admission tail shared by a local prefill and a handoff
        import (``engine.py:1800``): deliver the first token (or
        suppress it on a replay), close out a one-token or EOS request,
        else install the slot's state and seed the drafter. Both paths
        keep the same ``emitted``/``skip`` bookkeeping, so a resumed
        stream is the same whichever way it was admitted."""
        _driver_emit("engine.admit", request=req.req_id, slot=slot,
                     epoch=self._epoch, prompt_len=P, max_new=req.max_new,
                     resume_from=req.skip)
        skip = req.skip
        if skip > 0:
            skip -= 1            # replay: the first token was delivered
        else:
            self._count(tokens=1)
            sm["engine_tokens"].inc(labels={"deployment": self.deployment})
            req.lane.q.put(("item", np.asarray([first], np.int32)))
        if req.max_new <= 1 or (self.eos_token >= 0
                                and first == self.eos_token):
            req.lane.q.put((_STREAM_END, None))
            self._count(completed=1)
            if pages:
                self._pool.unref(pages)
                self._pt[slot, :] = gpt_decode.PT_SENTINEL
            self._observe_pages(sm)
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
        self._observe_pages(sm)
        return True

    def _prefill_paged(self, req: _EngineRequest, slot: int, P: int,
                       key: np.ndarray, sm, epoch: int = -1
                       ) -> Optional[Tuple[int, List[int], float]]:
        """Map the cached prefix (refcounted, COW fork if it ends
        mid-page), allocate fresh pages for the suffix, prefill ONLY the
        suffix, then register the prompt's pages in the prefix cache.
        Returns ``(first_token, pages, t_admit)``, ``t_admit`` the end of
        the admission wait, or None (nothing taken) when
        pages are unavailable even after LRU eviction, or when a restart
        retired this driver during the prefill."""
        ps = self.page_size
        # One snapshot for the whole admission: a restart swaps the pool
        # structures wholesale.
        pool, prefix, pt, cache = self._pool, self._prefix, self._pt, \
            self._cache
        hist, shared_pages = (0, [])
        if prefix is not None:
            hist, shared_pages = prefix.lookup(req.prompt)
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
        fresh = self._alloc_pages(-(-P // ps) - shared_full, pool, prefix)
        if fresh is None:
            pool.unref(shared)
            if partial:
                pool.unref([cow_src])
            return None
        pages = shared + fresh
        t_admit = time.time()
        sl = P - hist
        bucket = next(b for b in self.prompt_buckets if b >= sl)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :sl] = req.prompt[hist:]
        pt_row = np.full((self.max_pages,), gpt_decode.PT_SENTINEL,
                         np.int32)
        pt_row[:len(pages)] = pages
        pt[slot] = pt_row
        first, rng = self._fn("prefill_into_slot_paged")(
            self._params_dev, cache, padded, sl, hist, pt_row, cow_src,
            slot, key, cfg=self.cfg, page_size=ps,
            temperature=self.temperature, kv_dtype=self.kv_dtype)
        if partial:
            # The fork is enqueued ahead of any later write to cow_src on
            # the same stream; its pin is no longer needed.
            pool.unref([cow_src])
        if self._stale(epoch):
            pool.unref(pages)        # hand back, on the same snapshot
            return None
        self._rngs[slot] = rng
        labels = {"deployment": self.deployment}
        if partial:
            self._count(cow_copies=1)
            sm["engine_cow_copies"].inc(labels=labels)
        if hist:
            self._count(prefix_hits=1, prefix_tokens_reused=hist)
            sm["engine_prefix_hits"].inc(labels=labels)
        if prefix is not None:
            prefix.insert(req.prompt, pages)
        return first, pages, t_admit

    def _finish_export(self, req: _EngineRequest, slot: int, P: int,
                       pages: List[int], first: int, sm) -> bool:
        """Handoff export tail (``engine.py:1927``), right after the
        prefill: the slot's K/V trimmed to the prompt and gathered on the
        device, copied to the host, the slot's pages freed, a lease
        granted, and the descriptor delivered on the request's lane. The
        slot never enters steady state."""
        quant = self.paged and self.kv_dtype == "int8"
        if self.paged:
            dev = self._fn("export_slot_kv_paged")(
                self._cache, self._pt[slot], cfg=self.cfg,
                page_size=self.page_size, kv_dtype=self.kv_dtype,
                length=P)
        else:
            dev = self._fn("export_slot_kv")(self._cache, slot,
                                             cfg=self.cfg, length=P)
        host = gpt_decode.kv_to_host(*dev)
        k, v = host[:2]
        ks, vs = host[2:] if quant else (None, None)
        rng = np.asarray(self._rngs[slot], np.uint32).copy()
        if pages:
            self._pool.unref(pages)
            self._pt[slot, :] = gpt_decode.PT_SENTINEL
        payload = _ho.build_payload(
            k=k, v=v, prompt=req.prompt, pos=P, first=first, rng=rng,
            seed=req.seed, max_new=req.max_new, ks=ks, vs=vs,
            kv_dtype=self.kv_dtype if quant else None,
            page_size=self.page_size if quant else None)
        fields, nbytes = _ho.ship_payload(payload)
        lease_id, expires = self._leases.grant(
            epoch=self._epoch, nbytes=nbytes, ttl_s=req.ttl_s or None)
        desc = dict(fields)
        desc.update({
            "lease_id": lease_id, "epoch": self._epoch,
            "expires_at": expires, "digest": payload["digest"],
            "prompt": req.prompt, "pos": P, "first": first,
            "seed": req.seed, "max_new": req.max_new,
            "created_t": time.time(), "nbytes": nbytes,
            # The reference's locality hint is the runtime's node id,
            # None outside a runtime (``engine.py:187``); the port has
            # no runtime.
            "node_id": None, "deployment": self.deployment})
        # ``tokens`` counts the sampled first token, so a fault armed at
        # token N fires on a prefill engine too.
        self._count(handoffs_exported=1, handoff_ship_bytes=nbytes,
                    tokens=1)
        _driver_emit("handoff.grant", request=req.req_id, lease=lease_id,
                     epoch=self._epoch, nbytes=nbytes,
                     ttl_s=req.ttl_s or self._leases.ttl_s)
        _driver_emit("engine.export", request=req.req_id, slot=slot,
                     epoch=self._epoch, prompt_len=P, nbytes=nbytes)
        sm["kv_ship_bytes"].inc(nbytes,
                                labels={"deployment": self.deployment})
        req.lane.q.put(("item", desc))
        req.lane.q.put((_STREAM_END, None))
        self._observe_pages(sm)
        return True

    def _admit_import(self, req: _EngineRequest, slot: int, sm,
                      epoch: int = -1) -> bool:
        """Handoff import admission (``engine.py:2006``): scatter the
        verified payload into a free slot (flat) or freshly allocated
        pages (paged; only the covering pages are uploaded), restore the
        slot's PRNG lane and fed token, and enter steady state where the
        prefill engine stopped. False defers (no pages)."""
        payload = req.handoff["payload"]
        P = int(payload["pos"])
        t_admit = time.time()
        if self.paged:
            pool, prefix, pt, cache = self._pool, self._prefix, self._pt, \
                self._cache
            pages = self._alloc_pages(-(-P // self.page_size), pool, prefix)
            if pages is None:
                return False          # out of pages: defer, keep FIFO
            pt_row = np.full((self.max_pages,), gpt_decode.PT_SENTINEL,
                             np.int32)
            pt_row[:len(pages)] = pages
            pt[slot] = pt_row
            quant = self.kv_dtype == "int8"
            self._fn("import_slot_kv_paged")(
                cache, self._heads(payload["k"], -2),
                self._heads(payload["v"], -2), pt_row, slot, P,
                cfg=self.cfg, page_size=self.page_size,
                ks_pages=self._heads(payload["ks"], -1) if quant else None,
                vs_pages=self._heads(payload["vs"], -1) if quant else None)
            if self._stale(epoch):
                pool.unref(pages)     # stale driver: hand pages back
                return True
            # The shipped pages cover the whole prompt: later local
            # admissions of the same prefix map them.
            if prefix is not None and P == req.prompt.shape[0]:
                prefix.insert(req.prompt, pages)
        else:
            pages = []
            self._fn("import_slot_kv")(
                self._cache, self._heads(payload["k"], -2),
                self._heads(payload["v"], -2), slot, P, cfg=self.cfg)
            if self._stale(epoch):
                return True
        first = int(payload["first"])
        self._token[slot] = first
        self._rngs[slot] = np.asarray(payload["rng"], np.uint32)
        labels = {"deployment": self.deployment}
        sm["engine_admission_wait"].observe(max(t_admit - req.enq_t, 0.0),
                                            labels=labels)
        created = req.handoff.get("created_t")
        if created:
            # Export stamp to import: the handoff latency, on the wall
            # clock (the two engines may be two processes).
            sm["kv_handoff"].observe(max(time.time() - float(created), 0.0),
                                     labels=labels)
        self._count(handoffs_imported=1,
                    admitted=1 if req.skip == 0 else 0)
        _driver_emit("engine.import", request=req.req_id, slot=slot,
                     epoch=self._epoch, pos=P)
        return self._enter_steady_state(req, slot, first, P, pages, sm)

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
        culled = False
        for i, st in enumerate(self._state):
            if st is None or not st.parked:
                continue
            if st.lane.closed:
                self._free_slot(i)
                self._count(abandoned=1)
                culled = True
            elif deadline_expired(st.deadline_s):
                st.lane.q.put(("err", RequestDeadlineExceeded(
                    "request deadline passed while parked for pages")))
                self._free_slot(i)
                self._expired()
                culled = True
        if culled:
            self._observe_pages()
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
        req.enq_t = time.time()
        self._free_slot(youngest)
        self._pending.appendleft(req)
        self._count(preempted=1)
        _driver_emit("engine.preempt", request=req.req_id, slot=youngest,
                     epoch=self._epoch, delivered=st.emitted)
        self._observe_pages()
        return False

    def _dispatch_chunk(self, epoch: int = -1, cover: bool = True):
        """ONE k-step decode over every active slot, then per-slot
        routing/trimming and boundary frees. A stale driver (restarted
        past while its step ran) drops the result at the epoch guard.
        ``cover=False``: the spec dispatcher already ran this boundary's
        coverage pass before falling back to a chunk."""
        if self._stale(epoch):
            return
        if cover and self.paged and not self._cover_pages():
            return                    # re-run admission/coverage pass
        active = np.array([s is not None and not s.parked
                           for s in self._state], bool)
        n_active = int(active.sum())
        # ``dispatch_s`` is the host's wall time of the step call, which
        # ends with the copy of the chunk's tokens to the host that
        # delivery needs anyway; nothing else waits for the device.
        t0 = time.time()
        toks_np, _done, rngs_np = self._step(self._token, self._rngs,
                                             active)
        t1 = time.time()
        if self._stale(epoch):
            return                    # stale driver: drop on the floor
        sm = serve_metrics()
        labels = {"deployment": self.deployment}
        sm["engine_slot_occupancy"].observe(n_active / self.slots,
                                            labels=labels)
        sm["engine_dispatches"].inc(labels=labels)
        self._count(dispatches=1, occupancy_sum=n_active / self.slots)
        _driver_emit("engine.dispatch", epoch=self._epoch, active=n_active,
                     chunk=self.chunk, dispatch_s=round(t1 - t0, 6))
        if self.tp > 1:
            _driver_emit("shard.dispatch", epoch=self._epoch,
                         mesh=[("tp", self.tp)],
                         program="chunk_paged" if self.paged else "chunk")
        if self.paged and self.attn_kernel == "cuda":
            # One per chunk dispatch through K1 (the kernel runs chunk
            # times per layer inside it): the reference's "pallas" count.
            sm["engine_attn_kernel_dispatches"].inc(labels=labels)
            self._count(attn_kernel_dispatches=1)
        self._peak(n_active)
        emitted = 0
        for i, st in enumerate(self._state):
            if st is None or st.parked:
                continue                     # parked: nothing advanced
            self._token[i] = toks_np[i, -1]
            self._rngs[i] = rngs_np[i]
            st.pos += self.chunk             # mirrors the device pos
            n, j, running = self._deliver(i, st, toks_np[i], self.chunk, sm)
            emitted += n
            if running and self._drafter is not None:
                # Adaptive fallback round: keep the drafter's history
                # (and its self-assessment) current; -1 = nothing was
                # proposed.
                self._drafter.observe(i, toks_np[i, :j], -1)
        if emitted:
            sm["engine_tokens"].inc(emitted, labels=labels)
            self._count(tokens=emitted)
        self._observe_pages(sm)

    def _dispatch_spec(self, epoch: int = -1):
        """Draft-k-verify-once twin of :meth:`_dispatch_chunk`
        (``engine.py:2326``): the drafter proposes ``draft_k`` tokens per
        active slot, ONE batched verify scores them, and each slot
        advances by its own ``accepted + 1``, through the same
        EOS/deadline/replay delivery as the chunk path.

        ``spec_threshold > 0``: the round verifies only when the
        drafters' mean expected acceptance over the runnable lanes
        clears the threshold, else it runs ONE plain chunk for the whole
        pool (a split pool would pay for both steps). A stale driver
        drops the result at the epoch guard."""
        if self._stale(epoch):
            return
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
                self._dispatch_chunk(epoch, cover=False)
                return
        draft = self._drafter.propose(active, self._token)
        com_np, acc_np, rngs_np = self._verify(self._token, draft,
                                               self._rngs, active)
        if self._stale(epoch):
            return                    # stale driver: drop on the floor
        sm = serve_metrics()
        labels = {"deployment": self.deployment}
        sm["engine_slot_occupancy"].observe(n_active / self.slots,
                                            labels=labels)
        sm["engine_dispatches"].inc(labels=labels)
        accepted = int(acc_np[active].sum())
        sm["engine_spec_proposed"].inc(self.draft_k * n_active,
                                       labels=labels)
        if accepted:
            sm["engine_spec_accepted"].inc(accepted, labels=labels)
        self._count(dispatches=1, occupancy_sum=n_active / self.slots,
                    spec_rounds=1, spec_proposed=self.draft_k * n_active,
                    spec_accepted=accepted, spec_lanes=n_active)
        # A verify round runs no decode attention kernel: nothing for
        # attn_kernel_dispatches (``engine.py:2392-2401``).
        _driver_emit("engine.dispatch", epoch=self._epoch, active=n_active,
                     spec=True, accepted=accepted)
        if self.tp > 1:
            _driver_emit("shard.dispatch", epoch=self._epoch,
                         mesh=[("tp", self.tp)],
                         program="verify_paged" if self.paged
                         else "verify")
        self._peak(n_active)
        emitted = 0
        for i, st in enumerate(self._state):
            if st is None or not active[i]:
                continue
            na = int(acc_np[i])
            sm["engine_spec_accept_len"].observe(na, labels=labels)
            self._rngs[i] = rngs_np[i]
            st.pos += na + 1                 # mirrors the device pos
            n, j, running = self._deliver(i, st, com_np[i], na + 1, sm)
            emitted += n
            if j:
                # The last delivered token, kept also when the lane just
                # finished (``engine.py:2446``): a freed slot's row still
                # runs in the next dispatch, and under MoE it competes
                # for the experts' capacity.
                self._token[i] = com_np[i, j - 1]
            if running:
                self._drafter.observe(i, com_np[i, :j], na)
        if emitted:
            sm["engine_tokens"].inc(emitted, labels=labels)
            self._count(tokens=emitted)
        self._observe_pages(sm)

    def _peak(self, n_active: int):
        with self._stats_lock:
            self._stats["peak_active"] = max(self._stats["peak_active"],
                                             n_active)

    def _deliver(self, i: int, st: _Slot, row: np.ndarray, adv: int, sm
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
            self._expired(sm)
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
