"""Dynamic request batching with bucketed padding: the ``@batch``
decorator, the port's copy of ``ray_tpu/serve/batching.py``.

A queue per wrapped function (or per instance, for a method) and a
flusher thread: a batch leaves on ``max_batch_size`` callers or after
``batch_wait_timeout_s``. Entries whose request deadline passed while
queued are failed out at the flush. Every flush observes the three batch
histograms (``serve_batch_size``, ``serve_batch_fill_ratio``,
``serve_batch_wait_seconds``) and records a ``batch.wait`` span for each
traced caller.

**Bucketed padding** (``pad_to_bucket=True``): the flusher pads each
batch up to the next bucket (powers of two by default) by repeating the
last item, runs the handler on it and truncates the results, so the
handler only ever sees ``len(buckets)`` distinct batch sizes: one
compiled shape, cuDNN plan or CUDA graph per bucket.

**Streaming batches** (``stream=True``): the handler is a generator
taking ``List[T]`` and yielding per-batch slices (one element per
batched caller), and each caller's call returns an iterator of its own
elements::

    @batch(max_batch_size=4, stream=True)
    def decode_batch(self, requests):        # one fused decode loop
        for chunk in self._decode_chunks(requests):
            yield chunk                       # List[per-caller slice]

**Continuous batching** (``continuous=True``): no queue forms; the
handler maps each request to ``(engine, submit_kwargs)`` and the
wrapper submits it to the :class:`~ray_tpu_torch.serve.engine.DecodeEngine`
slot pool, forwarding the request's deadline, trace context,
``resume_from`` and handoff hop (:mod:`~ray_tpu_torch.serve.request`).
"""
from __future__ import annotations

import concurrent.futures
import functools
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..util import tracing
from .request import (RequestDeadlineExceeded, deadline_expired,
                      get_request_deadline, get_request_deployment,
                      get_request_handoff, get_request_resume_from)


def default_buckets(max_batch_size: int) -> List[int]:
    """Powers of two up to (and including) max_batch_size."""
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return sorted(set(out))


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


#: end-of-stream marker on the per-caller queues of a streaming batch
_STREAM_END = object()


class _StreamLane:
    """One caller's lane of a streaming batch or of an engine stream: an
    unbounded queue of ``("item", x)``, ``("err", exc)`` or
    ``(_STREAM_END, None)`` events, plus a closed flag the consumer sets
    on abandonment, so the producer stops feeding (and, once every lane
    closes, stops computing) chunks nobody will read."""

    __slots__ = ("q", "closed")

    def __init__(self):
        self.q = queue.SimpleQueue()
        self.closed = False


class _BatchQueue:
    """One pending-request queue + flusher thread per wrapped function."""

    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float,
                 pad: bool, buckets: Optional[Sequence[int]],
                 stream: bool = False):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self.pad = pad
        self.stream = stream
        self.buckets = sorted(buckets) if buckets else \
            default_buckets(max_batch_size)
        self.q: "queue.Queue" = queue.Queue()
        self.batch_sizes: List[int] = []  # observed (pre-pad) sizes
        self._thread = threading.Thread(
            target=self._flusher, daemon=True, name="rt-serve-batch")
        self._thread.start()

    def submit(self, item,
               deadline_s: Optional[float] = None,
               trace_ctx: Optional[dict] = None,
               deployment: str = "") -> "concurrent.futures.Future":
        """Enqueue one caller's item. ``trace_ctx``/``deployment`` are
        the caller's request identity, captured at the wrapper (the
        flusher thread has no request context of its own): the flush
        records a ``batch.wait`` span per entry and labels the batch
        histograms by deployment."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        self.q.put((item, fut, deadline_s, trace_ctx, time.time(),
                    deployment))
        return fut

    def _flusher(self):
        while True:
            entry = self.q.get()
            batch = [entry]
            deadline = time.monotonic() + self.timeout_s
            while len(batch) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            self._run_batch(batch)

    def _drop_expired(self, batch):
        """Flush-time expiry sweep: entries whose request deadline passed
        while queued are failed out of the batch instead of padding it,
        so the device never computes answers nobody waits for. Returns
        the live entries."""
        from .._private.metrics import serve_metrics

        live = []
        for entry in batch:
            item, fut, dl = entry[0], entry[1], entry[2]
            if deadline_expired(dl):
                if not fut.done():
                    fut.set_exception(RequestDeadlineExceeded(
                        "request expired while queued for batching"))
                serve_metrics()["requests_expired"].inc(
                    labels={"where": "batcher",
                            "deployment": entry[5] or ""})
            else:
                live.append(entry)
        return live

    def _observe_flush(self, batch):
        """Batch-shape histograms + one ``batch.wait`` stage span per
        traced entry, recorded at flush time (the stage ends when the
        batch leaves the queue for the handler)."""
        from .._private.metrics import serve_metrics

        sm = serve_metrics()
        flush_t = time.time()
        n = len(batch)
        labels = {"deployment": batch[0][5] or ""}
        sm["batch_size"].observe(n, labels=labels)
        sm["batch_fill_ratio"].observe(n / max(self.max_batch_size, 1),
                                       labels=labels)
        for _item, _fut, _dl, tctx, enq_t, dep in batch:
            sm["batch_wait"].observe(max(flush_t - enq_t, 0.0),
                                     labels={"deployment": dep or ""})
            if tctx is not None:
                tracing.record_span("batch.wait", enq_t, flush_t,
                                    parent_ctx=tctx, batch_size=n,
                                    deployment=dep or "")

    def _run_batch(self, batch):
        batch = self._drop_expired(batch)
        if not batch:
            return  # every caller's deadline passed: skip the dispatch
        self._observe_flush(batch)
        items = [b[0] for b in batch]
        futs = [b[1] for b in batch]
        # The first traced caller's context parents the handler's spans
        # (the flusher thread has no context).
        lead_ctx = next((b[3] for b in batch if b[3] is not None), None)
        self.batch_sizes.append(len(items))
        n = len(items)
        if self.pad:
            target = pad_to_bucket(n, self.buckets)
            items = items + [items[-1]] * (target - n)
        if self.stream:
            # A thread per streaming batch: the flusher goes straight
            # back to collecting the next batch, so back-to-back batches
            # of streams overlap instead of queueing behind one long
            # generation. The handler must tolerate concurrent calls.
            threading.Thread(
                target=self._run_batch_stream,
                args=(items, futs, n, lead_ctx),
                daemon=True, name="rt-serve-batch-stream").start()
            return
        try:
            with tracing.activate_context(lead_ctx):
                results = self.fn(items)
            if results is None or len(results) < n:
                raise ValueError(
                    f"batch handler returned {0 if results is None else len(results)} "
                    f"results for {n} requests")
            for fut, r in zip(futs, results[:n]):
                fut.set_result(r)
        except Exception as e:  # noqa: BLE001 - fan the error out per caller
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)

    def _run_batch_stream(self, items, futs, n, lead_ctx=None):
        """Streaming flush (on its own thread, one per batch): the
        handler yields per-batch slices; element i of every slice goes
        to caller i's lane, so all callers stream off one handler call,
        driven until exhaustion or until every lane is abandoned. Closed
        lanes stop receiving chunks."""
        lanes = [_StreamLane() for _ in range(n)]
        for fut, lane in zip(futs, lanes):
            fut.set_result(lane)
        try:
            # The lead caller's trace context stays active for the whole
            # drive loop: every resume of the handler generator runs on
            # this thread, and its spans must join the request's trace.
            with tracing.activate_context(lead_ctx):
                gen = self.fn(items)
                try:
                    for slice_ in gen:
                        if all(lane.closed for lane in lanes):
                            break  # every consumer left; stop computing
                        if slice_ is None or len(slice_) < n:
                            raise ValueError(
                                f"streaming batch handler yielded "
                                f"{0 if slice_ is None else len(slice_)} "
                                f"results for {n} requests")
                        for lane, r in zip(lanes, list(slice_)[:n]):
                            if not lane.closed:
                                lane.q.put(("item", r))
                finally:
                    if hasattr(gen, "close"):
                        gen.close()  # run the handler's cleanup
            for lane in lanes:
                lane.q.put((_STREAM_END, None))
        except Exception as e:  # noqa: BLE001 - fan out per caller
            for lane in lanes:
                lane.q.put(("err", e))


# Queues live here or on the instance, not in decorator closures, so a
# decorated class stays picklable (locks and running threads are not).
_REGISTRY: dict = {}
_REG_LOCK = threading.Lock()


def _queue_for(self_obj, key, fn, cfg) -> _BatchQueue:
    max_bs, wait_s, pad, buckets, stream = cfg
    if self_obj is not None:
        attr = f"__rt_batch_queue_{fn.__name__}"
        bq = self_obj.__dict__.get(attr)
        if bq is None:
            with _REG_LOCK:
                bq = self_obj.__dict__.get(attr)
                if bq is None:
                    bq = _BatchQueue(lambda items: fn(self_obj, items),
                                     max_bs, wait_s, pad, buckets, stream)
                    object.__setattr__(self_obj, attr, bq)
        return bq
    with _REG_LOCK:
        bq = _REGISTRY.get(key)
        if bq is None:
            bq = _REGISTRY[key] = _BatchQueue(fn, max_bs, wait_s, pad,
                                              buckets, stream)
    return bq


def _drain_stream(lane: _StreamLane):
    """Caller-side iterator over one lane. Marks the lane closed on exit
    (exhaustion, error, or abandonment), so the producer stops feeding
    it."""
    try:
        while True:
            kind, val = lane.q.get()
            if kind is _STREAM_END:
                return
            if kind == "err":
                raise val
            yield val
    finally:
        lane.closed = True


class _EngineStream:
    """Iterator over one engine lane. A class, not a generator, so it can
    carry ``__rt_engine_stream__`` (a serving layer reads that marker to
    leave per-chunk spans to the engine, whose ``decode.chunk`` spans
    carry dispatch timing) and so ``close()`` marks the lane abandoned
    even before the first pull (closing an unstarted generator skips its
    ``finally``)."""

    __rt_engine_stream__ = True

    def __init__(self, lane: _StreamLane):
        self._lane = lane
        self._it = _drain_stream(lane)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def poll(self):
        """Non-blocking pull of one event: ``("item", chunk)``,
        ``("end", None)``, or None when nothing is queued; a failed
        stream raises its error. For a consumer that drains many streams
        from one thread (``ray_tpu_torch/data/llm.py``). Do not mix with
        iteration on the same stream."""
        try:
            kind, val = self._lane.q.get_nowait()
        except queue.Empty:
            return None
        if kind is _STREAM_END:
            return ("end", None)
        if kind == "err":
            raise val
        return ("item", val)

    def close(self):
        self._lane.closed = True
        self._it.close()


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01, pad_to_bucket: bool = False,
          buckets: Optional[Sequence[int]] = None, stream: bool = False,
          continuous: bool = False, page_size: Optional[int] = None,
          prefix_cache: Optional[bool] = None, spec_decode=None,
          draft_k: Optional[int] = None,
          spec_threshold: Optional[float] = None,
          attn_kernel: Optional[str] = None,
          kv_dtype: Optional[str] = None):
    """Decorator: turn a ``List[T] -> List[R]`` handler into a ``T -> R``
    callable that batches concurrent callers.

    Usage (on a method)::

        @batch(max_batch_size=16, batch_wait_timeout_s=0.005,
               pad_to_bucket=True)
        def predict_batch(self, inputs):      # inputs: List[np.ndarray]
            return self._predict(np.stack(inputs))   # bucket sizes only

        def __call__(self, request):
            return self.predict_batch(request)

    With ``stream=True`` the handler is a generator yielding per-batch
    slices and each call returns an iterator of that caller's elements.

    With ``continuous=True`` the handler is called once per request and
    returns ``(engine, submit_kwargs)``; the wrapper forwards the
    request's deadline and trace context into ``engine.submit`` and
    returns the request's own chunk-slice stream::

        @batch(continuous=True)
        def decode(self, request):
            return self.engine, {"prompt": request["prompt"],
                                 "max_new": request["max_new"]}

    ``page_size=`` / ``prefix_cache=`` / ``attn_kernel=`` /
    ``kv_dtype=`` / ``spec_decode=`` / ``draft_k=`` /
    ``spec_threshold=`` (continuous only) are pushed into the handler's
    engine with :meth:`~ray_tpu_torch.serve.engine.DecodeEngine.apply_config`
    on its first use (a matching engine just validates).
    """
    if continuous and (stream or pad_to_bucket or buckets is not None):
        raise ValueError(
            "continuous=True replaces the flusher with an engine slot "
            "pool; stream/pad_to_bucket/buckets do not apply")
    if not continuous and (page_size is not None
                           or prefix_cache is not None
                           or spec_decode is not None
                           or draft_k is not None
                           or spec_threshold is not None
                           or attn_kernel is not None
                           or kv_dtype is not None):
        raise ValueError(
            "page_size/prefix_cache/spec_decode/draft_k/spec_threshold/"
            "attn_kernel/kv_dtype are decode-engine knobs; they "
            "require continuous=True")
    if buckets is not None:
        bs = sorted(int(b) for b in buckets)
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got "
                             f"{list(buckets)}")
        if bs[-1] < max_batch_size:
            # Otherwise pad_to_bucket returns buckets[-1] for a full
            # batch and the "pad" is a negative-count no-op: the handler
            # would see unpadded sizes.
            raise ValueError(
                f"buckets {list(buckets)} do not cover "
                f"max_batch_size={max_batch_size}; add a bucket >= "
                f"{max_batch_size} (a full batch cannot be padded DOWN "
                f"to {bs[-1]})")

    def decorate(fn):
        is_method = _looks_like_method(fn)
        if continuous:
            return _decorate_continuous(fn, page_size, prefix_cache,
                                        spec_decode, draft_k,
                                        spec_threshold, attn_kernel,
                                        kv_dtype)
        cfg = (max_batch_size, batch_wait_timeout_s, pad_to_bucket,
               tuple(buckets) if buckets else None, stream)
        key = (getattr(fn, "__module__", ""), getattr(fn, "__qualname__", ""))

        @functools.wraps(fn)
        def wrapper(*args):
            import ray_tpu_torch.serve.batching as _mod

            if is_method:
                self_obj, item = args
            else:
                self_obj, (item,) = None, args
            # The caller's request deadline (queued entries are dropped
            # at flush once nobody waits for them), trace context and
            # deployment, captured here: the flusher thread that records
            # the batch.wait stage has no request context of its own.
            out = _mod._queue_for(self_obj, key, fn, cfg).submit(
                item, deadline_s=get_request_deadline(),
                trace_ctx=tracing.current_context(),
                deployment=get_request_deployment() or "").result()
            return _drain_stream(out) if stream else out

        wrapper.__rt_is_batched__ = True
        return wrapper

    if _fn is not None and callable(_fn):
        return decorate(_fn)
    return decorate


def _decorate_continuous(fn, page_size: Optional[int] = None,
                         prefix_cache: Optional[bool] = None,
                         spec_decode=None, draft_k: Optional[int] = None,
                         spec_threshold: Optional[float] = None,
                         attn_kernel: Optional[str] = None,
                         kv_dtype: Optional[str] = None):
    """Engine-backed admission: per request, the handler maps the item
    to ``(engine, submit_kwargs)`` and the wrapper feeds the engine's
    admission queue with the request's deadline (the engine drops it
    unstarted or frees its slot mid-generation) and trace context (the
    engine's ``engine.admission`` and ``decode.chunk`` spans join the
    request's trace). Decorator-level engine knobs go to ``apply_config``
    the first time each engine passes through."""

    import weakref

    configured: "weakref.WeakSet" = weakref.WeakSet()

    @functools.wraps(fn)
    def wrapper(*args):
        out = fn(*args)
        try:
            engine, kw = out
            kw = dict(kw)
        except (TypeError, ValueError):
            raise TypeError(
                f"@batch(continuous=True) handler "
                f"{fn.__qualname__} must return (engine, submit_kwargs),"
                f" got {type(out).__name__}") from None
        if (page_size is not None or prefix_cache is not None
                or spec_decode is not None or draft_k is not None
                or spec_threshold is not None
                or attn_kernel is not None or kv_dtype is not None) \
                and engine not in configured:
            engine.apply_config(page_size=page_size,
                                prefix_cache=prefix_cache,
                                spec_decode=spec_decode,
                                draft_k=draft_k,
                                spec_threshold=spec_threshold,
                                attn_kernel=attn_kernel,
                                kv_dtype=kv_dtype)
            configured.add(engine)
        # Disaggregated dispatch: the prefill hop answers with a leased
        # handoff descriptor, the decode hop imports one instead of
        # prefilling. The handler's kwargs stay authoritative for what
        # to generate; the hop marker only picks the entry point.
        hop = get_request_handoff()
        if hop == "export":
            return engine.handoff(
                kw["prompt"], kw["max_new"],
                seed=int(kw.get("seed", 0)),
                deadline_s=get_request_deadline(),
                trace_ctx=tracing.current_context())
        if isinstance(hop, dict):
            lane = engine.admit_prefilled(
                hop, deadline_s=get_request_deadline(),
                trace_ctx=tracing.current_context(),
                resume_from=get_request_resume_from())
            return _EngineStream(lane)
        # Mid-stream failover replay: a resumed request replays the same
        # deterministic generation with the delivered prefix suppressed.
        kw.setdefault("resume_from", get_request_resume_from())
        lane = engine.submit(deadline_s=get_request_deadline(),
                             trace_ctx=tracing.current_context(), **kw)
        return _EngineStream(lane)

    wrapper.__rt_is_batched__ = True
    wrapper.__rt_continuous__ = True
    return wrapper


def _looks_like_method(fn) -> bool:
    import inspect

    params = list(inspect.signature(fn).parameters)
    return bool(params) and params[0] == "self"
