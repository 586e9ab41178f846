"""Trace spans: the port's copy of ``ray_tpu/util/tracing.py``.

A span is a dict with the reference's keys (``name``, ``kind``,
``trace_id``, ``span_id``, ``parent_id``, ``start``, ``end``, ``status``
and, when it has any, ``attrs``); ``start``/``end`` are ``time.time()``
stamps. A context is ``{"trace_id", "span_id"}``: it rides a runtime
task's wire meta (``trace_ctx`` on the spec, :func:`on_submit` at
submission, :func:`execute_span` around the user code in the worker) and
a request across a thread hop (``trace_ctx`` on
:meth:`~ray_tpu_torch.serve.engine.DecodeEngine.submit`). Finished spans
wait in a bounded per-process buffer; a span evicted at capacity is
counted (:func:`dropped_total`, the ``tracing_spans_dropped_total``
counter) instead of lost silently. Workers flush the buffer to the head
with their task events; :func:`get_spans` reads the head's store, and the
head folds spans into the chrome-trace timeline.

Standard library only. Usage::

    import ray_tpu_torch as rt
    from ray_tpu_torch.util import tracing

    rt.init()
    tracing.enable()
    with tracing.span("my-request", user="alice"):
        ref = my_task.remote()          # submit span, child of my-request
        rt.get(ref)                     # the worker executes under it
    spans = tracing.get_spans()         # cluster-wide, from the head
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Union

# (trace_id, span_id) of the active span in this thread/coroutine.
_current: contextvars.ContextVar = contextvars.ContextVar(
    "rt_trace_ctx", default=None)

_enabled = os.environ.get("RT_TRACING_ENABLED", "").lower() in (
    "1", "true", "yes", "on")
# Finished spans waiting for a flush to the head.
_buffer: deque = deque(maxlen=100_000)
# Spans evicted at capacity (the deque drops silently; a trace missing
# its middle is worse than an honest drop count). Guarded by _drop_lock;
# reported to the head with every span flush and surfaced through
# ``get_spans(with_meta=True)`` and the
# ``tracing_spans_dropped_total`` counter.
_dropped = 0
_drop_lock = threading.Lock()


def enable() -> None:
    """Turn on span recording in THIS process. Remote workers switch on
    lazily: any task submitted while tracing is enabled carries a
    ``trace_ctx``, and executing a traced task records spans regardless
    of the worker-local flag (the decision belongs to the submitter,
    like the reference's driver-side ``_tracing_startup_hook``).

    Serve proxies mirror the driver's flag on the next
    ``serve.start()``/``serve.run()`` call (or set ``RT_TRACING_ENABLED=1``
    cluster-wide to trace every process from boot)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def current_context() -> Optional[Dict[str, str]]:
    cur = _current.get()
    if cur is None:
        return None
    return {"trace_id": cur[0], "span_id": cur[1]}


def _record(name: str, kind: str, trace_id: str, span_id: str,
            parent_id: Optional[str], start: float, end: float,
            attrs: Optional[Dict[str, Any]], status: str = "ok") -> dict:
    span = {
        "name": name, "kind": kind,
        "trace_id": trace_id, "span_id": span_id, "parent_id": parent_id,
        "start": start, "end": end, "status": status,
    }
    if attrs:
        span["attrs"] = attrs
    if len(_buffer) >= (_buffer.maxlen or 0) > 0:
        _note_dropped(1)  # append below evicts the oldest span silently
    _buffer.append(span)
    return span


_drop_counter = None


def _note_dropped(n: int) -> None:
    global _dropped, _drop_counter
    if n <= 0:
        return
    with _drop_lock:
        _dropped += n
        # Lazy init under the same lock: a racing double-create would
        # register two instruments and lose one side's increments.
        if _drop_counter is None:
            try:
                from .._private.metrics import Counter

                _drop_counter = Counter(
                    "tracing_spans_dropped_total",
                    "Finished spans evicted from the per-process buffer "
                    "at capacity before a flush")
            except Exception:  # noqa: BLE001 - never break tracing
                return
    try:
        _drop_counter.inc(n)
    except Exception:  # noqa: BLE001 - accounting must never break tracing
        pass


def take_dropped() -> int:
    """Drop count since the last take (shipped with each span flush)."""
    global _dropped
    with _drop_lock:
        n, _dropped = _dropped, 0
        return n


def add_dropped(n: int) -> None:
    """Return an unshipped drop count after a failed flush (the head
    never saw it, so it must ride the next report)."""
    global _dropped
    if n > 0:
        with _drop_lock:
            _dropped += n


def dropped_total() -> int:
    """Drops counted in this process and not yet reported to the head."""
    with _drop_lock:
        return _dropped


@contextlib.contextmanager
def span(name: str, kind: str = "internal", **attrs):
    """Record a span; nested ``span()``/task submissions become children.

    No-op (yields None) when tracing is disabled, so library code may
    instrument unconditionally. Inside a traced task the propagated
    context is active even though the worker never called ``enable()``
    — user spans there must record, so the context check comes first.
    """
    parent = _current.get()
    if parent is None and not _enabled:
        yield None
        return
    trace_id = parent[0] if parent else _new_id(16)
    span_id = _new_id(8)
    token = _current.set((trace_id, span_id))
    start = time.time()
    status = "ok"
    try:
        yield {"trace_id": trace_id, "span_id": span_id}
    except BaseException:
        status = "error"
        raise
    finally:
        _current.reset(token)
        _record(name, kind, trace_id, span_id,
                parent[1] if parent else None, start, time.time(),
                attrs or None, status)


class ManualSpan:
    """Span whose lifetime crosses threads (streaming responses: opened
    where the stream is submitted, finished wherever it ends). The
    contextvar window for parenting child submissions is explicit
    (:meth:`activate`), so no token is ever reset on a foreign thread.
    """

    def __init__(self, name: str, kind: str, parent, attrs):
        self.name = name
        self.kind = kind
        self.trace_id = parent[0] if parent else _new_id(16)
        self.span_id = _new_id(8)
        self._parent_id = parent[1] if parent else None
        self._attrs = attrs or None
        self._start = time.time()
        self._done = False

    @contextlib.contextmanager
    def activate(self):
        token = _current.set((self.trace_id, self.span_id))
        try:
            yield self
        finally:
            _current.reset(token)

    def finish(self, status: str = "ok") -> None:
        if self._done:
            return
        self._done = True
        _record(self.name, self.kind, self.trace_id, self.span_id,
                self._parent_id, self._start, time.time(), self._attrs,
                status)


def manual_span(name: str, kind: str = "internal",
                **attrs) -> Optional[ManualSpan]:
    """Open a :class:`ManualSpan`, or None when tracing is off (callers
    guard their ``activate``/``finish`` with that)."""
    parent = _current.get()
    if parent is None and not _enabled:
        return None
    return ManualSpan(name, kind, parent, attrs)


def record_span(name: str, start: float, end: Optional[float] = None,
                kind: str = "stage",
                parent_ctx: Optional[Dict[str, str]] = None,
                status: str = "ok", **attrs) -> Optional[dict]:
    """Record an already-measured span (start/end are wall-clock
    ``time.time()`` stamps) without touching the active context.

    The serve data plane uses this for stage timings whose lifetime does
    not match any ``with`` block: queue waits measured across a process
    hop (``replica.queue_wait`` starts at the router's submission stamp),
    batcher flush waits recorded on the flusher thread, and per-chunk
    decode dispatches. Parents under ``parent_ctx`` (a wire context dict)
    when given, else the caller's active span; no-op when neither exists
    and tracing is off."""
    parent = None
    if parent_ctx is not None:
        parent = (parent_ctx["trace_id"], parent_ctx["span_id"])
    else:
        parent = _current.get()
    if parent is None and not _enabled:
        return None
    trace_id = parent[0] if parent else _new_id(16)
    return _record(name, kind, trace_id, _new_id(8),
                   parent[1] if parent else None, start,
                   time.time() if end is None else end,
                   attrs or None, status)


@contextlib.contextmanager
def activate_context(ctx: Optional[Dict[str, str]]):
    """Make a wire context (``{"trace_id", "span_id"}``) the active span
    on this thread for the duration of the block, so spans recorded and
    tasks submitted inside parent under it. Used where a request crosses
    an untraced thread hop — e.g. the batcher invoking the user handler
    on its flusher thread. No-op for ``ctx=None``."""
    if ctx is None:
        yield None
        return
    token = _current.set((ctx["trace_id"], ctx["span_id"]))
    try:
        yield ctx
    finally:
        _current.reset(token)


def on_submit(name: str) -> Optional[Dict[str, str]]:
    """Called by the core worker at task/actor-call submission. Records a
    point-in-time submit span (child of the caller's active span) and
    returns the wire context the execute side parents under, or None when
    tracing is off (the common case — one branch on the hot path).

    A worker submitting from inside a traced task has an active context
    (execute_span set it) even though its local flag is off — the chain
    must continue across hops, so the context check comes first."""
    parent = _current.get()
    if parent is None and not _enabled:
        return None
    trace_id = parent[0] if parent else _new_id(16)
    span_id = _new_id(8)
    now = time.time()
    _record(f"submit {name}", "submit", trace_id, span_id,
            parent[1] if parent else None, now, now, None)
    return {"trace_id": trace_id, "span_id": span_id}


@contextlib.contextmanager
def execute_span(meta: dict, name: str):
    """Worker-side child span around user-code execution of a traced task.

    Pulls the propagated context from the task wire meta; a task with no
    ``trace_ctx`` (tracing off at the submitter) costs one dict lookup.
    """
    ctx = meta.get("trace_ctx")
    if ctx is None:
        yield None
        return
    trace_id = ctx["trace_id"]
    span_id = _new_id(8)
    token = _current.set((trace_id, span_id))
    start = time.time()
    status = "ok"
    try:
        yield {"trace_id": trace_id, "span_id": span_id}
    except BaseException:
        status = "error"
        raise
    finally:
        _current.reset(token)
        _record(f"execute {name}", "execute", trace_id, span_id,
                ctx.get("span_id"), start, time.time(), None, status)


def drain() -> List[dict]:
    """Hand off buffered finished spans (called by the flush loop).
    Pops item-wise: a span appended concurrently by an executor thread
    either makes this drain or stays for the next one — a snapshot +
    clear() would silently drop it."""
    out: List[dict] = []
    while True:
        try:
            out.append(_buffer.popleft())
        except IndexError:
            return out


def requeue(spans: List[dict]) -> None:
    """Return drained spans to the buffer after a failed flush (oldest
    first, so a healthy next flush preserves order; the deque bound
    drops the oldest if the head stays unreachable)."""
    if _buffer.maxlen:
        # extendleft on a bounded deque evicts from the RIGHT silently;
        # count what cannot fit so the loss is visible.
        _note_dropped(len(spans) + len(_buffer) - _buffer.maxlen)
    _buffer.extendleft(reversed(spans))


def local_spans() -> List[dict]:
    """Finished spans still buffered in this process (testing hook)."""
    return list(_buffer)


def get_spans(limit: int = 1000,
              with_meta: bool = False) -> Union[List[dict], Dict[str, Any]]:
    """Cluster-wide finished spans, from the head (flushes local first).

    ``with_meta=True`` returns ``{"spans": [...], "dropped_total": N}``
    where ``dropped_total`` counts spans evicted from process buffers at
    capacity cluster-wide — a non-zero value means traces may be missing
    their middles."""
    from ..core.worker import CoreWorker

    core = CoreWorker.current()
    core.flush_task_events()
    out = core.head_call("get_spans",
                         {"limit": limit, "with_meta": with_meta})
    return out
