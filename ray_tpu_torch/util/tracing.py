"""Trace spans: the port's copy of the parts of ``ray_tpu/util/tracing.py``
that the serving engine and the request batcher record with.

A span is a dict with the reference's keys (``name``, ``kind``,
``trace_id``, ``span_id``, ``parent_id``, ``start``, ``end``, ``status``
and, when it has any, ``attrs``); ``start``/``end`` are ``time.time()``
stamps. A context is ``{"trace_id", "span_id"}``, the form a request
carries across a thread hop (``trace_ctx`` on
:meth:`~ray_tpu_torch.serve.engine.DecodeEngine.submit`). Finished spans
wait in a bounded per-process buffer; a span evicted at capacity is
counted (:func:`dropped_total`, the port's
``tracing_spans_dropped_total`` counter) instead of lost silently.

Standard library only. The reference's ``on_submit``, ``execute_span``,
``get_spans`` and ``ManualSpan``/``manual_span`` stand on the runtime's
core worker and head (task submission, the wire meta, the head's span
store) and are not copied: :func:`drain` hands the buffer to whatever
exports it.

Usage::

    from ray_tpu_torch.util import tracing

    tracing.enable()
    with tracing.span("request"):
        lane = engine.submit(prompt, 32,
                             trace_ctx=tracing.current_context())
    spans = tracing.drain()     # engine.admission, decode.chunk, request
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# (trace_id, span_id) of the active span in this thread/coroutine.
_current: contextvars.ContextVar = contextvars.ContextVar(
    "rt_trace_ctx", default=None)

_enabled = os.environ.get("RT_TRACING_ENABLED", "").lower() in (
    "1", "true", "yes", "on")
# Finished spans waiting for a drain.
_buffer: deque = deque(maxlen=100_000)
# Spans evicted at capacity (the deque drops silently; a trace missing
# its middle is worse than an honest drop count). Guarded by _drop_lock.
_dropped = 0
_drop_lock = threading.Lock()


def enable() -> None:
    """Turn on span recording in this process. A span recorded under a
    propagated context records whatever the flag says: the decision
    belongs to whoever opened the trace."""
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
    """Drop count since the last take (shipped with each span export)."""
    global _dropped
    with _drop_lock:
        n, _dropped = _dropped, 0
        return n


def add_dropped(n: int) -> None:
    """Return an unshipped drop count after a failed export, so it rides
    the next one."""
    global _dropped
    if n > 0:
        with _drop_lock:
            _dropped += n


def dropped_total() -> int:
    """Drops counted in this process and not yet taken."""
    with _drop_lock:
        return _dropped


@contextlib.contextmanager
def span(name: str, kind: str = "internal", **attrs):
    """Record a span; spans opened or recorded inside become children.

    No-op (yields None) when tracing is disabled and no context is
    active, so library code may instrument unconditionally; under a
    propagated context it records, so the context check comes first."""
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


def record_span(name: str, start: float, end: Optional[float] = None,
                kind: str = "stage",
                parent_ctx: Optional[Dict[str, str]] = None,
                status: str = "ok", **attrs) -> Optional[dict]:
    """Record an already-measured span (``time.time()`` stamps) without
    touching the active context: the batcher's queue waits, recorded on
    its flusher thread, and the engine's admissions and decode
    dispatches, recorded on its driver thread. Parents under
    ``parent_ctx`` when given, else the caller's active span; no-op when
    neither exists and tracing is off."""
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
    on this thread for the block, so spans recorded inside parent under
    it: where a request crosses an untraced thread hop, as the batcher
    calling the handler on its flusher thread. No-op for ``ctx=None``."""
    if ctx is None:
        yield None
        return
    token = _current.set((ctx["trace_id"], ctx["span_id"]))
    try:
        yield ctx
    finally:
        _current.reset(token)


def drain() -> List[dict]:
    """Hand off the buffered finished spans. Pops item-wise: a span
    appended concurrently either makes this drain or stays for the next
    one (a snapshot + clear() would drop it)."""
    out: List[dict] = []
    while True:
        try:
            out.append(_buffer.popleft())
        except IndexError:
            return out


def requeue(spans: List[dict]) -> None:
    """Return drained spans to the buffer after a failed export (oldest
    first; the bound drops the oldest, counted)."""
    if _buffer.maxlen:
        # extendleft on a bounded deque evicts from the RIGHT silently;
        # count what cannot fit so the loss is visible.
        _note_dropped(len(spans) + len(_buffer) - _buffer.maxlen)
    _buffer.extendleft(reversed(spans))


def local_spans() -> List[dict]:
    """Finished spans still buffered in this process (testing hook)."""
    return list(_buffer)
