"""Stream lanes, prompt buckets and deadlines for the port's engine.

The port's own copy of the pieces of ``ray_tpu/serve/batching.py``
(``default_buckets``, ``_STREAM_END``, ``_StreamLane``, ``_EngineStream``)
and ``ray_tpu/serve/request.py`` (``deadline_expired``,
``RequestDeadlineExceeded``) that the decode engine uses, trimmed to
that use: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import queue
import time
from typing import List, Optional

#: End-of-stream marker on a lane's queue.
_STREAM_END = object()


def default_buckets(max_size: int) -> List[int]:
    """Powers of two up to (and including) ``max_size``."""
    out, b = [], 1
    while b < max_size:
        out.append(b)
        b *= 2
    out.append(max_size)
    return sorted(set(out))


class RequestDeadlineExceeded(TimeoutError):
    """The request's absolute deadline passed before (or while) the
    engine could produce an answer."""


def deadline_expired(deadline_s: Optional[float]) -> bool:
    """``deadline_s`` is an absolute ``time.time()`` stamp (None = no
    limit)."""
    return deadline_s is not None and time.time() > deadline_s


class _StreamLane:
    """One caller's lane: an unbounded queue of ``("item", chunk)``,
    ``("err", exc)`` or ``(_STREAM_END, None)`` events, plus a closed
    flag the consumer sets on abandonment so the engine frees the slot."""

    __slots__ = ("q", "closed")

    def __init__(self):
        self.q = queue.SimpleQueue()
        self.closed = False


def _drain_stream(lane: _StreamLane):
    """Caller-side iterator over one lane; marks the lane closed on exit
    (exhaustion, error, or abandonment)."""
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
    """Iterator over one engine lane. A class, not a generator, so that
    ``close()`` marks the lane abandoned even before the first pull
    (closing an unstarted generator skips its ``finally``)."""

    def __init__(self, lane: _StreamLane):
        self._lane = lane
        self._it = _drain_stream(lane)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self):
        self._lane.closed = True
        self._it.close()
