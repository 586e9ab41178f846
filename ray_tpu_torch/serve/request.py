"""The request vocabulary of the serving path: absolute deadlines, the
typed overload and expiry errors, the request-scoped context a serving
layer sets around user code, the wire keys that carry it, and the
picklable HTTP request/response snapshot handed to ingress code.

The port's copy of ``ray_tpu/serve/request.py``. The reference bases its
errors on ``ray_tpu.exceptions.RayTpuError``; the port imports nothing of
the JAX package, so they share :class:`ServeError` here instead.

Deadlines are **absolute wall-clock timestamps** (``time.time()``), like
gRPC deadlines: a request is stamped once at the edge and every
downstream hop (the batcher's flush, the engine's admission and each of
its chunk boundaries) compares against the same instant instead of
restarting its own timeout window. Wall-clock, not monotonic, because
the stamp may cross process boundaries.

The context variables are set by whatever serves the request (the
reference's replica) around the code that calls a ``@batch`` wrapper or
an engine: the wrapper forwards the deadline, the resume count and the
handoff hop into :class:`~ray_tpu_torch.serve.engine.DecodeEngine`, the
engine stamps its flight-recorder events with the request id, and the
batcher labels its histograms and spans with the deployment.
"""
from __future__ import annotations

import contextvars
import json as _json
import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional
from urllib.parse import parse_qsl, urlsplit


class ServeError(Exception):
    """Base of the serving path's typed errors (the reference's
    ``RayTpuError``)."""


class RequestDeadlineExceeded(ServeError, TimeoutError):
    """The request's absolute deadline passed before (or while) it could
    be answered. Never retried: nobody is waiting."""


class ReplicaOverloadedError(ServeError):
    """Typed replica pushback: the replica is at ``max_ongoing_requests``.

    A router re-picks another replica instead of marking this one dead:
    overload is a routing signal, not a failure."""

    #: Routing signal, not a failure (as ``ReplicaDrainingError``,
    #: ``EngineShutdownError`` and ``EngineRestartError``).
    retryable = True


class ReplicaDrainingError(ServeError):
    """Typed drain pushback: the replica stopped admitting because it is
    being torn down. Like overload, a routing signal."""

    retryable = True


class BackPressureError(ServeError):
    """Every replica is saturated and the pending queue is past its
    bound; the request was shed instead of queued (HTTP ``503`` with
    ``Retry-After``). ``retry_after_s`` is the server's backoff hint."""

    def __init__(self, message: str = "deployment is overloaded",
                 retry_after_s: float = 1.0):
        self.retry_after_s = retry_after_s
        super().__init__(message)

    def __reduce__(self):
        return (BackPressureError, (str(self.args[0] if self.args else ""),
                                    self.retry_after_s))


def make_deadline(timeout_s: Optional[float]) -> Optional[float]:
    """Absolute wall-clock deadline for a fresh request (None = no limit)."""
    return None if timeout_s is None else _time.time() + timeout_s


def remaining_s(deadline_s: Optional[float]) -> Optional[float]:
    """Seconds until the deadline (may be <= 0); None = unbounded."""
    return None if deadline_s is None else deadline_s - _time.time()


def deadline_expired(deadline_s: Optional[float]) -> bool:
    return deadline_s is not None and _time.time() > deadline_s


#: Per-request deadline, set around user code so nested work (the
#: batcher, the engine) inherits the caller's deadline without threading
#: it through user signatures.
_request_deadline: "contextvars.ContextVar[Optional[float]]" = \
    contextvars.ContextVar("rt_serve_request_deadline", default=None)


def get_request_deadline() -> Optional[float]:
    """Absolute deadline of the request being handled on this thread
    (None outside a deadline-stamped request)."""
    return _request_deadline.get()


#: Name of the deployment handling the current request. Layers with no
#: deployment identity of their own (the ``@batch`` flusher above all)
#: read it to label their histograms and spans.
_request_deployment: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("rt_serve_request_deployment", default=None)


def get_request_deployment() -> Optional[str]:
    """Deployment name of the request being handled on this thread
    (None outside a request scope)."""
    return _request_deployment.get()


#: Wire trace context of the request's submission
#: (``{"trace_id", "span_id"}``), so stage spans recorded on other
#: threads (the batcher's, the engine's) join the request's trace.
TRACE_CTX_KEY = "trace_ctx"
SUBMITTED_AT_KEY = "submitted_at"
#: Mid-stream failover replay token (tokens the caller already holds): a
#: resumed stream re-executes the same deterministic call and the
#: serving side suppresses the first ``resume_from`` tokens.
RESUME_FROM_KEY = "resume_from"
#: Request correlation id, stamped once when the logical request is born
#: and re-sent on every retry, resume and disaggregated hop: the join key
#: of the flight recorder's events.
REQUEST_ID_KEY = "rt_request_id"
#: Disaggregated prefill/decode hop marker: the string ``"export"`` on
#: the prefill hop (the continuous-batching wrapper answers with a
#: handoff descriptor instead of a stream), or the descriptor dict on
#: the decode hop (the wrapper imports it with
#: ``engine.admit_prefilled`` instead of prefilling).
HANDOFF_KEY = "handoff"


#: Tokens already delivered to the caller of the request being handled
#: on this thread (0 for a fresh stream); the continuous-batching
#: wrapper forwards it as ``DecodeEngine.submit(resume_from=...)``.
_request_resume_from: "contextvars.ContextVar[int]" = \
    contextvars.ContextVar("rt_serve_request_resume_from", default=0)


def get_request_resume_from() -> int:
    """Delivered-token count of the stream being resumed on this thread
    (0 outside a resumed stream)."""
    return _request_resume_from.get()


#: Handoff hop of the request being handled on this thread: None (plain
#: colocated request), ``"export"`` (prefill hop) or the handoff
#: descriptor dict (decode hop); see :data:`HANDOFF_KEY`.
_request_handoff: "contextvars.ContextVar[Any]" = \
    contextvars.ContextVar("rt_serve_request_handoff", default=None)


def get_request_handoff() -> Any:
    """The current request's handoff hop marker; None outside a
    disaggregated dispatch."""
    return _request_handoff.get()


#: Correlation id of the request being handled on this thread; the
#: engine stamps it on the request's flight-recorder events and mints a
#: local ``eng-<pid hex>-<n>`` id when none is set.
_request_id: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("rt_serve_request_id", default=None)


def get_request_id() -> Optional[str]:
    """Correlation id of the request being handled on this thread (None
    outside a request scope)."""
    return _request_id.get()


def stream_item_width(item) -> int:
    """Tokens carried by one stream item: a list/tuple chunk slice its
    length, an array slice its element count (a ``[B, j]`` slice is B*j
    tokens, where ``len()`` would say B), anything else 1.

    The one definition behind the replay token: the caller counts
    delivered tokens with it and the serving side suppresses that many
    on resume, so the two must never classify an item differently."""
    if isinstance(item, (list, tuple)):
        return len(item)
    if getattr(item, "ndim", 0):
        return int(getattr(item, "size", 1))
    return 1


@dataclass
class Request:
    method: str = "GET"
    path: str = "/"
    query_params: Dict[str, str] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def json(self) -> Any:
        return _json.loads(self.body or b"null")

    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")

    @classmethod
    def from_target(cls, method: str, target: str, headers: Dict[str, str],
                    body: bytes) -> "Request":
        parts = urlsplit(target)
        return cls(method=method, path=parts.path,
                   query_params=dict(parse_qsl(parts.query)),
                   headers=headers, body=body)


@dataclass
class Response:
    """Optional rich response; plain return values are auto-encoded."""

    body: Any = b""
    status: int = 200
    content_type: Optional[str] = None

    def encode(self):
        ctype, body = encode_body(self.body)
        return self.status, self.content_type or ctype, body


def encode_body(value: Any):
    """Encode a handler return value to (content_type, bytes)."""
    if isinstance(value, Response):
        _, ctype, body = value.encode()
        return ctype, body
    if isinstance(value, bytes):
        return "application/octet-stream", value
    if isinstance(value, str):
        return "text/plain; charset=utf-8", value.encode()
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            value = value.tolist()
        elif isinstance(value, np.generic):
            value = value.item()
    except Exception:  # noqa: BLE001
        pass
    return "application/json", _json.dumps(value).encode()
