"""The request context the engine reads: the correlation id of the request
being handled on this thread (``ray_tpu/serve/request.py:175-188``).

A serving layer sets ``_request_id`` around the code that submits to an
engine; the engine stamps that id on the request's flight-recorder
events, and mints a local ``eng-<pid hex>-<n>`` id when none is set. The
deadline helpers live in :mod:`ray_tpu_torch.serve._stream`.
"""
from __future__ import annotations

import contextvars
from typing import Optional

#: Correlation id of the request being handled on this thread.
_request_id: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("rt_serve_request_id", default=None)


def get_request_id() -> Optional[str]:
    """Correlation id of the request being handled on this thread (None
    outside a request scope)."""
    return _request_id.get()
