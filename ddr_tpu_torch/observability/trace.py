"""Trace ids: the ids that let one forecast request be followed from HTTP
admission to its reply, and a batch to the requests it served.

The port's copy of ``ddr_tpu/observability/trace.py``'s id half, standard
library only:

- ``trace_id`` — one logical operation end to end (one forecast request from
  admission to reply, across services when the caller supplies it as
  ``X-DDR-Trace-Id``);
- ``span_id`` — one timed region inside a trace;
- ``parent_id`` — the enclosing span.

Tracing is on by default and host-side only; ``DDR_TRACE=0`` turns every
mint site into None (requests then carry no trace ids). The JAX module's
``SpanContext``, ``derive_id``, thread-local span stack and step contexts
serve its training loop's spans and run recorder (ROADMAP A.10); nothing on
the port's serve path uses them.
"""

from __future__ import annotations

import os
import re
import uuid
from typing import Any

__all__ = [
    "adopt_trace_id",
    "new_span_id",
    "new_trace_id",
    "trace_enabled",
]

#: Supplied trace ids are cut to visible ASCII and capped, as request ids are
#: (``serving.service.make_request_id``), so a client cannot put control
#: characters into a header or a log line.
_TRACE_ID_STRIP = re.compile(r"[^\x21-\x7e]")
_TRACE_ID_MAX = 64


def trace_enabled() -> bool:
    """Master switch: ``DDR_TRACE`` (default on; ``0``/``false``/``no``/``off``
    disables every mint site)."""
    return os.environ.get("DDR_TRACE", "1").strip().lower() not in ("0", "false", "no", "off")


def new_trace_id() -> str:
    """A fresh random 16-hex trace id."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    """A fresh random 12-hex span id."""
    return uuid.uuid4().hex[:12]


def adopt_trace_id(supplied: Any = None) -> str:
    """A caller-supplied trace id, sanitised, or a fresh one when nothing
    usable was supplied."""
    if supplied:
        cleaned = _TRACE_ID_STRIP.sub("", str(supplied))[:_TRACE_ID_MAX]
        if cleaned:
            return cleaned
    return new_trace_id()
