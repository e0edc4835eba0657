"""Trace ids: the ids that let one forecast request be followed from HTTP
admission to its reply, and a batch to the requests it served.

The port's copy of ``ddr_tpu/observability/trace.py``, standard library
only:

- ``trace_id`` — one logical operation end to end (one forecast request from
  admission to reply, across services when the caller supplies it as
  ``X-DDR-Trace-Id``);
- ``span_id`` — one timed region inside a trace;
- ``parent_id`` — the enclosing span.

Tracing is on by default and host-side only; ``DDR_TRACE=0`` turns every
mint site into None (requests and run-log events then carry no trace ids).
:class:`SpanContext` is one span's identity; the thread-local stack gives a
:func:`~ddr_tpu_torch.observability.spans.span` its parent, and
:func:`step_context` derives a training step's root ids from the run's seed
and the step, so the step event and its ``phase/*`` spans share a trace.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import threading
import uuid
from typing import Any

__all__ = [
    "SpanContext",
    "adopt_trace_id",
    "current",
    "derive_id",
    "new_span_id",
    "new_trace_id",
    "pop",
    "push",
    "run_trace_seed",
    "step_context",
    "trace_enabled",
]

_tls = threading.local()

#: Supplied trace ids are cut to visible ASCII and capped, as request ids are
#: (``serving.service.make_request_id``), so a client cannot put control
#: characters into a header or a log line.
_TRACE_ID_STRIP = re.compile(r"[^\x21-\x7e]")
_TRACE_ID_MAX = 64


def trace_enabled() -> bool:
    """Master switch: ``DDR_TRACE`` (default on; ``0``/``false``/``no``/``off``
    disables every mint site)."""
    return os.environ.get("DDR_TRACE", "1").strip().lower() not in ("0", "false", "no", "off")


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """One span's identity within a trace; derive children with :meth:`child`."""

    trace_id: str
    span_id: str
    parent_id: str | None = None

    def child(self, span_id: str | None = None) -> "SpanContext":
        """A new span under this one: the same trace, this span as parent."""
        return SpanContext(trace_id=self.trace_id, span_id=span_id or new_span_id(),
                           parent_id=self.span_id)

    def ids(self) -> dict[str, str]:
        """The event payload: ``trace_id``, ``span_id`` and ``parent_id``
        when the span has one."""
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        return out


def new_trace_id() -> str:
    """A fresh random 16-hex trace id."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    """A fresh random 12-hex span id."""
    return uuid.uuid4().hex[:12]


def derive_id(*parts: Any, length: int = 16) -> str:
    """A deterministic id from ``parts``: whoever hashes the same parts gets
    the same id."""
    h = hashlib.sha1("|".join(str(p) for p in parts).encode("utf-8"))
    return h.hexdigest()[:length]


def adopt_trace_id(supplied: Any = None) -> str:
    """A caller-supplied trace id, sanitised, or a fresh one when nothing
    usable was supplied."""
    if supplied:
        cleaned = _TRACE_ID_STRIP.sub("", str(supplied))[:_TRACE_ID_MAX]
        if cleaned:
            return cleaned
    return new_trace_id()


def _stack() -> list[SpanContext]:
    s = getattr(_tls, "ctx", None)
    if s is None:
        s = _tls.ctx = []
    return s


def current() -> SpanContext | None:
    """The innermost active context on this thread (None outside any span)."""
    s = _stack()
    return s[-1] if s else None


def push(ctx: SpanContext) -> None:
    _stack().append(ctx)


def pop() -> None:
    s = _stack()
    if s:
        s.pop()


def run_trace_seed(cfg: Any = None) -> str:
    """The run's identity string: ``DDR_RUN_ID`` when set, else the config's
    ``name`` and ``save_path``, else ``"run"``."""
    rid = os.environ.get("DDR_RUN_ID")
    if rid:
        return str(rid)
    if cfg is not None:
        name = getattr(cfg, "name", None)
        save = getattr(getattr(cfg, "params", None), "save_path", None)
        if name is not None or save is not None:
            return f"{name}:{save}"
    return "run"


def step_context(seed: str, step: Any) -> SpanContext | None:
    """The root context of training step ``step`` (an int or an
    ``"epoch:batch"`` string): trace and root-span ids derived from
    ``(seed, step)``. None when tracing is off."""
    if not trace_enabled():
        return None
    trace_id = derive_id("step", seed, step)
    return SpanContext(trace_id=trace_id, span_id=derive_id("root", trace_id, length=12))
