"""Span tracing: nested host timings that also show on the profiler's
timeline. The port's copy of ``ddr_tpu/observability/spans.py`` on
``torch.profiler``.

``span(name)`` times the enclosed region, records its nested
``outer/inner`` path to the active
:class:`~ddr_tpu_torch.observability.events.Recorder` as a ``span`` event,
and opens ``torch.profiler.record_function(name)``, so the region shows on a
profiler trace beside the port's ``ddr::`` ranges. ``trace(log_dir)`` runs
``torch.profiler.profile`` over a block when a directory is given (or
``DDR_PROFILE_DIR`` is set) and writes its Chrome trace there; it is
re-entrant, the outermost call owning the profiler. The on-demand capture
behind ``ddr profile`` and ``POST /v1/profile`` is ROADMAP A.10's second part.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Iterator

import torch

from ddr_tpu_torch.observability import trace as trace_ctx
from ddr_tpu_torch.observability.events import get_recorder

log = logging.getLogger(__name__)

__all__ = ["profile_dir_from_env", "span", "spanned", "trace", "trace_active"]

_tls = threading.local()

#: ``depth`` counts the live :func:`trace` frames; ``dir`` is set while the
#: profiler runs.
_TRACE = {"depth": 0, "dir": None}


def profile_dir_from_env() -> str | None:
    """``DDR_PROFILE_DIR`` -> the profiler's trace directory (None: off)."""
    return os.environ.get("DDR_PROFILE_DIR") or None


def trace_active() -> bool:
    """True while a :func:`trace` block runs the profiler."""
    return _TRACE["depth"] > 0


@contextmanager
def trace(log_dir: str | None = None) -> Iterator[None]:
    """``torch.profiler.profile`` (CPU, and CUDA when available) over the
    block when a directory is given or ``DDR_PROFILE_DIR`` is set, its Chrome
    trace written there as ``trace.json``; nothing otherwise. Nested calls
    only count their depth: the profiler starts and stops once."""
    if _TRACE["depth"] > 0:
        _TRACE["depth"] += 1
        try:
            yield
        finally:
            _TRACE["depth"] -= 1
        return
    log_dir = log_dir or profile_dir_from_env()
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log.info(f"Writing torch profiler trace to {log_dir}")
    _TRACE["depth"], _TRACE["dir"] = 1, str(log_dir)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
    finally:
        _TRACE["depth"], _TRACE["dir"] = 0, None


def _stack() -> list[str]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


@contextmanager
def span(name: str, emit: bool = True, parent: "object | None" = None) -> Iterator[None]:
    """Time a named region; spans nest (the recorded path is ``outer/inner``).

    The timing is recorded on every exit path, to the active recorder only
    (``emit=False`` keeps the profiler range and skips the event). While
    tracing is on (``DDR_TRACE``) and a recorder is active, the span joins the
    ambient trace: a child of the innermost span on this thread or of the
    explicit ``parent`` :class:`~ddr_tpu_torch.observability.trace.SpanContext`
    (threads do not share the stack), else the root of a new trace; its event
    then carries ``trace_id``, ``span_id`` and ``parent_id``.
    """
    stack = _stack()
    path = "/".join((*stack, name))
    stack.append(name)
    span_ctx = None
    if emit and trace_ctx.trace_enabled() and get_recorder() is not None:
        up = parent if parent is not None else trace_ctx.current()
        span_ctx = (up.child() if up is not None
                    else trace_ctx.SpanContext(trace_ctx.new_trace_id(), trace_ctx.new_span_id()))
        trace_ctx.push(span_ctx)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        stack.pop()
        if span_ctx is not None:
            trace_ctx.pop()
        dt = time.perf_counter() - t0
        if emit:
            rec = get_recorder()
            if rec is not None:
                rec.record_span(path, dt, ctx=span_ctx)


def spanned(name: str) -> Callable:
    """Decorator form of :func:`span` for a whole function."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
