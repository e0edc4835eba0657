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
re-entrant, the outermost call owning the profiler. ``capture_profile(log_dir,
seconds)`` is the on-demand capture behind ``POST /v1/profile``: a window of
live traffic, under the same one-profiler-a-process guard.

``torch.profiler`` records CPU ranges (``record_function``) only on the
thread that started it, while CUDA kernels come through CUPTI from every
thread. A capture therefore names the kernels a server launched from its
batcher thread; its ``ddr::`` ranges show only under :func:`trace`, which
runs on the thread of the work it wraps.
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

__all__ = [
    "ProfilerBusyError",
    "capture_profile",
    "profile_dir_from_env",
    "span",
    "spanned",
    "trace",
    "trace_active",
]

_tls = threading.local()

#: ``depth`` counts the live :func:`trace` frames; ``dir`` is set while the
#: profiler runs.
_TRACE = {"depth": 0, "dir": None}
# serializes capture starts (HTTP handler threads race); trace() runs on one
# thread by construction
_CAPTURE_LOCK = threading.Lock()


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
    log.info(f"Writing torch profiler trace to {log_dir}")
    _TRACE["depth"], _TRACE["dir"] = 1, str(log_dir)
    try:
        with torch.profiler.profile(activities=_activities()) as prof:
            yield
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
    finally:
        _TRACE["depth"], _TRACE["dir"] = 0, None


def _activities() -> list:
    """CPU, and CUDA when a card is visible."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


class ProfilerBusyError(RuntimeError):
    """A profiler capture or :func:`trace` is already running (one process
    runs one ``torch.profiler`` at a time)."""


def capture_profile(log_dir: str, seconds: float) -> threading.Thread:
    """Profile the process for ``seconds`` from now, the on-demand form of
    :func:`trace` behind ``POST /v1/profile``: a window of live traffic,
    written to ``<log_dir>/capture_<time>_<pid>.json`` (a Chrome trace).

    One owner thread starts the profiler, sleeps and stops it, so start and
    stop run on one thread whichever thread asked. Returns that thread (a
    caller can ``join`` it) once the profiler runs; a failure to start is
    raised here. Raises :class:`ProfilerBusyError` while a :func:`trace` or
    another capture runs: nesting would hand the caller a trace that someone
    else stops."""
    seconds = float(seconds)
    if seconds <= 0:
        raise ValueError(f"capture seconds must be > 0, got {seconds}")
    log_dir = str(log_dir)
    with _CAPTURE_LOCK:
        if _TRACE["depth"] > 0:
            raise ProfilerBusyError(f"a profiler trace is already running (dir={_TRACE['dir']})")
        _TRACE["depth"], _TRACE["dir"] = 1, log_dir
    started = threading.Event()
    failed: list[BaseException] = []
    out = Path(log_dir) / f"capture_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"

    def _own() -> None:
        try:
            prof = torch.profiler.profile(activities=_activities())
            prof.start()
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            failed.append(e)
            _TRACE["depth"], _TRACE["dir"] = 0, None
            started.set()
            return
        started.set()
        log.info(f"profiler capture started: {seconds:.3g}s -> {out}")
        try:
            time.sleep(seconds)
        finally:
            try:
                prof.stop()
                out.parent.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(out))
                log.info(f"profiler capture finished -> {out}")
            except Exception:
                log.exception("profiler capture stop failed")
            finally:
                _TRACE["depth"], _TRACE["dir"] = 0, None

    owner = threading.Thread(target=_own, name="ddr-profile-capture", daemon=True)
    owner.start()
    started.wait()
    if failed:
        raise failed[0]
    return owner


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
