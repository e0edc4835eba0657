"""Structured run telemetry, JSONL events: the port's copy of
``ddr_tpu/observability/events.py``.

A process-local :class:`Recorder` appends one JSON object a line to a run
log. Every event carries the envelope::

    {"event": <type>, "t": <seconds since the recorder started, monotonic>,
     "wall": <unix seconds>, "host": <process index>, "pid": <os pid>,
     "seq": <per-recorder counter>, ...payload}

The event types (:data:`EVENT_TYPES`) and :data:`SCHEMA_VERSION` are the JAX
package's, so a reader of either package's logs reads both.
:func:`run_telemetry` opens ``run_log.<cmd>.jsonl`` under
``DDR_METRICS_DIR`` (else the run's ``save_path``), activates it for the
command (``get_recorder``), writes ``run_start`` and, on every exit path,
``run_end`` with the rollup. ``DDR_METRICS_FLUSH_EVERY`` batches flushes and
``DDR_METRICS_MAX_MB`` bounds the log by rotating it into segments.

The port is one process until ROADMAP A.13, so :func:`host_layout` is
``(0, 1)``. Device memory comes from ``torch.cuda`` on the card; on the CPU
the entries name the platform only. An active recorder tees every event into
the live metrics registry
(:func:`~ddr_tpu_torch.observability.prometheus.event_tee`), and
``DDR_PROM_PORT`` makes :func:`run_telemetry` serve that registry on a
standalone ``/metrics`` exporter, whose bound port rides ``run_start`` as
``prom_port``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterator

log = logging.getLogger(__name__)

__all__ = [
    "EVENT_TYPES",
    "SCHEMA_VERSION",
    "Recorder",
    "max_log_bytes_from_env",
    "get_recorder",
    "activate",
    "deactivate",
    "run_telemetry",
    "metrics_dir_from_env",
    "flush_every_from_env",
    "device_memory_stats",
    "device_peak_bytes",
    "emit_heartbeat",
    "host_layout",
]

#: The event schema's version, stamped on every ``run_start`` (the JAX
#: package's: 5 added the ``anomaly`` event, ``loop_s`` on ``step`` and
#: ``prefetch_depth`` on ``heartbeat``).
SCHEMA_VERSION = 5

#: The closed vocabulary of event types. :meth:`Recorder.emit` warns on, but
#: still writes, any other name.
EVENT_TYPES = (
    "run_start",
    "step",
    "eval",
    "compile",
    "heartbeat",
    "span",
    "run_end",
    "serve_request",
    "serve_batch",
    "serve_shed",
    "health",
    "program_card",
    "slo",
    "fault",
    "preempt",
    "chaos",
    "skill",
    "drift",
    "audit",
    "reshard",
    "tune",
    "recovery",
    "data_anomaly",
    "canary",
    "verify",
    "anomaly",
)


def flush_every_from_env() -> int:
    """``DDR_METRICS_FLUSH_EVERY`` -> flush cadence in events (default 1,
    every line; a malformed value falls back to 1)."""
    raw = os.environ.get("DDR_METRICS_FLUSH_EVERY")
    if not raw:
        return 1
    try:
        return max(1, int(raw))
    except ValueError:
        log.warning(f"ignoring malformed DDR_METRICS_FLUSH_EVERY={raw!r} (want an integer)")
        return 1


#: An over-budget log is split into this many pieces: the first segment (it
#: holds ``run_start``), the newest few and the active file.
_ROTATE_SEGMENTS = 5


def max_log_bytes_from_env() -> int | None:
    """``DDR_METRICS_MAX_MB`` -> the run log's size bound in bytes (None:
    unbounded; malformed or non-positive values disable the bound)."""
    raw = os.environ.get("DDR_METRICS_MAX_MB")
    if not raw:
        return None
    try:
        mb = float(raw)
    except ValueError:
        log.warning(f"ignoring malformed DDR_METRICS_MAX_MB={raw!r} (want a number)")
        return None
    if mb <= 0:
        return None
    return int(mb * 1024 * 1024)


def metrics_dir_from_env() -> str | None:
    """``DDR_METRICS_DIR`` -> the run-log directory (None: the run's ``save_path``)."""
    return os.environ.get("DDR_METRICS_DIR") or None


def host_layout() -> tuple[int, int]:
    """``(process_index, process_count)``: ``(0, 1)``, the port being one
    process until ROADMAP A.13."""
    return 0, 1


def _json_default(obj: Any):
    """numpy scalars, Paths and anything else -> JSON-safe."""
    try:
        return float(obj)
    except (TypeError, ValueError):
        return str(obj)


class Recorder:
    """Process-local JSONL event writer with a per-run rollup.

    ``emit`` is thread-safe (the prefetch pool and the batcher thread emit
    beside the main thread). ``close`` writes the terminal ``run_end`` event
    with the rollup (event counts, span totals, anything merged through
    :meth:`merge_summary`).
    """

    def __init__(
        self,
        path: str | Path,
        host: int = 0,
        n_hosts: int = 1,
        tags: dict[str, Any] | None = None,
        flush_every: int | None = None,
        max_bytes: int | None = None,
    ) -> None:
        self.path = Path(path)
        self.host = int(host)
        self.n_hosts = int(n_hosts)
        self.tags = dict(tags or {})
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._seq = 0
        self._lock = threading.RLock()
        self._counts: dict[str, int] = {}
        self._spans: dict[str, list[float]] = {}  # path -> [count, total_seconds]
        self._extra: dict[str, Any] = {}
        self._closed = False
        self._flush_every = flush_every_from_env() if flush_every is None else max(1, int(flush_every))
        self._unflushed = 0
        # per-emit observers (the metrics tee); their failures are logged, never raised
        self._hooks: list[Any] = []
        self._max_bytes = max_log_bytes_from_env() if max_bytes is None else (
            int(max_bytes) if max_bytes else None
        )
        self._seg_bytes = max(4096, self._max_bytes // _ROTATE_SEGMENTS) if self._max_bytes else None
        self._seg_n = 0
        self._written = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("w", encoding="utf-8")

    @classmethod
    def open_run(
        cls,
        base_dir: str | Path,
        cmd: str = "run",
        tags: dict[str, Any] | None = None,
        host: int | None = None,
        n_hosts: int | None = None,
    ) -> "Recorder":
        """Open ``cmd``'s run log under ``base_dir``: ``run_log.<cmd>.jsonl``
        for process 0, ``run_log.<cmd>.host<K>.jsonl`` for any other."""
        if host is None or n_hosts is None:
            h, n = host_layout()
            host = h if host is None else host
            n_hosts = n if n_hosts is None else n_hosts
        name = f"run_log.{cmd}.jsonl" if host == 0 else f"run_log.{cmd}.host{host}.jsonl"
        return cls(Path(base_dir) / name, host=host, n_hosts=n_hosts, tags=tags)

    def add_hook(self, hook: Any) -> None:
        """Register ``hook(record_dict)``, called after each write (adding the
        same callable twice is a no-op)."""
        with self._lock:
            if hook not in self._hooks:
                self._hooks.append(hook)

    def emit(self, event: str, **payload: Any) -> None:
        """Append one event line (one write; flushed every ``flush_every``
        events and at close)."""
        if event not in EVENT_TYPES:
            log.warning(f"unknown telemetry event type {event!r} (writing anyway)")
        with self._lock:
            if self._closed:
                return
            rec: dict[str, Any] = {
                "event": event,
                "t": round(time.perf_counter() - self._t0, 6),
                "wall": round(time.time(), 3),
                "host": self.host,
                "pid": os.getpid(),
                "seq": self._seq,
            }
            if self.tags:
                rec["tags"] = self.tags
            rec.update(payload)
            self._seq += 1
            self._counts[event] = self._counts.get(event, 0) + 1
            line = json.dumps(rec, default=_json_default) + "\n"
            self._fh.write(line)
            self._unflushed += 1
            if self._unflushed >= self._flush_every:
                self._fh.flush()
                self._unflushed = 0
            if self._seg_bytes is not None:
                self._written += len(line)
                if self._written >= self._seg_bytes:
                    self._rotate()
            hooks = list(self._hooks)
        for hook in hooks:
            try:
                hook(rec)
            except Exception:
                log.exception(f"telemetry emit hook {hook!r} failed")

    def record_span(self, path: str, seconds: float, ctx: Any = None) -> None:
        """Aggregate one finished span and emit its ``span`` event; ``ctx``
        (a :class:`~ddr_tpu_torch.observability.trace.SpanContext`) adds its
        ids and the emitting thread's name."""
        with self._lock:
            agg = self._spans.setdefault(path, [0, 0.0])
            agg[0] += 1
            agg[1] += seconds
        extra: dict[str, Any] = {}
        if ctx is not None:
            extra = ctx.ids()
            extra["thread"] = threading.current_thread().name
        self.emit("span", name=path, seconds=round(seconds, 6), **extra)

    def _rotate(self) -> None:
        """Rename the active file to the next numbered segment and start a
        fresh one (the caller holds the lock). A filesystem refusal disables
        rotation for the rest of the run."""
        try:
            self._fh.flush()
            self._fh.close()
            self._seg_n += 1
            seg = self.path.with_name(f"{self.path.stem}.seg{self._seg_n}{self.path.suffix}")
            os.replace(self.path, seg)
            self._fh = self.path.open("w", encoding="utf-8")
            self._written = 0
            self._prune_segments()
        except OSError:
            log.exception("run-log rotation failed; disabling rotation")
            self._seg_bytes = None
            if self._fh.closed:
                self._fh = self.path.open("a", encoding="utf-8")

    def _segment_paths(self) -> list[tuple[int, Path]]:
        """This log's rotated segments as ``(N, path)``, ordered by N."""
        out: list[tuple[int, Path]] = []
        prefix = f"{self.path.stem}.seg"
        for p in self.path.parent.glob(f"{prefix}*{self.path.suffix}"):
            num = p.name[len(prefix):-len(self.path.suffix)]
            if num.isdigit():
                out.append((int(num), p))
        return sorted(out)

    def _prune_segments(self) -> None:
        """Keep the first segment (``run_start``) and the newest
        ``_ROTATE_SEGMENTS - 2``; delete the middle ones."""
        segs = self._segment_paths()
        keep_tail = _ROTATE_SEGMENTS - 2
        if len(segs) <= keep_tail + 1:
            return
        for _, p in segs[1:-keep_tail]:
            try:
                p.unlink()
            except OSError:
                pass

    def merge_summary(self, key: str, value: Any) -> None:
        """Attach one more rollup to ``run_end``."""
        with self._lock:
            self._extra[key] = value

    def summary(self) -> dict[str, Any]:
        with self._lock:
            out: dict[str, Any] = {
                "events": dict(self._counts),
                "spans": {
                    k: {"count": int(c), "seconds": round(s, 6)}
                    for k, (c, s) in sorted(self._spans.items())
                },
            }
            out.update(self._extra)
            return out

    def close(self, status: str = "ok") -> None:
        with self._lock:
            if self._closed:
                return
            self._seg_bytes = None  # run_end stays in the active file
            self.emit(
                "run_end",
                status=status,
                duration_s=round(time.perf_counter() - self._t0, 3),
                summary=self.summary(),
            )
            self._closed = True
            self._fh.flush()
            self._fh.close()


_ACTIVE: Recorder | None = None


def get_recorder() -> Recorder | None:
    """The active recorder, or None when telemetry is off."""
    return _ACTIVE


def activate(rec: Recorder) -> None:
    """Make ``rec`` the process's active recorder and tee its events into the
    live metrics registry."""
    global _ACTIVE
    if _ACTIVE is not None and _ACTIVE is not rec:
        log.warning(f"replacing active telemetry recorder {_ACTIVE.path}")
    try:
        from ddr_tpu_torch.observability.prometheus import event_tee

        rec.add_hook(event_tee)
    except Exception:
        log.exception("could not install prometheus tee on the active recorder")
    _ACTIVE = rec


def deactivate(rec: Recorder | None = None) -> None:
    """Clear the active recorder (a no-op when ``rec`` is given and is not it)."""
    global _ACTIVE
    if rec is None or _ACTIVE is rec:
        _ACTIVE = None


@contextmanager
def run_telemetry(
    cfg: Any = None,
    cmd: str = "run",
    base_dir: str | Path | None = None,
    tags: dict[str, Any] | None = None,
    **run_info: Any,
) -> Iterator[Recorder | None]:
    """Open and activate ``cmd``'s run log; ``run_start`` before the body,
    ``run_end`` after it.

    The directory is ``base_dir``, else ``DDR_METRICS_DIR``, else
    ``cfg.params.save_path``; with none, the body runs with a None recorder.
    ``run_end.status`` is ``ok``, ``interrupted`` (KeyboardInterrupt) or
    ``error:<Type>``, and the recorder is always deactivated and closed.

    ``DDR_PROM_PORT`` starts the standalone ``/metrics`` exporter, with or
    without a run log; its bound port (``0`` binds an ephemeral one) rides
    ``run_start`` as ``prom_port``, so a harness finds it in the log.
    """
    from ddr_tpu_torch.observability.prometheus import maybe_start_exporter_from_env

    exporter = maybe_start_exporter_from_env()
    if exporter is not None:
        log.info(f"prometheus exporter serving /metrics at {exporter.url}")
    base = base_dir or metrics_dir_from_env()
    if base is None and cfg is not None:
        base = getattr(getattr(cfg, "params", None), "save_path", None)
    if base is None:
        yield None
        return
    rec = Recorder.open_run(base, cmd=cmd, tags=tags)
    activate(rec)
    info = _cfg_summary(cfg)
    info.update(run_info)
    if exporter is not None:
        info.setdefault("prom_port", int(exporter.server_address[1]))
    rec.emit("run_start", cmd=cmd, schema_version=SCHEMA_VERSION, n_hosts=rec.n_hosts, **info)
    status = "ok"
    try:
        yield rec
    except BaseException as e:
        status = "interrupted" if isinstance(e, KeyboardInterrupt) else f"error:{type(e).__name__}"
        raise
    finally:
        deactivate(rec)
        rec.close(status=status)


def _cfg_summary(cfg: Any) -> dict[str, Any]:
    """The run-identifying slice of a config for ``run_start`` (a missing
    attribute is left out)."""
    if cfg is None:
        return {}
    out: dict[str, Any] = {}
    for attr in ("name", "mode", "device"):
        v = getattr(cfg, attr, None)
        if v is not None:
            out[attr] = str(getattr(v, "value", v))  # enums by value
    exp = getattr(cfg, "experiment", None)
    for attr in ("parallel", "epochs", "batch_size", "warmup"):
        v = getattr(exp, attr, None)
        if v is not None:
            out[attr] = v
    return out


def device_memory_stats(max_devices: int = 8) -> list[dict[str, Any]]:
    """Per-device memory entries: ``bytes_in_use``, ``peak_bytes_in_use`` and
    ``bytes_limit`` for each card once CUDA is in use; one platform-only
    ``cpu`` entry otherwise. At most ``max_devices`` entries."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return [{"id": 0, "platform": "cpu"}]
    out = []
    for i in range(min(torch.cuda.device_count(), max_devices)):
        out.append({
            "id": i,
            "platform": "gpu",
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        })
    return out


def device_peak_bytes(device: Any = None) -> int | None:
    """Peak allocated bytes of one card (``device=None``: the current one),
    or None on the CPU or before CUDA is in use."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return int(torch.cuda.max_memory_allocated(device))


def emit_heartbeat(rec: Recorder | None = None, **payload: Any) -> None:
    """Emit one ``heartbeat`` event (the payload and device memory) to
    ``rec`` or the active recorder; nothing with neither."""
    rec = rec if rec is not None else get_recorder()
    if rec is None:
        return
    rec.emit("heartbeat", devices=device_memory_stats(), **payload)
