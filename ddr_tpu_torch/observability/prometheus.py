"""Prometheus text exposition, the event -> metric mapping, and the
standalone ``/metrics`` exporter.

The port's copy of ``ddr_tpu/observability/prometheus.py``:

- :func:`render_text` — a :class:`MetricsRegistry` in Prometheus text
  exposition format 0.0.4 (``# HELP`` / ``# TYPE`` / one line a series;
  histograms as cumulative ``_bucket{le=...}``, ``_sum`` and ``_count``),
  byte for byte the JAX package's text for the same registry operations;
- :func:`declare_serve_metrics` — the service's and the watchdog's instrument
  set, declared up front so ``GET /metrics`` shows every name from the first
  scrape: JAX's set less the compile counter (``ddr_compiles_total``), since
  the port has no XLA compile cache and emits no ``compile`` events. The
  service sets the SLO gauges (``ddr_slo_attainment``,
  ``ddr_slo_burn_rate{window}``) from its tracker;
- :func:`event_tee` — one decision record (``{"event": ..., **payload}``) ->
  instrument updates, for the events the port emits: the train loop's
  ``step``, ``eval`` and ``heartbeat`` (with ``ddr_prefetch_depth``), and
  ``serve_request``, ``serve_batch``, ``serve_shed``, ``slo``, ``health``
  and the sentinel's ``anomaly``;
- :func:`start_exporter` / :func:`maybe_start_exporter_from_env` — ``GET
  /metrics`` on a daemon thread for commands without an HTTP front of their
  own (``DDR_PROM_PORT``; ``0`` binds an ephemeral port, which
  :func:`~ddr_tpu_torch.observability.events.run_telemetry` stamps as
  ``prom_port`` on ``run_start``).

The active run recorder (:mod:`~ddr_tpu_torch.observability.events`) tees
every event it writes through :func:`event_tee`; ``ddr serve`` answers the
same text on its own ``/metrics``.
"""

from __future__ import annotations

import logging
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ddr_tpu_torch.observability.registry import Histogram, MetricsRegistry, get_registry

log = logging.getLogger(__name__)

__all__ = [
    "CONTENT_TYPE",
    "OCCUPANCY_BUCKETS",
    "MetricsHTTPServer",
    "declare_serve_metrics",
    "event_tee",
    "maybe_start_exporter_from_env",
    "render_text",
    "start_exporter",
    "stop_exporter",
]

#: The exposition-format content type scrapers expect.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Batch-occupancy buckets: fractions of the batch slot.
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(names: tuple[str, ...], values: tuple[str, ...], const: dict,
                extra: dict | None = None) -> str:
    pairs = dict(const)
    pairs.update(zip(names, values))
    if extra:
        pairs.update(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(str(v))}"' for k, v in sorted(pairs.items())) + "}"


def render_text(registry: MetricsRegistry | None = None) -> str:
    """The whole registry in Prometheus text exposition format 0.0.4."""
    registry = registry or get_registry()
    const = registry.const_labels
    out: list[str] = []
    for metric in registry.collect():
        if metric.help:
            out.append(f"# HELP {metric.name} {_escape(metric.help)}")
        out.append(f"# TYPE {metric.name} {metric.kind}")
        series = metric.series()
        if isinstance(metric, Histogram):
            for key, state in sorted(series.items()):
                cum = 0
                for bound, n in zip(metric.buckets, state["buckets"]):
                    cum += n
                    lab = _labels_str(metric.labels, key, const, {"le": _fmt(bound)})
                    out.append(f"{metric.name}_bucket{lab} {cum}")
                cum += state["buckets"][-1]
                lab = _labels_str(metric.labels, key, const, {"le": "+Inf"})
                out.append(f"{metric.name}_bucket{lab} {cum}")
                plain = _labels_str(metric.labels, key, const)
                out.append(f"{metric.name}_sum{plain} {_fmt(state['sum'])}")
                out.append(f"{metric.name}_count{plain} {state['count']}")
        else:
            for key, value in sorted(series.items()):
                out.append(f"{metric.name}{_labels_str(metric.labels, key, const)} {_fmt(value)}")
    return "\n".join(out) + "\n"


def declare_serve_metrics(registry: MetricsRegistry | None = None) -> MetricsRegistry:
    """Declare the serving and health instrument set up front. Idempotent."""
    r = registry or get_registry()
    r.counter("ddr_requests_total", "Forecast requests by terminal status",
              labels=("status", "network", "model"))
    r.histogram("ddr_request_latency_seconds",
                "Admit-to-completion latency of served (status=ok) requests",
                labels=("network", "model"))
    # latency = queue wait (admission -> batch extraction, the coalescing hold
    # included) + execution (the batch's execute wall time) + reply overhead
    r.histogram("ddr_serve_queue_seconds",
                "Admission-to-extraction queue wait per request (includes the "
                "coalescing hold)",
                labels=("network", "model"))
    r.histogram("ddr_serve_execute_seconds",
                "Device execution time attributed to each served request (its "
                "micro-batch's execute wall time)",
                labels=("network", "model"))
    r.gauge("ddr_slo_attainment",
            "Sliding-window SLO attainment over the longest configured window")
    r.gauge("ddr_slo_burn_rate",
            "SLO error-budget burn rate per sliding window (1.0 = spending "
            "exactly the budget)", labels=("window",))
    r.counter("ddr_slo_alerts_total",
              "SLO fast-burn alert transitions", labels=("state",))
    r.counter("ddr_batches_total", "Executed micro-batches",
              labels=("network", "model"))
    r.histogram("ddr_batch_occupancy",
                "Fraction of the compiled batch slot filled per executed batch",
                labels=("network", "model"), buckets=OCCUPANCY_BUCKETS)
    r.histogram("ddr_batch_seconds", "Device execution time per micro-batch",
                labels=("network", "model"))
    qd = r.gauge("ddr_queue_depth", "Request queue depth after the last batch extraction")
    if not qd.series():
        qd.set(0.0)
    r.counter("ddr_sheds_total", "Shed/rejected requests by reason", labels=("reason",))
    # the priority-class split of the same decisions: which tier paid
    r.counter("ddr_serve_shed_total", "Shed/rejected requests by reason and "
              "priority class", labels=("reason", "priority"))
    r.counter("ddr_hot_reloads_total", "Checkpoint hot-reloads applied", labels=("model",))
    r.gauge("ddr_model_version", "Current params version per model", labels=("model",))
    hs = r.gauge(
        "ddr_health_status",
        "Numerical health of the last observed batch (1 healthy, 0 violating)",
    )
    if not hs.series():  # healthy until a watchdog says otherwise
        hs.set(1.0)
    r.counter("ddr_health_violations_total",
              "Health-watchdog threshold violations by reason", labels=("reason",))
    return r


def _get(payload: dict, key: str, default: float = 0.0) -> float:
    v = payload.get(key)
    try:
        return default if v is None else float(v)
    except (TypeError, ValueError):
        return default


def event_tee(record: dict, registry: MetricsRegistry | None = None) -> None:
    """Update the registry from one decision record. Every event bumps
    ``ddr_events_total``; the ``step``, ``eval``, ``heartbeat``, serve,
    health and ``anomaly`` events update their instruments; any other event
    updates nothing else (``skill`` and ``drift`` trackers set their own
    instruments when they observe, so mapping their events would count
    twice)."""
    r = registry or get_registry()
    event = str(record.get("event", "?"))
    r.counter("ddr_events_total", "Telemetry events by type", labels=("event",)).inc(event=event)
    if event in ("serve_request", "serve_batch", "serve_shed", "health", "slo") and (
        r.get("ddr_requests_total") is None  # declare once, not per event
    ):
        declare_serve_metrics(r)
    if event == "step":
        engine = str(record.get("engine", "?"))
        r.counter("ddr_steps_total", "Training steps", labels=("engine",)).inc(engine=engine)
        if record.get("seconds") is not None:
            r.histogram("ddr_step_seconds", "Synchronized training-step duration",
                        labels=("engine",)).observe(_get(record, "seconds"), engine=engine)
        if record.get("loss") is not None:
            r.gauge("ddr_loss", "Loss of the most recent training step").set(_get(record, "loss", math.nan))
        phases = record.get("phases")
        if isinstance(phases, dict):
            # the step's wall-clock split (observability.phases), live
            hist = r.histogram(
                "ddr_phase_seconds",
                "Per-step wall time by loop phase (data_load/host_prep/device_step/eval/checkpoint)",
                labels=("phase",),
            )
            for phase, seconds in phases.items():
                try:
                    hist.observe(float(seconds), phase=str(phase))
                except (TypeError, ValueError):
                    continue
    elif event == "eval":
        r.counter("ddr_evals_total", "Inference batches").inc()
    elif event == "heartbeat":
        r.counter("ddr_heartbeats_total", "Liveness heartbeats").inc()
        if record.get("prefetch_depth") is not None:
            # the prefetch pool's prepared batches at the beat: 0 sustained
            # means the loop waits on its data
            r.gauge("ddr_prefetch_depth",
                    "Prepared batches waiting in the training prefetch pool at the last heartbeat",
                    ).set(_get(record, "prefetch_depth"))
    elif event == "serve_request":
        status = str(record.get("status", "?"))
        network = str(record.get("network", "?"))
        model = str(record.get("model", "?"))
        r.get("ddr_requests_total").inc(status=status, network=network, model=model)
        if status == "ok" and record.get("latency_s") is not None:
            r.get("ddr_request_latency_seconds").observe(
                _get(record, "latency_s"), network=network, model=model)
        # queue wait for every status that queued (sheds included), execution
        # only for requests that ran
        if record.get("queue_s") is not None:
            r.get("ddr_serve_queue_seconds").observe(
                _get(record, "queue_s"), network=network, model=model)
        if record.get("execute_s") is not None:
            r.get("ddr_serve_execute_seconds").observe(
                _get(record, "execute_s"), network=network, model=model)
    elif event == "slo":
        r.get("ddr_slo_alerts_total").inc(state=str(record.get("state", "?")))
    elif event == "serve_batch":
        network = str(record.get("network", "?"))
        model = str(record.get("model", "?"))
        r.get("ddr_batches_total").inc(network=network, model=model)
        if record.get("occupancy") is not None:
            r.get("ddr_batch_occupancy").observe(
                _get(record, "occupancy"), network=network, model=model)
        if record.get("seconds") is not None:
            r.get("ddr_batch_seconds").observe(_get(record, "seconds"), network=network, model=model)
        if record.get("queue_depth") is not None:
            r.get("ddr_queue_depth").set(_get(record, "queue_depth"))
    elif event == "serve_shed":
        reason = str(record.get("reason", "?"))
        r.get("ddr_sheds_total").inc(reason=reason)
        r.get("ddr_serve_shed_total").inc(reason=reason, priority=str(record.get("priority", "batch")))
    elif event == "health":
        for reason in record.get("reasons") or ["?"]:
            r.get("ddr_health_violations_total").inc(reason=str(reason))
    elif event == "anomaly":
        # the sentinel's episode transitions: the counter counts episodes
        # (firing edges), the gauge which signals are firing now
        signal = str(record.get("signal", "?"))
        state = str(record.get("state", "?"))
        if state == "firing":
            r.counter("ddr_anomalies_total", "Performance-anomaly episodes by signal",
                      labels=("signal",)).inc(signal=signal)
        r.gauge("ddr_anomaly_active",
                "Whether a performance anomaly is currently firing per signal (1 firing, 0 resolved)",
                labels=("signal",)).set(1.0 if state == "firing" else 0.0, signal=signal)


# ---------------------------------------------------------------------------
# The standalone exporter (DDR_PROM_PORT): GET /metrics on a daemon thread.
# ---------------------------------------------------------------------------


class _MetricsHandler(BaseHTTPRequestHandler):
    server: "MetricsHTTPServer"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        log.debug("prom %s", format % args)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_response(404)
            self.end_headers()
            return
        body = render_text(self.server.registry).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass


class MetricsHTTPServer(ThreadingHTTPServer):
    """``GET /metrics`` (and ``/``) over one registry."""

    daemon_threads = True

    def __init__(self, registry: MetricsRegistry, host: str, port: int) -> None:
        self.registry = registry
        super().__init__((host, port), _MetricsHandler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}/metrics"


_EXPORTER: MetricsHTTPServer | None = None
_EXPORTER_LOCK = threading.Lock()


def start_exporter(port: int, host: str = "0.0.0.0",
                   registry: MetricsRegistry | None = None) -> MetricsHTTPServer:
    """Serve ``GET /metrics`` on a daemon thread and return the server (its
    ``url`` has the bound port; ``port=0`` binds an ephemeral one). One
    exporter a process: a second call returns the running one."""
    global _EXPORTER
    with _EXPORTER_LOCK:
        if _EXPORTER is not None:
            return _EXPORTER
        server = MetricsHTTPServer(registry or get_registry(), host, port)
        threading.Thread(target=server.serve_forever, name="ddr-prom-exporter", daemon=True).start()
        _EXPORTER = server
    log.info(f"prometheus exporter listening on {server.url}")
    return server


def maybe_start_exporter_from_env() -> MetricsHTTPServer | None:
    """Start the exporter when ``DDR_PROM_PORT`` holds a port (``0``: an
    ephemeral one, read back from the server). A malformed value or a port
    that cannot be bound logs a warning and returns None: a metrics knob
    never takes a run down."""
    raw = os.environ.get("DDR_PROM_PORT")
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        log.warning(f"ignoring malformed DDR_PROM_PORT={raw!r} (want an integer)")
        return None
    try:
        return start_exporter(port)
    except OSError as e:
        log.warning(f"could not bind prometheus exporter on port {port}: {e}")
        return None


def stop_exporter() -> None:
    """Shut the process's exporter down (tests, and a caller that owns the
    process's lifetime)."""
    global _EXPORTER
    with _EXPORTER_LOCK:
        server, _EXPORTER = _EXPORTER, None
    if server is not None:
        server.shutdown()
        server.server_close()
