"""ForecastService: registered networks x hot-reloadable models, served in
padded batches.

The port of ``ddr_tpu/serving/service.py``'s request path. Per registered
``(network, model)`` pair the service runs one batched route

    (kan, q_prime (max_batch, horizon, N)) -> gauge runoff (max_batch, horizon, G)

as KAN -> denormalize -> batched ``route`` -> gauges. Requests are
zero-padded into the fixed batch slot, so a pair always runs the same
shapes; :meth:`ForecastService.warmup` builds the kernels and runs each pair
once before traffic. On a card the route goes through the CUDA wave-scan
kernel, once for a single-ring network and once a band for a deep one (the
stacked band router); the only synchronisation is the copy of a batch's
answers back to the host, where they go to clients.

Models live in a :class:`~ddr_tpu_torch.serving.registry.ModelRegistry`:
each batch takes one snapshot of its model, and a checkpoint watcher
(:meth:`ForecastService.watch_checkpoints`) swaps new weights in between
batches. Every request carries a ``request_id`` (a caller's, sanitised by
:func:`make_request_id`, else minted) and, with tracing on (``DDR_TRACE``),
a ``trace_id``, and is admitted in a priority class (``interactive``,
``batch``, ``bulk``). Every admission, batch and shed decision is an event
of the active run recorder (:mod:`~ddr_tpu_torch.observability.events`),
whose tee updates the live metrics registry (``GET /metrics``); with no run
log the decision goes to
:func:`~ddr_tpu_torch.observability.prometheus.event_tee` directly. Every terminal
decision is one good or bad observation of the
:class:`~ddr_tpu_torch.observability.slo.SloTracker` (``DDR_SLO_*``), which
the service mirrors onto the ``ddr_slo_*`` gauges and whose fast-burn alert
changes are ``slo`` events.

:meth:`ForecastService.ensemble_forecast` answers an E-member ensemble
(:mod:`ddr_tpu_torch.fleet.ensemble`): the KAN runs once and all members
route in one batched ``route``, one kernel launch for a single-ring network.
A :class:`~ddr_tpu_torch.observability.verification.ForecastLedger` attached
with :meth:`ForecastService.attach_verifier` records every forecast, single
and ensemble, for the delayed observation join (``POST /v1/observe``).

The numerical-health watchdog is on by default (``HealthConfig.from_env()``,
``DDR_HEALTH_ENABLED=0`` turns it off), as in the JAX service: every batch
but the warmup's computes its health stats on the device over the live
rows (pad rows masked out) of the runoff and of the request inflow before
flow scaling, plus the worst output columns when ``top_k > 0``, and the
watchdog thresholds them after the batch's copy to the host. Serving routes
in fp32: the JAX service has no dtype axis.

``stats()["fleet"]`` names the replica's place in a group
(:func:`~ddr_tpu_torch.fleet.config.fleet_identity`). The performance
sentinel (:mod:`~ddr_tpu_torch.observability.sentinel`, ``DDR_SENTINEL_*``)
samples the queue depth, the shed rate and the p99 latency once a
``sweep_s`` from the batch worker and from :meth:`ForecastService.stats`,
whose ``sentinel`` slice it is; ``DDR_SENTINEL_FLAG_WATCHDOG`` lets a
sustained anomaly degrade ``/readyz``. A skill tracker attached with
:meth:`ForecastService.attach_skill_tracker` is ``stats()["skill"]``. The
port has no XLA compile cache, so ``stats()["compiles"]`` is None and
``/v1/models``' ``programs`` is empty; mesh mode (ROADMAP A.13) is not in
this slice. The ``serve.execute`` fault site
(:mod:`~ddr_tpu_torch.observability.faults`) is resolved at construction and
fires at the top of each batch; its ``crash`` rides the batch's error path,
so every request still gets its terminal ``serve_request`` event.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.observability.health import (
    HealthConfig,
    HealthWatchdog,
    compute_health,
    compute_output_worst,
)
from ddr_tpu_torch.observability.events import get_recorder
from ddr_tpu_torch.observability.faults import fault_site
from ddr_tpu_torch.observability.prometheus import declare_serve_metrics, event_tee
from ddr_tpu_torch.observability.sentinel import Sentinel, SentinelConfig
from ddr_tpu_torch.observability.spans import span
from ddr_tpu_torch.observability.slo import SloConfig, SloTracker
from ddr_tpu_torch.observability.trace import (
    SpanContext,
    adopt_trace_id,
    new_span_id,
    new_trace_id,
    trace_enabled,
)
from ddr_tpu_torch.routing.chunked import ChunkedNetwork
from ddr_tpu_torch.routing.mc import Bounds, ChannelState, GaugeIndex, route
from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, engine_label, prepare_batch
from ddr_tpu_torch.routing.network import RiverNetwork
from ddr_tpu_torch.routing.stacked import StackedChunked
from ddr_tpu_torch.serving.batcher import (
    ForecastRequest,
    MicroBatcher,
    QueueFullError,
    RequestShedError,
)
from ddr_tpu_torch.serving.config import DEFAULT_PRIORITY, ServeConfig, priority_rank
from ddr_tpu_torch.serving.registry import ModelEntry, ModelRegistry

log = logging.getLogger(__name__)

__all__ = [
    "ForecastService",
    "NetworkEntry",
    "QueueFullError",
    "RequestShedError",
    "make_request_id",
    "request_window",
]

#: Characters allowed in a caller-supplied request id: visible ASCII only,
#: so the id is safe to echo in a header.
_REQUEST_ID_STRIP = re.compile(r"[^\x21-\x7e]")


def make_request_id(supplied: Any = None) -> str:
    """A caller-supplied request id with everything outside ``\\x21-\\x7e``
    stripped and cut to 128 characters, else a fresh 16-hex id. Always
    non-empty and header-safe."""
    if supplied:
        rid = _REQUEST_ID_STRIP.sub("", str(supplied))[:128]
        if rid:
            return rid
    return uuid.uuid4().hex[:16]


def request_window(net: NetworkEntry, network: str, q_prime: Any | None, t0: int | None,
                   gauges: Any | None, gauge_error: str = "gauges must lie in",
                   ) -> tuple[np.ndarray, int | None, np.ndarray | None]:
    """A request's inflow window, its first hour and its gauge selection,
    checked as the JAX service checks them; every bad field raises
    ``ValueError``. Exactly one of ``q_prime`` (a ``(horizon, N)`` payload)
    or ``t0`` (an hourly offset into the registered forcing; default 0)
    selects the window. Returns ``(window, start, gauge_sel)``: ``start`` is
    None for a q_prime payload, which has no timeline, and ``gauge_sel`` None
    for all gauges. ``gauge_error`` opens the out-of-range gauge message (the
    JAX package words it one way for single forecasts, another for
    ensembles)."""
    if q_prime is not None and t0 is not None:
        raise ValueError("pass q_prime or t0, not both")
    start = None
    if q_prime is not None:
        qp = np.asarray(q_prime, dtype=np.float32)
        if qp.shape != (net.horizon, net.n_segments):
            raise ValueError(f"q_prime must be ({net.horizon}, {net.n_segments}), got {qp.shape}")
    else:
        if net.forcing is None:
            raise ValueError(f"network {network!r} has no registered forcing; requests "
                             "must carry q_prime")
        start = 0 if t0 is None else int(t0)
        if not 0 <= start <= len(net.forcing) - net.horizon:
            raise ValueError(
                f"t0={start} out of range for forcing of {len(net.forcing)} hourly "
                f"steps and horizon {net.horizon}"
            )
        qp = net.forcing[start : start + net.horizon]
    gauge_sel = None
    if gauges is not None:
        gauge_sel = np.asarray(gauges, dtype=np.int64).ravel()
        if gauge_sel.size == 0:
            raise ValueError("gauges must be a non-empty index list (or omitted)")
        if gauge_sel.min() < 0 or gauge_sel.max() >= net.n_outputs:
            raise ValueError(f"{gauge_error} [0, {net.n_outputs}) for network {network!r}")
    return qp, start, gauge_sel


def _trace_fields(req: ForecastRequest) -> dict:
    """The trace ids of a request (empty when tracing was off at admission)."""
    return {k: req.meta[k] for k in ("trace_id", "span_id") if k in req.meta}


def _engine_kind(network: Any) -> str:
    """The JAX service's engine name of a built network."""
    if isinstance(network, StackedChunked):
        return "stacked"
    if isinstance(network, ChunkedNetwork):
        return "chunked"
    return "wavefront" if getattr(network, "wavefront", False) else "step"


@dataclasses.dataclass
class NetworkEntry:
    """One registered routing domain with its device-side structures."""

    name: str
    rd: Any  # RoutingData
    forcing: np.ndarray | None  # (T_total, N) hourly lateral inflow, or None
    horizon: int  # hourly steps per forecast
    network: RiverNetwork | StackedChunked
    channels: ChannelState
    gauge_index: GaugeIndex | None  # None = full-domain outputs
    attrs: torch.Tensor  # (N, n_attrs) KAN input on the device
    flow_scale: torch.Tensor | None  # (N,) on the device
    engine: str = "step"  # the JAX service's engine name

    @property
    def n_segments(self) -> int:
        return int(self.rd.n_segments)

    @property
    def n_outputs(self) -> int:
        return self.gauge_index.n_gauges if self.gauge_index is not None else self.n_segments


class ForecastService:
    """Batched, hot-reloadable forecast serving. Lifecycle: construct ->
    :meth:`register_network` / :meth:`register_model` (and
    :meth:`watch_checkpoints`) -> :meth:`warmup` -> :meth:`submit` /
    :meth:`forecast` or the HTTP front (:mod:`ddr_tpu_torch.serving.http_api`)
    -> :meth:`close`."""

    def __init__(
        self,
        cfg: Any,
        serve_cfg: ServeConfig | None = None,
        device: str | torch.device = "cuda",
        health_cfg: HealthConfig | None = None,
        slo_cfg: SloConfig | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig.from_env()
        self.registry = ModelRegistry()
        slo_cfg = slo_cfg or SloConfig.from_env()
        self.slo: SloTracker | None = SloTracker(slo_cfg) if slo_cfg.enabled else None
        self._verifier: Any = None  # a ForecastLedger, once attached
        self._ensembles: Any = None  # the EnsembleRunner, built on the first ensemble
        self.health_cfg = health_cfg or HealthConfig.from_env()
        self.watchdog = HealthWatchdog(self.health_cfg)
        # declared up front: GET /metrics shows every serve metric from the first scrape
        self.metrics = declare_serve_metrics()
        # the performance sentinel: the queue depth, shed rate and p99 latency,
        # sampled once a DDR_SENTINEL_SWEEP_S, not once a request
        try:
            sent_cfg = SentinelConfig.from_env()
        except ValueError:
            log.exception("ignoring malformed DDR_SENTINEL_* config")
            sent_cfg = SentinelConfig(enabled=False)
        self.sentinel: Sentinel | None = (
            Sentinel(sent_cfg, scope="serve", registry=self.metrics, emit=self._emit)
            if sent_cfg.enabled else None)
        self._sent_lock = threading.Lock()
        self._sent_last_sweep = time.monotonic()
        self._sent_last_shed = 0.0
        self._sent_sweeps = 0
        self._sent_flag_streak = 0
        self._sent_flagged = False
        self._sent_lat: list[float] = []  # the latencies since the last sweep
        self._skill: Any = None  # a SkillTracker, once attached
        self.bounds = Bounds.from_config(cfg.params.attribute_minimums)
        self._networks: dict[str, NetworkEntry] = {}
        self._lock = threading.Lock()
        self._ready = False
        self._warmup_error: str | None = None
        self._batcher = MicroBatcher(
            execute=self._execute,
            max_batch=self.serve_cfg.max_batch,
            queue_cap=self.serve_cfg.queue_cap,
            batch_wait_s=self.serve_cfg.batch_wait_s,
            backpressure=self.serve_cfg.backpressure,
            on_shed=self._on_shed,
        )
        # resolved once: None (DDR_FAULTS unset) costs one `if` a batch
        self._inject_execute = fault_site("serve.execute")

    # ---- registration ----

    def register_network(
        self,
        name: str,
        routing_data: Any,
        forcing: np.ndarray | None = None,
        horizon: int | None = None,
    ) -> NetworkEntry:
        """Register a routing domain. ``forcing`` (hourly ``(T_total, N)``)
        lets requests name a window by ``t0`` instead of shipping q_prime;
        ``horizon`` fixes the forecast length (default: the ServeConfig
        horizon, capped to the forcing length)."""
        rd = routing_data
        if forcing is not None:
            forcing = np.asarray(forcing, dtype=np.float32)
            if forcing.ndim != 2 or forcing.shape[1] != rd.n_segments:
                raise ValueError(f"forcing must be (T, {rd.n_segments}), got {forcing.shape}")
        if horizon is None:
            horizon = self.serve_cfg.horizon_hours
            if forcing is not None:
                horizon = min(horizon, len(forcing))
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if forcing is not None and len(forcing) < horizon:
            raise ValueError(f"forcing covers {len(forcing)} hourly steps < horizon {horizon}")
        network, channels, gauge_index = prepare_batch(
            rd, slope_min=self.cfg.params.attribute_minimums["slope"], device=self.device
        )
        entry = NetworkEntry(
            name=name,
            rd=rd,
            forcing=forcing,
            horizon=int(horizon),
            network=network,
            channels=channels,
            gauge_index=gauge_index,
            attrs=torch.as_tensor(
                np.asarray(rd.normalized_spatial_attributes, np.float32), device=self.device
            ),
            flow_scale=None if rd.flow_scale is None else torch.as_tensor(
                np.asarray(rd.flow_scale, np.float32), device=self.device
            ),
            engine=_engine_kind(network),
        )
        with self._lock:
            if name in self._networks:
                raise ValueError(f"network {name!r} is already registered")
            self._networks[name] = entry
            self._ready = False
        log.info(
            f"registered network {name!r}: {rd.n_segments} reaches, depth "
            f"{network.depth}, {engine_label(network)}, horizon {entry.horizon}h"
        )
        return entry

    def register_model(self, name: str, kan_model: torch.nn.Module, arch: dict | None = None,
                       source: str | None = None) -> ModelEntry:
        """Register a KAN under ``name`` (moved to the service's device, in
        eval mode); ``arch`` guards its checkpoint reloads."""
        with self._lock:
            self._ready = False
        entry = self.registry.register(name, kan_model.to(self.device), arch=arch, source=source)
        self.metrics.get("ddr_model_version").set(entry.version, model=name)
        return entry

    def unregister_model(self, name: str) -> None:
        """Unload a model: drop its registry entry and checkpoint watchers,
        shed its queued requests (``model-unloaded``; a batch in flight
        finishes on its snapshot), and drop its ``ddr_model_version``
        series. Other pairs stay warm."""
        self.registry.unregister(name)  # raises KeyError on unknown names
        self._batcher.purge(lambda r: r.key[1] == name, "model-unloaded")
        self.metrics.get("ddr_model_version").remove(model=name)
        log.info(f"unregistered model {name!r}")

    def watch_checkpoints(self, name: str, directory, poll_s: float | None = None):
        """Hot-reload ``name`` from the newest checkpoint under ``directory``
        (ServeConfig ``reload_poll_s`` cadence; 0 disables). Each applied
        reload bumps ``ddr_hot_reloads_total`` and ``ddr_model_version``."""
        poll = self.serve_cfg.reload_poll_s if poll_s is None else poll_s
        if poll <= 0:
            log.info("checkpoint watching disabled (reload_poll_s <= 0)")
            return None

        def _on_reload(entry: ModelEntry) -> None:
            self.metrics.get("ddr_hot_reloads_total").inc(model=entry.name)
            self.metrics.get("ddr_model_version").set(entry.version, model=entry.name)

        return self.registry.watch(name, directory, poll_s=poll, on_reload=_on_reload)

    # ---- warmup / readiness ----

    @property
    def ready(self) -> bool:
        return self._ready

    @property
    def warmup_error(self) -> str | None:
        """The failure of the last :meth:`warmup`, or None: ``/readyz`` tells
        this terminal state (503 ``warmup-failed``) from still warming."""
        return self._warmup_error

    def networks(self) -> dict[str, NetworkEntry]:
        with self._lock:
            return dict(self._networks)

    def warmup(self) -> None:
        """Run every (network, model) pair once on a zero batch, so the first
        request does not pay for the kernel build. A raising warmup is
        recorded on :attr:`warmup_error` and re-raised."""
        pairs = [(net, name) for net in self.networks().values() for name in self.registry.names()]
        if not pairs:
            raise RuntimeError("nothing to warm: register a network and a model first")
        self._warmup_error = None  # a retry presents as warming
        try:
            for net, name in pairs:
                with span(f"serve-warmup/{net.name}/{name}"):
                    t0 = time.perf_counter()
                    zeros = np.zeros((self.serve_cfg.max_batch, net.horizon, net.n_segments), np.float32)
                    self._run_batch(net, self.registry.get(name), zeros, warmup=True)
                log.info(f"warmed ({net.name}, {name}) in {time.perf_counter() - t0:.2f}s")
        except BaseException as e:
            self._warmup_error = f"{type(e).__name__}: {e}"
            raise
        with self._lock:
            self._ready = True

    # ---- request path ----

    def submit(
        self,
        network: str,
        model: str = "default",
        q_prime: Any | None = None,
        t0: int | None = None,
        gauges: Any | None = None,
        deadline_s: float | None = None,
        request_id: str | None = None,
        trace_id: str | None = None,
        priority: str | None = None,
    ) -> Future:
        """Admit one forecast request; returns its Future.

        Exactly one of ``q_prime`` (a ``(horizon, N)`` payload) or ``t0`` (an
        hourly offset into the registered forcing; default 0) selects the
        inflow window. ``gauges`` picks output columns (default all).
        ``request_id`` is sanitised (:func:`make_request_id`) or minted;
        ``trace_id`` is adopted or minted when tracing is on; ``priority`` is
        the request's class (default ``batch``). Invalid requests raise here;
        a full queue raises :class:`QueueFullError`."""
        net = self._networks.get(network)
        if net is None:
            raise ValueError(f"unknown network {network!r}")
        self.registry.get(model)  # raises KeyError on unknown models
        qp, start, gauge_sel = request_window(net, network, q_prime, t0, gauges)
        deadline = time.monotonic() + (
            self.serve_cfg.deadline_s if deadline_s is None else float(deadline_s)
        )
        prio = DEFAULT_PRIORITY if priority is None else str(priority)
        priority_rank(prio)  # an unknown class is the caller's bug
        rid = make_request_id(request_id)
        # start: where the verification ledger's valid hours count from
        meta = {"network": network, "model": model, "request_id": rid, "t0": start}
        if trace_enabled():
            meta["trace_id"] = adopt_trace_id(trace_id)
            meta["span_id"] = new_span_id()
        req = ForecastRequest(
            key=(network, model),
            payload={"q_prime": qp, "gauges": gauge_sel},
            deadline=deadline,
            meta=meta,
            priority=prio,
        )
        try:
            self._batcher.submit(req)
        except QueueFullError as e:
            e.request_id = rid  # error bodies echo the id the caller sent
            self._emit("serve_shed", reason="queue-full", policy=self.serve_cfg.backpressure,
                       network=network, model=model, request_id=rid, priority=prio, age_s=0.0,
                       **_trace_fields(req))
            # queue_s None: a rejected arrival never queued
            self._emit("serve_request", status="shed:queue-full", network=network, model=model,
                       request_id=rid, priority=prio, latency_s=0.0, queue_s=None, slo_ok=False,
                       **_trace_fields(req))
            self._observe_slo(False)
            raise
        return req.future

    def forecast(self, timeout: float | None = None, **kwargs) -> dict:
        """Blocking wrapper over :meth:`submit`."""
        return self.submit(**kwargs).result(timeout=timeout)

    def ensemble_forecast(self, **kwargs) -> dict:
        """One E-member ensemble forecast
        (:meth:`~ddr_tpu_torch.fleet.ensemble.EnsembleRunner.forecast`):
        percentile hydrographs and the worst gauges over all members. Takes
        :meth:`submit`'s request fields plus ``members``, ``percentiles`` and
        ``seed``, and runs on the caller's thread: an ensemble is a full
        batch of work and does not ride the micro-batcher. The runner is
        built on the first ensemble, as in the JAX service: a bad
        ``DDR_FLEET_*`` setting refuses ensembles, not the service."""
        from ddr_tpu_torch.fleet.ensemble import EnsembleRunner

        with self._lock:
            if self._ensembles is None:
                self._ensembles = EnsembleRunner(self)
            runner = self._ensembles
        return runner.forecast(**kwargs)

    # ---- execution (batcher worker thread) ----

    def _engine_label(self, net: NetworkEntry) -> str:
        return f"{net.name}:{net.engine}"

    @staticmethod
    def _queue_seconds(r: ForecastRequest) -> float | None:
        """Admission-to-extraction wait, or None for a request that never left
        the queue."""
        if not r.extracted:
            return None
        return round(max(0.0, r.extracted - r.admitted), 6)

    def _run_batch(
        self, net: NetworkEntry, entry: ModelEntry, qp: np.ndarray,
        n_live: int | None = None, warmup: bool = False,
    ) -> tuple[np.ndarray, float | None]:
        """Route one padded ``(max_batch, horizon, N)`` batch through
        ``entry`` (one registry snapshot for the whole batch), its first
        ``n_live`` rows carrying requests (default all); returns the host
        ``(max_batch, horizon, n_outputs)`` runoff and, on a card, the batch's
        device milliseconds (CUDA events from upload to the last kernel,
        health stats included). Every batch but a warmup's feeds the health
        watchdog."""
        p = self.cfg.params
        on_card = self.device.type == "cuda"
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        with torch.no_grad():  # grad mode is per thread: set here, on the batcher's
            q = torch.from_numpy(qp).to(self.device)
            raw = entry.kan(net.attrs)
            phys = denormalize_spatial_parameters(
                raw, p.parameter_ranges, p.log_space_parameters, p.defaults, net.n_segments
            )
            q_raw = q
            if net.flow_scale is not None:
                q = q * net.flow_scale
            runoff = route(
                net.network, net.channels, phys, q, gauges=net.gauge_index,
                bounds=self.bounds, device=self.device,
            ).runoff
            health = None
            if self.health_cfg.enabled and not warmup:
                # pad rows carry no request: masking them keeps the residual
                # and q_min independent of batch occupancy
                live = torch.arange(qp.shape[0], device=self.device) < (
                    qp.shape[0] if n_live is None else n_live)
                health = compute_health(runoff, q_raw, row_mask=live)
                if self.health_cfg.top_k > 0:
                    widx, wscore = compute_output_worst(runoff, self.health_cfg.top_k, row_mask=live)
                    health = dataclasses.replace(health, worst_idx=widx, worst_score=wscore)
        if on_card:
            end.record()
        # the copy to the host waits for the batch: the one synchronisation,
        # where the answers leave for their clients
        out = runoff.cpu().numpy()
        if health is not None:
            self.watchdog.observe(health, network=net.name, model=entry.name,
                                  batch_size=int(qp.shape[0] if n_live is None else n_live))
        return out, (start.elapsed_time(end) if on_card else None)

    def _execute(self, key: tuple, reqs: list[ForecastRequest]) -> None:
        try:
            self._execute_inner(key, reqs)
        except BaseException as e:
            # the batcher fails the futures; every request still reaches a
            # terminal status in the metrics
            now = time.monotonic()
            for r in reqs:
                self._emit("serve_request", status=f"error:{type(e).__name__}",
                           network=r.meta.get("network"), model=r.meta.get("model"),
                           request_id=r.meta.get("request_id"), latency_s=round(now - r.admitted, 6),
                           queue_s=self._queue_seconds(r), slo_ok=False, **_trace_fields(r))
                self._observe_slo(False)
            raise

    def _execute_inner(self, key: tuple, reqs: list[ForecastRequest]) -> None:
        network_name, model_name = key
        if self._inject_execute is not None:
            # a crash here fails every future of the batch through _execute's
            # error path, which gives each request its terminal event
            self._inject_execute(network=network_name, model=model_name, size=len(reqs))
        net = self._networks[network_name]
        entry = self.registry.get(model_name)  # ONE snapshot for the whole batch
        mb = self.serve_cfg.max_batch
        qp = np.zeros((mb, net.horizon, net.n_segments), dtype=np.float32)
        for i, r in enumerate(reqs):
            qp[i] = r.payload["q_prime"]
        with span(f"serve-batch/{network_name}", emit=False):
            t0 = time.perf_counter()
            runoff, device_ms = self._run_batch(net, entry, qp, n_live=len(reqs))
            exec_s = round(time.perf_counter() - t0, 6)
        now = time.monotonic()
        engine = self._engine_label(net)
        # the metrics are written before any future resolves: a client that
        # scrapes right after its answer finds its own request counted
        # the batch span: a trace of its own, linked to its member requests' spans
        batch_ctx = SpanContext(new_trace_id(), new_span_id()) if trace_enabled() else None
        members = [ids for ids in (_trace_fields(r) for r in reqs) if ids]
        self._emit("serve_batch", network=network_name, model=model_name, engine=engine,
                   size=len(reqs), occupancy=round(len(reqs) / mb, 4), seconds=exec_s,
                   version=entry.version, queue_depth=reqs[0].meta.get("queue_depth"),
                   **(batch_ctx.ids() if batch_ctx is not None else {}),
                   **({"members": members} if batch_ctx is not None and members else {}))
        outs = []
        for i, r in enumerate(reqs):
            sel = r.payload["gauges"]
            out = runoff[i] if sel is None else runoff[i][:, sel]
            outs.append(out)
            good = self._slo_good(r, now)
            self._emit("serve_request", status="ok", network=network_name, model=model_name,
                       request_id=r.meta.get("request_id"), latency_s=round(now - r.admitted, 6),
                       queue_s=self._queue_seconds(r), execute_s=exec_s, version=entry.version,
                       n_gauges=int(out.shape[1]), slo_ok=good, **_trace_fields(r))
            self._observe_slo(good)
            if self.sentinel is not None:
                with self._sent_lock:
                    self._sent_lat.append(now - r.admitted)
        self._sentinel_sweep()
        # the ledger is fed before any future resolves: a client that posts
        # observations right after its answer finds its forecast joinable
        valids = [self._feed_verifier(network_name, model_name, r.meta.get("request_id"), r.meta.get("t0"),
                                      r.payload["gauges"], np.asarray(out)[None])
                  for r, out in zip(reqs, outs)]
        for r, out, vt in zip(reqs, outs, valids):
            if r.future.set_running_or_notify_cancel():
                r.future.set_result({
                    "runoff": out,
                    "network": network_name,
                    "model": model_name,
                    "version": entry.version,
                    "engine": engine,
                    "request_id": r.meta.get("request_id"),
                    "queue_s": self._queue_seconds(r),
                    "execute_s": exec_s,
                    **({"valid_times": vt} if vt is not None else {}),
                    **_trace_fields(r),
                    # the port's own: the batch's size and device ms, and the
                    # request's admission-to-answer seconds
                    "batch_size": len(reqs),
                    "device_ms": device_ms,
                    "latency_s": now - r.admitted,
                })

    # ---- observability / lifecycle ----

    def _on_shed(self, req: ForecastRequest, reason: str) -> None:
        self._emit("serve_shed", reason=reason, policy=self.serve_cfg.backpressure,
                   network=req.meta.get("network"), model=req.meta.get("model"),
                   request_id=req.meta.get("request_id"), priority=req.priority,
                   age_s=round(req.age(), 6), **_trace_fields(req))
        self._emit("serve_request", status=f"shed:{reason}", network=req.meta.get("network"),
                   model=req.meta.get("model"), request_id=req.meta.get("request_id"),
                   priority=req.priority, latency_s=round(req.age(), 6),
                   queue_s=self._queue_seconds(req), slo_ok=False, **_trace_fields(req))
        self._observe_slo(False)
        if self.sentinel is not None:
            with self._sent_lock:
                self._sent_lat.append(req.age())
        self._sentinel_sweep()

    # ---- SLO accounting ----

    def _slo_good(self, req: ForecastRequest, now: float) -> bool:
        """Whether a served request met the objective: answered within its
        deadline (a late answer is a miss even though it ran) and, when one is
        configured, within the latency ceiling."""
        if self.slo is None:
            return True
        if req.deadline is not None and now > req.deadline:
            return False
        ceiling = self.slo.cfg.latency_s
        return ceiling is None or (now - req.admitted) <= ceiling

    def _observe_slo(self, good: bool) -> None:
        """One terminal decision into the tracker; on a new time bucket (about
        once a second, not once a request) the gauges are mirrored and the
        alert evaluated. Never raises into a request."""
        if self.slo is None:
            return
        try:
            if self.slo.observe(good):
                self._slo_sweep()
        except Exception:
            log.exception("SLO accounting failed")

    def _slo_sweep(self) -> None:
        """Mirror the tracker onto the ``ddr_slo_*`` gauges and emit one
        ``slo`` event per fast-burn alert change. Also run from
        :meth:`stats`, so an alert on a replica gone idle still resolves."""
        slo = self.slo
        if slo is None:
            return
        try:
            att = slo.attainment()
            if att is not None:
                self.metrics.get("ddr_slo_attainment").set(att)
            burn_gauge = self.metrics.get("ddr_slo_burn_rate")
            for window, burn in slo.burn_rates().items():
                if burn is not None:
                    burn_gauge.set(burn, window=window)
            change = slo.check_alert()
            if change is not None:
                self._emit("slo", **change)
        except Exception:
            log.exception("SLO accounting failed")

    def _sentinel_sweep(self) -> dict | None:
        """Feed one sample of the serving signals (queue depth, shed rate,
        p99 latency since the last sweep) to the sentinel, at most once a
        ``DDR_SENTINEL_SWEEP_S``: detector baselines assume even sampling.
        Run from the batch worker and from :meth:`stats`, so an idle replica
        keeps sampling and its anomalies can resolve.

        With ``DDR_SENTINEL_FLAG_WATCHDOG=1``, ``DDR_SENTINEL_FLAG_AFTER``
        sweeps in a row with an anomaly firing flag the health watchdog
        (``anomaly:<signal>``), degrading ``/readyz`` as a violation streak
        does; the first quiet sweep clears it. Returns the sentinel's status,
        or None when it is off. Never raises into a request."""
        s = self.sentinel
        if s is None:
            return None
        try:
            now = time.monotonic()
            bstats = self._batcher.stats()
            with self._sent_lock:
                dt = now - self._sent_last_sweep
                if dt < s.config.sweep_s:
                    return s.status()
                self._sent_last_sweep = now
                self._sent_sweeps += 1
                lat = sorted(self._sent_lat)
                del self._sent_lat[:]
                shed = float(bstats.get("shed", 0))
                shed_rate = max(0.0, shed - self._sent_last_shed) / dt if dt > 0 else 0.0
                self._sent_last_shed = shed
            step = self._sent_sweeps
            s.observe("queue_depth", float(bstats.get("depth", 0)), step=step)
            s.observe("shed_rate", shed_rate, step=step)
            if lat:
                s.observe("serve_p99_s", lat[min(len(lat) - 1, int(0.99 * len(lat)))], step=step)
            active = s.active()
            cfg = s.config
            if cfg.flag_watchdog:
                with self._sent_lock:
                    self._sent_flag_streak = self._sent_flag_streak + 1 if active else 0
                    streak = self._sent_flag_streak
                    flagged = self._sent_flagged
                    should_flag = streak >= cfg.flag_after
                    self._sent_flagged = should_flag
                if should_flag:
                    self.watchdog.flag([f"anomaly:{sig}" for sig in active], source="sentinel", sweeps=streak)
                elif flagged:
                    self.watchdog.flag([])
            return s.status()
        except Exception:
            log.exception("sentinel sweep failed")
            return None

    def attach_skill_tracker(self, tracker: Any) -> None:
        """Attach a :class:`~ddr_tpu_torch.observability.skill.SkillTracker`
        whose rollup is ``stats()["skill"]`` (fed by whatever loop holds
        observations: data assimilation, a shadow evaluation)."""
        self._skill = tracker

    # ---- verification ----

    def attach_verifier(self, ledger: Any) -> None:
        """Attach a :class:`~ddr_tpu_torch.observability.verification.ForecastLedger`:
        every forecast from here on (single and ensemble) is recorded for the
        delayed observation join (``POST /v1/observe``), answers gain
        ``valid_times``, and the ledger's rollup is ``stats()["verification"]``."""
        self._verifier = ledger

    @property
    def verifier(self) -> Any:
        return self._verifier

    def _feed_verifier(self, network: str, model: str, request_id: str | None, start: int | None,
                       gauge_sel: np.ndarray | None, runoff_e: np.ndarray) -> list[int] | None:
        """Record one answered forecast, an ``(E, T, G)`` member stack (E = 1
        for a single forecast, whose CRPS is then the absolute error), with
        the attached ledger. Valid hours are ``issue + 1 + i``, the issue hour
        being the window's ``start``, or the clock's hour for a q_prime
        payload (``start`` None). Returns them, or None without a ledger.
        Never raises: the answer is already computed."""
        if self._verifier is None:
            return None
        try:
            issue = int(time.time() // 3600) if start is None else int(start)
            valid = [issue + 1 + i for i in range(int(runoff_e.shape[1]))]
            gids = ([str(int(g)) for g in gauge_sel] if gauge_sel is not None
                    else [str(j) for j in range(int(runoff_e.shape[2]))])
            self._verifier.record_forecast(network, model, request_id, issue, valid, gids, runoff_e)
            return valid
        except Exception:
            log.exception("verification ledger feed failed")
            return None

    def _emit(self, event: str, **payload) -> None:
        """One decision into the active run log, whose tee updates the live
        metrics registry; with no run log, into the registry directly (never
        both, so a decision counts once)."""
        rec = get_recorder()
        if rec is not None:
            rec.emit(event, **payload)
            return
        try:  # a metrics bug must never fail the batch worker's requests
            event_tee({"event": event, **payload}, self.metrics)
        except Exception:
            log.exception("serve metrics tee failed")

    def models_info(self) -> dict:
        """The ``/v1/models`` payload: version and source of each model.
        ``programs`` (the JAX service's XLA cost cards) is empty: the port
        has no XLA compile cache, and only ``ddr profile`` writes program
        cards."""
        return {
            entry.name: {"version": entry.version, "source": entry.source, "programs": {}}
            for entry in (self.registry.get(n) for n in self.registry.names())
        }

    def networks_info(self) -> dict:
        """The ``/v1/networks`` payload."""
        return {
            name: {
                "n_reaches": net.n_segments,
                "horizon": net.horizon,
                "engine": self._engine_label(net),
                "n_outputs": net.n_outputs,
            }
            for name, net in self.networks().items()
        }

    def status(self) -> dict:
        """The health watchdog's rollup: batches observed, violations,
        streaks, ``degraded``, the last reasons and worst output columns."""
        return self.watchdog.status()

    @property
    def degraded(self) -> bool:
        """True once the watchdog has seen ``bad_batches`` violating batches
        in a row (or a stall): the service answers, but its numbers are
        suspect."""
        return self.watchdog.degraded

    def stats(self) -> dict:
        """The ``/v1/stats`` payload, with the JAX service's keys. ``fleet``
        is the replica's identity in its group (None outside one), ``slo``
        the tracker's status, ``sentinel`` the performance sentinel's,
        ``skill`` and ``verification`` the attached tracker's and ledger's
        (None without one); ``compiles`` is None, the port having no XLA
        compile cache to count."""
        from ddr_tpu_torch.fleet.config import fleet_identity

        self._slo_sweep()  # an idle replica resolves a stale alert by polling
        sentinel = self._sentinel_sweep()  # and a stale anomaly episode
        return {
            "ready": self._ready,
            "warmup_error": self._warmup_error,
            "fleet": fleet_identity(),
            "config": {
                "max_batch": self.serve_cfg.max_batch,
                "queue_cap": self.serve_cfg.queue_cap,
                "batch_wait_s": self.serve_cfg.batch_wait_s,
                "deadline_s": self.serve_cfg.deadline_s,
                "backpressure": self.serve_cfg.backpressure,
            },
            "queue": self._batcher.stats(),
            "compiles": None,
            "health": self.watchdog.status(),
            "sentinel": sentinel,
            "skill": None if self._skill is None else self._skill.status(),
            "verification": None if self._verifier is None else self._verifier.status(),
            "slo": None if self.slo is None else self.slo.status(),
            "models": self.models_info(),
            "networks": self.networks_info(),
        }

    def close(self, drain: bool = True) -> None:
        """Stop the checkpoint watchers, then the batcher (``drain=True``
        serves what is queued first)."""
        self.registry.close()
        self._batcher.close(drain=drain)
        rec = get_recorder()
        if rec is not None:
            rec.merge_summary("serve", self.stats())
