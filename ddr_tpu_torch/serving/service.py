"""ForecastService: registered networks x models, served in padded batches.

The port of ``ddr_tpu/serving/service.py``'s request path. Per registered
``(network, model)`` pair the service runs one batched route

    (kan, q_prime (max_batch, horizon, N)) -> gauge runoff (max_batch, horizon, G)

as KAN -> denormalize -> batched ``route`` -> gauges. Requests are
zero-padded into the fixed batch slot, so a pair always runs the same
shapes; :meth:`ForecastService.warmup` builds the kernels and runs each pair
once before traffic. On a card the route goes through the CUDA wave-scan
kernel; the only synchronisation is the copy of a batch's answers back to the
host, where they go to clients.

Not in this slice: the health watchdog, SLO tracking, the performance
sentinel, the verification ledger, ensembles, the HTTP front, mesh mode,
checkpoint watching and program cards.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.routing.mc import Bounds, ChannelState, GaugeIndex, route
from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, prepare_batch
from ddr_tpu_torch.routing.network import RiverNetwork
from ddr_tpu_torch.serving.batcher import (
    ForecastRequest,
    MicroBatcher,
    QueueFullError,
    RequestShedError,
)
from ddr_tpu_torch.serving.config import ServeConfig

log = logging.getLogger(__name__)

__all__ = ["ForecastService", "NetworkEntry", "QueueFullError", "RequestShedError"]


@dataclasses.dataclass
class NetworkEntry:
    """One registered routing domain with its device-side structures."""

    name: str
    rd: Any  # RoutingData
    forcing: np.ndarray | None  # (T_total, N) hourly lateral inflow, or None
    horizon: int  # hourly steps per forecast
    network: RiverNetwork
    channels: ChannelState
    gauge_index: GaugeIndex | None  # None = full-domain outputs
    attrs: torch.Tensor  # (N, n_attrs) KAN input on the device
    flow_scale: torch.Tensor | None  # (N,) on the device

    @property
    def n_segments(self) -> int:
        return int(self.rd.n_segments)

    @property
    def n_outputs(self) -> int:
        return self.gauge_index.n_gauges if self.gauge_index is not None else self.n_segments


class ForecastService:
    """Batched forecast serving. Lifecycle: construct ->
    :meth:`register_network` / :meth:`register_model` -> :meth:`warmup` ->
    :meth:`submit` / :meth:`forecast` -> :meth:`close`."""

    def __init__(
        self,
        cfg: Any,
        serve_cfg: ServeConfig | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()
        self.bounds = Bounds.from_config(cfg.params.attribute_minimums)
        self._networks: dict[str, NetworkEntry] = {}
        self._models: dict[str, torch.nn.Module] = {}
        self._lock = threading.Lock()
        self._ready = False
        self._batcher = MicroBatcher(
            execute=self._execute,
            max_batch=self.serve_cfg.max_batch,
            queue_cap=self.serve_cfg.queue_cap,
            batch_wait_s=self.serve_cfg.batch_wait_s,
        )

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
        if not network.single_ring:
            raise NotImplementedError(
                f"network {name!r} (depth {network.depth}) needs the stacked band "
                "router, a later slice of the port"
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
        )
        with self._lock:
            if name in self._networks:
                raise ValueError(f"network {name!r} is already registered")
            self._networks[name] = entry
            self._ready = False
        log.info(
            f"registered network {name!r}: {rd.n_segments} reaches, depth "
            f"{network.depth}, horizon {entry.horizon}h"
        )
        return entry

    def register_model(self, name: str, kan_model: torch.nn.Module) -> None:
        """Register (or replace) a KAN under ``name``; it moves to the
        service's device and to eval mode."""
        kan_model = kan_model.to(self.device).eval()
        with self._lock:
            self._models[name] = kan_model
            self._ready = False

    @property
    def ready(self) -> bool:
        return self._ready

    def warmup(self) -> None:
        """Run every (network, model) pair once on a zero batch, so the first
        request does not pay for the kernel build."""
        with self._lock:
            pairs = [(net, name) for net in self._networks.values() for name in self._models]
        if not pairs:
            raise RuntimeError("nothing to warm: register a network and a model first")
        for net, name in pairs:
            t0 = time.perf_counter()
            zeros = np.zeros((self.serve_cfg.max_batch, net.horizon, net.n_segments), np.float32)
            self._run_batch(net, self._models[name], zeros)
            log.info(f"warmed ({net.name}, {name}) in {time.perf_counter() - t0:.2f}s")
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
    ) -> Future:
        """Admit one forecast request; returns its Future.

        Exactly one of ``q_prime`` (a ``(horizon, N)`` payload) or ``t0`` (an
        hourly offset into the registered forcing; default 0) selects the
        inflow window. ``gauges`` picks output columns (default all).
        Invalid requests raise here."""
        net = self._networks.get(network)
        if net is None:
            raise ValueError(f"unknown network {network!r}")
        if model not in self._models:
            raise KeyError(f"unknown model {model!r}")
        if q_prime is not None and t0 is not None:
            raise ValueError("pass q_prime or t0, not both")
        if q_prime is not None:
            qp = np.asarray(q_prime, dtype=np.float32)
            if qp.shape != (net.horizon, net.n_segments):
                raise ValueError(
                    f"q_prime must be ({net.horizon}, {net.n_segments}), got {qp.shape}"
                )
        else:
            if net.forcing is None:
                raise ValueError(f"network {network!r} has no registered forcing; send q_prime")
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
            if gauge_sel.size == 0 or gauge_sel.min() < 0 or gauge_sel.max() >= net.n_outputs:
                raise ValueError(f"gauges must be a non-empty subset of [0, {net.n_outputs})")
        deadline = time.monotonic() + (
            self.serve_cfg.deadline_s if deadline_s is None else float(deadline_s)
        )
        req = ForecastRequest(
            key=(network, model),
            payload={
                "q_prime": qp,
                "gauges": gauge_sel,
                "request_id": request_id or uuid.uuid4().hex[:16],
            },
            deadline=deadline,
        )
        self._batcher.submit(req)
        return req.future

    def forecast(self, timeout: float | None = None, **kwargs) -> dict:
        """Blocking wrapper over :meth:`submit`."""
        return self.submit(**kwargs).result(timeout=timeout)

    # ---- execution (batcher worker thread) ----

    def _run_batch(
        self, net: NetworkEntry, kan: torch.nn.Module, qp: np.ndarray
    ) -> tuple[np.ndarray, float | None]:
        """Route one padded ``(max_batch, horizon, N)`` batch; returns the host
        ``(max_batch, horizon, n_outputs)`` runoff and, on a card, the batch's
        device milliseconds (CUDA events from upload to the last kernel)."""
        p = self.cfg.params
        on_card = self.device.type == "cuda"
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        with torch.no_grad():
            q = torch.from_numpy(qp).to(self.device)
            raw = kan(net.attrs)
            phys = denormalize_spatial_parameters(
                raw, p.parameter_ranges, p.log_space_parameters, p.defaults, net.n_segments
            )
            if net.flow_scale is not None:
                q = q * net.flow_scale
            runoff = route(
                net.network, net.channels, phys, q, gauges=net.gauge_index,
                bounds=self.bounds, device=self.device,
            ).runoff
        if on_card:
            end.record()
        # the copy to the host waits for the batch: the one synchronisation,
        # where the answers leave for their clients
        out = runoff.cpu().numpy()
        return out, (start.elapsed_time(end) if on_card else None)

    def _execute(self, key: tuple, reqs: list[ForecastRequest]) -> None:
        network_name, model_name = key
        net = self._networks[network_name]
        kan = self._models[model_name]
        mb = self.serve_cfg.max_batch
        qp = np.zeros((mb, net.horizon, net.n_segments), dtype=np.float32)
        for i, r in enumerate(reqs):
            qp[i] = r.payload["q_prime"]
        t0 = time.perf_counter()
        runoff, device_ms = self._run_batch(net, kan, qp)
        execute_s = time.perf_counter() - t0
        now = time.monotonic()
        for i, r in enumerate(reqs):
            sel = r.payload["gauges"]
            out = runoff[i] if sel is None else runoff[i][:, sel]
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(
                    {
                        "runoff": out,
                        "network": network_name,
                        "model": model_name,
                        "request_id": r.payload["request_id"],
                        "batch_size": len(reqs),
                        "latency_s": now - r.admitted,
                        "execute_s": execute_s,
                        "device_ms": device_ms,
                    }
                )

    def stats(self) -> dict:
        return {"ready": self._ready, "queue": self._batcher.stats()}

    def close(self, drain: bool = True) -> None:
        self._batcher.close(drain=drain)
