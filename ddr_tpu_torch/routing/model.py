"""High-level routing model wrapper: the ``dmc`` facade and batch preparation.

The port of ``ddr_tpu/routing/model.py`` without its multi-device branch.
The wrapper owns nothing learnable: it turns a :class:`RoutingData` batch
into the network, channel state and gauge index on a device, denormalizes
KAN outputs to physical parameters, routes, and carries discharge state
across sequential batches.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geometry.trapezoidal import maximum
from ddr_tpu_torch.geodatazoo.dataclasses import RoutingData
from ddr_tpu_torch.routing.mc import (
    Bounds,
    ChannelState,
    GaugeIndex,
    RouteResult,
    denormalize,
    route,
)
from ddr_tpu_torch.routing.chunked import ChunkedNetwork, build_routing_network
from ddr_tpu_torch.routing.network import RiverNetwork, build_network
from ddr_tpu_torch.routing.stacked import StackedChunked

__all__ = [
    "denormalize_spatial_parameters",
    "dmc",
    "engine_label",
    "prepare_batch",
    "prepare_channels",
    "single_ring_wavefront",
]


def engine_label(network: Any) -> str:
    """The name of the engine a built network routes on, as the JAX package
    prints it: ``stacked-chunked-wavefront[K-band-scan]``,
    ``depth-chunked-wavefront[K-band]``, ``single-ring-wavefront`` or
    ``step``."""
    if isinstance(network, StackedChunked):
        return f"stacked-chunked-wavefront[{network.n_chunks}-band-scan]"
    if isinstance(network, ChunkedNetwork):
        return f"depth-chunked-wavefront[{network.n_chunks}-band]"
    if getattr(network, "wavefront", False):
        return "single-ring-wavefront"
    return "step"


def single_ring_wavefront(network: Any) -> bool:
    """Is ``network`` routed by the single-ring wavefront engine? The one
    predicate of the ``q_prime_permuted`` fast path: the batch preparation
    that permutes ``q_prime``'s columns by ``network.wf_perm`` on the host
    and the loss that tells ``route`` they arrive permuted both ask it, so
    they cannot disagree."""
    return isinstance(network, RiverNetwork) and bool(network.wavefront)


def prepare_channels(
    rd: RoutingData, slope_min: float, device: str | torch.device = "cuda"
) -> tuple[ChannelState, GaugeIndex | None]:
    """Channel state (slope clamped to its minimum, observed geometry when
    present) and the gauge index (None when every segment is an output)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def opt(a):
        return None if a is None or np.asarray(a).size == 0 else f32(a)

    channels = ChannelState(
        length=f32(rd.length),
        slope=maximum(f32(rd.slope), slope_min),
        x_storage=f32(rd.x),
        top_width_data=opt(rd.top_width),
        side_slope_data=opt(rd.side_slope),
    )
    gauges = None
    if rd.outflow_idx is not None and len(rd.outflow_idx) != rd.n_segments:
        gauges = GaugeIndex.from_ragged(rd.outflow_idx, device=dev)
    return channels, gauges


def prepare_batch(
    rd: RoutingData, slope_min: float, device: str | torch.device = "cuda",
    fused: bool | None = None, chunked: bool = True,
) -> tuple[RiverNetwork | StackedChunked, ChannelState, GaugeIndex | None]:
    """RoutingData -> (network, channel state, gauge index) on ``device``.
    By default the network is the one
    :func:`~ddr_tpu_torch.routing.chunked.build_routing_network` picks:
    single-ring where its caps fit, the stacked band frame for deeper or
    wider networks. An explicit ``fused``, or ``chunked=False``, builds a
    plain :class:`~ddr_tpu_torch.routing.network.RiverNetwork` with
    :func:`~ddr_tpu_torch.routing.network.build_network` (``fused``
    forwarded), which a deep network then routes on the step engine."""
    if fused is None and chunked:
        network = build_routing_network(
            rd.adjacency_rows, rd.adjacency_cols, rd.n_segments, device=device
        )
    else:
        network = build_network(rd.adjacency_rows, rd.adjacency_cols, rd.n_segments, fused=fused,
                                device=device)
    channels, gauges = prepare_channels(rd, slope_min, device=device)
    return network, channels, gauges


def denormalize_spatial_parameters(
    raw: dict[str, torch.Tensor],
    parameter_ranges: dict[str, list[float]],
    log_space_parameters: list[str],
    defaults: dict[str, float],
    n_segments: int,
) -> dict[str, torch.Tensor]:
    """Sigmoid [0,1] KAN outputs -> physical parameters; ``p_spatial`` falls
    back to its config default when not learned."""
    out = {
        name: denormalize(raw[name], tuple(parameter_ranges[name]), name in log_space_parameters)
        for name in ("n", "q_spatial")
    }
    if "p_spatial" in raw and "p_spatial" in parameter_ranges:
        out["p_spatial"] = denormalize(
            raw["p_spatial"],
            tuple(parameter_ranges["p_spatial"]),
            "p_spatial" in log_space_parameters,
        )
    else:
        out["p_spatial"] = torch.full(
            (n_segments,), float(defaults["p_spatial"]), dtype=torch.float32,
            device=raw["n"].device,
        )
    return out


class dmc:
    """Routing model facade: ``forward(routing_data, streamflow,
    spatial_parameters, carry_state)`` returns ``{"runoff": (G, T)}``,
    carrying the final discharge between sequential batches when
    ``carry_state=True``. :meth:`state_dict` / :meth:`load_state_dict` carry
    everything but the KAN (config, progress counters, discharge state)."""

    def __init__(self, cfg: Any, device: str | torch.device = "cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bounds = Bounds.from_config(cfg.params.attribute_minimums)
        self._discharge_t: torch.Tensor | None = None
        self.epoch = 0
        self.mini_batch = 0

    def set_progress_info(self, epoch: int, mini_batch: int) -> None:
        self.epoch = epoch
        self.mini_batch = mini_batch

    def state_dict(self) -> dict[str, Any]:
        """The wrapper's state: config, device, progress counters and the
        carried discharge (host numpy, or None)."""
        return {
            "cfg": self.cfg,
            "device": str(self.device),
            "epoch": self.epoch,
            "mini_batch": self.mini_batch,
            "discharge_t": (
                None if self._discharge_t is None else self._discharge_t.detach().cpu().numpy()
            ),
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Restore :meth:`state_dict` output; the bounds are rebuilt from the
        restored config."""
        self.cfg = state.get("cfg", self.cfg)
        self.device = resolve_device(state.get("device", self.device))
        self.epoch = int(state.get("epoch", 0))
        self.mini_batch = int(state.get("mini_batch", 0))
        self.bounds = Bounds.from_config(self.cfg.params.attribute_minimums)
        dq = state.get("discharge_t")
        self._discharge_t = (
            None if dq is None else torch.as_tensor(np.asarray(dq, np.float32), device=self.device)
        )

    def forward(
        self,
        routing_dataclass: RoutingData,
        streamflow: np.ndarray | torch.Tensor,
        spatial_parameters: dict[str, torch.Tensor],
        carry_state: bool = False,
    ) -> dict[str, torch.Tensor]:
        rd = routing_dataclass
        p = self.cfg.params
        network, channels, gauges = prepare_batch(
            rd, slope_min=p.attribute_minimums["slope"], device=self.device
        )
        params = denormalize_spatial_parameters(
            spatial_parameters, p.parameter_ranges, p.log_space_parameters, p.defaults,
            rd.n_segments,
        )
        if isinstance(streamflow, np.ndarray) and np.isnan(streamflow).any():
            raise ValueError("q_prime has NaN flows")
        q_prime = torch.as_tensor(streamflow, dtype=torch.float32, device=self.device)
        if rd.flow_scale is not None:
            fs = torch.as_tensor(np.asarray(rd.flow_scale, np.float32), device=self.device)
            q_prime = q_prime * fs[None, :]
        q_init = self._discharge_t if carry_state else None
        result: RouteResult = route(
            network, channels, params, q_prime, q_init=q_init, gauges=gauges,
            bounds=self.bounds, device=self.device,
        )
        self._discharge_t = result.final_discharge
        return {"runoff": result.runoff.T}

    __call__ = forward
