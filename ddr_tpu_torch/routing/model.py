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
from ddr_tpu_torch.geodatazoo.synthetic import RoutingData
from ddr_tpu_torch.routing.mc import (
    Bounds,
    ChannelState,
    GaugeIndex,
    RouteResult,
    denormalize,
    route,
)
from ddr_tpu_torch.routing.network import RiverNetwork, build_network

__all__ = [
    "denormalize_spatial_parameters",
    "dmc",
    "prepare_batch",
    "prepare_channels",
]


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
        slope=torch.clamp_min(f32(rd.slope), slope_min),
        x_storage=f32(rd.x),
        top_width_data=opt(rd.top_width),
        side_slope_data=opt(rd.side_slope),
    )
    gauges = None
    if rd.outflow_idx is not None and len(rd.outflow_idx) != rd.n_segments:
        gauges = GaugeIndex.from_ragged(rd.outflow_idx, device=dev)
    return channels, gauges


def prepare_batch(
    rd: RoutingData, slope_min: float, device: str | torch.device = "cuda"
) -> tuple[RiverNetwork, ChannelState, GaugeIndex | None]:
    """RoutingData -> (network, channel state, gauge index) on ``device``.
    Only single-ring networks route in this slice (``route`` raises
    otherwise)."""
    network = build_network(rd.adjacency_rows, rd.adjacency_cols, rd.n_segments, device=device)
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
    ``carry_state=True``."""

    def __init__(self, cfg: Any, device: str | torch.device = "cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bounds = Bounds.from_config(cfg.params.attribute_minimums)
        self._discharge_t: torch.Tensor | None = None

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
