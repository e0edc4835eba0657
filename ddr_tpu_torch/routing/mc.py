"""Muskingum-Cunge routing: physics and the ``route`` entry point.

The port of ``ddr_tpu/routing/mc.py`` for the serving path. Per timestep the
engine solves

    (I - diag(c1) N) Q_{t+1} = c2 * (N @ Q_t) + c3 * Q_t + c4 * Q'

on the time-skewed wavefront schedule (:mod:`ddr_tpu_torch.routing.wavefront`),
the only engine of this slice. Networks the single ring cannot carry go to
the JAX package's stacked band router, which is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geometry.trapezoidal import rdiv, trapezoidal_geometry
from ddr_tpu_torch.routing.network import RiverNetwork

__all__ = [
    "DT_SECONDS",
    "Bounds",
    "ChannelState",
    "GaugeIndex",
    "RouteResult",
    "celerity",
    "denormalize",
    "muskingum_coefficients",
    "reach_physics",
    "route",
]

DT_SECONDS = 3600.0  # hourly routing step


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Physical lower bounds (config ``attribute_minimums``)."""

    velocity: float = 0.3
    depth: float = 0.01
    discharge: float = 0.0001
    bottom_width: float = 0.1
    slope: float = 0.0001

    @classmethod
    def from_config(cls, attribute_minimums: dict[str, float]) -> "Bounds":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in attribute_minimums.items() if k in names})


@dataclasses.dataclass(frozen=True)
class ChannelState:
    """Static per-reach attributes, ``(N,)`` float32 tensors. ``slope`` is
    pre-clamped to its minimum. ``top_width_data`` / ``side_slope_data`` are
    observed-geometry overrides (NaN = derive); they do not enter celerity."""

    length: torch.Tensor
    slope: torch.Tensor
    x_storage: torch.Tensor
    top_width_data: torch.Tensor | None = None
    side_slope_data: torch.Tensor | None = None

    def permuted(self, perm: torch.Tensor) -> "ChannelState":
        def g(a):
            return None if a is None else a[perm]

        return ChannelState(
            length=self.length[perm],
            slope=self.slope[perm],
            x_storage=self.x_storage[perm],
            top_width_data=g(self.top_width_data),
            side_slope_data=g(self.side_slope_data),
        )


@dataclasses.dataclass(frozen=True)
class GaugeIndex:
    """Padded ragged gauge aggregation: discharge at gauge g is the sum of the
    segments ``flat_idx[group_ids == g]``."""

    flat_idx: torch.Tensor  # (K,) int64 segment indices
    group_ids: torch.Tensor  # (K,) int64 gauge id per entry
    n_gauges: int

    @classmethod
    def from_ragged(
        cls, outflow_idx: list[np.ndarray], device: str | torch.device = "cuda"
    ) -> "GaugeIndex":
        dev = resolve_device(device)
        flat = np.concatenate([np.asarray(i, dtype=np.int64) for i in outflow_idx])
        groups = np.repeat(np.arange(len(outflow_idx)), [len(i) for i in outflow_idx])
        return cls(
            flat_idx=torch.as_tensor(flat, device=dev),
            group_ids=torch.as_tensor(groups, dtype=torch.int64, device=dev),
            n_gauges=len(outflow_idx),
        )

    def aggregate(self, q: torch.Tensor) -> torch.Tensor:
        """``(..., N) -> (..., G)``: one ``index_add_`` over the last axis."""
        out = q.new_zeros(q.shape[:-1] + (self.n_gauges,))
        return out.index_add_(-1, self.group_ids, q.index_select(-1, self.flat_idx))


@dataclasses.dataclass(frozen=True)
class RouteResult:
    """``runoff``: ``(..., T, G)`` gauge-aggregated or ``(..., T, N)``
    full-domain discharge; ``final_discharge``: ``(..., N)`` carry state."""

    runoff: torch.Tensor
    final_discharge: torch.Tensor


def denormalize(
    value: torch.Tensor, bounds: tuple[float, float], log_space: bool = False
) -> torch.Tensor:
    """Map sigmoid [0,1] outputs onto physical parameter bounds, optionally
    through log space for right-skewed parameters."""
    lo, hi = bounds
    if log_space:
        # float32 constants and a float32 difference, as the JAX version has
        log_lo = np.float32(math.log(np.float32(lo + 1e-6)))
        log_hi = np.float32(math.log(np.float32(hi)))
        return torch.exp(value * float(log_hi - log_lo) + float(log_lo))
    return value * (hi - lo) + lo


def muskingum_coefficients(
    length: torch.Tensor,
    velocity: torch.Tensor,
    x_storage: torch.Tensor,
    dt: float = DT_SECONDS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Muskingum-Cunge c1..c4 from travel time ``k = L / c`` and storage
    weight ``x``."""
    k = length / velocity
    denom = 2.0 * k * (1.0 - x_storage) + dt
    c1 = (dt - 2.0 * k * x_storage) / denom
    c2 = (dt + 2.0 * k * x_storage) / denom
    c3 = (2.0 * k * (1.0 - x_storage) - dt) / denom
    c4 = rdiv(2.0 * dt, denom)
    return c1, c2, c3, c4


def _override(derived: torch.Tensor, data: torch.Tensor | None) -> torch.Tensor:
    """Observed data where valid, the derived value where NaN."""
    if data is None:
        return derived
    return torch.where(torch.isnan(data), derived, data)


def celerity(
    q_t: torch.Tensor,
    n: torch.Tensor,
    p_spatial: torch.Tensor,
    q_spatial: torch.Tensor,
    channels: ChannelState,
    bounds: Bounds,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kinematic wave celerity from Manning velocity over the trapezoid.

    Returns ``(celerity, top_width, side_slope)``; velocity is clamped to
    ``[velocity_lb, 15]`` m/s, then scaled by 5/3.
    """
    geom = trapezoidal_geometry(
        n=n,
        p_spatial=p_spatial,
        q_spatial=q_spatial,
        discharge=q_t,
        slope=channels.slope,
        depth_lb=bounds.depth,
        bottom_width_lb=bounds.bottom_width,
    )
    top_width = _override(geom["top_width"], channels.top_width_data)
    side_slope = _override(geom["side_slope"], channels.side_slope_data)
    c = torch.clamp(geom["velocity"], bounds.velocity, 15.0) * (5.0 / 3.0)
    return c, top_width, side_slope


def reach_physics(
    network: RiverNetwork,
    channels: ChannelState,
    spatial_params: dict[str, torch.Tensor],
    bounds: Bounds = Bounds(),
    dt: float = DT_SECONDS,
):
    """The wave scan's per-reach operands in ``network.wf_perm`` order: a
    :class:`~ddr_tpu_torch.routing.wave_kernel.ReachPhysics`. Scalar
    parameters broadcast to ``(N,)``."""
    from ddr_tpu_torch.routing.wave_kernel import ReachPhysics

    perm = network.wf_perm.long()
    n = network.n

    def per_reach(a):
        a = torch.as_tensor(a, dtype=torch.float32, device=network.device)
        return a.expand(n).contiguous() if a.dim() == 0 else a[perm]

    return ReachPhysics(
        n=per_reach(spatial_params["n"]),
        p_spatial=per_reach(spatial_params["p_spatial"]),
        q_spatial=per_reach(spatial_params["q_spatial"]),
        channels=channels.permuted(perm),
        bounds=bounds,
        dt=float(dt),
    )


def route(
    network: RiverNetwork,
    channels: ChannelState,
    spatial_params: dict[str, torch.Tensor],
    q_prime: torch.Tensor,
    q_init: torch.Tensor | None = None,
    gauges: GaugeIndex | None = None,
    bounds: Bounds = Bounds(),
    dt: float = DT_SECONDS,
    kernel: str | None = None,
    device: str | torch.device = "cuda",
) -> RouteResult:
    """Route lateral inflows through the network over a full time window.

    ``q_prime`` is time-major ``(T, N)`` or a batch ``(B, T, N)`` that shares
    the network, channels and ``spatial_params`` (``{"n", "q_spatial",
    "p_spatial"}``, each ``(N,)`` or a scalar). ``q_init`` (``(N,)`` or
    ``(B, N)``) carries state across sequential windows; ``None`` hotstarts
    from ``q_prime[0]``. ``output[0]`` is the clamped initial state and step t
    consumes ``q_prime[t-1]``. ``gauges`` aggregates the output columns;
    ``None`` returns every reach.

    ``kernel`` selects the wave scan: ``None`` runs
    :func:`~ddr_tpu_torch.routing.wave_kernel.wave_scan` (the CUDA kernel on a
    card, its plain version on the CPU), ``"reference"`` the plain PyTorch
    version on any device (a yardstick, never the serving path).

    Inputs must lie on ``device`` (default ``"cuda"``; raises without a card).
    """
    from ddr_tpu_torch.routing.wavefront import wavefront_route_core

    dev = resolve_device(device)
    if not network.single_ring:
        raise NotImplementedError(
            f"network (depth={network.depth}, n={network.n}) is not single-ring "
            "eligible; the stacked band router (route_stacked) that carries it "
            "is a later slice of the port"
        )
    tensors = [network.level, q_prime, *spatial_params.values(), channels.length]
    if q_init is not None:
        tensors.append(q_init)
    for t in tensors:
        if torch.is_tensor(t) and t.device.type != dev.type:
            raise ValueError(f"route on {dev} got a tensor on {t.device}")

    perm = network.wf_perm.long()
    inv = network.wf_inv.long()
    physics = reach_physics(network, channels, spatial_params, bounds, dt)
    q_init_p = None if q_init is None else q_init[..., perm]
    runoff_p, final_p, _ = wavefront_route_core(
        network, physics, q_prime, q_init_p, kernel=kernel
    )
    if gauges is not None:
        gauges_p = dataclasses.replace(gauges, flat_idx=inv[gauges.flat_idx])
        runoff = gauges_p.aggregate(runoff_p)
    else:
        runoff = runoff_p[..., inv]
    return RouteResult(runoff=runoff, final_discharge=final_p[..., inv])
