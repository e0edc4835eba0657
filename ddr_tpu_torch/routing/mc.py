"""Muskingum-Cunge routing: physics and the ``route`` entry point.

The port of ``ddr_tpu/routing/mc.py``. Per timestep the engines solve

    (I - diag(c1) N) Q_{t+1} = c2 * (N @ Q_t) + c3 * Q_t + c4 * Q'

either on the time-skewed wavefront schedule, differentiated by its analytic
reverse-wavefront adjoint (or by autograd through the plain scan): the
single-ring engine (:mod:`ddr_tpu_torch.routing.wavefront`) where its caps
fit, the stacked band router (:mod:`ddr_tpu_torch.routing.stacked`) for
deeper or wider networks
(:func:`~ddr_tpu_torch.routing.chunked.build_routing_network` picks), the
unrolled depth-chunked router (:mod:`ddr_tpu_torch.routing.chunked`) under an
explicit cell budget; or one timestep at a time on the step engine
(:func:`route_step`, the level-scheduled solve of
:mod:`ddr_tpu_torch.routing.solver`), which computes in its inputs' dtype:
the float64 oracle of the others, and the engine of networks without
wavefront tables. The wavefront engines run their history ring in fp32 or
bf16 (``dtype``); every engine can return the numerical-health stats of the
result (:mod:`ddr_tpu_torch.observability.health`).
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geometry.trapezoidal import clip, maximum, rdiv, trapezoidal_geometry
from ddr_tpu_torch.routing.network import RiverNetwork
from ddr_tpu_torch.routing.solver import fused_solve, solve_lower_triangular

__all__ = [
    "DT_SECONDS",
    "Bounds",
    "ChannelState",
    "GaugeIndex",
    "RouteResult",
    "band_ids",
    "celerity",
    "denormalize",
    "hotstart_discharge",
    "muskingum_coefficients",
    "reach_physics",
    "route",
    "route_step",
]

log = logging.getLogger(__name__)

DT_SECONDS = 3600.0  # hourly routing step


def band_ids(level: torch.Tensor, depth: int, n_bands: int) -> tuple[torch.Tensor, int]:
    """Level-band id per node for the spatial health attribution: the
    longest-path levels ``[0, depth]`` split into ``min(n_bands, depth + 1)``
    equal-width bands, the one band definition every engine shares. Returns
    ``(ids (N,) int32, effective band count)``."""
    nb = max(1, min(int(n_bands), int(depth) + 1))
    ids = torch.clamp_max((level.to(torch.int32) * nb) // (int(depth) + 1), nb - 1)
    return ids.to(torch.int32), nb


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
        """``(..., N) -> (..., G)``: :meth:`sum_groups` of the gauges' segments."""
        return self.sum_groups(q.index_select(-1, self.flat_idx))

    def sum_groups(self, picked: torch.Tensor) -> torch.Tensor:
        """``(..., K)`` values of the ``flat_idx`` segments -> ``(..., G)``
        sums, each gauge's terms added left to right on either device, so a
        step gives the same bits every time it runs (a resumed run must
        retrace its uninterrupted twin). On the CPU that is ``index_add_``;
        on a card ``index_add_`` adds with atomics in no fixed order, so the
        sum is ``segment_reduce`` over the gauges' contiguous runs of
        ``group_ids`` (:meth:`from_ragged` sorts them), one thread a sum."""
        if picked.device.type != "cuda":
            return picked.new_zeros(picked.shape[:-1] + (self.n_gauges,)).index_add_(-1, self.group_ids, picked)
        lengths = torch.bincount(self.group_ids, minlength=self.n_gauges)
        lengths = lengths.expand(picked.shape[:-1] + (self.n_gauges,)).contiguous()
        return torch.segment_reduce(picked, "sum", lengths=lengths, axis=picked.dim() - 1, unsafe=True)


@dataclasses.dataclass(frozen=True)
class RouteResult:
    """``runoff``: ``(..., T, G)`` gauge-aggregated or ``(..., T, N)``
    full-domain discharge; ``final_discharge``: ``(..., N)`` carry state;
    ``health``: the :class:`~ddr_tpu_torch.observability.health.HealthStats`
    of the result when asked for; ``reach_stats``: the engines' per-reach
    intermediate of the spatial attribution, which :func:`route` collapses
    into ``health`` and drops."""

    runoff: torch.Tensor
    final_discharge: torch.Tensor
    health: object = None
    reach_stats: object = None


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
    c = clip(geom["velocity"], bounds.velocity, 15.0) * (5.0 / 3.0)
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


def hotstart_discharge(network: RiverNetwork, q_prime_t0: torch.Tensor, discharge_lb: float,
                       permuted: bool = False) -> torch.Tensor:
    """Cold-start discharge: the solve ``(I - N) Q0 = q'_0`` (the topological
    accumulation of lateral inflows), clamped. ``permuted=True`` takes and
    returns the fused schedule's level-contiguous order. Differentiable."""
    ones = torch.ones_like(q_prime_t0)
    if permuted:
        q0 = fused_solve(network.level_starts, ones, q_prime_t0, network.pred, network.down)
    else:
        q0 = solve_lower_triangular(network, ones, q_prime_t0)
    return maximum(q0, discharge_lb)


def route_step(
    network: RiverNetwork,
    channels: ChannelState,
    n_mann: torch.Tensor,
    p_spatial: torch.Tensor,
    q_spatial: torch.Tensor,
    q_t: torch.Tensor,
    q_prime_t: torch.Tensor,
    bounds: Bounds,
    dt: float = DT_SECONDS,
    permuted: bool = False,
) -> torch.Tensor:
    """One Muskingum-Cunge step from ``q_t`` (``(..., N)``); ``q_prime_t``
    must already be clamped to the discharge bound. ``permuted=True`` takes
    every per-reach tensor in the fused schedule's order and solves there."""
    c = celerity(q_t, n_mann, p_spatial, q_spatial, channels, bounds)[0]
    c1, c2, c3, c4 = muskingum_coefficients(channels.length, c, channels.x_storage, dt)
    i_t = network.upstream_sum_perm(q_t) if permuted else network.upstream_sum(q_t)
    b = c2 * i_t + c3 * q_t + c4 * q_prime_t
    if permuted:
        q_t1 = fused_solve(network.level_starts, c1, b, network.pred, network.down)
    else:
        q_t1 = solve_lower_triangular(network, c1, b)
    return maximum(q_t1, bounds.discharge)


def _route_steps(network: RiverNetwork, channels: ChannelState, spatial_params: dict,
                 q_prime: torch.Tensor, q_init, gauges, bounds: Bounds, dt: float,
                 want_spatial: bool) -> RouteResult:
    """The step engine over ``q_prime`` ``(..., T, N)``: the hotstart (or
    ``q_init``), then ``T - 1`` :func:`route_step` calls, in the inputs'
    dtype. On a fused network every per-reach tensor is permuted once into
    the level-contiguous order and only the outputs are mapped back. With
    gauges the per-reach health reductions ride four ``(..., N)``
    accumulators, as the JAX scan carry does; without them they reduce the
    full field."""
    from ddr_tpu_torch.observability.health import assemble_reach_stats, compute_reach_stats

    dev, lb = q_prime.device, bounds.discharge

    def operand(a):
        return a if torch.is_tensor(a) else torch.as_tensor(a, dtype=q_prime.dtype, device=dev)

    n_mann, p_spatial, q_spatial = (operand(spatial_params[k]) for k in ("n", "p_spatial", "q_spatial"))
    permuted = network.fused
    inv = None
    if permuted:
        perm, inv = network.perm.long(), network.inv_perm.long()

        def by_perm(a):
            return a if a.dim() == 0 else a[..., perm]

        channels = channels.permuted(perm)
        n_mann, p_spatial, q_spatial = by_perm(n_mann), by_perm(p_spatial), by_perm(q_spatial)
        q_prime = q_prime[..., perm]
        q_init = None if q_init is None else q_init[..., perm]
        if gauges is not None:
            gauges = dataclasses.replace(gauges, flat_idx=inv[gauges.flat_idx])

    if q_init is None:
        q = hotstart_discharge(network, q_prime[..., 0, :], lb, permuted=permuted)
    else:
        q = maximum(q_init, lb).expand(q_prime[..., 0, :].shape)

    def emit(x):
        return gauges.aggregate(x) if gauges is not None else x

    carry = want_spatial and gauges is not None
    if carry:
        big = torch.finfo(q.dtype).max
        qd = q.detach()
        fin = torch.isfinite(qd)
        acc = [(~fin).to(torch.int32), torch.where(fin, qd, big), torch.where(fin, qd, -big),
               torch.where(fin, qd, 0.0)]
    outs = [emit(q)]
    for t in range(q_prime.shape[-2] - 1):
        q = route_step(network, channels, n_mann, p_spatial, q_spatial, q,
                       maximum(q_prime[..., t, :], lb), bounds, dt, permuted=permuted)
        outs.append(emit(q))
        if carry:
            qd = q.detach()
            fin = torch.isfinite(qd)
            acc = [acc[0] + (~fin).to(torch.int32), torch.minimum(acc[1], torch.where(fin, qd, big)),
                   torch.maximum(acc[2], torch.where(fin, qd, -big)), acc[3] + torch.where(fin, qd, 0.0)]
    runoff = torch.stack(outs, dim=-2)
    reach = None
    if carry:
        lead = tuple(range(q.dim() - 1))  # a batch reduces like time
        nf, qmin, qmax, qsum = acc
        if lead:
            nf, qmin, qmax, qsum = nf.sum(lead, dtype=torch.int32), qmin.amin(lead), qmax.amax(lead), qsum.sum(lead)
        reach = assemble_reach_stats(nf, qmin, qmax, qsum, q_prime, inv=inv, q_prime_inv=inv)
    if permuted:
        q = q[..., inv]
        if gauges is None:
            runoff = runoff[..., inv]
    if want_spatial and gauges is None:
        reach = compute_reach_stats(runoff, q_prime, q_prime_inv=inv)
    return RouteResult(runoff=runoff, final_discharge=q, reach_stats=reach)


def route(
    network,
    channels: ChannelState,
    spatial_params: dict[str, torch.Tensor],
    q_prime: torch.Tensor,
    q_init: torch.Tensor | None = None,
    gauges: GaugeIndex | None = None,
    bounds: Bounds = Bounds(),
    dt: float = DT_SECONDS,
    engine: str | None = None,
    kernel: str | None = None,
    device: str | torch.device = "cuda",
    adjoint: str | None = None,
    remat_physics: bool = True,
    dtype: str = "fp32",
    collect_health: bool = False,
    health_bands: int = 0,
    health_topk: int = 8,
    q_prime_permuted: bool = False,
) -> RouteResult:
    """Route lateral inflows through the network over a full time window.

    ``q_prime`` is time-major ``(T, N)`` or a batch ``(B, T, N)`` that shares
    the network, channels and ``spatial_params`` (``{"n", "q_spatial",
    "p_spatial"}``, each ``(N,)`` or a scalar). ``q_init`` (``(N,)`` or
    ``(B, N)``) carries state across sequential windows; ``None`` hotstarts
    from ``q_prime[0]``. ``output[0]`` is the clamped initial state and step t
    consumes ``q_prime[t-1]``. ``gauges`` aggregates the output columns;
    ``None`` returns every reach.

    ``network`` picks the engine, as in the JAX package: a
    :class:`~ddr_tpu_torch.routing.stacked.StackedChunked` routes through
    :func:`~ddr_tpu_torch.routing.stacked.route_stacked`, a
    :class:`~ddr_tpu_torch.routing.chunked.ChunkedNetwork` through
    :func:`~ddr_tpu_torch.routing.chunked.route_chunked` (both: ``engine``
    ``None`` or ``"wavefront"``); a
    :class:`~ddr_tpu_torch.routing.network.RiverNetwork` on the wavefront
    engine where it carries the tables (``engine=None`` picks it), else on
    the step engine (``engine="step"``), which computes in the inputs'
    dtype and also routes networks of depth 0. When ``engine=None`` sends a
    network of depth > 0 to the step engine (one level-scheduled solve a
    timestep, no kernel: orders of magnitude slower than the wavefront
    engines on a deep network), a warning names the engine and how to reach
    a wavefront one.

    ``kernel`` selects the wavefront engines' scans: ``None`` runs
    :func:`~ddr_tpu_torch.routing.wave_kernel.wave_scan` forward and
    :func:`~ddr_tpu_torch.routing.reverse_kernel.reverse_scan` backward (the
    CUDA kernels on a card, their plain versions on the CPU), ``"reference"``
    the plain PyTorch versions on any device (a yardstick, never the main
    path). The step engine has no kernel: both are accepted there.

    ``adjoint`` selects the wavefront engines' backward: ``"analytic"`` (the
    default where ``None``) is the reverse-wavefront adjoint on the kernels,
    ``"ad"`` autograd through the plain forward scan, which on CUDA tensors
    needs ``kernel="reference"`` (the CUDA kernel has no autograd rule, and
    no fallback hides that). ``remat_physics`` recomputes the per-wave MC
    chain in the AD backward instead of storing it. The step engine
    differentiates through its solver, so an explicit ``adjoint`` there
    raises.

    ``dtype="bf16"`` stores the wavefront scans' history ring in bfloat16
    (bf16-compute / fp32-accumulate: one rounding point a wave, at the ring
    store; every sum and the backward in fp32); the step engine raises on
    it. An unknown dtype raises.

    ``collect_health=True`` adds ``RouteResult.health``: non-finite counts,
    discharge extrema and the mass residual over ``runoff``, ``q_prime`` and
    the final discharge, with the bf16 ``overflow``/``ulp_drift`` counters
    under ``dtype="bf16"``. ``health_bands > 0`` adds the per-level-band
    reductions and the top-``health_topk`` worst reaches (original order),
    from per-reach reductions over the full-domain solve (time, and the
    batch where there is one). The stats are device tensors: reading them
    is the caller's synchronisation.

    ``q_prime_permuted=True`` declares that ``q_prime``'s columns are already
    in ``network.wf_perm`` order (permuted on the host while the batch was
    prepared), so the single-ring wavefront engine skips its one gather of
    the inflow; any other engine raises on it.

    Inputs must lie on ``device`` (default ``"cuda"``; raises without a card).
    """
    from ddr_tpu_torch.routing.chunked import ChunkedNetwork, route_chunked
    from ddr_tpu_torch.routing.stacked import StackedChunked, route_stacked
    from ddr_tpu_torch.routing.wave_kernel import validate_dtype
    from ddr_tpu_torch.routing.wavefront import wavefront_route_core

    if adjoint not in (None, "analytic", "ad"):
        raise ValueError(f"unknown adjoint {adjoint!r} (use 'analytic', 'ad', or None)")
    if kernel not in (None, "reference"):
        raise ValueError(f"unknown kernel {kernel!r} (use None or 'reference')")
    validate_dtype(dtype)
    dev = resolve_device(device)
    banded = isinstance(network, (StackedChunked, ChunkedNetwork))
    level = network.orig_level if isinstance(network, StackedChunked) else network.level
    tensors = [level, q_prime, *spatial_params.values(), channels.length]
    if q_init is not None:
        tensors.append(q_init)
    for t in tensors:
        if torch.is_tensor(t) and t.device.type != dev.type:
            raise ValueError(f"route on {dev} got a tensor on {t.device}")
    # networks with an empty level field (no reaches) have no band health
    want_spatial = collect_health and health_bands > 0 and int(level.shape[0]) == network.n

    def finish(result: RouteResult) -> RouteResult:
        if not collect_health:
            return result
        from ddr_tpu_torch.observability.health import compute_band_health, compute_health

        health = compute_health(result.runoff, q_prime, final_discharge=result.final_discharge,
                                compute_dtype=dtype)
        if result.reach_stats is not None:
            ids, nb = band_ids(level, network.depth, health_bands)
            health = dataclasses.replace(health, **compute_band_health(
                result.reach_stats, ids, nb, top_k=health_topk, compute_dtype=dtype))
        return dataclasses.replace(result, health=health, reach_stats=None)

    if q_prime_permuted and banded:
        raise ValueError(f"q_prime_permuted is not supported on a {type(network).__name__}")
    if banded:
        if engine not in (None, "wavefront"):
            raise ValueError(f"a {type(network).__name__} always routes via its banded wavefront")
        router = route_stacked if isinstance(network, StackedChunked) else route_chunked
        return finish(router(network, channels, spatial_params, q_prime, q_init=q_init,
                             gauges=gauges, bounds=bounds, dt=dt, kernel=kernel, dtype=dtype,
                             adjoint=adjoint or "analytic", remat_physics=remat_physics,
                             collect_reach_stats=want_spatial))

    if engine is None:
        engine = "wavefront" if network.wavefront else "step"
        if engine == "step" and network.depth > 0:
            log.warning(
                f"route: a network of depth {network.depth} without wavefront tables routes on "
                "the step engine (one level-scheduled solve a timestep, no kernel); build it with "
                "build_routing_network for a wavefront engine, or pass engine='step'"
            )
    if q_prime_permuted and engine != "wavefront":
        raise ValueError("q_prime_permuted is only valid with the wavefront engine")
    if engine == "step":
        if adjoint is not None:
            raise ValueError(
                "adjoint applies to the wavefront routing family; the step engine "
                "differentiates through its own triangular-solve backward"
            )
        if dtype != "fp32":
            raise ValueError(
                "dtype='bf16' applies to the wavefront routing family; the step engine "
                "computes in its inputs' dtype"
            )
        return finish(_route_steps(network, channels, spatial_params, q_prime, q_init, gauges,
                                   bounds, dt, want_spatial))
    if engine != "wavefront":
        raise ValueError(f"unknown engine {engine!r} (use 'wavefront' or 'step')")
    if not network.wavefront:
        raise ValueError("network was built without wavefront tables")

    perm = network.wf_perm.long()
    inv = network.wf_inv.long()
    physics = reach_physics(network, channels, spatial_params, bounds, dt)
    q_init_p = None if q_init is None else q_init[..., perm]
    runoff_p, final_p, _ = wavefront_route_core(
        network, physics, q_prime, q_init_p, kernel=kernel, dtype=dtype,
        adjoint=adjoint or "analytic", remat_physics=remat_physics,
        q_prime_permuted=q_prime_permuted,
    )
    reach = None
    if want_spatial:
        from ddr_tpu_torch.observability.health import compute_reach_stats

        # runoff_p is the full-domain clamped solve in wf order; one gather
        # each puts the reductions back on the original axis
        reach = compute_reach_stats(runoff_p, q_prime, compute_dtype=dtype, runoff_inv=inv,
                                    q_prime_inv=inv if q_prime_permuted else None)
    if gauges is not None:
        gauges_p = dataclasses.replace(gauges, flat_idx=inv[gauges.flat_idx])
        runoff = gauges_p.aggregate(runoff_p)
    else:
        runoff = runoff_p[..., inv]
    return finish(RouteResult(runoff=runoff, final_discharge=final_p[..., inv], reach_stats=reach))
