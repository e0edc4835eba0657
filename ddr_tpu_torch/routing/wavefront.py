"""Time-skewed wavefront routing engine, forward only.

The port of ``ddr_tpu/routing/wavefront.py`` for serving. Reach ``i`` at
longest-path level ``L(i)`` computes its timestep-``t`` value at wave
``w = t + L(i) + 1``, so the whole route is ``T + depth`` sequential waves
(:mod:`ddr_tpu_torch.routing.wave_kernel`) instead of ``T x depth`` steps.
Around the scan sit two skews: the inflow rows are sheared into wave order
before it and the solve values sheared back to time-major order after it.
Here each skew is one ``torch.gather`` with a per-column row start (the JAX
package splits it into static slices or a vmapped slice only to bound XLA's
compile time).

This slice has no backward: the analytic adjoint and its reverse-scan kernel
belong to the training slice, so inputs that require grad raise.
"""

from __future__ import annotations

import torch

from ddr_tpu_torch.routing.network import RiverNetwork
from ddr_tpu_torch.routing.wave_kernel import ReachPhysics, wave_scan, wave_scan_reference

__all__ = ["wavefront_route_core"]


def _skew_by_level_runs(src: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """``(B, S, N) -> (B, width, N)`` with ``out[:, r, c] = src[:, starts[c] + r, c]``."""
    B, _, N = src.shape
    rows = starts[None, :] + torch.arange(width, device=src.device)[:, None]
    return torch.gather(src, 1, rows.expand(B, width, N))


def _input_skews(qp_p: torch.Tensor, level_p: torch.Tensor, depth: int, T: int) -> torch.Tensor:
    """The wave-input skew of ``q'`` ``(B, T, N)``: wave row ``w-1`` hands
    node i ``q'[clip(t - 1, 0, T - 2)]`` for its timestep ``t = w - 1 -
    L(i)`` (row t=0 carries ``q'[0]``, the hotstart forcing)."""
    B, _, n = qp_p.shape
    right_edge = qp_p[:, T - 2 : T - 1] if T >= 2 else qp_p[:, :1]
    padded = torch.cat(
        [
            qp_p[:, :1].expand(B, depth + 1, n),
            qp_p[:, : T - 1],
            right_edge.expand(B, depth, n),
        ],
        dim=1,
    )  # (B, T + 2*depth, n); row r <-> q' index clip(r - (depth+1), 0, T-2)
    return _skew_by_level_runs(padded, depth - level_p, T + depth)


def wavefront_route_core(
    network: RiverNetwork,
    physics: ReachPhysics,
    q_prime: torch.Tensor,
    q_init: torch.Tensor | None,
    kernel: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route timesteps ``0..T-1`` by wavefront, entirely in ``wf_perm`` order.

    ``q_prime`` is ``(T, N)`` or ``(B, T, N)``; ``physics`` holds per-reach
    operands already in wf order, shared by the batch; ``q_init`` (wf order,
    ``(N,)`` or ``(B, N)``) carries state across windows, ``None`` hotstarts
    in-band from ``q_prime[0]``. Returns ``(runoff, final, raw)`` in wf order
    with ``q_prime``'s leading shape: ``raw`` is the pre-clamp solve value and
    ``runoff = max(raw, lb)``.

    ``kernel=None`` runs :func:`wave_scan`; ``"reference"`` runs
    :func:`wave_scan_reference` on any device.
    """
    if kernel not in (None, "reference"):
        raise ValueError(f"unknown kernel {kernel!r} (use None or 'reference')")
    grads = [q_prime, q_init, physics.n, physics.p_spatial, physics.q_spatial,
             physics.channels.length, physics.channels.slope, physics.channels.x_storage]
    if any(t is not None and t.requires_grad for t in grads):
        raise NotImplementedError(
            "the wavefront engine of this slice is forward-only; gradients (the "
            "analytic adjoint and its reverse-scan kernel) come with the training "
            "slice. Route under torch.no_grad() or detach the inputs."
        )
    single = q_prime.dim() == 2
    qp = q_prime[None] if single else q_prime
    B, T, n = qp.shape
    depth = network.depth
    level_p = network.level_p.long()
    qp_p = qp.float()[..., network.wf_perm.long()]
    if q_init is not None:
        q_init = q_init.float().expand(B, n).contiguous()

    qs = _input_skews(qp_p, level_p, depth, T).contiguous()
    scan = wave_scan_reference if kernel == "reference" else wave_scan
    ys = scan(qs, network, physics, q_init, T=T)
    # x_t[i] was emitted at wave t + L(i) + 1, i.e. ys row t + L(i)
    raw = _skew_by_level_runs(ys, level_p, T)
    runoff = torch.clamp_min(raw, physics.bounds.discharge)
    final = runoff[:, -1]
    if single:
        return runoff[0], final[0], raw[0]
    return runoff, final, raw
