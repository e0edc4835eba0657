"""Time-skewed wavefront routing engine with its analytic reverse-wavefront adjoint.

The port of ``ddr_tpu/routing/wavefront.py``'s single-ring engine. Reach ``i``
at longest-path level ``L(i)`` computes its timestep-``t`` value at wave
``w = t + L(i) + 1``, so the whole route is ``T + depth`` sequential waves
(:mod:`ddr_tpu_torch.routing.wave_kernel`) instead of ``T x depth`` steps.
Around the scan sit two skews: the inflow rows are sheared into wave order
before it and the solve values sheared back to time-major order after it.
Here each skew is one ``torch.gather`` with a per-column row start (the JAX
package splits it into static slices or a vmapped slice only to bound XLA's
compile time).

The backward is not autograd through the scan: :class:`AnalyticRoute` is the
JAX package's ``_analytic_route`` custom VJP. The adjoint of the recurrence
is itself a wavefront over the TRANSPOSED network run in reverse time
(``tau = T-1-t``, ``M(i) = depth - L(i)``): the adjoint of reach ``i`` at
timestep ``t`` is computable at reverse wave ``v = tau + M(i) + 1``. Its
only residual is the raw ``(T, n)`` solve; everything separable in ``t`` (the
MC chain and its ``q_prev`` derivative, the operand re-gathers, every mask
and hotstart coefficient, the per-edge propagation weights) runs as
vectorized ``(T, n)`` passes before the scan, which is left with one ring
gather, two edge-weighted sums and a ring write per wave
(:mod:`ddr_tpu_torch.routing.reverse_kernel`); the output adjoints (``q'``,
``q_init``, the per-reach operands) come from the un-skewed ``lam`` field
after it. Clamp subgradients follow JAX: 0.5 at a tie (:func:`_dmax`).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from ddr_tpu_torch.geometry.trapezoidal import maximum
from ddr_tpu_torch.routing.network import RiverNetwork
from ddr_tpu_torch.routing.reverse_kernel import reverse_scan, reverse_scan_reference
from ddr_tpu_torch.routing.wave_kernel import (
    ReachPhysics,
    physics_derivatives,
    physics_pullback,
    reach_operands,
    reduce_gathered,
    wave_scan,
    wave_scan_reference,
    with_operands,
)

__all__ = ["AnalyticRoute", "wavefront_route_core"]


def _skew_by_level_runs(src: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """``(B, S, C) -> (B, width, C)`` with ``out[:, r, c] = src[:, starts[c] + r, c]``."""
    B, _, C = src.shape
    rows = starts[None, :] + torch.arange(width, device=src.device)[:, None]
    return torch.gather(src, 1, rows.expand(B, width, C))


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


def _reverse_stream(a: torch.Tensor, levels: torch.Tensor, depth: int, n_waves: int) -> torch.Tensor:
    """Stream ``a (B, T, C)`` into the reverse wave schedule: row ``v-1``
    hands column ``c`` (of level ``levels[c]``) ``a[T - v + depth -
    levels[c]]``, zeros outside ``[0, T-1]``."""
    B, _, C = a.shape
    padded = torch.cat(
        [a.new_zeros(B, depth, C), a.flip(1), a.new_zeros(B, depth + 1, C)], dim=1
    )  # row r <-> a[T-1-(r-depth)]
    return _skew_by_level_runs(padded, levels, n_waves)


def _unskew_reverse(lams: torch.Tensor, level_p: torch.Tensor, depth: int, T: int) -> torch.Tensor:
    """Collect per-node reverse-wave emissions ``(B, W, n)`` back to
    time-major ``(B, T, n)``: node i's timestep ``t`` sits at row ``T - 1 -
    t + M(i)``."""
    return _skew_by_level_runs(lams, depth - level_p, T).flip(1)


def _dmax(x: torch.Tensor, lb: float) -> torch.Tensor:
    """d/dx of ``max(x, lb)`` under JAX's balanced-tie convention (0.5 at
    equality), the subgradient :func:`~ddr_tpu_torch.geometry.trapezoidal.maximum`
    gives under autograd."""
    return torch.where(x > lb, 1.0, torch.where(x < lb, 0.0, 0.5)).to(x.dtype)


def _shift_down(a: torch.Tensor) -> torch.Tensor:
    """``(B, T, C)``: row ``t`` of the result is row ``t - 1`` of ``a``, row 0 zeros."""
    return F.pad(a, (0, 0, 1, 0))[:, :-1]


class AnalyticRoute(torch.autograd.Function):
    """The single-ring wavefront route ``q' (B, T, n) -> raw (B, T, n)`` (wf
    order, pre-clamp) with the analytic reverse-wavefront adjoint.

    ``apply(qp_p, q_init, n, p_spatial, q_spatial, slope, length, x_storage,
    network, physics, kernel)``: the tensors are the differentiable inputs
    (``q_init`` ``(B, n)`` or None; the per-reach operands ``(n,)`` in wf
    order); ``physics`` supplies the bounds and the timestep. The forward runs
    :func:`~ddr_tpu_torch.routing.wave_kernel.wave_scan` and saves only
    ``raw``; the backward runs
    :func:`~ddr_tpu_torch.routing.reverse_kernel.reverse_scan`.
    ``kernel="reference"`` runs both scans' plain versions on any device.
    """

    @staticmethod
    def forward(ctx, qp_p, q_init, n_mann, p_spatial, q_spatial, slope, length, x_storage,
                network: RiverNetwork, physics: ReachPhysics, kernel):
        ops = (n_mann, p_spatial, q_spatial, slope, length, x_storage)
        phys = with_operands(physics, ops)
        _, T, _ = qp_p.shape
        level_p = network.level_p.long()
        qs = _input_skews(qp_p, level_p, network.depth, T).contiguous()
        scan = wave_scan_reference if kernel == "reference" else wave_scan
        with record_function("ddr::forward_scan"):
            ys = scan(qs, network, phys, q_init, T=T)
        del qs
        # x_t[i] was emitted at wave t + L(i) + 1, i.e. ys row t + L(i)
        raw = _skew_by_level_runs(ys, level_p, T)
        ctx.network, ctx.physics, ctx.kernel = network, physics, kernel
        ctx.has_init = q_init is not None
        ctx.save_for_backward(raw, qp_p, q_init if q_init is not None else raw.new_zeros(0), *ops)
        return raw

    @staticmethod
    def backward(ctx, raw_bar):
        raw, qp_p, q_init, *ops = ctx.saved_tensors
        network, kernel, has_init = ctx.network, ctx.kernel, ctx.has_init
        phys = with_operands(ctx.physics, ops)
        lb = phys.bounds.discharge
        B, T, n = raw.shape
        depth, tw = network.depth, network.wf_t_width
        level_p = network.level_p.long()
        buckets = network.wf_buckets
        n_deg0 = buckets[0][0] if buckets else n
        wf_col = network.wf_col.long()
        t_col = network.wf_t_col.long()

        with record_function("ddr::adjoint_prepasses"):
            # re-gathers of the residual: N x_t (c1's operand) and the clamped
            # previous-timestep inflow sum (c2's operand)
            raw_pad = F.pad(raw, (0, 1))
            xpx = reduce_gathered(raw_pad[..., wf_col], network.wf_mask, buckets, n_deg0, lb, False, False)
            prev_pad = _shift_down(raw_pad)
            s_full = reduce_gathered(prev_pad[..., wf_col], network.wf_mask, buckets, n_deg0, lb, True, False)
            prev = prev_pad[..., :n]
            del raw_pad, prev_pad
            # the MC chain and its elementwise q_prev-derivative for all (t, i)
            # (row 0 is overwritten below: no physics on the hotstart diagonal)
            q_prev_all = maximum(prev, lb)  # max(x_{t-1}, lb)
            qpm1_all = _shift_down(qp_p)
            qpm1c = maximum(qpm1_all, lb)  # max(q'_{t-1}, lb)
            with record_function("ddr::adjoint_physics"):
                (c1, c2, c3, c4), (d1, d2, d3, d4) = physics_derivatives(q_prev_all, phys)
            # zc: transposed-solve weight (c1; hotstart c1_eff = 1 at t = 0, 0
            # with q_init since x_0 is then a leaf); uc: previous-timestep
            # inflow weight (c2, 0 at t = 0); ow: own-channel push; dm: the
            # clamp subgradient of x_{t-1} (0 at t = 0)
            zc = torch.cat([c1.new_full((B, 1, n), 0.0 if has_init else 1.0), c1[:, 1:]], dim=1)
            uc = F.pad(c2[:, 1:], (0, 0, 1, 0))
            dm_all = _dmax(prev, lb)
            dm_all[:, 0] = 0.0
            ow = dm_all * (d1 * xpx + d2 * s_full + d3 * q_prev_all + d4 * qpm1c + c3)
            del c1, c2, c3, d1, d2, d3, d4, prev
            # per-edge weight streams: slot (i, k) carries successor j's weight
            # at node i's in-flight timestep (pad slots read the zero column);
            # dm is folded into the inflow-adjoint edge stream
            zce = F.pad(zc, (0, 1))[..., t_col]
            duce = dm_all.repeat_interleave(tw, dim=-1) * F.pad(uc, (0, 1))[..., t_col]
            del uc, dm_all
            # ONE stacked reverse stream over [gbar | ow | zce | duce] columns
            with record_function("ddr::adjoint_stream"):
                levels = torch.cat([level_p, level_p, level_p.repeat_interleave(tw),
                                    level_p.repeat_interleave(tw)])
                rows_s = _reverse_stream(
                    torch.cat([raw_bar.to(raw.dtype), ow, zce, duce], dim=-1), levels, depth, T + depth
                ).contiguous()
            del ow, zce, duce, levels

        scan = reverse_scan_reference if kernel == "reference" else reverse_scan
        with record_function("ddr::reverse_scan"):
            lams = scan(rows_s, network, T=T)
        del rows_s

        with record_function("ddr::adjoint_postpasses"):
            lam_all = _unskew_reverse(lams, level_p, depth, T)  # (B, T, n), raw incl. t = 0
            del lams
            # theta_bar: ONE pullback of the chain over the whole (T, n) batch
            # (row 0 zeroed: no physics on the hotstart diagonal)
            lam_th = lam_all.clone()
            lam_th[:, 0] = 0.0
            needs = ctx.needs_input_grad[2:8]
            with record_function("ddr::adjoint_pullback"):
                theta_bar = physics_pullback(
                    q_prev_all, phys,
                    (lam_th * xpx, lam_th * s_full, lam_th * q_prev_all, lam_th * qpm1c), needs,
                )
            del lam_th, xpx, s_full, q_prev_all, qpm1c
            qp_bar = q_init_bar = None
            if ctx.needs_input_grad[0]:
                # row t of qp_emit holds q'bar_{t-1}; zc * lam at t = 0 is the
                # hotstart q'_0 adjoint (b = q'_0 raw, c1_eff = 1)
                qp_coef = c4 * _dmax(qpm1_all, lb)
                qp_coef[:, 0] = 0.0
                qp_bar = F.pad((qp_coef * lam_all)[:, 1:], (0, 0, 0, 1))
                qp_bar[:, 0] += zc[:, 0] * lam_all[:, 0]
            if has_init and ctx.needs_input_grad[1]:
                q_init_bar = _dmax(q_init, lb) * lam_all[:, 0]
        return (qp_bar, q_init_bar, *theta_bar, None, None, None)


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
    ``runoff = max(raw, lb)``. Differentiable in ``q_prime``, ``q_init`` and
    the per-reach operands through :class:`AnalyticRoute`.

    ``kernel=None`` runs :func:`wave_scan` forward and :func:`reverse_scan`
    backward; ``"reference"`` runs their plain versions on any device.
    """
    if kernel not in (None, "reference"):
        raise ValueError(f"unknown kernel {kernel!r} (use None or 'reference')")
    single = q_prime.dim() == 2
    qp = q_prime[None] if single else q_prime
    B, _, n = qp.shape
    qp_p = qp.float()[..., network.wf_perm.long()]
    if q_init is not None:
        q_init = q_init.float().expand(B, n).contiguous()
    raw = AnalyticRoute.apply(qp_p, q_init, *reach_operands(physics), network, physics, kernel)
    runoff = maximum(raw, physics.bounds.discharge)
    final = runoff[:, -1]
    if single:
        return runoff[0], final[0], raw[0]
    return runoff, final, raw
