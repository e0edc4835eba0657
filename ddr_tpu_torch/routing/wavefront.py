"""Time-skewed wavefront routing engine with its analytic reverse-wavefront adjoint.

The port of ``ddr_tpu/routing/wavefront.py``'s single-ring engine. Reach ``i``
at longest-path level ``L(i)`` computes its timestep-``t`` value at wave
``w = t + L(i) + 1``, so the whole route is ``T + depth`` sequential waves
(:mod:`ddr_tpu_torch.routing.wave_kernel`) instead of ``T x depth`` steps.
The JAX package shears the inflow rows into wave order before its scan and
the solve values back to time-major order after it, since a TPU block spec
wants whole rows. The port's scans are time-major
(:func:`~ddr_tpu_torch.routing.wave_kernel.wave_scan_tm`,
:func:`~ddr_tpu_torch.routing.reverse_kernel.reverse_scan_tm`): each reach
reads and writes its own timestep, so the analytic route has no skews. The
skews stay for ``adjoint="ad"``, which differentiates the pre-skewed plain
scan, and as the layout of the pre-skewed plain versions: each is one
``torch.gather`` with a per-column row index, clamped to the series and
masked outside it, so no padded copy of the series is made.

The same engine runs each band of the stacked band router
(:mod:`ddr_tpu_torch.routing.stacked`): a band is a table object with the
kernels' field names, external inflow rows ``x_ext``/``s_ext`` from earlier
bands, and masked raw sums (``mask_raw``), as the JAX band frame has them;
and each band of the unrolled depth-chunked router
(:mod:`ddr_tpu_torch.routing.chunked`), a network of its own with external
rows and unmasked raw sums.

The default backward is not autograd through the scan: :class:`AnalyticRoute`
is the JAX package's ``_analytic_route`` custom VJP (``adjoint="ad"``, autograd
through the plain scan, is its in-framework check: :func:`route_raw`). The adjoint of the recurrence
is itself a wavefront over the TRANSPOSED network run in reverse time
(``tau = T-1-t``, ``M(i) = depth - L(i)``): the adjoint of reach ``i`` at
timestep ``t`` is computable at reverse wave ``v = tau + M(i) + 1``. Its
only residual is the raw ``(T, n)`` solve; everything separable in ``t`` (the
MC chain and its ``q_prev`` derivative, the operand re-gathers, every mask
and hotstart coefficient, the per-edge propagation weights) runs as
vectorized ``(T, n)`` passes before the scan, which is left with one ring
gather, two edge-weighted sums and a ring write per wave
(:mod:`ddr_tpu_torch.routing.reverse_kernel`); the output adjoints (``q'``,
``q_init``, the per-reach operands) come from its time-major ``lam`` field
after it. Clamp subgradients follow JAX: 0.5 at a tie (:func:`_dmax`).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from ddr_tpu_torch.geometry.trapezoidal import maximum
from ddr_tpu_torch.routing.network import RiverNetwork
from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm, reverse_scan_tm_reference
from ddr_tpu_torch.routing.wave_kernel import (
    ReachPhysics,
    physics_derivatives,
    physics_pullback,
    reach_operands,
    reduce_gathered,
    validate_dtype,
    wave_scan_autograd,
    wave_scan_tm,
    wave_scan_tm_reference,
    with_operands,
)

__all__ = ["AnalyticRoute", "route_raw", "wavefront_route_core"]


def _skew(src: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """``(B, S, C) -> (B, R, C)`` with ``out[:, r, c] = src[:, rows[r, c], c]``,
    zero where ``valid[r, c]`` is false: one gather, no padded copy of ``src``."""
    out = torch.gather(src, 1, rows.expand(src.shape[0], *rows.shape))
    return out if valid is None else out.masked_fill_(~valid, 0.0)


def _skew_by_level_runs(src: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """``(B, S, C) -> (B, width, C)`` with ``out[:, r, c] = src[:, starts[c] + r, c]``."""
    return _skew(src, starts[None, :] + torch.arange(width, device=src.device)[:, None])


def _input_skews(qp_p: torch.Tensor, level_p: torch.Tensor, depth: int, T: int) -> torch.Tensor:
    """The wave-input skew of ``q'`` ``(B, T, N)``: wave row ``w-1`` hands
    node i ``q'[clip(t - 1, 0, T - 2)]`` for its timestep ``t = w - 1 -
    L(i)`` (row t=0 carries ``q'[0]``, the hotstart forcing)."""
    r = torch.arange(T + depth, device=qp_p.device)[:, None]
    return _skew(qp_p, (r - level_p[None, :] - 1).clamp(0, max(T - 2, 0)))


def _ext_skews(x_ext: torch.Tensor, s_ext: torch.Tensor, level_p: torch.Tensor, depth: int,
               T: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The wave-input skews of the external inflow series ``(B, T, N)``:
    wave row ``w-1`` hands node i ``a[t]`` for its timestep ``t = w - 1 -
    L(i)``, zero outside ``[0, T-1]``. One index serves both."""
    t = torch.arange(T + depth, device=x_ext.device)[:, None] - level_p[None, :]
    rows, valid = t.clamp(0, T - 1), (t >= 0) & (t < T)
    return _skew(x_ext, rows, valid), _skew(s_ext, rows, valid)


# The reverse wave schedule's layout: the streams of the pre-skewed plain
# reverse scan (reverse_kernel.reverse_scan_reference) and back.


def _reverse_index(levels: torch.Tensor, depth: int, T: int, n_waves: int):
    """``(rows, valid)`` of the reverse wave schedule: row ``v-1`` of column
    ``c`` (of level ``levels[c]``) reads timestep ``T - v + depth -
    levels[c]``, valid inside ``[0, T-1]``."""
    t = (T - 1 + depth) - torch.arange(n_waves, device=levels.device)[:, None] - levels[None, :]
    return t.clamp(0, T - 1), (t >= 0) & (t < T)


def _reverse_stream(a: torch.Tensor, levels: torch.Tensor, depth: int, n_waves: int) -> torch.Tensor:
    """Stream ``a (B, T, C)`` into the reverse wave schedule
    (:func:`_reverse_index`), zeros outside ``[0, T-1]``."""
    return _skew(a, *_reverse_index(levels, depth, a.shape[1], n_waves))


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
    """The wavefront route ``q' (B, T, n) -> raw (B, T, n)`` (wf or band-slot
    order, pre-clamp) with the analytic reverse-wavefront adjoint.

    ``apply(qp_p, q_init, x_ext, s_ext, n, p_spatial, q_spatial, slope,
    length, x_storage, network, physics, kernel, mask_raw, dtype)``: the tensors are
    the differentiable inputs (``q_init`` ``(B, n)`` or None; ``x_ext`` and
    ``s_ext`` ``(B, T, n)`` external inflow series, the raw same-timestep and
    the clamped previous-timestep sums of predecessors outside the table, or
    both None; the per-reach operands ``(n,)``). ``network`` is a
    :class:`~ddr_tpu_torch.routing.network.RiverNetwork` or a band of a
    stacked frame (:class:`~ddr_tpu_torch.routing.stacked.BandTables`);
    ``physics`` supplies the bounds and the timestep; ``mask_raw`` masks the
    raw predecessor sums, as the band frame does. The forward runs
    :func:`~ddr_tpu_torch.routing.wave_kernel.wave_scan_tm` with its ring in
    ``dtype`` (``"fp32"`` or ``"bf16"``) and saves only ``raw`` besides the
    inputs: under bf16 that is the rounded series upcast, what the ring
    held. The backward runs
    :func:`~ddr_tpu_torch.routing.reverse_kernel.reverse_scan_tm`, always in
    fp32 over that residual, as the JAX backward does
    (``ddr_tpu/routing/wavefront.py:183-190, 594-597``). Both scans read and
    write time-major ``(B, T, .)`` arrays, so neither has a skew around it.
    ``kernel="reference"`` runs both scans' plain versions on any device.
    """

    @staticmethod
    def forward(ctx, qp_p, q_init, x_ext, s_ext, n_mann, p_spatial, q_spatial, slope, length,
                x_storage, network, physics: ReachPhysics, kernel, mask_raw: bool, dtype: str):
        ops = (n_mann, p_spatial, q_spatial, slope, length, x_storage)
        phys = with_operands(physics, ops)
        # a band's series are column slices of the boundary sums
        xe = None if x_ext is None else x_ext.contiguous()
        se = None if s_ext is None else s_ext.contiguous()
        scan = wave_scan_tm_reference if kernel == "reference" else wave_scan_tm
        with record_function("ddr::forward_scan"):
            raw = scan(qp_p, network, phys, q_init, x_ext=xe, s_ext=se, mask_raw=mask_raw,
                       compute_dtype=dtype)
        del xe, se
        ctx.network, ctx.physics, ctx.kernel, ctx.mask_raw = network, physics, kernel, mask_raw
        ctx.has_init, ctx.has_ext = q_init is not None, x_ext is not None
        empty = raw.new_zeros(0)
        ctx.save_for_backward(
            raw, qp_p, q_init if q_init is not None else empty,
            x_ext if x_ext is not None else empty, s_ext if s_ext is not None else empty, *ops,
        )
        return raw

    @staticmethod
    def backward(ctx, raw_bar):
        raw, qp_p, q_init, x_ext, s_ext, *ops = ctx.saved_tensors
        network, kernel, mask_raw = ctx.network, ctx.kernel, ctx.mask_raw
        has_init, has_ext = ctx.has_init, ctx.has_ext
        phys = with_operands(ctx.physics, ops)
        lb = phys.bounds.discharge
        B, T, n = raw.shape
        tw = network.wf_t_width
        buckets = network.wf_buckets
        n_deg0 = buckets[0][0] if buckets else n
        wf_col = network.wf_col.long()
        t_col = network.wf_t_col.long()

        with record_function("ddr::adjoint_prepasses"):
            # re-gathers of the residual: N x_t (c1's operand) and the clamped
            # previous-timestep inflow sum (c2's operand), each with its
            # external inflow
            raw_pad = F.pad(raw, (0, 1))
            xpx = reduce_gathered(raw_pad[..., wf_col], network.wf_mask, buckets, n_deg0, lb, False,
                                  mask_raw)
            prev_pad = _shift_down(raw_pad)
            s_full = reduce_gathered(prev_pad[..., wf_col], network.wf_mask, buckets, n_deg0, lb, True,
                                     mask_raw)
            if has_ext:
                xpx = xpx + x_ext
                s_full = s_full + s_ext
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
            # per-edge weights: slot (i, k) carries successor j's weight at
            # node i's timestep (pad slots read the zero column); dm is folded
            # into the inflow-adjoint edge weight
            zce = F.pad(zc, (0, 1))[..., t_col]
            duce = dm_all.repeat_interleave(tw, dim=-1) * F.pad(uc, (0, 1))[..., t_col]
            if not has_ext:
                del uc
            del dm_all

        scan = reverse_scan_tm_reference if kernel == "reference" else reverse_scan_tm
        with record_function("ddr::reverse_scan"):
            lam_all = scan(raw_bar.to(raw.dtype).contiguous(), ow, zce, duce, network)  # raw incl. t = 0
        del ow, zce, duce

        with record_function("ddr::adjoint_postpasses"):
            # theta_bar: ONE pullback of the chain over the whole (T, n) batch
            # (row 0 zeroed: no physics on the hotstart diagonal)
            lam_th = lam_all.clone()
            lam_th[:, 0] = 0.0
            needs = ctx.needs_input_grad[4:10]
            with record_function("ddr::adjoint_pullback"):
                theta_bar = physics_pullback(
                    q_prev_all, phys,
                    (lam_th * xpx, lam_th * s_full, lam_th * q_prev_all, lam_th * qpm1c), needs,
                )
            del lam_th, xpx, s_full, q_prev_all, qpm1c
            qp_bar = q_init_bar = x_ext_bar = s_ext_bar = None
            if ctx.needs_input_grad[0]:
                # row t of qp_emit holds q'bar_{t-1}; zc * lam at t = 0 is the
                # hotstart q'_0 adjoint (b = q'_0 raw, c1_eff = 1)
                qp_coef = c4 * _dmax(qpm1_all, lb)
                qp_coef[:, 0] = 0.0
                qp_bar = F.pad((qp_coef * lam_all)[:, 1:], (0, 0, 0, 1))
                qp_bar[:, 0] += zc[:, 0] * lam_all[:, 0]
            if has_init and ctx.needs_input_grad[1]:
                q_init_bar = _dmax(q_init, lb) * lam_all[:, 0]
            if has_ext and ctx.needs_input_grad[2]:
                x_ext_bar = zc * lam_all  # row 0: the hotstart row's x_ext term
            if has_ext and ctx.needs_input_grad[3]:
                s_ext_bar = uc * lam_all
        return (qp_bar, q_init_bar, x_ext_bar, s_ext_bar, *theta_bar, None, None, None, None, None)


def route_raw(qp_p, q_init, x_ext, s_ext, network, physics: ReachPhysics, kernel, mask_raw: bool,
              dtype: str, adjoint: str = "analytic", remat_physics: bool = True) -> torch.Tensor:
    """The raw ``(B, T, n)`` solve of one wavefront network or band, in its
    own order, differentiable by either adjoint: ``"analytic"`` through
    :class:`AnalyticRoute` (the scans ``kernel`` selects), ``"ad"`` by
    autograd through :func:`~ddr_tpu_torch.routing.wave_kernel.wave_scan_autograd`,
    the plain scan. The CUDA kernel has no autograd rule, so ``"ad"`` with
    ``kernel=None`` on CUDA tensors raises instead of leaving the kernel
    quietly (JAX's auto-selection would fall back to its XLA scan there);
    on the CPU ``kernel=None`` means the plain versions anyway."""
    if adjoint == "analytic":
        if network.wf_t_width <= 0:
            raise ValueError(
                "adjoint='analytic' needs the network's transposed wavefront tables "
                "(wf_t_*); rebuild the network or pass adjoint='ad'"
            )
        return AnalyticRoute.apply(qp_p, q_init, x_ext, s_ext, *reach_operands(physics), network,
                                   physics, kernel, mask_raw, dtype)
    if adjoint != "ad":
        raise ValueError(f"unknown adjoint {adjoint!r} (use 'analytic' or 'ad')")
    if kernel is None and qp_p.device.type != "cpu":
        raise ValueError(
            "adjoint='ad' differentiates the plain scan: the CUDA kernel has no autograd "
            "rule, so pass kernel='reference' (or use adjoint='analytic' on the kernels)"
        )
    T = qp_p.shape[1]
    level_p = network.level_p.long()
    qs = _input_skews(qp_p, level_p, network.depth, T)
    xe = se = None
    if x_ext is not None:
        xe, se = _ext_skews(x_ext, s_ext, level_p, network.depth, T)
    with record_function("ddr::forward_scan"):
        ys = wave_scan_autograd(qs, network, physics, q_init, T=T, xe=xe, se=se, mask_raw=mask_raw,
                                compute_dtype=dtype, remat_physics=remat_physics)
    return _skew_by_level_runs(ys, level_p, T)


def wavefront_route_core(
    network: RiverNetwork,
    physics: ReachPhysics,
    q_prime: torch.Tensor,
    q_init: torch.Tensor | None,
    kernel: str | None = None,
    dtype: str = "fp32",
    adjoint: str = "analytic",
    remat_physics: bool = True,
    q_prime_permuted: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route timesteps ``0..T-1`` by wavefront, entirely in ``wf_perm`` order.

    ``q_prime`` is ``(T, N)`` or ``(B, T, N)``; ``physics`` holds per-reach
    operands already in wf order, shared by the batch; ``q_init`` (wf order,
    ``(N,)`` or ``(B, N)``) carries state across windows, ``None`` hotstarts
    in-band from ``q_prime[0]``; ``q_prime_permuted`` says ``q_prime``'s
    columns already are in wf order (else they are gathered). Returns ``(runoff, final, raw)`` in wf order
    with ``q_prime``'s leading shape: ``raw`` is the pre-clamp solve value and
    ``runoff = max(raw, lb)``. Differentiable in ``q_prime``, ``q_init`` and
    the per-reach operands, by the adjoint :func:`route_raw` runs
    (``"analytic"`` or ``"ad"``; ``remat_physics`` applies to ``"ad"``).

    ``kernel=None`` runs :func:`wave_scan` forward and :func:`reverse_scan`
    backward; ``"reference"`` runs their plain versions on any device.
    ``dtype="bf16"`` stores the forward's ring in bfloat16 (bf16-compute /
    fp32-accumulate); ``raw`` is then the rounded series upcast.
    """
    if kernel not in (None, "reference"):
        raise ValueError(f"unknown kernel {kernel!r} (use None or 'reference')")
    validate_dtype(dtype)
    single = q_prime.dim() == 2
    qp = q_prime[None] if single else q_prime
    B, _, n = qp.shape
    qp_p = qp.float().contiguous() if q_prime_permuted else qp.float()[..., network.wf_perm.long()]
    if q_init is not None:
        q_init = q_init.float().expand(B, n).contiguous()
    raw = route_raw(qp_p, q_init, None, None, network, physics, kernel, False, dtype, adjoint,
                    remat_physics)
    runoff = maximum(raw, physics.bounds.discharge)
    final = runoff[:, -1]
    if single:
        return runoff[0], final[0], raw[0]
    return runoff, final, raw
