"""Trapezoidal channel geometry as elementwise tensor math.

The port of ``ddr_tpu/geometry/trapezoidal.py``: invert Manning's equation
for depth given Leopold & Maddock width parameters, then derive the full
cross-section. The wave-scan kernel (``csrc/wave_scan.cu``) hard-codes the
same chain op for op; this function is its plain version.

Every clamp is :func:`maximum` / :func:`clip`, never ``torch.clamp``: JAX
differentiates ``jnp.maximum`` and ``jnp.clip`` with a tie split 0.5/0.5,
``torch.clamp`` passes the whole gradient at a tie, and the analytic adjoint
(``routing/wavefront.py``) hard-codes the JAX rule.
"""

from __future__ import annotations

import torch

__all__ = ["clip", "maximum", "rdiv", "trapezoidal_geometry"]


def rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as one correctly rounded division (``float / Tensor`` in
    PyTorch computes ``t.reciprocal() * a``, which rounds twice)."""
    return torch.div(torch.tensor(a, dtype=t.dtype, device=t.device), t)


def maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``max(x, lo)`` whose gradient splits 0.5/0.5 where ``x == lo``, as
    ``jnp.maximum``'s does (``torch.clamp_min`` gives 1 there)."""
    return torch.maximum(x, x.new_full((), lo))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``min(max(x, lo), hi)`` with the tie-splitting gradient of ``jnp.clip``."""
    return torch.minimum(maximum(x, lo), x.new_full((), hi))


def trapezoidal_geometry(
    n: torch.Tensor,
    p_spatial: torch.Tensor,
    q_spatial: torch.Tensor,
    discharge: torch.Tensor,
    slope: torch.Tensor,
    depth_lb: float = 0.01,
    bottom_width_lb: float = 0.01,
) -> dict[str, torch.Tensor]:
    """Trapezoidal cross-section from per-reach Manning ``n``, Leopold &
    Maddock coefficient ``p`` and exponent ``q`` (0 = rectangular, 1 =
    triangular), ``discharge`` (m^3/s) and bed ``slope`` (m/m).

    Returns ``depth``, ``top_width``, ``bottom_width``, ``side_slope``,
    ``cross_sectional_area``, ``wetted_perimeter``, ``hydraulic_radius`` and
    ``velocity``.
    """
    q_eps = q_spatial + 1e-6

    numerator = discharge * n * (q_eps + 1.0)
    denominator = p_spatial * torch.sqrt(slope)
    depth = maximum(
        torch.pow(numerator / (denominator + 1e-8), rdiv(3.0, 5.0 + 3.0 * q_eps)),
        depth_lb,
    )
    top_width = p_spatial * torch.pow(depth, q_eps)
    side_slope = clip(top_width * q_eps / (2.0 * depth), 0.5, 50.0)
    bottom_width = maximum(top_width - 2.0 * side_slope * depth, bottom_width_lb)

    area = (top_width + bottom_width) * depth / 2.0
    wetted_perimeter = bottom_width + 2.0 * depth * torch.sqrt(1.0 + side_slope * side_slope)
    hydraulic_radius = area / wetted_perimeter
    velocity = rdiv(1.0, n) * torch.pow(hydraulic_radius, 2.0 / 3.0) * torch.sqrt(slope)

    return {
        "depth": depth,
        "top_width": top_width,
        "bottom_width": bottom_width,
        "side_slope": side_slope,
        "cross_sectional_area": area,
        "wetted_perimeter": wetted_perimeter,
        "hydraulic_radius": hydraulic_radius,
        "velocity": velocity,
    }
