"""Kolmogorov-Arnold Network as a ``torch.nn.Module``.

The port of ``ddr_tpu/nn/kan.py`` (static-grid form): Linear(in -> hidden)
-> ``num_hidden_layers`` x KAN layer (hidden -> hidden) -> Linear(hidden ->
n_params) -> sigmoid, returning ``{param_name: (N,)}`` in [0, 1]. Each KAN
edge applies ``phi(x) = w_base * silu(x) + sum_g c_g * B_g(x)`` with an
order-``k`` B-spline basis on a uniform grid, evaluated by Cox-de Boor.

Parameters keep the flax names and shapes (``w_base (in, out)``,
``spline_coef (in, n_basis, out)``), so :mod:`ddr_tpu_torch.nn.convert`
carries JAX weights across leaf for leaf. Adaptive grids come later.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["KANLayer", "Kan", "bspline_basis", "uniform_knots"]


def bspline_basis(x: torch.Tensor, knots: torch.Tensor, k: int) -> torch.Tensor:
    """Order-``k`` B-spline basis of ``x (..., F)`` on a shared knot vector
    ``(G + 2k + 1,)``: returns ``(..., F, G + k)``."""
    x = x[..., None]
    b = ((x >= knots[:-1]) & (x < knots[1:])).to(x.dtype)
    for d in range(1, k + 1):
        left = (x - knots[: -(d + 1)]) / (knots[d:-1] - knots[: -(d + 1)]) * b[..., :-1]
        right = (knots[d + 1 :] - x) / (knots[d + 1 :] - knots[1:-d]) * b[..., 1:]
        b = left + right
    return b


def uniform_knots(
    grid_size: int, spline_order: int, grid_range, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Extended uniform knot vector over ``grid_range``: ``(G + 2k + 1,)``."""
    lo, hi = grid_range
    h = (hi - lo) / grid_size
    steps = torch.arange(-spline_order, grid_size + spline_order + 1, dtype=dtype, device=device)
    return steps * h + lo


class KANLayer(nn.Module):
    """One KAN layer: a learnable spline activation per (input, output) edge."""

    def __init__(
        self,
        in_features: int,
        features: int,
        grid_size: int = 3,
        spline_order: int = 3,
        grid_range: tuple[float, float] = (-1.0, 1.0),
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.grid_size = grid_size
        self.spline_order = spline_order
        self.grid_range = tuple(grid_range)
        n_basis = grid_size + spline_order
        self.w_base = nn.Parameter(torch.empty(in_features, features))
        self.spline_coef = nn.Parameter(torch.empty(in_features, n_basis, features))
        with torch.no_grad():
            # kaiming-normal over fan_in, normal(0, 0.1): the flax initializers
            self.w_base.normal_(0.0, (2.0 / in_features) ** 0.5, generator=generator)
            self.spline_coef.normal_(0.0, 0.1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        knots = uniform_knots(
            self.grid_size, self.spline_order, self.grid_range, x.dtype, x.device
        )
        basis = bspline_basis(x, knots, self.spline_order)  # (..., in, n_basis)
        spline = torch.einsum("...ig,igf->...f", basis, self.spline_coef)
        base = nn.functional.silu(x) @ self.w_base
        return base + spline


class Kan(nn.Module):
    """The parameter-learning network: z-scored catchment attributes ->
    physical parameters in [0, 1], one ``(N,)`` tensor per learnable name."""

    def __init__(
        self,
        input_var_names: tuple[str, ...],
        learnable_parameters: tuple[str, ...],
        hidden_size: int = 11,
        num_hidden_layers: int = 1,
        grid: int = 3,
        k: int = 3,
        grid_range: tuple[float, float] = (-2.0, 2.0),
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.input_var_names = tuple(input_var_names)
        self.learnable_parameters = tuple(learnable_parameters)
        self.input = nn.Linear(len(self.input_var_names), hidden_size)
        self.layers = nn.ModuleList(
            KANLayer(hidden_size, hidden_size, grid, k, grid_range, generator=generator)
            for _ in range(num_hidden_layers)
        )
        self.output = nn.Linear(hidden_size, len(self.learnable_parameters))
        with torch.no_grad():
            fan_in, fan_out = len(self.input_var_names), len(self.learnable_parameters)
            self.input.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
            self.output.weight.normal_(
                0.0, (2.0 / (hidden_size + fan_out)) ** 0.5, generator=generator
            )
            self.input.bias.zero_()
            self.output.bias.zero_()

    def forward(self, inputs: torch.Tensor) -> dict[str, torch.Tensor]:
        """``inputs``: ``(N, len(input_var_names))`` z-scored attributes."""
        x = self.input(inputs)
        for layer in self.layers:
            x = layer(x)
        x = torch.sigmoid(self.output(x))
        return {name: x[..., i] for i, name in enumerate(self.learnable_parameters)}
