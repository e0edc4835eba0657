"""The port's KAN initialisers against flax's.

flax's ``kaiming_normal`` and ``xavier_normal`` are ``variance_scaling(...,
"truncated_normal")``: a normal of std ``sigma / 0.87962566`` truncated to
two of those stds, so the samples keep std ``sigma``. On large layers the
port's initialisers must draw no sample outside those bounds and give the
sample std of JAX's freshly initialised parameters of the same shapes within
2% (the two packages draw different numbers from their seeds, so the
comparison is of distributions; at 2 M samples the std's own spread is
below 0.1%).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from ddr_tpu_torch.nn.kan import TRUNCATED_NORMAL_STD, Kan, KANLayer

IN, OUT = 4096, 512


def _check(w, sigma, flax_init, shape, label):
    w = w.detach().double().numpy()
    bound = 2.0 * sigma / TRUNCATED_NORMAL_STD
    assert np.abs(w).max() <= bound * (1 + 1e-6), f"{label}: a sample beyond 2 sigma'"
    ref = np.asarray(flax_init(jax.random.PRNGKey(0), shape, np.float32), np.float64)
    assert np.abs(ref).max() <= bound * (1 + 1e-6)
    assert w.std() == pytest.approx(ref.std(), rel=0.02), label
    assert w.std() == pytest.approx(sigma, rel=0.02), label


def test_kan_layer_w_base_is_flax_kaiming_normal():
    layer = KANLayer(IN, OUT, generator=torch.Generator().manual_seed(0))
    _check(layer.w_base, (2.0 / IN) ** 0.5, nn.initializers.kaiming_normal(), (IN, OUT), "w_base")
    # the spline coefficients stay normal(0, 0.1), untruncated as in flax
    assert layer.spline_coef.detach().std() == pytest.approx(0.1, rel=0.02)
    assert layer.spline_coef.detach().abs().max() > 2 * 0.1 / TRUNCATED_NORMAL_STD


def test_kan_linear_weights_are_flax_kaiming_and_xavier_normal():
    names = tuple(f"x{i}" for i in range(IN))
    params = tuple(f"p{i}" for i in range(OUT))
    kan = Kan(names, params, hidden_size=OUT, num_hidden_layers=0,
              generator=torch.Generator().manual_seed(1))
    # torch stores (out, in); flax's Dense kernel is (in, out): same fans
    _check(kan.input.weight.T, (2.0 / IN) ** 0.5, nn.initializers.kaiming_normal(), (IN, OUT),
           "input weight")
    _check(kan.output.weight.T, (2.0 / (OUT + OUT)) ** 0.5, nn.initializers.xavier_normal(),
           (OUT, OUT), "output weight")


def test_initialisation_is_deterministic_under_a_generator():
    a = KANLayer(64, 32, generator=torch.Generator().manual_seed(7))
    b = KANLayer(64, 32, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a.w_base, b.w_base) and torch.equal(a.spline_coef, b.spline_coef)
