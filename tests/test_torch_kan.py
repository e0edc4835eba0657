"""The port's ``Kan`` against flax ``Kan.apply`` on the same weights.

flax weights from a fixed PRNG key cross over through
``kan_state_from_flax``; inputs come from a fixed numpy seed. Tolerance:
atol 1e-5 on the sigmoid outputs in [0, 1] (float32 matmuls and einsums sum
in different orders in XLA and PyTorch).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.nn.kan import Kan as FlaxKan
from ddr_tpu.nn.kan import bspline_basis as jax_bspline_basis
from ddr_tpu.nn.kan import uniform_knots as jax_uniform_knots
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.nn.kan import Kan, bspline_basis, uniform_knots

NAMES = tuple(f"a{i}" for i in range(10))


@pytest.mark.parametrize("layers,hidden", [(1, 11), (2, 7)])
def test_kan_matches_flax(layers, hidden):
    fk = FlaxKan(input_var_names=NAMES, learnable_parameters=("n", "q_spatial"),
                 hidden_size=hidden, num_hidden_layers=layers)
    x = np.random.default_rng(5).normal(size=(256, 10)).astype(np.float32)
    params = fk.init(jax.random.PRNGKey(layers), jnp.asarray(x))
    ref = fk.apply(params, jnp.asarray(x))

    kan = Kan(NAMES, ("n", "q_spatial"), hidden_size=hidden, num_hidden_layers=layers)
    kan.load_state_dict(kan_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        out = kan(torch.as_tensor(x))
    assert set(out) == {"n", "q_spatial"}
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=0)


def test_bspline_basis_matches_jax():
    x = np.random.default_rng(6).uniform(-2.5, 2.5, size=(64, 5)).astype(np.float32)
    ref = jax_bspline_basis(jnp.asarray(x), jax_uniform_knots(3, 3, (-2.0, 2.0)), 3)
    out = bspline_basis(torch.as_tensor(x), uniform_knots(3, 3, (-2.0, 2.0)), 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_seeded_init_is_reproducible():
    a = Kan(NAMES, ("n",), generator=torch.Generator().manual_seed(0))
    b = Kan(NAMES, ("n",), generator=torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
