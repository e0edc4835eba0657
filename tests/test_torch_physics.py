"""Elementwise parity of the port's MC physics with the JAX package.

Inputs are float32 from a fixed numpy seed; both sides run float32 on the
CPU. Tolerance: rtol 1e-6, with an absolute floor of 1e-6 x the field's
largest magnitude. The floor is for ``bottom_width = top_width - 2 z depth``,
whose cancellation turns one-ulp differences between XLA's and PyTorch's
``pow`` into a larger relative error near zero.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.geometry.trapezoidal import trapezoidal_geometry as jax_geometry
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu_torch.geometry.trapezoidal import trapezoidal_geometry
from ddr_tpu_torch.routing import mc

N = 2048


def _close(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * scale, err_msg=label)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {
        "n": rng.uniform(0.015, 0.25, N),
        "p_spatial": rng.uniform(1.0, 200.0, N),
        "q_spatial": rng.uniform(0.0, 1.0, N),
        "discharge": rng.uniform(0.0, 500.0, N),
        "slope": rng.uniform(1e-4, 0.02, N),
    }


def _both(a):
    a = {k: np.asarray(v, np.float32) for k, v in a.items()}
    return {k: jnp.asarray(v) for k, v in a.items()}, {k: torch.as_tensor(v) for k, v in a.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_trapezoidal_geometry(seed):
    j, t = _both(_inputs(seed))
    ref = jax_geometry(**j, depth_lb=0.01, bottom_width_lb=0.01)
    out = trapezoidal_geometry(**t, depth_lb=0.01, bottom_width_lb=0.01)
    assert set(ref) == set(out)
    for k in ref:
        _close(ref[k], out[k], k)


def test_celerity_with_observed_overrides():
    rng = np.random.default_rng(2)
    a = _inputs(2)
    tw = rng.uniform(5.0, 50.0, N)
    tw[rng.random(N) < 0.5] = np.nan
    j, t = _both({**a, "length": rng.uniform(800, 6000, N), "x": np.full(N, 0.3), "tw": tw})
    bounds_j = jax_mc.Bounds(velocity=0.01, depth=0.01, bottom_width=0.01)
    bounds_t = mc.Bounds(velocity=0.01, depth=0.01, bottom_width=0.01)
    ch_j = jax_mc.ChannelState(length=j["length"], slope=j["slope"], x_storage=j["x"],
                               top_width_data=j["tw"])
    ch_t = mc.ChannelState(length=t["length"], slope=t["slope"], x_storage=t["x"],
                           top_width_data=t["tw"])
    ref = jax_mc.celerity(j["discharge"], j["n"], j["p_spatial"], j["q_spatial"], ch_j, bounds_j)
    out = mc.celerity(t["discharge"], t["n"], t["p_spatial"], t["q_spatial"], ch_t, bounds_t)
    for name, r, o in zip(("celerity", "top_width", "side_slope"), ref, out):
        _close(r, o, name)


def test_muskingum_coefficients():
    rng = np.random.default_rng(3)
    j, t = _both({"L": rng.uniform(800, 6000, N), "c": rng.uniform(0.5, 25.0, N),
                  "x": rng.uniform(0.1, 0.4, N)})
    ref = jax_mc.muskingum_coefficients(j["L"], j["c"], j["x"])
    out = mc.muskingum_coefficients(t["L"], t["c"], t["x"])
    for i, (r, o) in enumerate(zip(ref, out)):
        _close(r, o, f"c{i + 1}")


@pytest.mark.parametrize("log_space", [False, True])
def test_denormalize(log_space):
    v = np.random.default_rng(4).uniform(0.0, 1.0, N).astype(np.float32)
    ref = jax_mc.denormalize(jnp.asarray(v), (1.0, 200.0), log_space)
    out = mc.denormalize(torch.as_tensor(v), (1.0, 200.0), log_space)
    _close(ref, out, "denormalize")
