"""The port's ``ddr benchmark`` and its LTI comparator against the JAX
package's, on the CPU.

``irf_kernels`` for every family of ``IRF_FAMILIES`` (random travel times
and weights, and kernels narrower than a bin that fall back to a spike); the
complex64 triangular solve on both schedules; ``route_lti`` on a depth-12
river tree, with the frequency bins and reaches chunked small so every
chunk boundary is crossed; then ``benchmark()``'s ``benchmark_results.zarr``
on the 32-reach twin from one set of KAN weights (JAX's initialisation,
written as each package's own checkpoint).

Tolerance: ``|a - b| <= 1e-5 |ref| + 1e-5 max|ref|``, as in the other
parity tests; the IRF kernels within ``1e-5 max|ref|`` and the LTI routes
within ``1e-5 max|ref|``, as stated for them.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu import training as jax_training
from ddr_tpu.benchmarks.irf import irf_kernels as jax_irf_kernels
from ddr_tpu.benchmarks.irf import route_lti as jax_route_lti
from ddr_tpu.io import zarrlite as jax_zarrlite
from ddr_tpu.routing import solver as jax_solver
from ddr_tpu.routing.network import build_network as jax_build_network
from ddr_tpu.scripts import common as jax_common
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch.benchmarks import benchmark, irf
from ddr_tpu_torch.benchmarks.configs import LTIRouteConfig, validate_benchmark_config
from ddr_tpu_torch.benchmarks.irf import IRF_FAMILIES, irf_kernels, route_lti
from ddr_tpu_torch.geodatazoo.synthetic import Synthetic, make_deep_network
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.routing import solver
from ddr_tpu_torch.routing.network import build_network
from ddr_tpu_torch.scripts.common import kan_arch
from ddr_tpu_torch.training import save_state
from ddr_tpu_torch.validation.configs import load_config

CONFIG = "examples/synthetic/config.yaml"
# the JAX package's benchmarks/__init__.py exports a function of the module's name
jax_benchmark = importlib.import_module("ddr_tpu.benchmarks.benchmark")


def close(got, ref, label="", rtol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, label
    assert np.isfinite(got).all(), label
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5 * np.abs(ref).max(), err_msg=label)


@pytest.mark.parametrize("family", IRF_FAMILIES)
def test_irf_kernels_match_jax(family):
    rng = np.random.default_rng(7)
    n = 40
    k = np.concatenate([rng.uniform(0.02, 0.4, n - 2), [1e-9, 0.001]])  # the last two narrower than a bin
    x = np.concatenate([rng.uniform(0.0, 0.49, n - 2), [0.0, 0.3]])
    got = irf_kernels(family, k, x, 1.0 / 24.0, 48, nash_n=3)
    want = jax_irf_kernels(family, k, x, 1.0 / 24.0, 48, nash_n=3)
    assert got.dtype == np.float32 and got.shape == (n, 48)
    close(got, want, family, rtol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="not in"):
        irf_kernels("gamma", k, x, 1.0, 4)


def _tree():
    rows, cols = make_deep_network(96, 12, seed=5)
    return rows, cols, 96


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "rectangle"])
def test_complex_solve_matches_jax(fused):
    rows, cols, n = _tree()
    net = build_network(rows, cols, n, fused=fused, device="cpu")
    jnet = jax_build_network(rows, cols, n, fused=fused)
    rng = np.random.default_rng(11)
    c1 = (rng.uniform(0.1, 0.9, (5, n)) * np.exp(1j * rng.uniform(-3, 3, (5, n)))).astype(np.complex64)
    b = (rng.normal(size=(5, n)) + 1j * rng.normal(size=(5, n))).astype(np.complex64)
    got = solver.solve_lower_triangular(net, torch.as_tensor(c1), torch.as_tensor(b))
    assert got.dtype == torch.complex64
    want = np.stack([np.asarray(jax_solver.solve_lower_triangular(jnet, jnp.asarray(c1[i]), jnp.asarray(b[i])))
                     for i in range(5)])
    close(got.numpy(), want, "complex solve")
    with pytest.raises(ValueError, match="one dtype"):
        solver.solve_lower_triangular(net, torch.as_tensor(c1), torch.as_tensor(b.real.copy()))
    with pytest.raises(ValueError, match="one dtype"):
        solver.solve_lower_triangular(net, torch.ones(n, dtype=torch.int64), torch.ones(n, dtype=torch.int64))


@pytest.mark.parametrize("family,pad_steps", [("muskingum", None), ("nash_cascade", 64), ("hayami", None)])
def test_route_lti_matches_jax(family, pad_steps, monkeypatch):
    rows, cols, n = _tree()
    net = build_network(rows, cols, n, device="cpu")
    jnet = jax_build_network(rows, cols, n)
    assert net.depth >= 8
    rng = np.random.default_rng(13)
    kernels = irf_kernels(family, rng.uniform(0.05, 0.2, n), rng.uniform(0.1, 0.4, n), 1.0 / 24.0, 24)
    q_prime = rng.gamma(2.0, 1.5, (200, n)).astype(np.float32)
    monkeypatch.setattr(irf, "REACH_BATCH", 10)
    got = route_lti(net, kernels, torch.as_tensor(q_prime), pad_steps=pad_steps, freq_batch=37)
    want = np.asarray(jax_route_lti(jnet, kernels, jnp.asarray(q_prime), pad_steps=pad_steps))
    assert got.dtype == torch.float32 and got.shape == (200, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # one chunk of everything gives the same route
    monkeypatch.setattr(irf, "REACH_BATCH", 1 << 20)
    whole = route_lti(net, kernels, torch.as_tensor(q_prime), pad_steps=pad_steps, freq_batch=1 << 20)
    np.testing.assert_allclose(whole.numpy(), got.numpy(), rtol=0, atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="reaches"):
        route_lti(net, kernels, torch.as_tensor(q_prime[:, :-1]))


def test_lti_config_validates_like_jax():
    from ddr_tpu.benchmarks.configs import LTIRouteConfig as JaxLTIRouteConfig

    raw = {"irf_fn": "hayami", "max_delay": "48", "x": 0.2, "nash_n": 2}
    assert LTIRouteConfig.from_dict(raw).model_dump() == JaxLTIRouteConfig(**raw).model_dump()
    assert LTIRouteConfig().model_dump() == JaxLTIRouteConfig().model_dump()
    for bad in ({"irf_fn": "gamma"}, {"x": 0.5}, {"nash_n": 0}, {"unknown": 1}):
        with pytest.raises(ValueError):
            LTIRouteConfig.from_dict(bad)


def test_summed_q_prime_store_is_refused_by_name():
    raw = {"name": "x", "geodataset": "synthetic", "mode": "testing", "kan": {"input_var_names": ["a"]},
           "summed_q_prime": "sqp.zarr"}
    with pytest.raises(NotImplementedError, match="A.8"):
        validate_benchmark_config(raw)
    cfg = validate_benchmark_config({**raw, "summed_q_prime": None, "diffroute": {"irf_fn": "pure_lag"}})
    assert cfg.lti.irf_fn == "pure_lag" and cfg.ddr.name == "x"


def test_benchmark_writes_jax_results_store(tmp_path):
    ov = ["synthetic_segments=32", "device=cpu", "experiment.end_time=1981/10/22",
          "experiment.batch_size=6"]
    jcfg = jax_load_config(CONFIG, [*ov, "mode=testing"], save_config=False)
    _, params = jax_common.build_kan(jcfg)
    jax_ckpt = jax_training.save_state(tmp_path / "jax_ckpt", "x", 1, 0, params, None,
                                       arch=jax_common.kan_arch(jcfg))
    cfg = load_config(CONFIG, [*ov, "mode=testing"], save_config=False)
    ckpt = save_state(tmp_path / "ckpt", "x", 1, 0, kan_state_from_flax(params), None, arch=kan_arch(cfg))

    assert benchmark.main([CONFIG, *ov, f"experiment.checkpoint={ckpt}",
                           f"params.save_path={tmp_path / 'port'}"]) == 0
    assert jax_benchmark.main([CONFIG, *ov, f"experiment.checkpoint={jax_ckpt}",
                               f"params.save_path={tmp_path / 'jax'}"]) == 0

    ours = jax_zarrlite.open_group(tmp_path / "port" / "benchmark_results.zarr")
    ref = jax_zarrlite.open_group(tmp_path / "jax" / "benchmark_results.zarr")
    assert sorted(ours.keys()) == sorted(ref.keys()) == ["lti_predictions", "mc_predictions", "observations"]
    for name in ref.keys():
        close(ours[name][:], ref[name][:], name)
    drop = ("version", "model_checkpoint")
    assert {k: v for k, v in ours.attrs.items() if k not in drop} == {
        k: v for k, v in ref.attrs.items() if k not in drop}
    assert ours.attrs["model_checkpoint"] == str(ckpt)


def test_benchmark_baseline_and_mass_balance(tmp_path):
    """The twin's ΣQ' baseline: the inflow summed over every reach upstream
    of each gauge's inflow segments, against a plain accumulation in
    numpy; the LTI route conserves it."""
    ov = ["synthetic_segments=32", "device=cpu", "experiment.end_time=1981/11/20", "mode=testing",
          f"params.save_path={tmp_path}"]
    cfg = load_config(CONFIG, ov, save_config=False)
    bench = validate_benchmark_config({**cfg.model_dump(), "lti": {"irf_fn": "linear_storage"}})

    ds = Synthetic(cfg)
    sqp = benchmark.summed_q_prime_hourly(cfg, ds, ds.streamflow)
    rd = ds.routing_data
    rows, cols = np.asarray(rd.adjacency_rows), np.asarray(rd.adjacency_cols)
    # a reach's total is its own inflow plus its upstream reaches' totals
    acc = ds.basin.q_prime[: sqp.shape[1]].astype(np.float64)  # the window's (D - 1) * 24 hours
    for i in _topological(rows, cols, rd.n_segments):
        acc[:, i] += acc[:, cols[rows == i]].sum(1)
    want = np.stack([acc[:, np.asarray(ix)].sum(1) for ix in rd.outflow_idx])
    close(sqp, want, "ΣQ'")
    # the LTI route conserves volume: what it lacks is still in transit at the window's end
    lti = benchmark.run_lti_benchmark(bench, ds, ds.streamflow)
    err = benchmark.mass_balance(lti, sqp, 0)
    print(f"LTI against ΣQ': relative volume error {err}")
    assert err.max() < 0.05


def _topological(rows, cols, n):
    indeg = np.bincount(rows, minlength=n)
    order, ready = [], [i for i in range(n) if indeg[i] == 0]
    while ready:
        i = ready.pop()
        order.append(i)
        for d in rows[cols == i]:
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    return order
