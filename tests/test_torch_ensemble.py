"""Ensemble forecasts of the port against the JAX package's.

- the threefry draws (:mod:`ddr_tpu_torch.fleet.prng`): ``PRNGKey``,
  ``fold_in`` and the random bits equal ``jax.random``'s bit for bit; the
  float32 normals (and ``erfinv`` alone) within rtol 1e-6 (the largest
  difference measured is about 2.4e-7, two float32 ulp);
- ``member_forcing`` and the device-side ``member_windows`` within rtol 1e-6
  of JAX's ``member_forcing``; ``perturbation_seed`` and ``percentile_bands``
  (broken members included) equal;
- ``ForecastService.ensemble_forecast`` on a 4,096-reach basin with E = 8 on
  the same weights and window as JAX's compiled ensemble program:
  percentile bands and the member mean within rtol 1e-5 (with an absolute
  floor of 1e-5 x the largest magnitude, the serving bound), the worst
  gauges equal as sets; each member equals the same perturbed window served
  alone through ``forecast(q_prime=...)`` bit for bit;
- ``FleetConfig``'s ensemble knobs read the environment as JAX's do, and the
  request checks refuse what JAX's refuse.

Every input is drawn from numpy generators seeded with fixed integers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.fleet import ensemble as jens
from ddr_tpu.fleet.config import FleetConfig as JaxFleetConfig
from ddr_tpu_torch.fleet import ensemble as tens
from ddr_tpu_torch.fleet import prng
from ddr_tpu_torch.fleet.config import FleetConfig

NAMES = [f"a{i}" for i in range(10)]

# ---- the threefry draws ----


@pytest.mark.parametrize("seed", [0, 1, 977, 2**31 - 1, 2**32 - 1])
def test_keys_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in np.asarray(key)) == prng.prng_key(seed)
    for data in (0, 1, 63, 2**31 + 5):
        ref = tuple(int(v) for v in np.asarray(jax.random.fold_in(key, data)))
        assert prng.fold_in(prng.prng_key(seed), data) == ref


@pytest.mark.parametrize("shape", [(1,), (7,), (37, 29), (3, 5, 11)])
def test_random_bits_equal_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(123), 4)
    ref = np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32)).astype(np.int64)
    out = prng.random_bits(prng.fold_in(prng.prng_key(123), 4), int(np.prod(shape))).reshape(shape)
    np.testing.assert_array_equal(out.numpy(), ref)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)).max())


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_normals_equal_jax_within_rtol_1e6(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    ref = np.asarray(jax.random.normal(key, (300, 333)), np.float32)
    out = prng.normal(prng.fold_in(prng.prng_key(seed), 3), (300, 333)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    assert np.mean(out == ref) > 0.9  # most values are the same float32


def test_erfinv32_equals_xla_erf_inv():
    u = np.linspace(-0.99999994, 0.99999994, 400_001, dtype=np.float32)
    u = np.concatenate([u, np.float32([-1.0, 1.0, 0.0, 1e-30, -0.9966])])
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    out = prng.erfinv32(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(out[:-5], ref[:-5], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(out[-5:], ref[-5:])  # +-1 map to +-inf, as in XLA


@pytest.mark.parametrize("sigma", [0.0, 0.1, 0.5])
def test_member_forcing_equals_jax(sigma):
    rng = np.random.default_rng(8)
    q = rng.uniform(0.0, 5.0, size=(24, 301)).astype(np.float32)
    for member in (0, 1, 5):
        ref = jens.member_forcing(q, "req-7", 2, member, sigma)
        out = tens.member_forcing(q, "req-7", 2, member, sigma)
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    windows = tens.member_windows(torch.from_numpy(q), tens.perturbation_seed("req-7", 2), 6, sigma)
    assert windows.shape == (6, 24, 301) and windows.is_contiguous()
    for member in range(6):
        np.testing.assert_allclose(windows[member].numpy(), jens.member_forcing(q, "req-7", 2, member, sigma),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("request_id,seed", [("abc", 0), ("lt-17", 3), ("", 0), ("ünï", 2**40)])
def test_perturbation_seed_equals_jax(request_id, seed):
    assert tens.perturbation_seed(request_id, seed) == jens.perturbation_seed(request_id, seed)


@pytest.mark.parametrize("broken", [0, 1, 3])
def test_percentile_bands_equal_jax(broken):
    rng = np.random.default_rng(broken)
    runoff = rng.lognormal(size=(8, 12, 5)).astype(np.float32)
    for m in range(broken):
        runoff[m, int(rng.integers(12)), int(rng.integers(5))] = [np.nan, np.inf, -np.inf][m]
    if broken == 3:
        runoff[:, 0, 0] = np.nan  # a cell where every member broke
    ref, ref_bad = jens.percentile_bands(runoff, (10.0, 50.0, 90.0))
    out, bad = tens.percentile_bands(runoff, (10.0, 50.0, 90.0))
    assert bad == ref_bad
    np.testing.assert_array_equal(out, ref)


ENVIRONS = [{}, {"DDR_FLEET_ENSEMBLE_MAX_MEMBERS": "16", "DDR_FLEET_ENSEMBLE_SIGMA": "0.25"},
            {"DDR_FLEET_ENSEMBLE_SIGMA": "", "DDR_FLEET_REPLICAS": "3"}]


@pytest.mark.parametrize("environ", ENVIRONS, ids=range(len(ENVIRONS)))
def test_fleet_config_reads_the_ensemble_knobs_as_jax(environ):
    ours, ref = FleetConfig.from_env(environ), JaxFleetConfig.from_env(environ)
    assert (ours.ensemble_max_members, ours.ensemble_sigma) == (ref.ensemble_max_members, ref.ensemble_sigma)


@pytest.mark.parametrize("environ", [{"DDR_FLEET_ENSEMBLE_MAX_MEMBERS": "0"}, {"DDR_FLEET_ENSEMBLE_SIGMA": "-1"},
                                     {"DDR_FLEET_ENSEMBLE_MAX_MEMBERS": "many"}])
def test_fleet_config_refuses_what_jax_refuses(environ):
    with pytest.raises(ValueError) as ref:
        JaxFleetConfig.from_env(environ)
    with pytest.raises(ValueError) as ours:
        FleetConfig.from_env(environ)
    assert str(ours.value) == str(ref.value)


# ---- the service's ensembles against JAX's compiled program ----


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """A JAX and a port service on one 4,096-reach basin and one set of KAN
    weights, horizon 24 h."""
    from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
    from ddr_tpu.nn.kan import Kan as FlaxKan
    from ddr_tpu.serving.config import ServeConfig as JaxServeConfig
    from ddr_tpu.serving.service import ForecastService as JaxForecastService
    from ddr_tpu.validation.configs import Config as JaxConfig
    from ddr_tpu_torch.geodatazoo.synthetic import make_basin
    from ddr_tpu_torch.nn.convert import kan_state_from_flax
    from ddr_tpu_torch.nn.kan import Kan
    from ddr_tpu_torch.serving.config import ServeConfig
    from ddr_tpu_torch.serving.service import ForecastService
    from ddr_tpu_torch.validation.configs import Config, KanConfig

    basin = dict(n_segments=4096, n_gauges=6, n_days=3, seed=31, depth=40)
    ours, ref = make_basin(**basin), jax_make_basin(**basin)
    fk = FlaxKan(input_var_names=tuple(NAMES), learnable_parameters=("n", "q_spatial"))
    variables = fk.init(jax.random.PRNGKey(1), jnp.asarray(ref.routing_data.normalized_spatial_attributes))
    kan = Kan(NAMES, ("n", "q_spatial"))
    kan.load_state_dict(kan_state_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    kw = dict(horizon_hours=24, max_batch=2, batch_wait_s=0.002)
    jsvc = JaxForecastService(
        JaxConfig(name="t", geodataset="synthetic", mode="testing", kan={"input_var_names": NAMES},
                  experiment={"start_time": "1981/10/01", "end_time": "1981/10/10"},
                  params={"save_path": str(tmp_path_factory.mktemp("ens"))}), JaxServeConfig(**kw))
    tsvc = ForecastService(Config(kan=KanConfig(input_var_names=NAMES)), ServeConfig(**kw), device="cpu")
    jsvc.register_network("basin", ref.routing_data, forcing=ref.q_prime)
    jsvc.register_model("default", fk, variables)
    tsvc.register_network("basin", ours.routing_data, forcing=ours.q_prime)
    tsvc.register_model("default", kan)
    tsvc.warmup()
    yield jsvc, tsvc
    jsvc.close(drain=False)
    tsvc.close(drain=False)


def _close(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-8)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


ENSEMBLE_REQUESTS = {
    "t0 window": dict(t0=10, members=8, request_id="ens-a"),
    "gauges and percentiles": dict(t0=30, members=8, gauges=[5, 0, 2], percentiles=[0, 25, 50, 75, 100],
                                   seed=4, request_id="ens-b"),
}


@pytest.mark.parametrize("name", sorted(ENSEMBLE_REQUESTS))
def test_ensemble_forecast_equals_jax(services, name):
    jsvc, tsvc = services
    kw = ENSEMBLE_REQUESTS[name]
    ref = jsvc.ensemble_forecast(network="basin", **kw)
    out = tsvc.ensemble_forecast(network="basin", return_members=True, **kw)
    assert set(out) - {"member_runoff"} == set(ref)
    for key in ("members", "seed", "percentiles", "request_id", "version", "ensemble_nonfinite_members"):
        assert out[key] == ref[key], key
    assert out["runoff"].shape == ref["runoff"].shape
    _close(ref["runoff"], out["runoff"], f"{name}: percentile bands")
    _close(ref["mean"], out["mean"], f"{name}: member mean")
    assert set(out["worst"]["gauges"]) == set(ref["worst"]["gauges"])
    np.testing.assert_allclose(out["worst"]["scores"], ref["worst"]["scores"], rtol=1e-5)
    assert out["member_runoff"].shape == (8, 24, len(kw.get("gauges", range(6))))


def test_each_member_equals_its_window_served_alone(services):
    """The E-member route of one request, member by member, against the same
    perturbed window through the service's batched path (another batch
    size, pad rows beside it): equal bit for bit."""
    _, tsvc = services
    out = tsvc.ensemble_forecast(network="basin", t0=12, members=5, request_id="alone", seed=9,
                                 return_members=True)
    net = tsvc.networks()["basin"]
    windows = tens.member_windows(torch.from_numpy(net.forcing[12:36]), tens.perturbation_seed("alone", 9), 5,
                                  FleetConfig.from_env().ensemble_sigma)
    for m in range(5):
        alone = tsvc.forecast(network="basin", q_prime=windows[m].numpy(), timeout=120)["runoff"]
        np.testing.assert_array_equal(out["member_runoff"][m], alone)


def test_a_replayed_request_id_reproduces_its_ensemble(services):
    _, tsvc = services
    a = tsvc.ensemble_forecast(network="basin", t0=5, members=3, request_id="again")
    b = tsvc.ensemble_forecast(network="basin", t0=5, members=3, request_id="again")
    c = tsvc.ensemble_forecast(network="basin", t0=5, members=3, request_id="again", seed=1)
    np.testing.assert_array_equal(a["runoff"], b["runoff"])
    assert not np.array_equal(a["runoff"], c["runoff"])


ENSEMBLE_ERRORS = {
    "members 0": dict(t0=0, members=0),
    "members over the cap": dict(t0=0, members=65),
    "percentile below 0": dict(t0=0, percentiles=[-1]),
    "no percentiles": dict(t0=0, percentiles=[]),
    "t0 out of range": dict(t0=60),
    "q_prime and t0": dict(t0=0, q_prime=np.zeros((24, 4096), np.float32)),
    "q_prime shape": dict(q_prime=np.zeros((3, 4096), np.float32)),
    "gauges empty": dict(t0=0, gauges=[]),
    "gauges out of range": dict(t0=0, gauges=[6]),
    "unknown network": dict(network="nope"),
}


@pytest.mark.parametrize("name", sorted(ENSEMBLE_ERRORS))
def test_ensemble_requests_refused_as_jax(services, name):
    jsvc, tsvc = services
    kw = {"network": "basin", **ENSEMBLE_ERRORS[name]}
    with pytest.raises(ValueError) as ref:
        jsvc.ensemble_forecast(**kw)
    with pytest.raises(ValueError) as ours:
        tsvc.ensemble_forecast(**kw)
    assert str(ours.value) == str(ref.value)
    with pytest.raises(KeyError):
        tsvc.ensemble_forecast(network="basin", model="nope", t0=0)
