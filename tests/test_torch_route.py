"""The port's ``route`` and ``dmc`` against the JAX package's ``mc.route``.

The same basin (the port's synthetic generator draws the JAX generator's
stream), parameters and inflows go through JAX ``mc.route(...,
kernel="xla")`` and the port's wavefront engine on the CPU, for gauge and
full-domain outputs, in-band hotstart and carried state, one request and a
batch; and a chain too deep for the single ring, through the stacked band
router. Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x the largest
magnitude, as for the wave scan.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing.chunked import build_routing_network as jax_build_routing_network
from ddr_tpu.routing.model import prepare_batch as jax_prepare_batch
from ddr_tpu.routing.network import build_network as jax_build_network
from ddr_tpu_torch.geodatazoo.synthetic import make_basin
from ddr_tpu_torch.routing import mc
from ddr_tpu_torch.routing.model import dmc, prepare_batch
from ddr_tpu_torch.routing.chunked import build_routing_network
from ddr_tpu_torch.routing.network import build_network
from ddr_tpu_torch.routing.stacked import StackedChunked
from ddr_tpu_torch.validation.configs import Config, KanConfig

SLOPE_MIN = 0.001
T = 24


def _close(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-8)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


def _basins(seed=11):
    kw = dict(n_segments=96, n_gauges=4, n_days=2, seed=seed, depth=12)
    return make_basin(**kw), jax_make_basin(**kw)


def _params(basin):
    rng = np.random.default_rng(13)
    n = basin.routing_data.n_segments
    return {
        "n": rng.uniform(0.02, 0.1, n).astype(np.float32),
        "q_spatial": rng.uniform(0.1, 0.9, n).astype(np.float32),
        "p_spatial": np.full(n, 21.0, np.float32),
    }


def test_synthetic_basin_matches_jax():
    ours, ref = _basins()
    for field in ("adjacency_rows", "adjacency_cols", "normalized_spatial_attributes",
                  "length", "slope", "x"):
        np.testing.assert_array_equal(
            getattr(ours.routing_data, field), getattr(ref.routing_data, field), err_msg=field
        )
    np.testing.assert_array_equal(ours.q_prime, ref.q_prime)
    for a, b in zip(ours.routing_data.outflow_idx, ref.routing_data.outflow_idx):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gauged", [True, False], ids=["gauges", "full-domain"])
@pytest.mark.parametrize("init", ["hotstart", "q_init"])
def test_route_matches_jax(gauged, init):
    ours, ref = _basins()
    params = _params(ours)
    q = ours.q_prime[:T]
    q[:, ::7] = 0.0  # headwater inflows below the discharge clamp
    q_init = np.random.default_rng(17).uniform(0.0, 3.0, q.shape[1]).astype(np.float32)

    net_j, ch_j, g_j = jax_prepare_batch(ref.routing_data, SLOPE_MIN)
    res_j = jax_mc.route(
        net_j, ch_j, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(q),
        q_init=jnp.asarray(q_init) if init == "q_init" else None,
        gauges=g_j if gauged else None, kernel="xla",
    )
    net, ch, g = prepare_batch(ours.routing_data, SLOPE_MIN, device="cpu")
    res = mc.route(
        net, ch, {k: torch.as_tensor(v) for k, v in params.items()}, torch.as_tensor(q),
        q_init=torch.as_tensor(q_init) if init == "q_init" else None,
        gauges=g if gauged else None, device="cpu",
    )
    _close(res_j.runoff, res.runoff, "runoff")
    _close(res_j.final_discharge, res.final_discharge, "final discharge")


def test_batched_route_equals_per_request_routes():
    ours, _ = _basins()
    params = {k: torch.as_tensor(v) for k, v in _params(ours).items()}
    net, ch, g = prepare_batch(ours.routing_data, SLOPE_MIN, device="cpu")
    q = torch.as_tensor(ours.q_prime[:T])
    batch = torch.stack([q, 0.5 * q, 2.0 * q])
    res_b = mc.route(net, ch, params, batch, gauges=g, device="cpu")
    for i in range(3):
        res_i = mc.route(net, ch, params, batch[i], gauges=g, device="cpu")
        torch.testing.assert_close(res_b.runoff[i], res_i.runoff)
        torch.testing.assert_close(res_b.final_discharge[i], res_i.final_discharge)


def test_dmc_carries_state_like_jax_route():
    ours, ref = _basins(seed=19)
    params = _params(ours)
    cfg = Config(kan=KanConfig(input_var_names=[f"a{i}" for i in range(10)]))
    # raw KAN-space values whose denormalization gives `params`
    lo_n, hi_n = cfg.params.parameter_ranges["n"]
    raw = {"n": torch.as_tensor((params["n"] - lo_n) / (hi_n - lo_n)),
           "q_spatial": torch.as_tensor(params["q_spatial"])}
    model = dmc(cfg, device="cpu")
    first = model(ours.routing_data, ours.q_prime[:T], raw, carry_state=True)["runoff"]
    second = model(ours.routing_data, ours.q_prime[T : 2 * T], raw, carry_state=True)["runoff"]

    net_j, ch_j, g_j = jax_prepare_batch(ref.routing_data, cfg.params.attribute_minimums["slope"])
    phys = {"n": jnp.asarray(raw["n"].numpy()) * (hi_n - lo_n) + lo_n,
            "q_spatial": jnp.asarray(params["q_spatial"]),
            "p_spatial": jnp.full(96, 21.0, jnp.float32)}
    bounds = jax_mc.Bounds.from_config(cfg.params.attribute_minimums)
    r1 = jax_mc.route(net_j, ch_j, phys, jnp.asarray(ref.q_prime[:T]), gauges=g_j,
                      bounds=bounds, kernel="xla")
    r2 = jax_mc.route(net_j, ch_j, phys, jnp.asarray(ref.q_prime[T : 2 * T]),
                      q_init=r1.final_discharge, gauges=g_j, bounds=bounds, kernel="xla")
    _close(np.asarray(r1.runoff).T, first, "first window")
    _close(np.asarray(r2.runoff).T, second, "second window (carried state)")


def test_dmc_state_dict_round_trips_like_jax():
    """``set_progress_info``, ``state_dict`` and ``load_state_dict`` against
    JAX's ``dmc``: the same counters and carried discharge after one
    carried window, and a fresh wrapper loaded from the state routes the
    next window as the original does (and as JAX's does)."""
    from ddr_tpu.routing.model import dmc as jax_dmc
    from ddr_tpu.validation.configs import Config as JaxConfig

    ours, ref = _basins(seed=23)
    params = _params(ours)
    names = [f"a{i}" for i in range(10)]
    cfg = Config(kan=KanConfig(input_var_names=names))
    jcfg = JaxConfig(name="dmc", geodataset="synthetic", mode="routing", kan={"input_var_names": names})
    lo_n, hi_n = cfg.params.parameter_ranges["n"]
    raw = {"n": (params["n"] - lo_n) / (hi_n - lo_n), "q_spatial": params["q_spatial"]}
    model, jmodel = dmc(cfg, device="cpu"), jax_dmc(jcfg, device="cpu")
    assert model.state_dict()["discharge_t"] is None and jmodel.state_dict()["discharge_t"] is None
    model(ours.routing_data, ours.q_prime[:T], {k: torch.as_tensor(v) for k, v in raw.items()},
          carry_state=True)
    jmodel(ref.routing_data, ref.q_prime[:T], {k: jnp.asarray(v) for k, v in raw.items()},
           carry_state=True)
    for m in (model, jmodel):
        m.set_progress_info(epoch=3, mini_batch=7)
    state, jstate = model.state_dict(), jmodel.state_dict()
    assert set(state) == set(jstate)
    assert (state["epoch"], state["mini_batch"]) == (jstate["epoch"], jstate["mini_batch"]) == (3, 7)
    assert state["cfg"] is cfg and state["device"] == "cpu"
    assert isinstance(state["discharge_t"], np.ndarray)
    _close(jstate["discharge_t"], state["discharge_t"], "carried discharge")

    fresh = dmc(Config(kan=KanConfig(input_var_names=names[:4])), device="cpu")
    fresh.load_state_dict(state)
    assert (fresh.epoch, fresh.mini_batch, fresh.cfg) == (3, 7, cfg)
    jfresh = jax_dmc(jcfg, device="cpu")
    jfresh.load_state_dict(jstate)
    window = {k: torch.as_tensor(v) for k, v in raw.items()}
    nxt = slice(T, 2 * T)
    want = model(ours.routing_data, ours.q_prime[nxt], window, carry_state=True)["runoff"]
    got = fresh(ours.routing_data, ours.q_prime[nxt], window, carry_state=True)["runoff"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jgot = jfresh(ref.routing_data, ref.q_prime[nxt], {k: jnp.asarray(v) for k, v in raw.items()},
                  carry_state=True)["runoff"]
    _close(np.asarray(jgot), got, "second window after load_state_dict")


def test_ineligible_network_raises_not_implemented():
    """A chain deeper than the single-ring cap: as a plain network it has no
    wavefront tables, and ``route`` gives it the step engine, as JAX does
    (an explicit ``engine="wavefront"`` is refused); through
    ``build_routing_network`` it routes on the stacked band router. Both
    match JAX."""
    n = 1100
    rows, cols = np.arange(1, n), np.arange(0, n - 1)
    net = build_network(rows, cols, n, device="cpu")
    assert not net.single_ring
    rng = np.random.default_rng(5)
    ch_np = {"length": rng.uniform(800.0, 6000.0, n), "slope": rng.uniform(1e-3, 1e-2, n),
             "x": np.full(n, 0.3)}
    params_np = {"n": rng.uniform(0.02, 0.1, n), "q_spatial": rng.uniform(0.1, 0.9, n),
                 "p_spatial": np.full(n, 21.0)}
    q = rng.uniform(0.0, 2.0, (4, n)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    ch = mc.ChannelState(length=t(ch_np["length"]), slope=t(ch_np["slope"]), x_storage=t(ch_np["x"]))
    params = {k: t(v) for k, v in params_np.items()}
    assert not net.wavefront
    with pytest.raises(ValueError, match="without wavefront tables"):
        mc.route(net, ch, params, t(q), engine="wavefront", device="cpu")
    j = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    jch = jax_mc.ChannelState(length=j(ch_np["length"]), slope=j(ch_np["slope"]), x_storage=j(ch_np["x"]))
    jparams = {k: j(v) for k, v in params_np.items()}
    stacked = build_routing_network(rows, cols, n, device="cpu")
    assert isinstance(stacked, StackedChunked) and stacked.depth == n - 1
    for label, ours, theirs in (("step engine", net, jax_build_network(rows, cols, n)),
                                ("stacked router", stacked, jax_build_routing_network(rows, cols, n))):
        res = mc.route(ours, ch, params, t(q), device="cpu")
        ref = jax_mc.route(theirs, jch, jparams, j(q), kernel="xla")
        _close(ref.runoff, res.runoff, f"runoff of the 1100-deep chain, {label}")
        _close(ref.final_discharge, res.final_discharge, f"final discharge of the 1100-deep chain, {label}")


def test_inputs_that_require_grad_raise():
    """Inputs that require grad: unknown adjoints raise; the analytic
    adjoint (the default) and ``adjoint="ad"`` (autograd through the plain
    scan) give finite gradients to every parameter, the inflows and the
    channel lengths, and the same ones."""
    ours, _ = _basins()
    params = {k: torch.as_tensor(v).requires_grad_(True) for k, v in _params(ours).items()}
    net, ch, g = prepare_batch(ours.routing_data, SLOPE_MIN, device="cpu")
    ch = dataclasses.replace(ch, length=ch.length.clone().requires_grad_(True))
    q = torch.as_tensor(ours.q_prime[:T]).requires_grad_(True)
    with pytest.raises(ValueError, match="unknown adjoint"):
        mc.route(net, ch, params, q, gauges=g, adjoint="bogus", device="cpu")
    leaves = [*params.values(), q, ch.length]
    grads = {}
    for adjoint in ("analytic", "ad"):
        res = mc.route(net, ch, params, q, gauges=g, adjoint=adjoint, device="cpu")
        grads[adjoint] = torch.autograd.grad(res.runoff.sum() + res.final_discharge.sum(), leaves)
    for name, t, ga, gd in zip([*params, "q_prime", "length"], leaves, *grads.values()):
        assert ga.shape == t.shape, name
        assert torch.isfinite(ga).all() and ga.abs().sum() > 0, name
        _close(ga.numpy(), gd.numpy(), f"d/d{name}, analytic vs ad")
