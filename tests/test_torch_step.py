"""The port's step engine against the JAX package's ``route(engine="step")``.

The step engine routes one timestep at a time: the hotstart solve (or the
carried ``q_init``), then ``T - 1`` Muskingum-Cunge steps, each a level
scheduled triangular solve (``ddr_tpu_torch.routing.solver``) on the fused
schedule where the network has one, else on the rectangle. It computes in
its inputs' dtype, so it is the float64 oracle of the wavefront engines, and
it routes networks of depth 0. The same basins, parameters and inflows, made
from fixed seeds with numpy, go through both packages in float32 and in
float64 (JAX under ``jax.enable_x64()``, scoped); the health stats' two
per-reach branches (carried accumulators with gauges, the full field
without), a depth-0 network, gradients, a batch and the engine's errors.

Tolerances: float32 rtol 1e-5 with an absolute floor of 1e-5 x the largest
magnitude; float64 rtol 1e-12 (the same float64 operations, reassociated
only where a solve row sums several edges); gradients rtol 1e-4.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing import model as jax_model
from ddr_tpu.routing.network import build_network as jax_build_network
from ddr_tpu_torch.geodatazoo.synthetic import make_basin, make_deep_network
from ddr_tpu_torch.routing import mc, model
from ddr_tpu_torch.routing.network import build_network

N, DEPTH, T = 200, 24, 12
LB = 1e-4
GAUGES = [np.array([N - 1]), np.array([5, 17, 150]), np.array([40, 41])]


def _close(ref, out, label, rtol=1e-5):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = max(np.max(np.abs(ref)), np.max(np.abs(out)), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * scale, err_msg=label)


def _inputs(seed=3, n=N, depth=DEPTH):
    rng = np.random.default_rng(seed)
    rows, cols = make_deep_network(n, depth, seed=seed) if depth else (np.zeros(0, np.int64),) * 2
    data = {
        "length": rng.uniform(1000, 5000, n), "slope": rng.uniform(1e-3, 1e-2, n), "x": np.full(n, 0.3),
        "n": rng.uniform(0.02, 0.2, n), "q_spatial": rng.uniform(0.1, 0.9, n), "p_spatial": np.full(n, 21.0),
    }
    q = rng.uniform(0.0, 1.0, (T, n))
    q[rng.random(q.shape) < 0.2] = 0.0  # inflows below the discharge clamp
    q_init = rng.uniform(0.0, 2.0, n)
    q_init[::6] = 0.0
    return rows, cols, n, data, q, q_init


def _route_both(args, fused, dtype, init, gauged, **kw):
    rows, cols, n, data, q, q_init = args
    npd = np.float64 if dtype == "f64" else np.float32
    tdt = torch.float64 if dtype == "f64" else torch.float32
    t = lambda a: torch.as_tensor(np.asarray(a, npd))  # noqa: E731
    net = build_network(rows, cols, n, fused=fused, device="cpu")
    assert net.fused == bool(fused)
    res = mc.route(net, mc.ChannelState(length=t(data["length"]), slope=t(data["slope"]),
                                        x_storage=t(data["x"])),
                   {k: t(data[k]) for k in ("n", "q_spatial", "p_spatial")}, t(q),
                   q_init=t(q_init) if init else None,
                   gauges=mc.GaugeIndex.from_ragged(GAUGES, device="cpu") if gauged else None,
                   bounds=mc.Bounds(discharge=LB), engine="step", device="cpu", **kw)
    assert res.runoff.dtype == tdt

    def jax_run():
        j = lambda a: jnp.asarray(np.asarray(a, npd))  # noqa: E731
        jnet = jax_build_network(rows, cols, n, fused=fused)
        ch = jax_mc.ChannelState(length=j(data["length"]), slope=j(data["slope"]), x_storage=j(data["x"]))
        return jax_mc.route(jnet, ch, {k: j(data[k]) for k in ("n", "q_spatial", "p_spatial")}, j(q),
                            q_init=j(q_init) if init else None,
                            gauges=jax_mc.GaugeIndex.from_ragged(GAUGES) if gauged else None,
                            bounds=jax_mc.Bounds(discharge=LB), engine="step", **kw)

    if dtype == "f64":
        with jax.enable_x64():
            ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax_run)())
        assert ref.runoff.dtype == np.float64
    else:
        ref = jax.jit(jax_run)()
    return res, ref


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", ["fused/hotstart/gauges", "rectangle/q_init/full-domain",
                                  "rectangle/hotstart/gauges"])
def test_step_route_matches_jax(case, dtype):
    schedule, init, where = case.split("/")
    res, ref = _route_both(_inputs(), schedule == "fused", dtype, init == "q_init", where == "gauges")
    rtol = 1e-12 if dtype == "f64" else 1e-5
    assert res.runoff.shape == ref.runoff.shape
    _close(ref.runoff, res.runoff, f"{case} {dtype}: runoff", rtol)
    _close(ref.final_discharge, res.final_discharge, f"{case} {dtype}: final discharge", rtol)


@pytest.mark.parametrize("gauged", [True, False], ids=["carried-accumulators", "full-field"])
def test_step_reach_stats_match_jax(gauged):
    """Both per-reach branches of the band health: the carried
    accumulators (gauges) and the reductions over the full field."""
    res, ref = _route_both(_inputs(5), True, "f32", True, gauged, collect_health=True, health_bands=4,
                           health_topk=5)
    h, jh = res.health, ref.health
    assert int(h.nonfinite) == int(jh.nonfinite)
    for field in ("q_min", "q_max", "mass_residual", "band_q_min", "band_q_max", "band_residual"):
        _close(getattr(jh, field), getattr(h, field), f"health {field}")
    np.testing.assert_array_equal(h.band_nonfinite.numpy(), np.asarray(jh.band_nonfinite))
    _close(jh.worst_score, h.worst_score, "worst scores")
    assert set(h.worst_idx.tolist()) == set(np.asarray(jh.worst_idx).tolist())


def test_depth_zero_network_routes_on_the_step_engine():
    """No edges: no wavefront tables, so ``route`` picks the step engine
    (it used to raise) and each reach routes alone, as in JAX."""
    rows, cols, n, data, q, q_init = _inputs(7, n=16, depth=0)
    net = build_network(rows, cols, n, device="cpu")
    assert net.depth == 0 and not net.wavefront
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    j = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    res = mc.route(net, mc.ChannelState(length=t(data["length"]), slope=t(data["slope"]), x_storage=t(data["x"])),
                   {k: t(data[k]) for k in ("n", "q_spatial", "p_spatial")}, t(q), device="cpu")
    ref = jax_mc.route(jax_build_network(rows, cols, n),
                       jax_mc.ChannelState(length=j(data["length"]), slope=j(data["slope"]), x_storage=j(data["x"])),
                       {k: j(data[k]) for k in ("n", "q_spatial", "p_spatial")}, j(q))
    _close(ref.runoff, res.runoff, "depth-0 runoff")
    _close(ref.final_discharge, res.final_discharge, "depth-0 final discharge")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "rectangle"])
def test_step_gradients_match_jax(fused):
    rows, cols, n, data, q, q_init = _inputs(9)
    w = np.random.default_rng(10).normal(size=(T, len(GAUGES))).astype(np.float32)
    jnet = jax_build_network(rows, cols, n, fused=fused)
    jg = jax_mc.GaugeIndex.from_ragged(GAUGES)
    f32 = {k: np.asarray(v, np.float32) for k, v in data.items()}

    def loss(params, qp, length):
        ch = jax_mc.ChannelState(length=length, slope=jnp.asarray(f32["slope"]), x_storage=jnp.asarray(f32["x"]))
        res = jax_mc.route(jnet, ch, params, qp, gauges=jg, bounds=jax_mc.Bounds(discharge=LB), engine="step")
        return (res.runoff * w).sum() + res.final_discharge.sum()

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        {k: jnp.asarray(f32[k]) for k in ("n", "q_spatial", "p_spatial")}, jnp.asarray(np.float32(q)),
        jnp.asarray(f32["length"]))
    p = {k: torch.tensor(f32[k], requires_grad=True) for k in ("n", "q_spatial", "p_spatial")}
    qp = torch.tensor(np.float32(q), requires_grad=True)
    length = torch.tensor(f32["length"], requires_grad=True)
    net = build_network(rows, cols, n, fused=fused, device="cpu")
    res = mc.route(net, mc.ChannelState(length=length, slope=torch.tensor(f32["slope"]),
                                        x_storage=torch.tensor(f32["x"])),
                   p, qp, gauges=mc.GaugeIndex.from_ragged(GAUGES, device="cpu"),
                   bounds=mc.Bounds(discharge=LB), device="cpu")
    ((res.runoff * torch.as_tensor(w)).sum() + res.final_discharge.sum()).backward()
    for k in p:
        _close(ref[0][k], p[k].grad, f"d/d{k}", rtol=1e-4)
    _close(ref[1], qp.grad, "d/dq_prime", rtol=1e-4)
    _close(ref[2], length.grad, "d/dlength", rtol=1e-4)


def test_batched_step_route_equals_per_request_routes():
    rows, cols, n, data, q, q_init = _inputs(11)
    net = build_network(rows, cols, n, wavefront=False, device="cpu")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    ch = mc.ChannelState(length=t(data["length"]), slope=t(data["slope"]), x_storage=t(data["x"]))
    params = {k: t(data[k]) for k in ("n", "q_spatial", "p_spatial")}
    batch = torch.stack([t(q), 0.5 * t(q)])
    q_init_b = torch.stack([t(q_init), t(q_init) + 1.0])
    res = mc.route(net, ch, params, batch, q_init=q_init_b, collect_health=True, health_bands=3,
                   device="cpu")
    for i in range(2):
        one = mc.route(net, ch, params, batch[i], q_init=q_init_b[i], device="cpu")
        torch.testing.assert_close(res.runoff[i], one.runoff)
        torch.testing.assert_close(res.final_discharge[i], one.final_discharge)
    assert res.health.band_q_max.shape == (3,)


def test_step_engine_errors_are_jaxs():
    rows, cols, n, data, q, _ = _inputs()
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    args = (mc.ChannelState(length=t(data["length"]), slope=t(data["slope"]), x_storage=t(data["x"])),
            {k: t(data[k]) for k in ("n", "q_spatial", "p_spatial")}, t(q))
    net = build_network(rows, cols, n, device="cpu")
    assert net.wavefront  # the default picks the wavefront engine; "step" is asked for
    for adjoint in ("analytic", "ad"):
        with pytest.raises(ValueError, match="step engine"):
            mc.route(net, *args, engine="step", adjoint=adjoint, device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        mc.route(net, *args, engine="step", dtype="bf16", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        mc.route(net, *args, engine="steps", device="cpu")
    ref = mc.route(net, *args, engine="step", kernel="reference", device="cpu")  # no kernel to pick
    torch.testing.assert_close(ref.runoff, mc.route(net, *args, engine="step", device="cpu").runoff)


def test_engine_none_on_a_deep_plain_network_warns_of_the_step_engine(caplog):
    """JAX's dispatch sends a network without wavefront tables to the step
    engine; the port does too, and says so when the network is deep (a
    slow path on a card). An explicit ``engine="step"``, a network with
    tables and a depth-0 network route without the warning."""
    rows, cols, n, data, q, _ = _inputs(13)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    args = (mc.ChannelState(length=t(data["length"]), slope=t(data["slope"]), x_storage=t(data["x"])),
            {k: t(data[k]) for k in ("n", "q_spatial", "p_spatial")}, t(q))
    plain = build_network(rows, cols, n, wavefront=False, device="cpu")
    with caplog.at_level(logging.WARNING, logger="ddr_tpu_torch.routing.mc"):
        res = mc.route(plain, *args, device="cpu")
    warned = [r.getMessage() for r in caplog.records if r.name == "ddr_tpu_torch.routing.mc"]
    assert len(warned) == 1 and f"depth {DEPTH}" in warned[0] and "step engine" in warned[0]
    assert "engine='step'" in warned[0] and "build_routing_network" in warned[0]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="ddr_tpu_torch.routing.mc"):
        step = mc.route(plain, *args, engine="step", device="cpu")
        mc.route(build_network(rows, cols, n, device="cpu"), *args, device="cpu")
        flat = _inputs(7, n=16, depth=0)
        mc.route(build_network(flat[0], flat[1], 16, device="cpu"),
                 mc.ChannelState(length=t(flat[3]["length"]), slope=t(flat[3]["slope"]),
                                 x_storage=t(flat[3]["x"])),
                 {k: t(flat[3][k]) for k in ("n", "q_spatial", "p_spatial")}, t(flat[4]), device="cpu")
    assert not [r for r in caplog.records if r.name == "ddr_tpu_torch.routing.mc"]
    torch.testing.assert_close(res.runoff, step.runoff, rtol=0, atol=0)


@pytest.mark.parametrize("fused, chunked", [(None, True), (None, False), (False, True), (True, True)],
                         ids=["default", "chunked-off", "fused-off", "fused-on"])
def test_prepare_batch_options_pick_jaxs_network(fused, chunked):
    """``prepare_batch(fused=, chunked=)`` on a basin past the single-ring
    depth cap: the default builds the stacked band frame, ``chunked=False``
    or an explicit ``fused`` a plain network (its fused schedule as asked)
    that routes on the step engine, as in the JAX package."""
    kw = dict(n_segments=1100, n_gauges=4, n_days=2, seed=6, depth=1030)
    ours, ref = make_basin(**kw).routing_data, jax_make_basin(**kw).routing_data
    try:
        jnet, *_ = jax_model.prepare_batch(ref, 1e-3, fused=fused, chunked=chunked)
    except ValueError:
        with pytest.raises(ValueError):
            model.prepare_batch(ours, 1e-3, device="cpu", fused=fused, chunked=chunked)
        return
    net, channels, gauges = model.prepare_batch(ours, 1e-3, device="cpu", fused=fused, chunked=chunked)
    assert type(net).__name__ == type(jnet).__name__
    assert model.engine_label(net) == jax_model.engine_label(jnet)
    if (fused, chunked) == (None, True):
        assert model.engine_label(net).startswith("stacked-chunked-wavefront")
    else:
        assert not net.wavefront and net.fused == bool(jnet.fused)
        np.testing.assert_array_equal(net.edge_src.numpy(), np.asarray(jnet.edge_src))
        np.testing.assert_array_equal(net.edge_tgt.numpy(), np.asarray(jnet.edge_tgt))
    assert channels.length.shape == (1100,) and gauges.n_gauges == 4
