"""The port's ``ForecastService`` against the JAX serving computation.

The service runs on the CPU (``device="cpu"``). Its answers are held against
JAX ``Kan.apply -> denormalize_spatial_parameters -> mc.route`` on the same
weights (carried across by ``kan_state_from_flax``), basin and inflow
windows. Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x the largest
magnitude, as for the route. Also: the health watchdog sees every served
batch with its pad rows masked, and its stats match JAX's service program;
entry points refuse to run without a card unless asked for the CPU; the
batcher's queue rules.
"""

from __future__ import annotations

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
from ddr_tpu.nn.kan import Kan as FlaxKan
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing.model import denormalize_spatial_parameters as jax_denormalize
from ddr_tpu.routing.model import prepare_batch as jax_prepare_batch
from ddr_tpu_torch.geodatazoo.synthetic import make_basin
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.routing.model import dmc
from ddr_tpu_torch.routing.network import build_network
from ddr_tpu_torch.serving.batcher import ForecastRequest, MicroBatcher, QueueFullError
from ddr_tpu_torch.serving.config import ServeConfig
from ddr_tpu_torch.serving.service import ForecastService
from ddr_tpu_torch.validation.configs import Config, KanConfig

NAMES = [f"a{i}" for i in range(10)]
HORIZON = 12


def _close(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-8)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


def test_service_answers_match_jax_pipeline():
    kw = dict(n_segments=96, n_gauges=4, n_days=2, seed=23, depth=10)
    ours, ref = make_basin(**kw), jax_make_basin(**kw)
    cfg = Config(kan=KanConfig(input_var_names=NAMES))
    p = cfg.params

    fk = FlaxKan(input_var_names=tuple(NAMES), learnable_parameters=("n", "q_spatial"))
    attrs = jnp.asarray(ref.routing_data.normalized_spatial_attributes)
    variables = fk.init(jax.random.PRNGKey(0), attrs)
    kan = Kan(NAMES, ("n", "q_spatial"))
    kan.load_state_dict(kan_state_from_flax(jax.tree_util.tree_map(np.asarray, variables)))

    svc = ForecastService(cfg, ServeConfig(max_batch=4, horizon_hours=HORIZON), device="cpu")
    try:
        svc.register_network("basin", ours.routing_data, forcing=ours.q_prime)
        svc.register_model("default", kan)
        svc.warmup()
        assert svc.ready
        payload = ours.q_prime[20 : 20 + HORIZON] * 1.5
        futures = [svc.submit("basin", t0=t0) for t0 in (0, 5, 30)]
        futures.append(svc.submit("basin", q_prime=payload, gauges=[1, 3]))
        answers = [f.result(timeout=120) for f in futures]
    finally:
        svc.close()

    raw = fk.apply(variables, attrs)
    phys = jax_denormalize(raw, p.parameter_ranges, p.log_space_parameters, p.defaults, 96)
    net_j, ch_j, g_j = jax_prepare_batch(ref.routing_data, p.attribute_minimums["slope"])
    bounds = jax_mc.Bounds.from_config(p.attribute_minimums)
    windows = [ref.q_prime[t0 : t0 + HORIZON] for t0 in (0, 5, 30)] + [payload]
    for i, (window, ans) in enumerate(zip(windows, answers)):
        expect = jax_mc.route(net_j, ch_j, phys, jnp.asarray(window), gauges=g_j,
                              bounds=bounds, kernel="xla").runoff
        expect = np.asarray(expect)
        if i == 3:
            expect = expect[:, [1, 3]]
        assert ans["runoff"].shape == expect.shape and ans["device_ms"] is None
        _close(expect, ans["runoff"], f"request {i}")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(kan=KanConfig(input_var_names=NAMES))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ForecastService(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dmc(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_network(np.array([1]), np.array([0]), 2)
    from ddr_tpu_torch.routing import mc

    net = build_network(np.array([1]), np.array([0]), 2, device="cpu")
    ch = mc.ChannelState(length=torch.ones(2), slope=torch.ones(2), x_storage=torch.ones(2))
    params = {"n": torch.ones(2), "q_spatial": torch.ones(2), "p_spatial": torch.ones(2)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mc.route(net, ch, params, torch.ones(3, 2))


def test_service_rejects_bad_requests():
    basin = make_basin(n_segments=32, n_gauges=2, n_days=1, seed=1, depth=4)
    svc = ForecastService(Config(kan=KanConfig(input_var_names=NAMES)),
                          ServeConfig(horizon_hours=6), device="cpu")
    try:
        svc.register_network("b", basin.routing_data, forcing=basin.q_prime)
        svc.register_model("default", Kan(NAMES, ("n", "q_spatial")))
        with pytest.raises(ValueError, match="unknown network"):
            svc.submit("nope")
        with pytest.raises(KeyError):
            svc.submit("b", model="nope")
        with pytest.raises(ValueError, match="out of range"):
            svc.submit("b", t0=100)
        with pytest.raises(ValueError, match="q_prime must be"):
            svc.submit("b", q_prime=np.zeros((5, 32)))
        with pytest.raises(ValueError, match="gauges"):
            svc.submit("b", gauges=[7])
    finally:
        svc.close()


def test_batcher_coalesces_by_key_and_rejects_when_full():
    seen = []
    entered, gate = threading.Event(), threading.Event()

    def execute(key, reqs):
        entered.set()
        gate.wait(timeout=10)
        seen.append((key, len(reqs)))
        for r in reqs:
            r.future.set_result(key)

    mb = MicroBatcher(execute, max_batch=3, queue_cap=4, batch_wait_s=0.05)
    try:
        first = mb.submit(ForecastRequest(key="a", payload=None))  # held in execute
        assert entered.wait(timeout=10)
        reqs = [mb.submit(ForecastRequest(key=k, payload=None)) for k in "aaba"]
        with pytest.raises(QueueFullError):
            mb.submit(ForecastRequest(key="a", payload=None))
        gate.set()
        for r in [first, *reqs]:
            assert r.future.result(timeout=10) == r.key
    finally:
        mb.close()
    assert seen == [("a", 1), ("a", 3), ("b", 1)]
    assert mb.stats()["rejected"] == 1


def test_batcher_sheds_expired_requests():
    mb = MicroBatcher(lambda key, reqs: None, max_batch=2, batch_wait_s=0.0)
    try:
        req = ForecastRequest(key="a", payload=None, deadline=time.monotonic() - 1.0)
        mb.submit(req)
        with pytest.raises(Exception, match="deadline"):
            req.future.result(timeout=10)
    finally:
        mb.close()


def test_watchdog_sees_every_served_batch_with_pad_rows_masked(tmp_path, monkeypatch):
    """The watchdog is on by default: warmup feeds it nothing, every served
    batch once. On one padded batch (3 live rows, a pad row of huge inflow)
    the port's health stats equal those of JAX's service program (its
    compiled ``(params, q_prime_batch, n_live) -> (runoff, health)``) within
    rtol 1e-5, and equal the stats of the live rows alone, so the pad row
    was masked out."""
    from ddr_tpu.serving.config import ServeConfig as JaxServeConfig
    from ddr_tpu.serving.service import ForecastService as JaxForecastService
    from ddr_tpu.validation.configs import Config as JaxConfig
    from ddr_tpu_torch.observability.health import compute_health, compute_output_worst

    kw = dict(n_segments=96, n_gauges=4, n_days=2, seed=23, depth=10)
    ours, ref = make_basin(**kw), jax_make_basin(**kw)
    cfg = Config(kan=KanConfig(input_var_names=NAMES))
    fk = FlaxKan(input_var_names=tuple(NAMES), learnable_parameters=("n", "q_spatial"))
    variables = fk.init(jax.random.PRNGKey(0), jnp.asarray(ref.routing_data.normalized_spatial_attributes))
    kan = Kan(NAMES, ("n", "q_spatial"))
    kan.load_state_dict(kan_state_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    for var in [v for v in os.environ if v.startswith("DDR_HEALTH_")]:
        monkeypatch.delenv(var)

    svc = ForecastService(cfg, ServeConfig(max_batch=4, horizon_hours=HORIZON), device="cpu")
    seen = []
    observe = svc.watchdog.observe
    monkeypatch.setattr(svc.watchdog, "observe",
                        lambda stats, **ctx: seen.append((stats, ctx)) or observe(stats, **ctx))
    try:
        svc.register_network("basin", ours.routing_data, forcing=ours.q_prime)
        svc.register_model("default", kan)
        svc.warmup()
        assert svc.status()["batches"] == 0 and svc.health_cfg.enabled
        answers = [f.result(timeout=120) for f in [svc.submit("basin", t0=t0) for t0 in (0, 3, 7, 11, 20)]]
        batches = len({(a["execute_s"], a["device_ms"]) for a in answers})
        status = svc.status()
        assert status["batches"] == batches == len(seen) and status["violations"] == 0
        assert not svc.degraded and svc.stats()["health"]["batches"] == batches
        assert sum(ctx["batch_size"] for _, ctx in seen) == 5
        assert status["spatial"]["worst_idx"] == [int(i) for i in seen[-1][0].worst_idx]

        qp = np.zeros((4, HORIZON, 96), np.float32)
        for i, t0 in enumerate((0, 5, 30)):
            qp[i] = ours.q_prime[t0 : t0 + HORIZON]
        qp[3] = 1e4  # a pad row: if it leaked in, q_max and the residual would show it
        svc._run_batch(svc._networks["basin"], svc.registry.get("default"), qp, n_live=3)
        stats, ctx = seen[-1]
        assert ctx == {"network": "basin", "model": "default", "batch_size": 3}
    finally:
        svc.close()

    jcfg = JaxConfig(name="t", geodataset="synthetic", mode="testing",
                     kan={"input_var_names": NAMES},
                     experiment={"start_time": "1981/10/01", "end_time": "1981/10/10"},
                     params={"save_path": str(tmp_path)})
    jsvc = JaxForecastService(jcfg, JaxServeConfig(max_batch=4, horizon_hours=HORIZON))
    try:
        jnet = jsvc.register_network("basin", ref.routing_data, forcing=ref.q_prime)
        jsvc.register_model("default", fk, variables)
        fn, _ = jsvc._serve_fn(jnet, jsvc.registry.get("default"))
        jrunoff, jstats = fn(jsvc.registry.get("default").params, qp, np.int32(3))
    finally:
        jsvc.close(drain=False)
    for f in ("q_min", "q_max", "mass_residual", "worst_score"):
        _close(np.asarray(getattr(jstats, f)), getattr(stats, f).numpy(), f"health {f} vs JAX")
    assert int(stats.nonfinite) == int(jstats.nonfinite) == 0
    assert set(stats.worst_idx.tolist()) == set(np.asarray(jstats.worst_idx).tolist())
    # the same stats from the live rows alone
    live = torch.as_tensor(np.asarray(jrunoff)[:3])
    alone = compute_health(live, torch.as_tensor(qp[:3]))
    for f in ("q_min", "q_max", "mass_residual"):
        _close(getattr(alone, f).numpy(), getattr(stats, f).numpy(), f"health {f} vs the live rows")
    idx, _ = compute_output_worst(live, svc.health_cfg.top_k)
    assert set(idx.tolist()) == set(stats.worst_idx.tolist())
