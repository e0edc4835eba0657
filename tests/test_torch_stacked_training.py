"""Training and serving on deep networks: the port against the JAX package.

A synthetic basin of depth 1030 (beyond the single-ring cap of 1024, so
``prepare_batch`` gives both packages a stacked band frame) is observed by
each package's twin experiment, and the same flax KAN weights take two train
steps in each, as in ``test_torch_training.py``; then ``ForecastService``
(``device="cpu"``) serves the basin and its answers are held against JAX
``Kan.apply -> denormalize -> mc.route``. Both packages get the same
band-count constants (JAX through ``DDR_WAVE_FIXED_US``/``DDR_WAVE_RING_GBPS``,
the port through its module constants), chosen so the frame has 5 bands.

Tolerances as in ``test_torch_training.py`` and ``test_torch_service.py``:
loss and daily predictions rtol 1e-5, KAN gradients rtol 1e-4 (absolute
floor 1e-5 x the leaf's largest magnitude), post-step parameters under the
Adam rule there, served answers rtol 1e-5 with an absolute floor of 1e-5 x
the largest magnitude.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu import training as jax_training
from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
from ddr_tpu.geodatazoo.synthetic import observe as jax_observe
from ddr_tpu.nn.kan import Kan as FlaxKan
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing.model import denormalize_spatial_parameters as jax_denormalize
from ddr_tpu.routing.model import prepare_batch as jax_prepare_batch
from ddr_tpu.routing.stacked import StackedChunked as JaxStackedChunked
from ddr_tpu_torch import training
from ddr_tpu_torch.geodatazoo.synthetic import make_basin, observe
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.routing import stacked
from ddr_tpu_torch.routing.mc import Bounds
from ddr_tpu_torch.routing.model import engine_label, prepare_batch
from ddr_tpu_torch.routing.stacked import StackedChunked
from ddr_tpu_torch.serving.config import ServeConfig
from ddr_tpu_torch.serving.service import ForecastService
from ddr_tpu_torch.validation.configs import Config, KanConfig
from tests.test_torch_training import _check_params, _close

NAMES = tuple(f"a{i}" for i in range(10))
N_DAYS, WARMUP = 4, 1
LR1, LR2 = 0.005, 0.001
BASIN = dict(n_segments=1100, n_gauges=4, n_days=N_DAYS, seed=6, depth=1030)
FIXED_US, RING_GBPS = 30.0, 1.0  # 5 bands at this shape


def _same_band_constants(mp: pytest.MonkeyPatch) -> None:
    mp.setenv("DDR_WAVE_FIXED_US", str(FIXED_US))
    mp.setenv("DDR_WAVE_RING_GBPS", str(RING_GBPS))
    mp.setattr(stacked, "WAVE_FIXED_S", FIXED_US * 1e-6)
    mp.setattr(stacked, "RING_COPY_BYTES_PER_S", RING_GBPS * 1e9)


class _Case:
    """Both packages' observed deep basin, step, loss and state."""

    def __init__(self):
        cfg = Config(kan=KanConfig(input_var_names=list(NAMES)))
        p = cfg.params
        jcfg = types.SimpleNamespace(params=types.SimpleNamespace(
            attribute_minimums=p.attribute_minimums, tau=p.tau))
        ours = observe(make_basin(**BASIN), cfg, device="cpu")
        ref = jax_observe(jax_make_basin(**BASIN), jcfg)
        self.obs_ours, self.obs_ref = ours.obs_daily, ref.obs_daily
        obs = ref.obs_daily[: N_DAYS - 2]
        mask = np.isfinite(obs)
        attrs = ours.routing_data.normalized_spatial_attributes
        q = ours.q_prime[: (N_DAYS - 1) * 24]
        bounds_kw = {k: v for k, v in p.attribute_minimums.items() if k != "slope"}
        n = BASIN["n_segments"]

        fk = FlaxKan(input_var_names=NAMES, learnable_parameters=("n", "q_spatial"))
        self.jparams = jax.tree_util.tree_map(np.asarray, fk.init(jax.random.PRNGKey(0), attrs))
        net_j, ch_j, g_j = jax_prepare_batch(ref.routing_data, p.attribute_minimums["slope"])
        jbounds = jax_mc.Bounds(**bounds_kw)
        self.jopt = jax_training.make_optimizer(LR1)
        self.jstate = self.jopt.init(self.jparams)
        self.jstep = jax_training.make_batch_train_step(
            fk, jbounds, p.parameter_ranges, p.log_space_parameters, p.defaults, p.tau, WARMUP,
            self.jopt, donate=False,
        )
        self.jargs = (net_j, ch_j, g_j, jnp.asarray(attrs), jnp.asarray(q),
                      jnp.asarray(np.nan_to_num(obs)), jnp.asarray(mask))

        def jloss(params):
            raw = fk.apply(params, self.jargs[3])
            spatial = jax_denormalize(raw, p.parameter_ranges, p.log_space_parameters, p.defaults, n)
            res = jax_mc.route(net_j, ch_j, spatial, self.jargs[4], gauges=g_j, bounds=jbounds)
            return jax_training.masked_l1_daily(res.runoff, self.jargs[5], self.jargs[6], p.tau, WARMUP)

        self.jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))

        self.kan = Kan(NAMES, ("n", "q_spatial"))
        self.kan.load_state_dict(kan_state_from_flax(self.jparams))
        self.opt = training.make_optimizer(self.kan.parameters(), LR1)
        net, ch, g = prepare_batch(ours.routing_data, p.attribute_minimums["slope"], device="cpu")
        self.networks = (net, net_j)
        self.step = training.make_batch_train_step(
            self.kan, Bounds(**bounds_kw), p.parameter_ranges, p.log_space_parameters, p.defaults,
            p.tau, WARMUP, self.opt, device="cpu",
        )
        self.args = (net, ch, g, torch.as_tensor(attrs), torch.as_tensor(q),
                     torch.as_tensor(np.nan_to_num(obs)), torch.as_tensor(mask))

    def both_steps(self):
        _, grads = self.jgrad(self.jparams)
        jgrads = kan_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
        self.jparams, self.jstate, jl, jd = self.jstep(self.jparams, self.jstate, *self.jargs)
        raw_grads = {}
        hooks = [p.register_hook(lambda g, k=k: raw_grads.__setitem__(k, g.clone()))
                 for k, p in self.kan.named_parameters()]
        loss, daily = self.step(*self.args)
        for h in hooks:
            h.remove()
        return jl, jd, loss, daily, raw_grads, jgrads


@pytest.fixture(scope="module")
def case():
    with pytest.MonkeyPatch.context() as mp:
        _same_band_constants(mp)
        return _Case()


def test_deep_basin_routes_on_the_stacked_frame_in_both_packages(case):
    net, net_j = case.networks
    assert isinstance(net, StackedChunked) and isinstance(net_j, JaxStackedChunked)
    assert net.n_chunks == net_j.n_chunks == 5 and net.span_max == net_j.span_max
    assert engine_label(net) == "stacked-chunked-wavefront[5-band-scan]"


def test_observe_on_a_deep_basin_matches_jax(case):
    assert case.obs_ours.shape == case.obs_ref.shape == (N_DAYS - 1, 4)
    _close(case.obs_ref, case.obs_ours, "observed daily discharge")


def test_two_train_steps_on_a_deep_basin_match_jax(case):
    for i, lr in enumerate((LR1, LR2)):
        if i == 1:
            jax_training.set_learning_rate(case.jstate, lr)
            training.set_learning_rate(case.opt, lr)
        ref_before = kan_state_from_flax(case.jparams)
        before = {k: v.clone() for k, v in case.kan.state_dict().items()}
        jl, jd, loss, daily, grads, jgrads = case.both_steps()
        label = f"step {i + 1} (lr {lr})"
        assert np.isfinite(float(loss)) and float(loss) > 0.0
        _close(jl, loss, f"{label}: loss")
        _close(jd, daily, f"{label}: daily")
        for k, g in grads.items():
            _close(jgrads[k], g, f"{label}: grad {k}", rtol=1e-4)
        _check_params(ref_before, kan_state_from_flax(case.jparams), before, case.kan.state_dict(),
                      grads, lr, label)


def test_service_serves_a_deep_basin_like_jax(monkeypatch):
    _same_band_constants(monkeypatch)
    horizon = 12
    kw = dict(BASIN, n_days=2)
    ours, ref = make_basin(**kw), jax_make_basin(**kw)
    cfg = Config(kan=KanConfig(input_var_names=list(NAMES)))
    p = cfg.params
    fk = FlaxKan(input_var_names=NAMES, learnable_parameters=("n", "q_spatial"))
    attrs = jnp.asarray(ref.routing_data.normalized_spatial_attributes)
    variables = fk.init(jax.random.PRNGKey(1), attrs)
    kan = Kan(list(NAMES), ("n", "q_spatial"))
    kan.load_state_dict(kan_state_from_flax(jax.tree_util.tree_map(np.asarray, variables)))

    svc = ForecastService(cfg, ServeConfig(max_batch=2, horizon_hours=horizon), device="cpu")
    try:
        entry = svc.register_network("deep", ours.routing_data, forcing=ours.q_prime)
        assert isinstance(entry.network, StackedChunked) and entry.network.n_chunks == 5
        svc.register_model("default", kan)
        svc.warmup()
        answers = [f.result(timeout=300) for f in [svc.submit("deep", t0=t0) for t0 in (0, 9)]]
    finally:
        svc.close()

    raw = fk.apply(variables, attrs)
    phys = jax_denormalize(raw, p.parameter_ranges, p.log_space_parameters, p.defaults,
                           kw["n_segments"])
    net_j, ch_j, g_j = jax_prepare_batch(ref.routing_data, p.attribute_minimums["slope"])
    assert isinstance(net_j, JaxStackedChunked) and net_j.n_chunks == 5
    bounds = jax_mc.Bounds.from_config(p.attribute_minimums)
    for t0, ans in zip((0, 9), answers):
        expect = jax_mc.route(net_j, ch_j, phys, jnp.asarray(ref.q_prime[t0 : t0 + horizon]),
                              gauges=g_j, bounds=bounds, kernel="xla").runoff
        assert ans["runoff"].shape == expect.shape == (horizon, 4)
        _close(np.asarray(expect), ans["runoff"], f"request at t0 {t0}")
