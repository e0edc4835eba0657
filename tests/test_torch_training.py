"""The port's train step against ``ddr_tpu.training.make_batch_train_step``.

One synthetic basin (the port's generator draws the JAX generator's stream)
is observed by each package's twin experiment, and the same flax KAN weights
(carried across by ``kan_state_from_flax``) take two steps in each: one at lr
0.005, then one after ``set_learning_rate(..., 0.001)``. JAX routes with its
analytic adjoint on the XLA scan; the port with its analytic adjoint on the
plain scans (the CPU versions of the CUDA kernels).

Tolerances: loss and daily predictions rtol 1e-5; KAN gradients rtol 1e-4
with an absolute floor of 1e-5 x the leaf's largest magnitude (the reductions
over reaches run in another order); post-step parameters rtol 1e-5, with an
absolute floor of 1e-5 x lr (the size of one update, so that a parameter
near zero is not held to the rounding of ``p - update``), where ``|grad| >=
1e-4 x max|grad|`` of the leaf, else ``|change| <= lr (1 + 1e-3)`` (Adam moves every component with a nonzero gradient by about ``lr``
at its first step, so a noise-level gradient whose sign differs between the
two frameworks moves its parameter the other way).

The window is 4 days (T = 96 h) with a 1-day warmup: the daily loss needs
at least two days after the tau trim.
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
from ddr_tpu.routing.model import prepare_batch as jax_prepare_batch
from ddr_tpu_torch import training
from ddr_tpu_torch.geodatazoo.synthetic import make_basin, observe
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.routing.mc import Bounds
from ddr_tpu_torch.routing.model import prepare_batch
from ddr_tpu_torch.scripts_utils import compute_daily_runoff, resolve_learning_rate
from ddr_tpu_torch.validation.configs import Config, KanConfig

NAMES = tuple(f"a{i}" for i in range(10))
N_DAYS, WARMUP = 4, 1
LR1, LR2 = 0.005, 0.001


def _cfg():
    return Config(kan=KanConfig(input_var_names=list(NAMES)))


def _close(ref, out, label, rtol=1e-5):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = max(np.max(np.abs(ref)), np.max(np.abs(out)), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-5 * scale, err_msg=label)


def _check_params(ref_before, ref, before, out, grads, lr, label):
    """Post-step parameters under the Adam rule above: equal where the
    gradient is well above noise, elsewhere each package moved at most lr."""
    for k, g in grads.items():
        g = g.double().numpy()
        r, o = np.asarray(ref[k], np.float64), out[k].detach().double().numpy()
        r0, o0 = np.asarray(ref_before[k], np.float64), before[k].double().numpy()
        big = np.abs(g) >= 1e-4 * np.abs(g).max()
        np.testing.assert_allclose(o[big], r[big], rtol=1e-5, atol=1e-5 * lr, err_msg=f"{label}: {k}")
        for moved, who in ((np.abs(o - o0)[~big], "port"), (np.abs(r - r0)[~big], "JAX")):
            assert np.all(moved <= lr * (1 + 1e-3)), f"{label}: {k}: {who} moved {moved.max()}"


class _Case:
    """Both packages' step, loss and state on one observed basin."""

    def __init__(self):
        cfg = _cfg()
        p = cfg.params
        jcfg = types.SimpleNamespace(params=types.SimpleNamespace(
            attribute_minimums=p.attribute_minimums, tau=p.tau))
        kw = dict(n_segments=96, n_gauges=4, n_days=N_DAYS, seed=5, depth=10)
        ours = observe(make_basin(**kw), cfg, device="cpu")
        ref = jax_observe(jax_make_basin(**kw), jcfg)
        self.obs_ours, self.obs_ref = ours.obs_daily, ref.obs_daily
        obs = ref.obs_daily[: N_DAYS - 2]  # days 1..D-2 of the window
        mask = np.isfinite(obs)
        attrs = ours.routing_data.normalized_spatial_attributes
        q = ours.q_prime[: (N_DAYS - 1) * 24]
        bounds_kw = {k: v for k, v in p.attribute_minimums.items() if k != "slope"}

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
            from ddr_tpu.routing.model import denormalize_spatial_parameters as jden

            raw = fk.apply(params, self.jargs[3])
            spatial = jden(raw, p.parameter_ranges, p.log_space_parameters, p.defaults, 96)
            res = jax_mc.route(net_j, ch_j, spatial, self.jargs[4], gauges=g_j, bounds=jbounds)
            return jax_training.masked_l1_daily(res.runoff, self.jargs[5], self.jargs[6], p.tau, WARMUP)

        self.jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        self.fk, self.jbounds, self.bounds = fk, jbounds, Bounds(**bounds_kw)

        self.kan = Kan(NAMES, ("n", "q_spatial"))
        self.kan.load_state_dict(kan_state_from_flax(self.jparams))
        self.opt = training.make_optimizer(self.kan.parameters(), LR1)
        net, ch, g = prepare_batch(ours.routing_data, p.attribute_minimums["slope"], device="cpu")
        self.step = training.make_batch_train_step(
            self.kan, Bounds(**bounds_kw), p.parameter_ranges, p.log_space_parameters, p.defaults,
            p.tau, WARMUP, self.opt, device="cpu",
        )
        self.args = (net, ch, g, torch.as_tensor(attrs), torch.as_tensor(q),
                     torch.as_tensor(np.nan_to_num(obs)), torch.as_tensor(mask))

    def jax_grads(self):
        """KAN gradients of the JAX loss at the current JAX parameters, in the
        port's state-dict layout."""
        _, grads = self.jgrad(self.jparams)
        return kan_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))

    def both_steps(self):
        """One step in each package; returns (JAX loss, JAX daily, port loss,
        port daily, port pre-clip gradients)."""
        jgrads = self.jax_grads()
        self.jparams, self.jstate, jl, jd = self.jstep(self.jparams, self.jstate, *self.jargs)
        raw_grads = {}
        hook = [p.register_hook(lambda g, k=k: raw_grads.__setitem__(k, g.clone()))
                for k, p in self.kan.named_parameters()]
        loss, daily = self.step(*self.args)
        for h in hook:
            h.remove()
        return jl, jd, loss, daily, raw_grads, jgrads


@pytest.fixture(scope="module")
def case():
    return _Case()


def test_observe_matches_jax(case):
    assert case.obs_ours.shape == case.obs_ref.shape == (N_DAYS - 1, 4)
    _close(case.obs_ref, case.obs_ours, "observed daily discharge")


def test_two_train_steps_match_jax(case):
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


def test_make_train_step_binds_one_network_like_jax():
    """``make_train_step`` (the step of one fixed network) against JAX's:
    one step from the same weights gives the same loss, daily runoff and
    parameters (the rule of ``_check_params``), and the port's equals the
    batch step it binds, bit for bit."""
    c = _Case()
    p = _cfg().params
    net_j, ch_j, g_j, *jinputs = c.jargs
    jstep = jax_training.make_train_step(
        c.fk, net_j, ch_j, g_j, c.jbounds, p.parameter_ranges, p.log_space_parameters, p.defaults,
        p.tau, WARMUP, c.jopt, donate=False,
    )
    ref_before = kan_state_from_flax(c.jparams)
    jgrads = c.jax_grads()
    jparams, _, jl, jd = jstep(c.jparams, c.jstate, *jinputs)

    net, ch, g, *inputs = c.args
    fixed, batch = Kan(NAMES, ("n", "q_spatial")), Kan(NAMES, ("n", "q_spatial"))
    for kan in (fixed, batch):
        kan.load_state_dict(ref_before)
    args = (c.bounds, p.parameter_ranges, p.log_space_parameters, p.defaults, p.tau, WARMUP)
    step = training.make_train_step(fixed, net, ch, g, *args,
                                    training.make_optimizer(fixed.parameters(), LR1), device="cpu")
    batch_step = training.make_batch_train_step(batch, *args,
                                                training.make_optimizer(batch.parameters(), LR1),
                                                device="cpu")
    grads = {}
    hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g.clone()))
             for k, p in fixed.named_parameters()]
    loss, daily = step(*inputs)
    for h in hooks:
        h.remove()
    batch_loss, batch_daily = batch_step(net, ch, g, *inputs)
    assert float(loss) == float(batch_loss) and torch.equal(daily, batch_daily)
    for k, v in fixed.state_dict().items():
        assert torch.equal(v, batch.state_dict()[k]), k
    _close(jl, loss, "loss")
    _close(jd, daily, "daily")
    for k, gk in grads.items():
        _close(jgrads[k], gk, f"grad {k}", rtol=1e-4)
    _check_params(ref_before, kan_state_from_flax(jparams), ref_before, fixed.state_dict(), grads, LR1,
                  "make_train_step")


@pytest.mark.parametrize("where", ["below", "equal", "above"])
def test_clip_by_global_norm_follows_optax(where):
    import optax

    rng = np.random.default_rng(23)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    norm = float(torch.sqrt(sum(torch.as_tensor(a).pow(2).sum() for a in leaves)))
    max_norm = {"below": 2.0 * norm, "equal": norm, "above": norm / 3.0}[where]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in leaves], None)
    grads = [torch.as_tensor(a.copy()) for a in leaves]
    pre = training.clip_by_global_norm(grads, max_norm)
    assert float(pre) == norm
    for r, g in zip(ref, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)
    if where == "below":  # kept exactly
        for a, g in zip(leaves, grads):
            np.testing.assert_array_equal(g.numpy(), a)
    if where == "above":
        assert abs(float(torch.sqrt(sum(g.pow(2).sum() for g in grads))) - max_norm) < 1e-5 * max_norm


def test_daily_runoff_and_schedule_match_jax():
    from ddr_tpu.scripts_utils import compute_daily_runoff as jax_daily
    from ddr_tpu.scripts_utils import resolve_learning_rate as jax_lr

    hourly = np.random.default_rng(29).uniform(0.0, 5.0, (3, 9 * 24)).astype(np.float32)
    np.testing.assert_allclose(compute_daily_runoff(hourly, 3), jax_daily(hourly, 3), rtol=1e-6)
    schedule = _cfg().experiment.learning_rate
    for epoch in range(0, 6):
        assert resolve_learning_rate(schedule, epoch) == jax_lr(schedule, epoch)


def test_masked_l1_daily_matches_jax():
    rng = np.random.default_rng(31)
    runoff = rng.uniform(0.0, 4.0, (5 * 24, 3)).astype(np.float32)
    obs = rng.uniform(0.0, 4.0, (4, 3)).astype(np.float32)
    mask = rng.random((4, 3)) < 0.7
    obs[~mask] = np.nan
    jl, jd = jax_training.masked_l1_daily(jnp.asarray(runoff), jnp.asarray(obs), jnp.asarray(mask), 3, 1)
    loss, daily = training.masked_l1_daily(torch.as_tensor(runoff), torch.as_tensor(obs),
                                           torch.as_tensor(mask), 3, 1)
    _close(jd, daily, "daily")
    _close(jl, loss, "loss")
