"""``python -m ddr_tpu_torch.cli train`` against JAX's ``ddr train``, end to end on the CPU.

Both loops train ``examples/synthetic/config.yaml`` (64 reaches, 2 epochs,
batch size 2: two steps an epoch, learning rates 0.01 then 0.003) from the
same weights and batch order: JAX's ``train(cfg)`` starts from
``build_kan(cfg)``'s initialisation, and the port's resumes from a
checkpoint written by its own ``save_state`` (epoch 1, mini-batch 0, no
optimizer state) holding those weights carried across by
``kan_state_from_flax``, so the port trains the same four batches. Each
package builds its own twin dataset and routes it on its own engine (the
port on the plain versions of its CUDA scans). The losses are read from the
port's step log lines and from JAX's step outputs.

Tolerances, fp32. Epoch 1's losses rtol 1e-5. Epoch 2's losses rtol 3e-4
(measured 1.1e-4 at most): no float32 loop meets 1e-5 there, JAX's own
included. JAX's float32 loop parts from its float64 loop by 5.9e-6 and
7.9e-5 in epoch 2, the port's by 9.6e-7 and 2.8e-5
(``test_float32_trajectories_against_float64``). The cause is the float64
gradient itself: on step 2's batch it is ill-conditioned at the routing
step in which one reach's flow falls onto the discharge floor, so float32
rounding moves the gradients of that reach and its upstream reaches by
about 1e-4 relative in both packages, and Adam, which divides each
component by its own running RMS, carries that into the small components
of the weights (``test_step_two_gradients_against_float64``). The final
KAN weights: rtol 1e-4 with an absolute floor of 1e-2 x the sum of the
learning rates of the run, 1% of the most Adam can move a component in
four steps (measured: 5.6e-5 at most). Each test prints what it measured
(``-s``).

bf16 (``DDR_TRAIN_DTYPE=bf16``): every loss within one bf16 epsilon,
``2**-7 |ref| + 1e-5 max|ref|``, the tolerance of ``tests/test_torch_bf16.py``
(both packages round the ring at the same point), and the final weights as
in fp32.
"""

from __future__ import annotations

import json
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ddr_tpu import training as jax_training
from ddr_tpu.geodatazoo.loader import DataLoader as JaxDataLoader
from ddr_tpu.geodatazoo.synthetic import Synthetic as JaxSynthetic
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing.model import denormalize_spatial_parameters as jax_denormalize
from ddr_tpu.routing.model import prepare_batch as jax_prepare_batch
from ddr_tpu.scripts import train as jax_train_script
from ddr_tpu.scripts.common import daily_observation_targets
from ddr_tpu.scripts.common import build_kan as jax_build_kan
from ddr_tpu.validation.configs import Config as JaxConfig
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch import cli
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.routing.mc import Bounds
from ddr_tpu_torch.routing.mc import route as port_route
from ddr_tpu_torch.routing.model import prepare_batch
from ddr_tpu_torch.scripts import train as train_script
from ddr_tpu_torch.scripts.common import build_kan, kan_arch
from ddr_tpu_torch.training import make_batch_loss, make_batch_train_step, make_optimizer, save_state, set_learning_rate
from ddr_tpu_torch.training import masked_l1_daily as port_masked_l1_daily
from ddr_tpu_torch.validation.configs import load_config

CONFIG = "examples/synthetic/config.yaml"
OVERRIDES = ["synthetic_segments=64", "device=cpu", "mode=training"]
LR_SUM = 2 * 0.01 + 2 * 0.003
EPS_BF16 = 2.0**-7


class _Losses(logging.Handler):
    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        m = re.match(r"epoch \d+ mini-batch \d+: loss=(\S+) \(", record.getMessage())
        if m:
            self.losses.append(float(m.group(1)))


@pytest.fixture
def port_losses():
    handler = _Losses()
    logger = logging.getLogger(train_script.__name__)
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)  # clears the loggers' cached INFO-is-off answers
    yield handler.losses
    logger.removeHandler(handler)
    logger.setLevel(level)


def _run_jax(tmp_path, monkeypatch):
    cfg = jax_load_config(CONFIG, OVERRIDES + [f"params.save_path={tmp_path}/jax"], save_config=False)
    losses = []
    original = jax_train_script.make_batch_train_step

    def recording(*args, **kwargs):
        step = original(*args, **kwargs)

        def wrapped(*a):
            out = step(*a)
            losses.append(float(out[2]))
            return out

        return wrapped

    monkeypatch.setattr(jax_train_script, "make_batch_train_step", recording)
    params, _ = jax_train_script.train(cfg)
    _, init = jax_build_kan(cfg)
    return losses, params, init


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_port_train_matches_jax_train(tmp_path, monkeypatch, port_losses, dtype):
    monkeypatch.setenv("DDR_TRAIN_DTYPE", dtype)
    jax_losses, jax_params, init = _run_jax(tmp_path, monkeypatch)

    cfg = load_config(CONFIG, OVERRIDES + [f"params.save_path={tmp_path}/port"], save_config=False)
    ck = save_state(tmp_path / "init", cfg.name, 1, 0, kan_state_from_flax(init), None, arch=kan_arch(cfg))
    cfg.experiment.checkpoint = ck
    kan, _ = train_script.train(cfg)

    assert len(port_losses) == len(jax_losses) == 4
    got, want = np.asarray(port_losses), np.asarray(jax_losses)
    assert np.isfinite(got).all()
    ref = kan_state_from_flax(jax_params)
    weights = max(float(np.abs(v.numpy() - ref[k].numpy()).max()) for k, v in kan.state_dict().items())
    print(f"{dtype}: loss rel {np.abs(got - want) / np.abs(want)}, final weights max abs {weights:.2e}")
    if dtype == "fp32":
        np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5, atol=0, err_msg="epoch 1 losses")
        np.testing.assert_allclose(got[2:], want[2:], rtol=3e-4, atol=0, err_msg="epoch 2 losses")
    else:
        np.testing.assert_allclose(got, want, rtol=EPS_BF16, atol=1e-5 * np.abs(want).max())
    for k, v in kan.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-2 * LR_SUM, err_msg=k)


class _Twin:
    """JAX's twin dataset, the four batches both loops train (epoch 1's, then
    epoch 2's, windows drawn as the loops draw them) and the KAN, for the
    float32 analysis below."""

    def __init__(self):
        self.cfg = jax_load_config(CONFIG, OVERRIDES, save_config=False)
        self.port_cfg = load_config(CONFIG, OVERRIDES, save_config=False)
        self.dataset = JaxSynthetic(self.cfg)
        loader = JaxDataLoader(self.dataset, batch_size=2, shuffle=True,
                               rng=np.random.default_rng(self.cfg.seed), drop_last=True)
        self.batches = list(loader) + list(loader)
        self.kan_model, self.init = jax_build_kan(self.cfg)
        p = self.cfg.params
        self.bounds = jax_mc.Bounds.from_config(p.attribute_minimums)

    def lr(self, k):
        """The learning rate the schedule sets before step ``k`` (0-based), or None."""
        epoch, batch = divmod(k, 2)
        return self.cfg.experiment.learning_rate.get(epoch + 1) if batch == 0 else None

    def jax_inputs(self, rd, dtype):
        q = np.asarray(self.dataset.streamflow(routing_dataclass=rd), np.float32)
        obs, mask = daily_observation_targets(rd)
        network, channels, gauges = jax_prepare_batch(rd, self.cfg.params.attribute_minimums["slope"])
        channels = jax.tree_util.tree_map(
            lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x, channels)
        return (network, channels, gauges, jnp.asarray(rd.normalized_spatial_attributes, dtype),
                jnp.asarray(q, dtype), jnp.asarray(obs, dtype), jnp.asarray(mask))

    def port_inputs(self, rd):
        q = np.asarray(self.dataset.streamflow(routing_dataclass=rd), np.float32)
        obs, mask = daily_observation_targets(rd)
        return (*prepare_batch(rd, self.port_cfg.params.attribute_minimums["slope"], device="cpu"),
                torch.as_tensor(rd.normalized_spatial_attributes), torch.as_tensor(q),
                torch.as_tensor(obs), torch.as_tensor(mask))

    def spatial(self, params, attrs):
        p = self.cfg.params
        return jax_denormalize(self.kan_model.apply(params, attrs), p.parameter_ranges,
                               p.log_space_parameters, p.defaults, attrs.shape[0])

    def route_loss(self, spatial, network, channels, gauges, attrs, q, obs, mask):
        spatial = {k: v.astype(q.dtype) for k, v in spatial.items()}
        runoff = jax_mc.route(network, channels, spatial, q, gauges=gauges, bounds=self.bounds).runoff
        return jax_training.masked_l1_daily(runoff, obs, mask, self.cfg.params.tau,
                                            self.cfg.experiment.warmup)[0]

    def kan_loss(self, params, *inputs):
        return self.route_loss(self.spatial(params, inputs[3]), *inputs)

    def jax_trajectory(self, dtype, steps=4):
        """JAX's batch train step over the first ``steps`` batches from
        ``build_kan``'s weights: (losses, weights after each step)."""
        p = self.cfg.params
        optimizer = jax_training.make_optimizer(self.lr(0))
        step = jax_training.make_batch_train_step(
            self.kan_model, self.bounds, p.parameter_ranges, p.log_space_parameters, p.defaults,
            p.tau, self.cfg.experiment.warmup, optimizer, donate=False)
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), self.init)
        state, losses, weights = optimizer.init(params), [], []
        for k, rd in enumerate(self.batches[:steps]):
            if k and self.lr(k) is not None:
                state = jax_training.set_learning_rate(state, self.lr(k))
            params, state, loss, _ = step(params, state, *self.jax_inputs(rd, dtype))
            losses.append(float(loss))
            weights.append(params)
        return np.asarray(losses), weights

    def port_trajectory(self):
        """The port's batch train step over the four batches from the same weights: losses."""
        p = self.port_cfg.params
        kan = build_kan(self.port_cfg, device="cpu")
        kan.load_state_dict(kan_state_from_flax(self.init))
        optimizer = make_optimizer(kan.parameters(), self.lr(0))
        step = make_batch_train_step(kan, Bounds.from_config(p.attribute_minimums), p.parameter_ranges,
                                     p.log_space_parameters, p.defaults, p.tau,
                                     self.port_cfg.experiment.warmup, optimizer, device="cpu")
        losses = []
        for k, rd in enumerate(self.batches):
            if k and self.lr(k) is not None:
                set_learning_rate(optimizer, self.lr(k))
            losses.append(float(step(*self.port_inputs(rd))[0]))
        return np.asarray(losses)


@pytest.fixture(scope="module")
def twin():
    return _Twin()


def test_float32_trajectories_against_float64(twin):
    """Why epoch 2's losses cannot be held to 1e-5: the four steps of both
    loops run in float32 and, for JAX, in float64 too (``enable_x64``), from
    the same weights on the same batches. JAX's own float32 losses part
    from its float64 losses by more than 1e-5 in epoch 2 (measured 5.9e-6
    and 7.9e-5); the port's float32 losses are held to lie no farther from
    JAX's float64 ones than JAX's float32 losses do, or within 1e-6."""
    l32, _ = twin.jax_trajectory(jnp.float32)
    with jax.enable_x64():
        l64, _ = twin.jax_trajectory(jnp.float64)
    port = twin.port_trajectory()
    jax_dev, port_dev = np.abs(l32 - l64) / l64, np.abs(port - l64) / l64
    print(f"relative departure from JAX's float64 losses: JAX float32 {jax_dev}, port {port_dev}")
    assert np.all(port_dev <= np.maximum(jax_dev, 1e-6)), (port_dev, jax_dev)


def _median_rel(grads, ref):
    return {k: float(np.median(np.abs(grads[k] - ref[k]) / np.abs(ref[k]))) for k in ref}


def _floor_step(twin, rd, spatial, inputs, sensitive):
    """Float64, on the step engine with one ``q_spatial`` per routing step:
    how much each step's share of the gradient of the ``sensitive`` reaches
    moves when every ``n`` grows by a relative 1e-6. Returns (the step
    that moves most, the share of the total movement within three steps
    of it, the full-domain flow ``(T, N)``)."""
    network, channels, gauges, _, q, obs, mask = inputs
    plain, _, _ = jax_prepare_batch(rd, twin.cfg.params.attribute_minimums["slope"], fused=False,
                                    chunked=False)
    floor = twin.bounds.discharge

    def loss(q_spatial_t, n):
        q0 = jax_mc.hotstart_discharge(plain, q[0], floor)

        def body(q_t, xs):
            q_prev, qs = xs
            q_next = jax_mc.route_step(plain, channels, n, spatial["p_spatial"], qs, q_t,
                                       jnp.maximum(q_prev, floor), twin.bounds)
            return q_next, gauges.aggregate(q_next)

        _, outs = jax.lax.scan(body, q0, (q[:-1], q_spatial_t))
        runoff = jnp.concatenate([gauges.aggregate(q0)[None], outs])
        return jax_training.masked_l1_daily(runoff, obs, mask, twin.cfg.params.tau,
                                            twin.cfg.experiment.warmup)[0]

    per_step = jax.jit(jax.grad(loss))
    q_spatial_t = jnp.tile(spatial["q_spatial"][None], (q.shape[0] - 1, 1))
    moved = (np.asarray(per_step(q_spatial_t, spatial["n"] * (1 + 1e-6)))
             - np.asarray(per_step(q_spatial_t, spatial["n"])))[:, sensitive]
    by_step = np.abs(moved).sum(axis=1)
    t = int(np.argmax(by_step))
    flow = np.asarray(jax_mc.route(network, channels, spatial, q, bounds=twin.bounds, engine="step").runoff)
    return t, float(by_step[max(t - 3, 0) : t + 4].sum() / by_step.sum()), flow


def test_step_two_gradients_against_float64(twin):
    """Why float32 gradients part on step 2: at the weights after JAX's
    first step, on the second batch, against float64 (JAX under
    ``enable_x64``).

    - The route's gradient with respect to the spatial parameters is
      ill-conditioned in float64 itself: a relative change of 1e-6 in every
      ``n`` moves it by more than 1e-5 of its largest component on a few
      reaches (one reach and its upstream reaches; measured 5.4e-4), and
      nearly all of that movement comes from within three routing steps of
      the step in which that reach's flow falls onto the discharge floor.
    - Each package's float32 route gradient errs by more than 1e-5 of its
      largest component only on those reaches (measured: JAX 3.2e-4, the
      port 1.3e-4), and no L1 residual changes sign.
    - The KAN gradient sums over reaches, so every leaf carries that error:
      the port's median relative error per leaf is at most JAX's (measured
      1.1e-4 to 1.5e-4 against 2.8e-4 to 4.0e-4). Adam divides each
      component by its own running RMS, so its second update carries the
      error of the small components into the weights."""
    _, weights = twin.jax_trajectory(jnp.float32, steps=1)
    params, second = weights[0], twin.batches[1]
    inputs32 = twin.jax_inputs(second, jnp.float32)

    with jax.enable_x64():
        inputs64 = twin.jax_inputs(second, jnp.float64)
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
        g64 = jax.grad(twin.kan_loss)(p64, *inputs64)
        ref = {k: v.double().numpy() for k, v in
               kan_state_from_flax(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), g64)).items()}
        spatial = twin.spatial(p64, inputs64[3])
        route_grad = jax.jit(jax.grad(twin.route_loss))
        r64 = {k: np.asarray(v) for k, v in route_grad(spatial, *inputs64).items()}
        moved = route_grad({**spatial, "n": spatial["n"] * (1 + 1e-6)}, *inputs64)
        scale = {k: np.abs(r64[k]).max() for k in ("n", "q_spatial")}
        movement = max(float(np.abs(np.asarray(moved[k]) - r64[k]).max() / scale[k]) for k in scale)
        sensitive = np.flatnonzero(np.any([np.abs(np.asarray(moved[k]) - r64[k]) > 1e-5 * scale[k]
                                           for k in scale], axis=0))
        t, share, flow = _floor_step(twin, second, spatial, inputs64, sensitive)
        runoff64 = jax_mc.route(inputs64[0], inputs64[1], spatial, inputs64[4], gauges=inputs64[2],
                                bounds=twin.bounds).runoff
        daily64 = np.asarray(jax_training.daily_from_hourly(runoff64, twin.cfg.params.tau))
        spatial = {k: np.asarray(v) for k, v in spatial.items()}
    floor = twin.bounds.discharge
    onto_floor = [int(r) for r in sensitive if flow[t + 1, r] == floor < flow[t, r]]
    print(f"float64 gradient moved by {movement:.2e} of its largest component on reaches "
          f"{sensitive.tolist()}; {share:.1%} of it within three routing steps of the step into hour "
          f"{t + 1}, where reaches {onto_floor} fall onto the discharge floor")
    assert 0 < len(sensitive) < inputs64[3].shape[0] // 4
    assert share > 0.9 and onto_floor

    # float32 route gradients of both packages at the same spatial parameters
    spatial32 = {k: jnp.asarray(v, jnp.float32) for k, v in spatial.items()}
    jax_r32 = {k: np.asarray(v, np.float64) for k, v in jax.grad(twin.route_loss)(spatial32, *inputs32).items()}
    port_in = twin.port_inputs(second)
    port_spatial = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True) for k, v in spatial.items()}
    result = port_route(*port_in[:2], port_spatial, port_in[4], gauges=port_in[2],
                        bounds=Bounds.from_config(twin.port_cfg.params.attribute_minimums), device="cpu")
    loss, daily32 = port_masked_l1_daily(result.runoff, port_in[5], port_in[6], twin.port_cfg.params.tau,
                                         twin.port_cfg.experiment.warmup)
    loss.backward()
    port_r32 = {k: port_spatial[k].grad.double().numpy() for k in scale}
    obs, mask = daily_observation_targets(second)
    mask[: twin.cfg.experiment.warmup] = False
    flips = int((np.sign(daily64 - obs)[mask] != np.sign(daily32.detach().double().numpy() - obs)[mask]).sum())
    errs = {}
    for who, grads in (("JAX", jax_r32), ("port", port_r32)):
        err = {k: np.abs(grads[k] - r64[k]) / scale[k] for k in scale}
        errs[who] = max(float(e.max()) for e in err.values())
        off = sorted({int(r) for e in err.values() for r in np.flatnonzero(e > 1e-5)} - set(sensitive.tolist()))
        assert not off, (who, off)
    print(f"float32 route gradients err by at most {errs} of the largest component; L1 sign flips {flips}")
    assert flips == 0

    g32 = jax.grad(twin.kan_loss)(params, *inputs32)
    jax_err = _median_rel({k: v.double().numpy() for k, v in kan_state_from_flax(g32).items()}, ref)
    cfg = twin.port_cfg
    kan = build_kan(cfg, device="cpu")
    kan.load_state_dict(kan_state_from_flax(params))
    loss_fn = make_batch_loss(kan, Bounds.from_config(cfg.params.attribute_minimums), cfg.params.parameter_ranges,
                              cfg.params.log_space_parameters, cfg.params.defaults, cfg.params.tau,
                              cfg.experiment.warmup, device="cpu")
    loss_fn(*port_in)[0].backward()
    port_err = _median_rel({k: v.grad.double().numpy() for k, v in kan.named_parameters()}, ref)
    print({k: (f"port {port_err[k]:.2e}", f"jax {jax_err[k]:.2e}") for k in ref})
    for k in ref:
        assert port_err[k] <= jax_err[k], (k, port_err[k], jax_err[k])


def test_cli_trains_on_the_cpu_when_asked(tmp_path, port_losses):
    code = cli.main(["train", CONFIG, "device=cpu", "synthetic_segments=32", "experiment.epochs=1",
                     f"params.save_path={tmp_path}"])
    assert code == 0 and len(port_losses) == 2 and np.isfinite(port_losses).all()
    assert sorted(p.name for p in (tmp_path / "saved_models").glob("*.pkl")) == [
        "_synthetic_example_epoch_1_mb_0.pkl", "_synthetic_example_epoch_1_mb_1.pkl"]
    saved = yaml.safe_load((tmp_path / "pydantic_config.yaml").read_text())
    assert saved["mode"] == "training" and saved["device"] == "cpu"
    assert json.loads(JaxConfig(**saved).model_dump_json())["synthetic_segments"] == 32


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``device=cpu`` the entry point asks for the card, and on a
    machine without one it raises instead of moving to the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["train", CONFIG, f"params.save_path={tmp_path}"])
    with pytest.raises(ValueError, match="'cuda'"):
        cli.main(["train", CONFIG, "device=tpu", f"params.save_path={tmp_path}"])


@pytest.mark.parametrize("command,item", [("geometry-predictor", "A.11"), ("sweep", "A.12"), ("tune", "A.13")])
def test_cli_names_the_item_of_an_unported_command(capsys, command, item):
    assert cli.main([command, CONFIG]) == 2
    assert item in capsys.readouterr().err
    assert cli.main(["--help"]) == 0


def test_cli_dispatches_serve(tmp_path, monkeypatch):
    """``serve`` reaches ``scripts/serve.py`` with the config in testing mode
    and the ``DDR_SERVE_*`` knobs (the server itself runs in
    ``tests/test_torch_serve_cli.py``)."""
    from ddr_tpu_torch.scripts import serve as serve_script

    seen = []
    monkeypatch.setattr(serve_script, "serve", lambda cfg, serve_cfg: seen.append((cfg, serve_cfg)) or 0)
    monkeypatch.setenv("DDR_SERVE_PORT", "0")
    monkeypatch.setenv("DDR_SERVE_MAX_BATCH", "3")
    assert cli.main(["serve", CONFIG, "device=cpu", f"params.save_path={tmp_path}"]) == 0
    (cfg, serve_cfg), = seen
    assert cfg.mode.value == "testing" and cfg.device == "cpu"
    assert (serve_cfg.port, serve_cfg.max_batch) == (0, 3)
    assert "serve" in cli._COMMANDS and "serve" not in cli._NOT_PORTED


def test_cli_dispatches_loadtest(tmp_path, capsys):
    """``loadtest --synthetic`` runs an in-process service on the CPU when
    asked (``device=cpu`` applies to the synthetic config), writes its
    report and prints it last; ``--fleet 2`` drives two such services
    through the fleet router."""
    code = cli.main(["loadtest", "--synthetic", "--n", "32", "--horizon", "6", "--rps", "40",
                     "--duration", "0.5", "--out", str(tmp_path), "--label", "cli", "device=cpu"])
    assert code == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report == json.loads((tmp_path / "LOADTEST_cli.json").read_text())
    assert report["device"] == "cpu" and report["ok"] == report["requests"] > 0
    assert cli.main(["loadtest", "--synthetic", "--fleet", "2", "--n", "32", "--horizon", "6", "--rps", "40",
                     "--duration", "0.3", "--out", str(tmp_path), "--label", "fleet", "device=cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (report["target"], report["fleet"], report["device"]) == ("fleet:2", 2, "cpu")
    assert report["ok"] == report["requests"] > 0
    assert "loadtest" in cli._COMMANDS and "loadtest" not in cli._NOT_PORTED


def test_cli_dispatches_verify(tmp_path, capsys):
    """``verify --synthetic`` runs the self-test on the CPU when asked and
    records its joins in its run log, which ``verify <logdir>`` replays."""
    code = cli.main(["verify", "--synthetic", "--n", "32", "--horizon", "8", "--members", "4",
                     "--requests", "3", "--out", str(tmp_path), "--label", "cli", "device=cpu"])
    assert code == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ordering_ok"] and report["matched_samples"] > 0 and report["device"] == "cpu"
    assert (tmp_path / "VERIFY_cli.md").read_text().startswith("## ddr verify")
    assert (tmp_path / "run_log.verify.jsonl").exists()
    assert cli.main(["verify", str(tmp_path), "--out", str(tmp_path / "replay")]) == 0
    replay = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert replay["mode"] == "replay" and replay["files"] == 1 and replay["matched_samples"] > 0
    assert "verify" in cli._COMMANDS and "verify" not in cli._NOT_PORTED


#: Each ported evaluation command, the store it writes and that store's arrays.
PORTED = {
    "test": ("model_test.zarr", ["observations", "predictions"]),
    "route": ("chrout.zarr", ["discharge"]),
    "train-and-test": ("model_test.zarr", ["observations", "predictions"]),
    "benchmark": ("benchmark_results.zarr", ["lti_predictions", "mc_predictions", "observations"]),
}


@pytest.mark.parametrize("command", sorted(PORTED))
def test_cli_dispatches_each_ported_command(tmp_path, monkeypatch, command):
    """Each command runs on the CPU when asked, on a 32-reach twin over 25
    days, and writes its store, which the JAX package's zarrlite reads; the
    evaluation commands start from a checkpoint, train-and-test from
    nothing. Without ``device=cpu`` each asks for the card and raises on a
    machine without one."""
    from ddr_tpu.io import zarrlite as jax_zarrlite

    base = [CONFIG, "device=cpu", "synthetic_segments=32", "experiment.end_time=1981/10/25",
            f"params.save_path={tmp_path / 'run'}"]
    if command == "train-and-test":
        extra = ["experiment.epochs=1", "experiment.test_start_time=1981/10/01",
                 "experiment.test_end_time=1981/10/25"]
    else:
        cfg = load_config(CONFIG, base[1:], save_config=False)
        ck = save_state(tmp_path / "ckpt", cfg.name, 1, 0, build_kan(cfg), None, arch=kan_arch(cfg))
        extra = [f"experiment.checkpoint={ck}"]
    assert cli.main([command, *base, *extra]) == 0

    store, arrays = PORTED[command]
    root = jax_zarrlite.open_group(tmp_path / "run" / store)
    assert sorted(root.keys()) == arrays
    for name in arrays:
        values = root[name][:]
        assert values.dtype == np.float32 and values.shape[0] == 4 and np.isfinite(values).all(), name
    model = root.attrs.get("model", root.attrs.get("model_checkpoint"))
    if command == "train-and-test":
        assert model.endswith("_synthetic_example_epoch_1_mb_1.pkl")
    else:
        assert model == extra[0].split("=", 1)[1]

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main([command, *[a for a in base if a != "device=cpu"], *extra])
