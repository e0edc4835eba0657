"""The port's self-healing ``ddr train`` against the JAX loop, on the CPU.

Both loops train the chaos drill's config (the synthetic twin at 32
reaches, batch 1: four mini-batches an epoch, learning rate 0.01, no
shuffle) from the same weights: JAX's ``train`` starts from its
``build_kan``, the port's resumes from a checkpoint holding those weights
(epoch 1, mini-batch 0, no optimizer state), as in
``tests/test_torch_train_cli.py``. Writes are synchronous
(``DDR_CKPT_ASYNC=0``), so the pinned-good checkpoint the ladder sees does
not depend on the writer thread's timing. Under each scenario the run logs
hold the same ``recovery`` and ``data_anomaly`` events (every key but the
envelope's), the same ``recovered`` markers on the same steps, the same
run_end ``recovery`` and ``data_validate`` rollups, and the steps' losses
agree within ``test_port_train_matches_jax_train``'s rtol 3e-4 (NaN where
NaN):

* the nan storm of ``ddr chaos train --nan-storm`` (``DEFAULT_NAN_STORM``
  under ``DDR_DATA_VALIDATE=quarantine``) over 2 epochs: a quarantined
  batch, a skip on ``non-finite`` inflow, a skip on a non-finite gradient
  norm; in the port's run every restore leaves the KAN and every Adam
  tensor bit for bit as they were before the step;
* ``DDR_RECOVERY_MAX_SKIPS=0``: a rollback to the pinned-good checkpoint
  with the learning rate halved;
* the rollback budget 0 as well: a give-up, its ``-giveup`` checkpoint
  saved degraded, and ``main`` returning 3 in both packages;
* ``DDR_TRAIN_DTYPE=bf16`` with ``DDR_HEALTH_MAX_ULP_DRIFT=0``: every step
  re-run clean on the fp32 twin.

And, the port alone: a preemption requested after the second step saves
``<name>-preempt`` with a ``preempt`` event, and a directory resume starts
at the next mini-batch and takes the uninterrupted run's steps bit for bit.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from ddr_tpu.observability import events as jax_events
from ddr_tpu.observability import faults as jax_faults
from ddr_tpu.scripts import train as jax_train_script
from ddr_tpu.scripts.common import build_kan as jax_build_kan
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch import training
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.observability import events as port_events
from ddr_tpu_torch.observability import faults as port_faults
from ddr_tpu_torch.observability.preempt import PreemptionHandler
from ddr_tpu_torch.scripts import train as train_script
from ddr_tpu_torch.scripts.chaos import DEFAULT_NAN_STORM, _train_cfg_dict, _yaml_text
from ddr_tpu_torch.scripts.common import kan_arch
from ddr_tpu_torch.validation.configs import load_config

RTOL = 3e-4
ENVELOPE = {"event", "t", "wall", "seq", "pid", "host", "tags"}


class _Args:
    segments, epochs = 32, 2


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DDR_CKPT_ASYNC", "0")
    monkeypatch.setenv("DDR_HEALTH_ENABLED", "1")
    monkeypatch.setenv("DDR_RECOVERY_ENABLED", "1")
    for var in ("DDR_METRICS_DIR", "DDR_DATA_VALIDATE", "DDR_TRAIN_DTYPE", "DDR_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    yield
    jax_faults.configure(None)
    port_faults.configure(None)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The drill config (2 epochs) and the port's checkpoint of JAX's initial
    weights."""
    root = tmp_path_factory.mktemp("heal")
    cfg_dict = _train_cfg_dict(root / "unused", None, _Args)
    cfg_dict["name"] = "heal"
    path = root / "heal.yaml"
    path.write_text(_yaml_text(cfg_dict))
    jax_cfg = jax_load_config(str(path), [], save_config=False)
    _, init = jax_build_kan(jax_cfg)
    cfg = load_config(str(path), ["device=cpu"], save_config=False)
    ck = training.save_state(root / "init", cfg.name, 1, 0, kan_state_from_flax(init), None, arch=kan_arch(cfg))
    return path, ck


def _events(run_dir) -> list[dict]:
    return [json.loads(line) for line in (run_dir / "run_log.train.jsonl").read_text().splitlines()]


def _of(events, kind) -> list[dict]:
    return [{k: v for k, v in e.items() if k not in ENVELOPE} for e in events if e["event"] == kind]


def _run_jax(drill, run_dir, faults=None, overrides=(), main=False):
    path, _ = drill
    argv = [str(path), f"params.save_path={run_dir}", *overrides]
    jax_faults.configure(faults)
    try:
        if main:
            return jax_train_script.main(argv), _events(run_dir)
        cfg = jax_load_config(argv[0], argv[1:], save_config=False)
        with jax_events.run_telemetry(cfg, "train"):
            jax_train_script.train(cfg)
        return 0, _events(run_dir)
    finally:
        jax_faults.configure(None)


def _run_port(drill, run_dir, faults=None, overrides=(), main=False, resume=True):
    path, ck = drill
    argv = [str(path), "device=cpu", f"params.save_path={run_dir}", *overrides]
    if resume:
        argv.append(f"experiment.checkpoint={ck}")
    port_faults.configure(faults)
    try:
        if main:
            return train_script.main(argv), _events(run_dir)
        cfg = load_config(argv[0], argv[1:], save_config=False)
        with port_events.run_telemetry(cfg, "train"):
            train_script.train(cfg)
        return 0, _events(run_dir)
    finally:
        port_faults.configure(None)


def _steps(events) -> dict:
    return {(e["epoch"], e["batch"]): (e["loss"], e.get("recovered")) for e in events if e["event"] == "step"}


def _assert_same_run(got, want, expect_stages):
    """Same recovery and data_anomaly events, markers, rollups; losses within RTOL."""
    assert _of(got, "recovery") == _of(want, "recovery")
    assert [e["stage"] for e in _of(got, "recovery")] == expect_stages
    assert _of(got, "data_anomaly") == _of(want, "data_anomaly")
    g, w = _steps(got), _steps(want)
    assert sorted(g) == sorted(w)
    assert {k: v[1] for k, v in g.items()} == {k: v[1] for k, v in w.items()}
    np.testing.assert_allclose([g[k][0] for k in sorted(g)], [w[k][0] for k in sorted(w)], rtol=RTOL,
                               atol=0, equal_nan=True)
    g_end, w_end = got[-1], want[-1]
    assert g_end["event"] == w_end["event"] == "run_end"
    assert g_end["status"] == w_end["status"]
    for key in ("recovery", "data_validate"):
        assert g_end["summary"].get(key) == w_end["summary"].get(key), key


def _bitwise(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_bitwise(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))
    return a == b


def test_nan_storm_equals_jax_and_restores_bit_for_bit(drill, tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_DATA_VALIDATE", "quarantine")
    _, want = _run_jax(drill, tmp_path / "jax", DEFAULT_NAN_STORM)

    restores = []
    snapshot, restore = train_script.snapshot_state, train_script.restore_snapshot
    before = {}

    def snapshot_and_keep(kan, optimizer):
        before["state"] = (training._clone_tree(kan.state_dict()), training._clone_tree(optimizer.state_dict()))
        return snapshot(kan, optimizer)

    def restore_and_check(kan, optimizer, snap):
        restore(kan, optimizer, snap)
        restores.append(_bitwise(kan.state_dict(), before["state"][0])
                        and _bitwise(optimizer.state_dict(), before["state"][1]))

    monkeypatch.setattr(train_script, "snapshot_state", snapshot_and_keep)
    monkeypatch.setattr(train_script, "restore_snapshot", restore_and_check)
    _, got = _run_port(drill, tmp_path / "port", DEFAULT_NAN_STORM)

    _assert_same_run(got, want, ["skip", "skip", "skip"])
    assert [e["site"] for e in _of(got, "fault")] == ["data.forcings", "device.step", "device.grads"]
    assert [(e["reasons"], e["batch"]) for e in _of(got, "recovery")] == [
        (["data-anomaly"], 1), (["non-finite", "grad-norm"], 2), (["grad-norm"], 3)]
    markers = {k: v[1] for k, v in _steps(got).items() if v[1]}
    assert markers == {(1, 2): "skip", (1, 3): "skip"}  # the quarantined batch has no step
    assert math.isnan(_steps(got)[(1, 2)][0])
    assert restores == [True, True]  # both skips put every tensor back as it was
    end = got[-1]["summary"]
    assert end["recovery"]["quarantined"] == [{"epoch": 1, "batch": b} for b in (1, 2, 3)]
    assert end["data_validate"] == {"policy": "quarantine", "batches": 8, "anomalies": 1, "quarantined": 1,
                                    "events_suppressed": 0}
    # no checkpoint of a skipped step
    names = sorted(p.name for p in (tmp_path / "port" / "saved_models").glob("*.pkl"))
    assert names == [f"_heal_epoch_{e}_mb_{b}.pkl" for e, b in [(1, 0), (2, 0), (2, 1), (2, 2), (2, 3)]]


def test_rollback_with_lr_backoff_equals_jax(drill, tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_RECOVERY_MAX_SKIPS", "0")
    spec, one_epoch = "nan@device.step=2:n=1", ["experiment.epochs=1"]
    _, want = _run_jax(drill, tmp_path / "jax", spec, one_epoch)
    _, got = _run_port(drill, tmp_path / "port", spec, one_epoch)
    _assert_same_run(got, want, ["rollback"])
    (rb,) = _of(got, "recovery")
    assert rb["checkpoint"] == "_heal_epoch_1_mb_1.pkl" and rb["lr_backoff"] == 0.5
    assert _steps(got)[(1, 2)][1] == "rollback"
    blob = training.load_state(tmp_path / "port" / "saved_models" / "_heal_epoch_1_mb_3.pkl")
    assert [g["lr"] for g in blob["opt_state"]["param_groups"]] == [0.005]


def test_give_up_saves_degraded_and_main_returns_3(drill, tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_RECOVERY_MAX_SKIPS", "0")
    monkeypatch.setenv("DDR_RECOVERY_MAX_ROLLBACKS", "0")
    spec, one_epoch = "nan@device.step=2:n=1", ["experiment.epochs=1"]
    rc_jax, want = _run_jax(drill, tmp_path / "jax", spec, one_epoch, main=True)
    rc, got = _run_port(drill, tmp_path / "port", spec, one_epoch, main=True)
    assert rc == rc_jax == 3
    _assert_same_run(got, want, ["give-up"])
    assert got[-1]["status"] == "error:RecoveryGiveUp"
    saved = tmp_path / "port" / "saved_models"
    giveup = saved / "_heal-giveup_epoch_1_mb_2.pkl"
    manifest = json.loads(giveup.with_name(giveup.name + ".manifest.json").read_text())
    assert manifest["degraded"] is True and training.checkpoint_degraded(giveup) is True
    assert training.pinned_good_checkpoint(saved).name == "_heal_epoch_1_mb_1.pkl"
    jax_saved = tmp_path / "jax" / "saved_models"
    assert sorted(p.name for p in saved.glob("*.pkl")) == sorted(p.name for p in jax_saved.glob("*.pkl"))


def test_bf16_violation_reroutes_clean_on_fp32_as_jax(drill, tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_TRAIN_DTYPE", "bf16")
    monkeypatch.setenv("DDR_HEALTH_MAX_ULP_DRIFT", "0")
    monkeypatch.setenv("DDR_RECOVERY_MAX_REROUTES", "8")
    one_epoch = ["experiment.epochs=1"]
    _, want = _run_jax(drill, tmp_path / "jax", None, one_epoch)
    _, got = _run_port(drill, tmp_path / "port", None, one_epoch)
    _assert_same_run(got, want, ["fp32-reroute"] * 4)
    assert {e["outcome"] for e in _of(got, "recovery")} == {"clean"}
    assert [e["reasons"] for e in _of(got, "health")] == [["ulp-drift"]] * 4
    assert {v[1] for v in _steps(got).values()} == {"fp32-reroute"}
    # a rerouted step is a good step: scored and checkpointed
    assert len(list((tmp_path / "port" / "saved_models").glob("*.pkl"))) == 4


class _RequestAfterTwoSteps(PreemptionHandler):
    """Asks for the stop at the second step boundary, as a SIGTERM during
    the second step would."""

    @property
    def requested(self) -> bool:
        self._reads = getattr(self, "_reads", 0) + 1
        if self._reads == 2:
            self.request("SIGTERM")
        return super().requested


def test_preemption_saves_and_resumes_at_the_next_batch(drill, tmp_path, monkeypatch):
    monkeypatch.delenv("DDR_RECOVERY_ENABLED")
    one_epoch = ["experiment.epochs=1"]
    _, clean = _run_port(drill, tmp_path / "clean", None, one_epoch)
    monkeypatch.setattr(train_script, "PreemptionHandler", _RequestAfterTwoSteps)
    _, first = _run_port(drill, tmp_path / "run", None, one_epoch)
    monkeypatch.setattr(train_script, "PreemptionHandler", PreemptionHandler)
    (pre,) = _of(first, "preempt")
    assert (pre["reason"], pre["epoch"], pre["batch"], pre["step"]) == ("SIGTERM", 1, 1, 2)
    assert pre["mesh"]["n_devices"] == 1 and pre["mesh"]["platform"] == "cpu"
    saved = tmp_path / "run" / "saved_models"
    assert training.latest_checkpoint(saved).name == "_heal-preempt_epoch_1_mb_1.pkl"
    assert sorted(_steps(first)) == [(1, 0), (1, 1)]

    _, resumed = _run_port(drill, tmp_path / "run", None, [*one_epoch, f"experiment.checkpoint={saved}"],
                           resume=False)
    steps = _steps(resumed)
    assert sorted(steps) == [(1, 2), (1, 3)]
    assert {k: steps[k] for k in steps} == {k: _steps(clean)[k] for k in steps}  # bit for bit


def test_snapshot_restore_is_bit_for_bit_through_a_nan_step():
    """The unit the ladder stands on: a NaN step updates the KAN and Adam in
    place; a restore (twice, as a failed fp32 reroute then a skip do) leaves
    every tensor as before the step."""
    from ddr_tpu_torch.geodatazoo.synthetic import make_basin
    from ddr_tpu_torch.nn.kan import Kan
    from ddr_tpu_torch.routing.mc import Bounds
    from ddr_tpu_torch.routing.model import prepare_batch
    from ddr_tpu_torch.validation.configs import Config, KanConfig

    cfg = Config(kan=KanConfig(input_var_names=[f"a{i}" for i in range(10)]))
    p = cfg.params
    basin = make_basin(n_segments=32, n_gauges=2, n_days=4, depth=6, seed=3)
    rd = basin.routing_data
    net, ch, gauges = prepare_batch(rd, p.attribute_minimums["slope"], device="cpu")
    kan = Kan(tuple(cfg.kan.input_var_names), tuple(cfg.kan.learnable_parameters), hidden_size=8,
              generator=torch.Generator().manual_seed(0))
    opt = training.make_optimizer(kan.parameters(), 0.01)
    step = training.make_batch_train_step(kan, Bounds.from_config(p.attribute_minimums), p.parameter_ranges,
                                          p.log_space_parameters, p.defaults, tau=p.tau, warmup=1,
                                          optimizer=opt, device="cpu", collect_health=True)
    attrs = torch.as_tensor(rd.normalized_spatial_attributes, dtype=torch.float32)
    q = torch.as_tensor(np.asarray(basin.q_prime[: 3 * 24], np.float32))  # a 4-day window
    obs = torch.ones(2, 2)  # (D - 2 days, gauges)
    mask = torch.ones_like(obs, dtype=torch.bool)
    step(net, ch, gauges, attrs, q, obs, mask)  # Adam has moments to restore
    snap = training.snapshot_state(kan, opt)
    ref = (training._clone_tree(kan.state_dict()), training._clone_tree(opt.state_dict()))
    q_bad = q.clone()
    q_bad.view(-1)[::3] = float("nan")
    for _ in range(2):
        loss, _, health = step(net, ch, gauges, attrs, q_bad, obs, mask)
        assert not math.isfinite(float(loss)) and int(health.nonfinite) > 0
        assert not _bitwise(kan.state_dict(), ref[0])
        training.restore_snapshot(kan, opt, snap)
        assert _bitwise(kan.state_dict(), ref[0]) and _bitwise(opt.state_dict(), ref[1])
