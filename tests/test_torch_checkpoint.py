"""The port's pickle checkpoints and the train loop's resume.

* ``save_state`` -> ``verify_checkpoint`` -> ``load_state`` round-trips the
  KAN, the Adam state (after real steps) and the loader's RNG state exactly,
  directly and through the background writer, whose snapshot is a copy
  taken when ``save`` is called (a parameter changed right after stays out
  of the file).
* A bit-flipped or truncated blob fails its manifest, is quarantined
  (renamed ``*.corrupt``) and is skipped by a directory resume, both by
  ``load_latest_state`` and by the train loop.
* An architecture mismatch raises without quarantine; so does a blob of
  the JAX package (its own format marker).
* Retention keeps the newest ``DDR_CKPT_KEEP_LAST`` and the newest of each
  epoch.
* The train loop resumes mid-epoch at the JAX loop's rule (a checkpoint at
  mini-batch 0 resumes at 0, any other at the next one) and executes the
  same (epoch, mini-batch) sequence as JAX's ``train`` from the same
  checkpoint. The JAX package's directory checkpoints are refused naming
  ROADMAP A.13; malformed self-healing switches raise as JAX's do, and an
  injected ``crash@step`` takes the run down with ``InjectedFault``.
* The pinned-good marker against the JAX package's: the pointer's JSON, its
  refresh only on a healthy save and, through the background writer, only
  once the blob has landed; the fallback scan when the pointer names a
  missing file; retention keeping the pinned file; a ``checkpoint.write``
  crash leaving a ``.tmp`` that no scan takes, and a corrupt write
  quarantined on load.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import time

import numpy as np
import pytest
import torch

from ddr_tpu import training as jax_training
from ddr_tpu.observability import faults as jax_faults
from ddr_tpu.scripts import train as jax_train_script
from ddr_tpu.scripts.common import build_kan as jax_build_kan
from ddr_tpu.scripts.common import kan_arch as jax_kan_arch
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch import training
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.observability import faults
from ddr_tpu_torch.observability.faults import InjectedFault
from ddr_tpu_torch.scripts import train as train_script
from ddr_tpu_torch.scripts.common import kan_arch
from ddr_tpu_torch.validation.configs import load_config

CONFIG = "examples/synthetic/config.yaml"
ARCH = {"model": "kan", "grid": 3}


def _kan_and_adam(steps=2):
    kan = Kan(tuple(f"a{i}" for i in range(4)), ("n", "q_spatial"), hidden_size=5,
              generator=torch.Generator().manual_seed(0))
    opt = training.make_optimizer(kan.parameters(), 0.01)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(7, 4)), dtype=torch.float32)
    for _ in range(steps):
        opt.zero_grad()
        sum(v.sum() for v in kan(x).values()).backward()
        opt.step()
    return kan, opt


def _assert_state_equal(kan, opt, blob):
    for k, v in kan.state_dict().items():
        np.testing.assert_array_equal(blob["params"][k], v.numpy(), err_msg=k)
    other, opt2 = _kan_and_adam(steps=0)
    other.load_state_dict({k: torch.as_tensor(v) for k, v in blob["params"].items()})
    training.restore_optimizer(opt2, blob["opt_state"])
    want, got = opt.state_dict(), opt2.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, st in want["state"].items():
        for name, v in st.items():
            torch.testing.assert_close(got["state"][i][name], v, rtol=0, atol=0)


def test_round_trip(tmp_path):
    kan, opt = _kan_and_adam()
    rng_state = {"bit_generator": np.random.default_rng(3).bit_generator.state}
    path = training.save_state(tmp_path, "run", 2, 5, kan, opt, rng_state=rng_state, arch=ARCH,
                               healthy=True)
    assert path.name == "_run_epoch_2_mb_5.pkl"
    data = training.verify_checkpoint(path)
    blob = training.load_state(path, expected_arch=ARCH)
    assert pickle.loads(data)["epoch"] == blob["epoch"] == 2 and blob["mini_batch"] == 5
    assert blob["rng_state"] == rng_state and blob["degraded"] is False
    _assert_state_equal(kan, opt, blob)
    assert training.latest_checkpoint(tmp_path) == path


def test_async_writer_snapshots_at_save(tmp_path):
    kan, opt = _kan_and_adam()
    want = {k: v.clone() for k, v in kan.state_dict().items()}
    writer = training.AsyncCheckpointWriter()
    try:
        for mb in range(3):
            writer.save(tmp_path, "run", 1, mb, kan, opt, arch=ARCH)
        with torch.no_grad():
            for p in kan.parameters():
                p.add_(1.0)  # after the last save: must not reach its file
        assert writer.drain(timeout=30)
    finally:
        writer.close()
    blob = training.load_state(training.latest_checkpoint(tmp_path), expected_arch=ARCH)
    assert blob["mini_batch"] == 2
    for k, v in want.items():
        np.testing.assert_array_equal(blob["params"][k], v.numpy())


@pytest.mark.parametrize("damage", ["bit-flip", "truncate"])
def test_damaged_blob_is_quarantined_and_skipped(tmp_path, damage):
    kan, opt = _kan_and_adam()
    good = training.save_state(tmp_path, "run", 1, 0, kan, opt, arch=ARCH)
    bad = training.save_state(tmp_path, "run", 1, 1, kan, opt, arch=ARCH)
    data = bytearray(bad.read_bytes())
    if damage == "bit-flip":
        data[len(data) // 2] ^= 0x10
    else:
        data = data[: len(data) // 2]
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        training.verify_checkpoint(bad)
    assert bad.exists()  # verification alone never quarantines
    blob, path = training.load_latest_state(tmp_path, expected_arch=ARCH)
    assert path == good and blob["mini_batch"] == 0
    assert not bad.exists() and bad.with_name(bad.name + ".corrupt").exists()
    assert training.checkpoint_candidates(tmp_path) == [good]


def test_mismatches_raise_without_quarantine(tmp_path):
    kan, opt = _kan_and_adam()
    path = training.save_state(tmp_path, "run", 1, 0, kan, opt, arch=ARCH)
    with pytest.raises(ValueError, match="different architecture"):
        training.load_state(path, expected_arch=dict(ARCH, grid=5))
    assert path.exists()
    jax_path = jax_training.save_state(tmp_path / "jax", "run", 1, 0, {"w": np.ones(2)}, None)
    with pytest.raises(ValueError, match="not a checkpoint of the PyTorch port"):
        training.load_state(jax_path)
    assert jax_path.exists()


def test_retention_keeps_recent_and_one_per_epoch(tmp_path, monkeypatch):
    kan, opt = _kan_and_adam(steps=0)
    for epoch in (1, 2):
        for mb in range(3):
            training.save_state(tmp_path, "run", epoch, mb, kan, opt)
    monkeypatch.setenv("DDR_CKPT_KEEP_LAST", "2")
    deleted = training.prune_checkpoints_from_env(tmp_path)
    kept = sorted(p.name for p in training.checkpoint_candidates(tmp_path))
    assert kept == ["_run_epoch_1_mb_2.pkl", "_run_epoch_2_mb_1.pkl", "_run_epoch_2_mb_2.pkl"]
    assert len(deleted) == 3 and not any(p.with_name(p.name + ".manifest.json").exists() for p in deleted)


class _Steps(logging.Handler):
    """The (epoch, mini-batch) of every step line the port's loop logs."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def emit(self, record):
        m = re.match(r"epoch (\d+) mini-batch (\d+): loss=", record.getMessage())
        if m:
            self.steps.append((int(m.group(1)), int(m.group(2))))


@pytest.fixture
def step_log():
    handler = _Steps()
    logger = logging.getLogger(train_script.__name__)
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)  # clears the loggers' cached INFO-is-off answers
    yield handler
    logger.removeHandler(handler)
    logger.setLevel(level)


@pytest.mark.parametrize("mini_batch", [0, 1])
def test_resume_mid_epoch_follows_the_jax_rule(tmp_path, step_log, monkeypatch, mini_batch):
    """batch size 1 (4 batches an epoch), one epoch: a checkpoint at
    mini-batch 0 resumes there, one at mini-batch 1 resumes at 2."""
    ov = ["device=cpu", "mode=training", "experiment.batch_size=1", "experiment.epochs=1"]
    jax_cfg = jax_load_config(CONFIG, ov + [f"params.save_path={tmp_path}/jax"], save_config=False)
    _, params = jax_build_kan(jax_cfg)
    jax_ck = jax_training.save_state(tmp_path / "jax_init", jax_cfg.name, 1, mini_batch, params, None,
                                     arch=jax_kan_arch(jax_cfg))
    jax_cfg.experiment.checkpoint = jax_ck
    jax_steps = []
    original = jax_train_script.make_batch_train_step

    def recording(*args, **kwargs):
        step = original(*args, **kwargs)

        def wrapped(*a):
            jax_steps.append(None)
            return step(*a)

        return wrapped

    monkeypatch.setattr(jax_train_script, "make_batch_train_step", recording)
    jax_train_script.train(jax_cfg)

    cfg = load_config(CONFIG, ov + [f"params.save_path={tmp_path}/port"], save_config=False)
    ck = training.save_state(tmp_path / "init", cfg.name, 1, mini_batch, kan_state_from_flax(params),
                             None, arch=kan_arch(cfg))
    cfg.experiment.checkpoint = ck
    train_script.train(cfg)
    start = 0 if mini_batch == 0 else mini_batch + 1
    assert step_log.steps == [(1, i) for i in range(start, 4)]
    assert len(jax_steps) == len(step_log.steps)
    names = sorted(p.name for p in (tmp_path / "port/saved_models").glob("*.pkl"))
    assert names == sorted(p.name for p in (tmp_path / "jax/saved_models").glob("*.pkl"))


def test_directory_resume_skips_a_corrupt_newest(tmp_path, step_log):
    ov = ["device=cpu", "mode=training", "experiment.batch_size=1", "experiment.epochs=1",
          f"params.save_path={tmp_path}"]
    cfg = load_config(CONFIG, ov, save_config=False)
    train_script.train(cfg, max_batches=2)
    saved = tmp_path / "saved_models"
    newest = training.latest_checkpoint(saved)
    assert newest.name.endswith("_epoch_1_mb_1.pkl")
    data = bytearray(newest.read_bytes())
    data[-10] ^= 0x01
    newest.write_bytes(bytes(data))
    step_log.steps.clear()
    cfg.experiment.checkpoint = saved
    train_script.train(cfg, max_batches=1)
    assert step_log.steps == [(1, 0)]  # resumed from mini-batch 0's checkpoint, which resumes at 0
    assert newest.with_name(newest.name + ".corrupt").exists()


@pytest.mark.parametrize("var,value,error,match", [
    ("DDR_RECOVERY_MAX_ROLLBACKS", "-1", ValueError, "max_rollbacks must be >= 0, got -1"),
    ("DDR_DATA_VALIDATE", "sometimes", ValueError,
     re.escape("bad DDR_DATA_VALIDATE='sometimes' (want one of off, warn, quarantine)")),
    ("DDR_CKPT_FORMAT", "orbax", NotImplementedError, r"ROADMAP A\.13"),
    ("DDR_FAULTS", "crash@step=1", InjectedFault, "injected fault: crash@device.step step=1"),
])
def test_optional_switches_raise_by_name(tmp_path, monkeypatch, var, value, error, match):
    """A malformed recovery budget or validation policy raises the JAX loop's
    error, the directory checkpoint names the item that ports sharded state,
    and ``crash@step=1`` takes the run down at its second step."""
    monkeypatch.setenv(var, value)
    monkeypatch.setattr(faults, "_PLAN", None)  # DDR_FAULTS is parsed on first use
    cfg = load_config(CONFIG, ["device=cpu", "mode=training", f"params.save_path={tmp_path}"],
                      save_config=False)
    with pytest.raises(error, match=match) as raised:
        train_script.train(cfg)
    if error is InjectedFault:
        assert raised.value.site == "device.step"
        assert training.latest_checkpoint(tmp_path / "saved_models").name.endswith("_epoch_1_mb_0.pkl")
    if var != "DDR_CKPT_FORMAT" and var != "DDR_FAULTS":
        # JAX's loop builds the same objects from the same variable
        from ddr_tpu.observability.recovery import ForcingValidator, RecoveryConfig

        with pytest.raises(error, match=match):
            RecoveryConfig.from_env() if var.startswith("DDR_RECOVERY") else ForcingValidator()


# ---------------------------------------------------------------------------
# The pinned-good marker, against the JAX package's
# ---------------------------------------------------------------------------

JAX_PARAMS = {"w": np.arange(6, dtype=np.float32)}


def _save(pkg, d, epoch, mb, healthy=None, scale=1.0):
    if pkg == "jax":
        return jax_training.save_state(d, "t", epoch, mb, {"w": JAX_PARAMS["w"] * scale}, None, healthy=healthy)
    return training.save_state(d, "t", epoch, mb, {"w": torch.as_tensor(JAX_PARAMS["w"] * scale)}, None,
                               healthy=healthy)


def _pointer(d):
    return json.loads((d / "_pinned_good.json").read_text())


@pytest.fixture
def disarm():
    yield
    faults.configure(None)
    jax_faults.configure(None)


def test_pinned_marker_equals_jax(tmp_path):
    seen = {}
    for pkg, mod in (("jax", jax_training), ("port", training)):
        d = tmp_path / pkg
        good = _save(pkg, d, 1, 0, healthy=True)
        first = _pointer(d)
        bad = _save(pkg, d, 1, 1, healthy=False, scale=2.0)  # a degraded save leaves the pin
        plain = _save(pkg, d, 1, 2)  # no verdict: no refresh either
        seen[pkg] = (first, _pointer(d), mod.pinned_good_checkpoint(d).name, mod.checkpoint_degraded(bad),
                     mod.checkpoint_degraded(good), mod.checkpoint_degraded(plain),
                     mod.latest_checkpoint(d).name)
    assert seen["port"] == seen["jax"]
    first, after, pinned, *_ = seen["port"]
    assert first == after == {"format": "ddr-tpu-pinned-good", "version": 1, "path": "_t_epoch_1_mb_0.pkl",
                              "epoch": 1, "mini_batch": 0}
    assert pinned == "_t_epoch_1_mb_0.pkl"


def test_pinned_marker_lands_after_the_async_blob(tmp_path, disarm):
    """The background writer refreshes the pointer only once the blob is in
    place: a slowed write leaves no pointer until it has landed."""
    faults.configure("slow@checkpoint.write:ms=400")
    writer = training.AsyncCheckpointWriter()
    try:
        writer.save(tmp_path, "t", 1, 0, {"w": torch.ones(3)}, None, healthy=True)
        time.sleep(0.1)
        assert not (tmp_path / "_pinned_good.json").exists()
        assert not (tmp_path / "_t_epoch_1_mb_0.pkl").exists()
        assert writer.drain(timeout=30.0)
        assert _pointer(tmp_path)["path"] == "_t_epoch_1_mb_0.pkl"
        writer.save(tmp_path, "t", 1, 1, {"w": torch.zeros(3)}, None, healthy=False)
        assert writer.drain(timeout=30.0)
    finally:
        writer.close()
    assert training.pinned_good_checkpoint(tmp_path).name == "_t_epoch_1_mb_0.pkl"


def test_stale_pointer_falls_back_to_the_scan_as_jax(tmp_path):
    found = {}
    for pkg, mod in (("jax", jax_training), ("port", training)):
        d = tmp_path / pkg
        good = _save(pkg, d, 1, 0, healthy=True)
        os.utime(good, (good.stat().st_atime, 1_000_000))
        gone = _save(pkg, d, 1, 1, healthy=True)
        bad = _save(pkg, d, 2, 0, healthy=False)
        os.utime(bad, (bad.stat().st_atime, 3_000_000))
        gone.unlink()
        gone.with_name(gone.name + ".manifest.json").unlink()
        found[pkg] = mod.pinned_good_checkpoint(d).name
        (d / "_pinned_good.json").write_text("{torn")
        found[pkg + "-unreadable"] = mod.pinned_good_checkpoint(d).name
    assert found["port"] == found["jax"] == "_t_epoch_1_mb_0.pkl"
    assert found["port-unreadable"] == found["jax-unreadable"] == "_t_epoch_1_mb_0.pkl"
    assert training.pinned_good_checkpoint(tmp_path / "empty") is None


def test_prune_keeps_the_pinned_checkpoint_as_jax(tmp_path):
    kept = {}
    for pkg, mod in (("jax", jax_training), ("port", training)):
        d = tmp_path / pkg
        pinned = _save(pkg, d, 1, 0, healthy=True)
        os.utime(pinned, (pinned.stat().st_atime, 1_000_000))
        for i, (epoch, mb) in enumerate([(1, 1), (1, 2), (2, 0), (2, 1)]):
            p = _save(pkg, d, epoch, mb, healthy=False)
            os.utime(p, (p.stat().st_atime, 2_000_000 + i))
        deleted = mod.prune_checkpoints(d, keep_last=1, keep_every_epoch=False)
        kept[pkg] = (sorted(p.name for p in deleted), sorted(p.name for p in mod.checkpoint_candidates(d)))
    assert kept["port"] == kept["jax"]
    assert kept["port"][1] == ["_t_epoch_1_mb_0.pkl", "_t_epoch_2_mb_1.pkl"]


def test_checkpoint_write_faults_as_jax(tmp_path, disarm):
    """``crash@checkpoint.write`` leaves the torn ``.tmp`` (no candidate, no
    manifest-less blob) and ``corrupt@checkpoint.write`` writes flipped bits
    under the intact manifest, which load quarantines."""
    outcomes = {}
    for pkg, mod, fmod in (("jax", jax_training, jax_faults), ("port", training, faults)):
        d = tmp_path / pkg
        fmod.configure("crash@checkpoint.write=0")
        with pytest.raises(fmod.InjectedFault) as crash:
            _save(pkg, d, 1, 0, healthy=True)
        fmod.configure("corrupt@checkpoint.write:n=1")
        corrupt = _save(pkg, d, 1, 1, healthy=True)
        fmod.configure(None)
        left = sorted(p.name for p in d.iterdir())
        cands = [p.name for p in mod.checkpoint_candidates(d)]
        with pytest.raises(ValueError, match="checksum mismatch"):
            mod.load_state(corrupt)
        outcomes[pkg] = (crash.value.site, left, cands, sorted(p.name for p in d.iterdir()))
    assert outcomes["port"] == outcomes["jax"]
    site, left, cands, after = outcomes["port"]
    assert site == "checkpoint.write"
    assert "_t_epoch_1_mb_0.pkl.tmp" in left and "_t_epoch_1_mb_0.pkl" not in left
    assert cands == ["_t_epoch_1_mb_1.pkl"]
    assert "_t_epoch_1_mb_1.pkl.corrupt" in after


def test_directory_resume_skips_a_torn_tmp(tmp_path, step_log):
    """A write killed between the temp file and the rename leaves a ``.tmp``;
    a directory resume takes the newest complete checkpoint instead."""
    ov = ["device=cpu", "mode=training", "experiment.batch_size=1", "experiment.epochs=1",
          f"params.save_path={tmp_path}"]
    cfg = load_config(CONFIG, ov, save_config=False)
    train_script.train(cfg, max_batches=2)
    saved = tmp_path / "saved_models"
    newest = training.latest_checkpoint(saved)
    torn = newest.with_name(newest.name.replace("_mb_1", "_mb_2") + ".tmp")
    torn.write_bytes(newest.read_bytes()[:100])
    step_log.steps.clear()
    cfg.experiment.checkpoint = saved
    train_script.train(cfg, max_batches=1)
    assert step_log.steps == [(1, 2)]  # resumed after mini-batch 1, not from the torn 2
