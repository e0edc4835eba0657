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
  checkpoint, with the optional subsystems it lacks refused by name.
"""

from __future__ import annotations

import logging
import pickle
import re

import numpy as np
import pytest
import torch

from ddr_tpu import training as jax_training
from ddr_tpu.scripts import train as jax_train_script
from ddr_tpu.scripts.common import build_kan as jax_build_kan
from ddr_tpu.scripts.common import kan_arch as jax_kan_arch
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch import training
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.nn.kan import Kan
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
    level, logger.level = logger.level, logging.INFO
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


@pytest.mark.parametrize("var,value,item", [
    ("DDR_RECOVERY_ENABLED", "1", "A.6"),
    ("DDR_DATA_VALIDATE", "warn", "A.6"),
    ("DDR_CKPT_FORMAT", "orbax", "A.6"),
    ("DDR_FAULTS", "crash@step=1", "A.6"),
])
def test_optional_switches_raise_by_name(tmp_path, monkeypatch, var, value, item):
    monkeypatch.setenv(var, value)
    cfg = load_config(CONFIG, ["device=cpu", "mode=training", f"params.save_path={tmp_path}"],
                      save_config=False)
    with pytest.raises(NotImplementedError, match=item):
        train_script.train(cfg)
