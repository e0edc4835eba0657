"""``ddr train``, ``ddr test`` and ``ddr route`` on the MERIT example, the
port against the JAX package, on the CPU.

Both packages read the example's stores (prepared by the port; equal to
JAX's, ``tests/test_torch_merit_stores.py``) through their own ``Merit``
dataset and ``StreamflowReader``. JAX's ``train`` runs once for the module
(2 epochs, batch 2 over the two gauges: one step an epoch), from its
``build_kan`` initialisation; the port's loop resumes from a checkpoint of
those weights (epoch 1, mini-batch 0), carried across by
``kan_state_from_flax``, so it trains the same batches. ``ddr test`` and
``ddr route`` then evaluate JAX's trained weights in both packages over
the example's 182 days in 2-day chunks with carried discharge.

Tolerances, fp32. Epoch 1's loss rtol 1e-5, as on the synthetic twin
(``tests/test_torch_train_cli.py``). Epoch 2's loss is held to rtol 1e-5
as well, no looser bound being needed here: measured 2.9e-9 (epoch 1) and
4.3e-7 (epoch 2) on the CPU. Predictions and routed discharge ``|a - b| <= 1e-5 |ref| +
1e-5 max|ref|``, the evaluation commands' bound
(``tests/test_torch_evaluate.py``). Each test prints what it measured
(``-s``).
"""

from __future__ import annotations

import logging
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from ddr_tpu.io import zarrlite as jax_zarrlite
from ddr_tpu.scripts import train as jax_train_script
from ddr_tpu.scripts.common import build_kan as jax_build_kan
from ddr_tpu.scripts.router import route_domain as jax_route_domain
from ddr_tpu.scripts.test import test as jax_test
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch import cli
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.scripts import train as train_script
from ddr_tpu_torch.scripts.common import kan_arch
from ddr_tpu_torch.scripts.prepare_merit_example import prepare
from ddr_tpu_torch.scripts.router import route_domain
from ddr_tpu_torch.scripts.test import test as port_test
from ddr_tpu_torch.training import latest_checkpoint, save_state
from ddr_tpu_torch.validation.configs import load_config
from tests.test_torch_merit_dataset import data_overrides

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "merit_basin"
LOSS_RTOL = 1e-5


class _Losses(logging.Handler):
    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        m = re.match(r"epoch \d+ mini-batch \d+: loss=(\S+) \(", record.getMessage())
        if m:
            self.losses.append(float(m.group(1)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The prepared example and JAX's training run on it: its per-step
    losses, its initial and its trained weights."""
    tmp = tmp_path_factory.mktemp("merit_commands")
    example = tmp / "merit_basin"
    shutil.copytree(EXAMPLE, example, ignore=shutil.ignore_patterns("data", "output"))
    prepare(example)
    cfg = jax_load_config(example / "config.yaml", [*data_overrides(example, "jax"), "mode=training",
                                                    f"params.save_path={tmp / 'jax'}"], save_config=False)
    losses = []
    original = jax_train_script.make_batch_train_step

    def recording(*args, **kwargs):
        step = original(*args, **kwargs)

        def wrapped(*a):
            out = step(*a)
            losses.append(float(out[2]))
            return out

        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train_script, "make_batch_train_step", recording)
    try:
        params, _ = jax_train_script.train(cfg)
    finally:
        mp.undo()
    _, init = jax_build_kan(cfg)
    return {"example": example, "tmp": tmp, "losses": losses, "init": init, "params": params}


def _port_cfg(run, name, mode, *extra):
    return load_config(run["example"] / "config.yaml",
                       [*data_overrides(run["example"], "port"), "device=cpu", f"mode={mode}",
                        f"params.save_path={run['tmp'] / name}", *extra], save_config=False)


def _jax_cfg(run, name, mode, *extra):
    return jax_load_config(run["example"] / "config.yaml",
                           [*data_overrides(run["example"], "jax"), f"mode={mode}",
                            f"params.save_path={run['tmp'] / name}", *extra], save_config=False)


def test_port_train_matches_jax_train(run):
    cfg = _port_cfg(run, "port-train", "training")
    ck = save_state(run["tmp"] / "init", cfg.name, 1, 0, kan_state_from_flax(run["init"]), None,
                    arch=kan_arch(cfg))
    cfg.experiment.checkpoint = ck
    handler = _Losses()
    logger = logging.getLogger(train_script.__name__)
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)  # clears the loggers' cached INFO-is-off answers
    try:
        kan, _ = train_script.train(cfg)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    got, want = np.asarray(handler.losses), np.asarray(run["losses"])
    print(f"merit train: port {got.tolist()} jax {want.tolist()} rel {(np.abs(got - want) / np.abs(want)).tolist()}")
    assert len(got) == len(want) == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got[:1], want[:1], rtol=LOSS_RTOL, atol=0, err_msg="epoch 1 loss")
    np.testing.assert_allclose(got[1:], want[1:], rtol=LOSS_RTOL, atol=0, err_msg="epoch 2 loss")
    ref = kan_state_from_flax(run["params"])
    for k, v in kan.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-2 * (0.01 + 0.003), err_msg=k)


def _close(got, ref, label):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all() and got.shape == ref.shape, label
    print(f"{label}: max rel {np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-12)):.3e}")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(), err_msg=label)


def test_test_predictions_match_jax(run):
    state = kan_state_from_flax(run["params"])
    port_test(_port_cfg(run, "port-test", "testing"), params=state)
    jax_test(_jax_cfg(run, "jax-test", "testing"), params=run["params"])
    ours = jax_zarrlite.open_group(run["tmp"] / "port-test" / "model_test.zarr")
    ref = jax_zarrlite.open_group(run["tmp"] / "jax-test" / "model_test.zarr")
    assert ours["predictions"].shape == (2, 180)
    _close(ours["predictions"][:], ref["predictions"][:], "merit test daily predictions")
    np.testing.assert_array_equal(ours["observations"][:], ref["observations"][:])
    drop = ("version", "model")
    assert {k: v for k, v in ours.attrs.items() if k not in drop} == {
        k: v for k, v in ref.attrs.items() if k not in drop}


def test_route_discharge_matches_jax(run):
    state = kan_state_from_flax(run["params"])
    got = route_domain(_port_cfg(run, "port-route", "routing"), params=state)
    want = jax_route_domain(_jax_cfg(run, "jax-route", "routing"), params=run["params"])
    assert got.shape == (2, 181 * 24)
    _close(got, want, "merit route hourly discharge")


def test_cli_runs_the_documented_commands_from_the_example(run, monkeypatch):
    """``train``, ``test`` and ``route`` through ``python -m ddr_tpu_torch.cli``
    from the example's directory with its relative paths, as its README says."""
    work = run["tmp"] / "cli"
    shutil.copytree(run["example"], work, ignore=shutil.ignore_patterns("output"))
    monkeypatch.chdir(work)
    assert cli.main(["train", "config.yaml", "device=cpu", "experiment.epochs=1"]) == 0
    ck = latest_checkpoint(Path("output/saved_models"))
    assert ck is not None and ck.name.endswith("_epoch_1_mb_0.pkl")
    for command, store, array, shape in (("test", "model_test.zarr", "predictions", (2, 180)),
                                         ("route", "chrout.zarr", "discharge", (2, 181 * 24))):
        assert cli.main([command, "config.yaml", "device=cpu", f"experiment.checkpoint={ck}"]) == 0
        out = zarrlite.open_group(Path("output") / store)[array][:]
        assert out.shape == shape and np.isfinite(out).all()
    assert Path("output/stats/merit_attribute_statistics_attributes.zarr.json").is_file()
