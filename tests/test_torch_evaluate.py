"""The port's evaluation commands against the JAX package's, on the CPU:
``evaluate_hourly``, ``ddr test`` (``model_test.zarr``), ``ddr route``
(``chrout.zarr``) and ``ddr train-and-test``.

Both packages evaluate the synthetic twin (32 reaches, 4 gauges) from one
set of KAN weights: JAX's ``build_kan`` initialisation, carried into the
port by ``kan_state_from_flax``. Each package builds its own twin and routes
it on its own engine (the port on the plain versions of its CUDA scans).
The window is cut to 22 days at 6 days a chunk, so 4 chunks run and every
chunk after the first starts from the previous one's final discharge
(``carry_state``).

Tolerance: ``|a - b| <= 1e-5 |ref| + 1e-5 max|ref|`` on predictions and
discharge; the metric batteries within 1e-5 absolute (the percentages
among them as ratios, see :data:`PERCENT`); the store attributes
equal apart from ``version`` and ``model``. ``train-and-test`` is held to
the port's own ``test`` of the checkpoint it trained, bit for bit.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from ddr_tpu.geodatazoo.synthetic import Synthetic as JaxSynthetic
from ddr_tpu.io import zarrlite as jax_zarrlite
from ddr_tpu.scripts import common as jax_common
from ddr_tpu.scripts.router import route_domain as jax_route_domain
from ddr_tpu.scripts.test import test as jax_test
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch.geodatazoo.synthetic import Synthetic
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.routing.model import dmc
from ddr_tpu_torch.scripts import common
from ddr_tpu_torch.scripts.router import route_domain
from ddr_tpu_torch.scripts.test import test as port_test
from ddr_tpu_torch.scripts.test import timestamp_strings
from ddr_tpu_torch.scripts.train_and_test import train_and_test
from ddr_tpu_torch.training import latest_checkpoint
from ddr_tpu_torch.validation.configs import load_config

CONFIG = "examples/synthetic/config.yaml"
WINDOW = ["synthetic_segments=32", "device=cpu", "experiment.end_time=1981/10/22",
          "experiment.batch_size=6"]
METRICS = ("bias", "corr", "corr_spearman", "fdc_rmse", "fhv", "flv", "kge", "kge_12", "mae", "nse",
           "pbias", "pbias_mid", "r2", "rmse", "rmse_high", "rmse_low", "rmse_mid", "ub_rmse")
#: The volume-bias metrics are percentages, 100 x a ratio: they are held to
#: 1e-5 as ratios (flv measured 2.0e-5 percent points apart, 2.0e-7 as a ratio).
PERCENT = ("fhv", "flv", "pbias", "pbias_mid")


def close(got, ref, label=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, label
    assert np.isfinite(got).all() and np.isfinite(ref).all(), label
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(), err_msg=label)


def _configs(tmp_path, mode, extra=()):
    ov = [*WINDOW, f"mode={mode}", *extra]
    ours = load_config(CONFIG, ov + [f"params.save_path={tmp_path / 'port'}"], save_config=False)
    ref = jax_load_config(CONFIG, ov + [f"params.save_path={tmp_path / 'jax'}"], save_config=False)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    return ours, ref


@pytest.fixture(scope="module")
def weights():
    """JAX's fresh KAN for the example config, and the same weights for the port."""
    cfg = jax_load_config(CONFIG, [*WINDOW, "mode=testing"], save_config=False)
    _, params = jax_common.build_kan(cfg)
    return params, kan_state_from_flax(params)


class _Chunks(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        if record.getMessage().startswith("evaluate batch "):
            self.lines.append(record.getMessage())


class _NoCarry(dmc):
    def forward(self, rd, q_prime, raw, carry_state=False):
        return super().forward(rd, q_prime, raw, carry_state=False)


def test_evaluate_hourly_matches_jax(tmp_path, weights):
    jax_params, state = weights
    cfg, jcfg = _configs(tmp_path, "testing")
    ours, ref = Synthetic(cfg), JaxSynthetic(jcfg)
    kan = common.build_kan(cfg)
    kan.load_state_dict(state)
    jkan, _ = jax_common.build_kan(jcfg)

    handler = _Chunks()
    logger = logging.getLogger(common.__name__)
    logger.addHandler(handler)
    level, logger.level = logger.level, logging.INFO
    try:
        got = common.evaluate_hourly(cfg, ours, ours.streamflow, kan)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    want = jax_common.evaluate_hourly(jcfg, ref, ref.streamflow, jkan, jax_params)
    assert len(handler.lines) == 4, handler.lines
    assert got.shape == want.shape == (4, 21 * 24)
    close(got, want, "hourly gauge predictions")

    # the carried discharge matters: without it the chunks after the first part from JAX
    no_carry = common.evaluate_hourly(cfg, ours, ours.streamflow, kan,
                                      routing_model=_NoCarry(cfg, device="cpu"))
    np.testing.assert_array_equal(no_carry[:, :120], got[:, :120])
    assert np.abs(no_carry[:, 120:] - want[:, 120:]).max() > 1e-3 * np.abs(want).max()


def _attrs_but(attrs, *drop):
    return {k: v for k, v in attrs.items() if k not in drop}


def test_test_writes_jax_model_test_store(tmp_path, weights):
    jax_params, state = weights
    cfg, jcfg = _configs(tmp_path, "testing")
    metrics = port_test(cfg, params=state)
    jax_metrics = jax_test(jcfg, params=jax_params)

    ours = jax_zarrlite.open_group(tmp_path / "port" / "model_test.zarr")  # JAX reads the port's store
    ref = jax_zarrlite.open_group(tmp_path / "jax" / "model_test.zarr")
    assert sorted(ours.keys()) == sorted(ref.keys()) == ["observations", "predictions"]
    close(ours["predictions"][:], ref["predictions"][:], "daily predictions")
    close(ours["observations"][:], ref["observations"][:], "daily observations")
    assert ours["predictions"].dtype == ref["predictions"].dtype == np.float32
    assert _attrs_but(ours.attrs, "version", "model") == _attrs_but(ref.attrs, "version", "model")
    for name in METRICS:
        scale = 100.0 if name in PERCENT else 1.0
        np.testing.assert_allclose(getattr(metrics, name) / scale, getattr(jax_metrics, name) / scale,
                                   rtol=0, atol=1e-5, err_msg=name)


def test_route_writes_jax_chrout_store(tmp_path, weights, capsys):
    jax_params, state = weights
    cfg, jcfg = _configs(tmp_path, "routing")
    got = route_domain(cfg, params=state)
    want = jax_route_domain(jcfg, params=jax_params)
    close(got, want, "routed discharge")
    assert "DDR routing summary" in capsys.readouterr().out

    ours = jax_zarrlite.open_group(tmp_path / "port" / "chrout.zarr")
    ref = jax_zarrlite.open_group(tmp_path / "jax" / "chrout.zarr")
    np.testing.assert_array_equal(ours["discharge"][:], got)
    close(ours["discharge"][:], ref["discharge"][:], "stored discharge")
    assert _attrs_but(ours.attrs, "version", "model") == _attrs_but(ref.attrs, "version", "model")


def test_train_and_test_evaluates_the_newest_checkpoint(tmp_path):
    window = ["experiment.epochs=1", "experiment.test_start_time=1981/10/01",
              "experiment.test_end_time=1981/10/25"]
    cfg = load_config(CONFIG, ["synthetic_segments=32", "device=cpu", "mode=training", *window,
                               f"params.save_path={tmp_path / 'tt'}"], save_config=False)
    (tmp_path / "tt").mkdir()
    metrics = train_and_test(cfg)
    ckpt = latest_checkpoint(tmp_path / "tt" / "saved_models")
    assert ckpt.name == "_synthetic_example_epoch_1_mb_1.pkl"
    assert cfg.experiment.checkpoint is None  # the test half ran on a copy

    again = load_config(CONFIG, ["synthetic_segments=32", "device=cpu", "mode=testing",
                                 "experiment.start_time=1981/10/01", "experiment.end_time=1981/10/25",
                                 f"experiment.checkpoint={ckpt}", f"params.save_path={tmp_path / 't'}"],
                        save_config=False)
    (tmp_path / "t").mkdir()
    alone = port_test(again)
    a = zarrlite.open_group(tmp_path / "tt" / "model_test.zarr")
    b = zarrlite.open_group(tmp_path / "t" / "model_test.zarr")
    np.testing.assert_array_equal(a["predictions"][:], b["predictions"][:])
    np.testing.assert_array_equal(a["observations"][:], b["observations"][:])
    assert dict(a.attrs) == dict(b.attrs)
    assert a.attrs["model"] == str(ckpt) and a.attrs["start_time"] == "1981/10/01"
    for name in METRICS:
        np.testing.assert_array_equal(getattr(metrics, name), getattr(alone, name), err_msg=name)


def test_timestamps_are_spelled_as_the_jax_stores_spell_them():
    days = np.arange(np.datetime64("1981-10-01"), np.datetime64("1981-10-04"))
    assert timestamp_strings(days) == ["1981-10-01 00:00:00", "1981-10-02 00:00:00",
                                       "1981-10-03 00:00:00"]
    hours = np.datetime64("1981-10-01T05", "h") + np.arange(2)
    assert timestamp_strings(hours) == ["1981-10-01 05:00:00", "1981-10-01 06:00:00"]


def test_load_kan_prefers_params_then_the_checkpoint(tmp_path, weights, caplog):
    _, state = weights
    cfg = load_config(CONFIG, [*WINDOW, "mode=testing"], save_config=False)
    kan = common.load_kan(cfg, state)
    for k, v in kan.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    with caplog.at_level(logging.WARNING, logger=common.__name__):
        fresh = common.load_kan(cfg, purpose="routing")
    assert "Creating new spatial model for routing." in caplog.text
    assert not fresh.training
