"""``ddr summed-q-prime`` and the ΣQ' store in ``ddr benchmark``, the port
against the JAX package, on the CPU.

Both packages read the MERIT example's stores (prepared by the port; equal
to JAX's, ``tests/test_torch_merit_stores.py``). ``eval_q_prime`` sums each
gauge's upstream inflow (``torch.nansum`` against ``jnp.nansum``): the
predictions and every metric within rtol 1e-6, the summary JSON and the
per-gauge CSV (same header and gauge order) within 1e-6, the zarr store's
attributes equal. ``ddr benchmark`` then reads each package's own ΣQ' store
from one set of KAN weights (JAX's initialisation, written as each package's
checkpoint): the ``summed_q_prime`` battery within 1e-6 and both mass
balances as logged (4 decimals).
"""

from __future__ import annotations

import csv
import importlib
import json
import logging
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from ddr_tpu import training as jax_training
from ddr_tpu.benchmarks.configs import validate_benchmark_config as jax_validate_benchmark_config
from ddr_tpu.io import zarrlite as jax_zarrlite
from ddr_tpu.scripts import common as jax_common
from ddr_tpu.scripts.summed_q_prime import eval_q_prime as jax_eval_q_prime
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch import cli
from ddr_tpu_torch.benchmarks import benchmark
from ddr_tpu_torch.benchmarks.configs import validate_benchmark_config
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.scripts.common import kan_arch
from ddr_tpu_torch.scripts.prepare_merit_example import prepare
from ddr_tpu_torch.scripts.summed_q_prime import SUMMARY_METRICS, eval_q_prime
from ddr_tpu_torch.training import save_state
from ddr_tpu_torch.validation.configs import load_config
from tests.test_torch_merit_dataset import data_overrides

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "merit_basin"
RTOL = 1e-6
#: A shorter window than the example's 182 days, in 10-day chunks, keeps the
#: two benchmark runs quick; it still spans the warmup and both gauges.
WINDOW = ["experiment.end_time=1981/12/09", "experiment.batch_size=10"]
jax_benchmark = importlib.import_module("ddr_tpu.benchmarks.benchmark")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The prepared example and both packages' ``eval_q_prime`` on it."""
    tmp = tmp_path_factory.mktemp("summed_q_prime")
    example = tmp / "merit_basin"
    shutil.copytree(EXAMPLE, example, ignore=shutil.ignore_patterns("data", "output"))
    prepare(example)
    path = example / "config.yaml"
    cfg = load_config(path, [*data_overrides(example, "port"), *WINDOW, "mode=testing", "device=cpu",
                             f"params.save_path={tmp / 'port'}"], save_config=False)
    jcfg = jax_load_config(path, [*data_overrides(example, "jax"), *WINDOW, "mode=testing",
                                  f"params.save_path={tmp / 'jax'}"], save_config=False)
    return {"example": example, "tmp": tmp, "cfg": cfg, "jcfg": jcfg,
            "ours": eval_q_prime(cfg), "ref": jax_eval_q_prime(jcfg)}


def test_eval_q_prime_matches_jax(runs):
    ours, ref = runs["ours"], runs["ref"]
    for name in ("pred", "target", *SUMMARY_METRICS):
        a, b = np.asarray(getattr(ours, name)), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, equal_nan=True, err_msg=name)
    assert np.isfinite(ours.pred).all() and (ours.pred > 0).all()
    print(f"ΣQ' predictions: max rel diff {np.max(np.abs(ours.pred - ref.pred) / np.abs(ref.pred)):.3g}")


def test_summary_json_and_csv_match_jax(runs):
    port, jax = runs["tmp"] / "port", runs["tmp"] / "jax"
    a = json.loads((port / "summed_q_prime_summary.json").read_text())
    b = json.loads((jax / "summed_q_prime_summary.json").read_text())
    assert list(a) == list(b) == list(SUMMARY_METRICS)
    for name in b:
        assert list(a[name]) == list(b[name]) == ["median", "mean"]
        np.testing.assert_allclose([a[name]["median"], a[name]["mean"]], [b[name]["median"], b[name]["mean"]],
                                   rtol=RTOL, err_msg=name)
    with open(port / "summed_q_prime_metrics.csv", newline="") as f:
        ours = list(csv.reader(f))
    with open(jax / "summed_q_prime_metrics.csv", newline="") as f:
        ref = list(csv.reader(f))
    assert ours[0] == ref[0] == ["gage_id", *SUMMARY_METRICS]
    assert [r[0] for r in ours[1:]] == [r[0] for r in ref[1:]] and len(ours) == len(ref) > 1
    np.testing.assert_allclose(np.asarray([r[1:] for r in ours[1:]], dtype=float),
                               np.asarray([r[1:] for r in ref[1:]], dtype=float), rtol=RTOL)


def test_zarr_store_matches_jax(runs):
    ours = zarrlite.open_group(runs["tmp"] / "port" / "summed_q_prime.zarr")
    ref = jax_zarrlite.open_group(runs["tmp"] / "jax" / "summed_q_prime.zarr")
    assert sorted(ours.keys()) == sorted(ref.keys()) == ["observations", "predictions"]
    assert dict(ours.attrs) == dict(ref.attrs)
    for name in ref.keys():
        a, b = ours[name][:], ref[name][:]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, equal_nan=True, err_msg=name)


def test_cli_dispatches_summed_q_prime(runs, tmp_path):
    """``python -m ddr_tpu_torch.cli summed-q-prime`` reaches the command and
    writes the same store as the direct call."""
    example = runs["example"]
    assert cli.main(["summed-q-prime", str(example / "config.yaml"), *data_overrides(example, "port"),
                     *WINDOW, "device=cpu", f"params.save_path={tmp_path}"]) == 0
    got = zarrlite.open_group(tmp_path / "summed_q_prime.zarr")["predictions"][:]
    want = zarrlite.open_group(runs["tmp"] / "port" / "summed_q_prime.zarr")["predictions"][:]
    np.testing.assert_array_equal(got, want)
    assert "summed-q-prime" in cli._COMMANDS and "summed-q-prime" not in cli._NOT_PORTED


MASS = re.compile(r"Mass balance (MC|LTI) vs ΣQ': mean rel err (\S+), median (\S+)")


def test_benchmark_reads_the_store_as_jax(runs, caplog):
    tmp, cfg, jcfg = runs["tmp"], runs["cfg"], runs["jcfg"]
    _, params = jax_common.build_kan(jcfg)
    jax_ckpt = jax_training.save_state(tmp / "jax_ckpt", "x", 1, 0, params, None,
                                       arch=jax_common.kan_arch(jcfg))
    ckpt = save_state(tmp / "ckpt", "x", 1, 0, kan_state_from_flax(params), None, arch=kan_arch(cfg))

    def raw(c, checkpoint, save, store):
        d = c.model_dump()
        return {**d, "experiment": {**d["experiment"], "checkpoint": str(checkpoint)},
                "params": {**d["params"], "save_path": str(save)}, "summed_q_prime": str(store)}

    with caplog.at_level(logging.INFO):
        ours = benchmark.benchmark(validate_benchmark_config(
            raw(cfg, ckpt, tmp / "bench_port", tmp / "port" / "summed_q_prime.zarr")))
        ref = jax_benchmark.benchmark(jax_validate_benchmark_config(
            raw(jcfg, jax_ckpt, tmp / "bench_jax", tmp / "jax" / "summed_q_prime.zarr")))
    assert sorted(ours) == sorted(ref) == ["lti", "mc", "summed_q_prime"]
    for name in (*SUMMARY_METRICS, "pred", "target"):
        np.testing.assert_allclose(getattr(ours["summed_q_prime"], name), getattr(ref["summed_q_prime"], name),
                                   rtol=RTOL, equal_nan=True, err_msg=name)
    lines = {pkg: {m.group(1): (float(m.group(2)), float(m.group(3)))
                   for r in caplog.records if r.name == logger and (m := MASS.match(r.getMessage()))}
             for pkg, logger in (("port", benchmark.__name__), ("jax", jax_benchmark.__name__))}
    print(f"mass balances: {lines}")
    assert sorted(lines["port"]) == sorted(lines["jax"]) == ["LTI", "MC"]
    for name in ("MC", "LTI"):
        # the logged values carry 4 decimals: equal up to the last one's rounding
        np.testing.assert_allclose(lines["port"][name], lines["jax"][name], rtol=0, atol=1.01e-4)
