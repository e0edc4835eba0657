"""The port's streaming skill tracker against the JAX package's
(``ddr_tpu/observability/skill.py``), on the same inputs.

- ``SkillConfig.from_env`` equals JAX's and refuses what JAX refuses;
- ``gauge_skill_from_sums`` on seeded sums (degenerate gauges included)
  equals JAX's to rtol 1e-6, NaN where JAX gives NaN;
- ``SkillTracker`` fed the same seeded batches (missing values, new gauges
  arriving, constant and zero-mass gauges) returns the same summaries, and
  its ``status()`` and ``results()`` equal JAX's to rtol 1e-6 after every
  batch; ``merge`` folds as JAX's does; the registries' text is equal;
- with a run recorder active, each observation is one ``skill`` event.

Every input is drawn from numpy generators seeded with fixed integers.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from ddr_tpu.observability import prometheus as jprom
from ddr_tpu.observability import skill as jsk
from ddr_tpu.observability.registry import MetricsRegistry as JaxRegistry
from ddr_tpu_torch.observability import prometheus as tprom
from ddr_tpu_torch.observability import skill as tsk
from ddr_tpu_torch.observability.events import Recorder, activate, deactivate
from ddr_tpu_torch.observability.registry import MetricsRegistry

RTOL = 1e-6


def assert_close(out, ref, where="") -> None:
    """Nested equality, floats within ``RTOL`` (NaN equal to NaN)."""
    if isinstance(ref, dict):
        assert isinstance(out, dict) and out.keys() == ref.keys(), (where, out, ref)
        for k in ref:
            assert_close(out[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(out) == len(ref), where
        for i, (a, b) in enumerate(zip(out, ref)):
            assert_close(a, b, f"{where}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert isinstance(out, float), (where, out, ref)
        if math.isnan(ref):
            assert math.isnan(out), where
        else:
            assert out == pytest.approx(ref, rel=RTOL, abs=1e-12), where
    else:
        assert out == ref, (where, out, ref)


@pytest.mark.parametrize("environ", [{}, {"DDR_SKILL_ENABLED": "no", "DDR_SKILL_TOPK": "3"},
                                     {"DDR_SKILL_MIN_SAMPLES": "5", "DDR_SKILL_TOPK": ""}])
def test_skill_config_from_env_equals_jax(environ):
    assert tsk.SkillConfig.from_env(environ).__dict__ == jsk.SkillConfig.from_env(environ).__dict__
    assert (tsk.SkillConfig.from_env(environ, enabled=True).__dict__
            == jsk.SkillConfig.from_env(environ, enabled=True).__dict__)


@pytest.mark.parametrize("environ", [{"DDR_SKILL_TOPK": "-1"}, {"DDR_SKILL_MIN_SAMPLES": "1"},
                                     {"DDR_SKILL_TOPK": "k"}])
def test_skill_config_refuses_what_jax_refuses(environ):
    with pytest.raises(ValueError) as ref:
        jsk.SkillConfig.from_env(environ)
    with pytest.raises(ValueError) as ours:
        tsk.SkillConfig.from_env(environ)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_samples", [2, 5])
def test_gauge_skill_from_sums_equals_jax(seed, min_samples):
    rng = np.random.default_rng(seed)
    G, T = 40, 30
    obs = rng.gamma(2.0, 3.0, (T, G))
    pred = obs * rng.uniform(0.5, 1.5, (T, G)) + rng.normal(0, 1, (T, G))
    obs[:, 0] = 4.0  # constant observations
    obs[:, 1] = 0.0  # zero observed mass
    pred[:, 2] = 1.0  # constant prediction
    valid = rng.random((T, G)) > 0.2
    valid[3:, 3] = False  # three pairs only
    valid[:, 4] = False  # no pairs
    p, o = np.where(valid, pred, 0.0), np.where(valid, obs, 0.0)
    sums = np.stack([valid.sum(0), p.sum(0), o.sum(0), (p * p).sum(0), (o * o).sum(0), (p * o).sum(0),
                     (np.where(valid, pred - obs, 0.0) ** 2).sum(0)], axis=1).astype(np.float64)
    out, ref = tsk.gauge_skill_from_sums(sums, min_samples), jsk.gauge_skill_from_sums(sums, min_samples)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=RTOL, equal_nan=True, err_msg=k)
    assert np.isnan(out["nse"][[0, 4]]).all()


def _batches(seed: int, n: int = 12):
    """Seeded ``(pred, obs, gauge_ids)`` batches: gauges arriving over time,
    NaN gaps, a constant and a zero-mass gauge, one skill-less gauge."""
    rng = np.random.default_rng(seed)
    ids = [f"g{k:02d}" for k in range(14)]
    for b in range(n):
        g = ids[: 6 + min(b, 8)]
        T = int(rng.integers(4, 10))
        obs = rng.gamma(2.0, 2.0, (T, len(g)))
        pred = obs * rng.uniform(0.7, 1.3, (T, len(g))) + rng.normal(0, 0.5, (T, len(g)))
        pred[:, 1] = rng.normal(0, 5, T)  # a gauge the model cannot see
        obs[:, 2] = 3.0
        obs[:, 3] = 0.0
        obs[rng.random(obs.shape) < 0.15] = np.nan
        pred[rng.random(pred.shape) < 0.05] = np.nan
        yield pred, obs, g


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cfg", [{}, {"top_k": 3, "min_samples": 6}, {"top_k": 0}])
def test_skill_tracker_equals_jax(seed, cfg):
    jreg, treg = JaxRegistry(const_labels={"host": 0}), MetricsRegistry(const_labels={"host": 0})
    ref = jsk.SkillTracker(jsk.SkillConfig(**cfg), registry=jreg)
    out = tsk.SkillTracker(tsk.SkillConfig(**cfg), registry=treg)
    for i, (pred, obs, ids) in enumerate(_batches(seed)):
        assert_close(out.observe(pred, obs, ids, batch=i), ref.observe(pred, obs, ids, batch=i), f"batch {i}")
        assert_close(out.status(), ref.status(), f"status {i}")
    assert_close(out.results(), ref.results(), "results")
    assert out.status()["observations"] == 12
    # the registry mirror: histograms and the capped worst-K series
    assert tprom.render_text(treg) == jprom.render_text(jreg)


def test_skill_tracker_merge_and_refusals_equal_jax():
    trackers = {}
    for side, mod, reg in (("jax", jsk, JaxRegistry), ("port", tsk, MetricsRegistry)):
        a = mod.SkillTracker(mod.SkillConfig(), registry=reg())
        b = mod.SkillTracker(mod.SkillConfig(), registry=reg())
        for i, (pred, obs, ids) in enumerate(_batches(4, 8)):
            (a if i % 2 else b).observe(pred, obs, ids)
        a.merge(b)
        with pytest.raises(ValueError):
            a.merge(a)
        with pytest.raises(ValueError, match="shape mismatch"):
            a.observe(np.zeros((3, 2)), np.zeros((3, 2)), ["x"])
        off = mod.SkillTracker(mod.SkillConfig(enabled=False), registry=reg())
        assert off.observe(np.ones((2, 1)), np.ones((2, 1)), ["x"]) is None
        trackers[side] = (a, off)
    assert_close(trackers["port"][0].results(), trackers["jax"][0].results(), "merged")
    assert trackers["port"][0].status()["observations"] == trackers["jax"][0].status()["observations"] == 8
    assert trackers["port"][1].status() == trackers["jax"][1].status()


def test_skill_events_reach_the_run_log(tmp_path):
    path = tmp_path / "run_log.skill.jsonl"
    rec = Recorder(path)
    activate(rec)
    try:
        tracker = tsk.SkillTracker(tsk.SkillConfig(), registry=MetricsRegistry())
        for pred, obs, ids in _batches(5, 3):
            summary = tracker.observe(pred, obs, ids, network="basin")
    finally:
        deactivate(rec)
        rec.close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    skill = [e for e in events if e["event"] == "skill"]
    assert len(skill) == 3 and skill[-1]["network"] == "basin"
    assert skill[-1]["nse"] == json.loads(json.dumps(summary["nse"]))
