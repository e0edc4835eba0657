"""The port's parameter-drift tracker against the JAX package's
(``ddr_tpu/observability/drift.py``), on the same inputs.

- ``drift_index`` on seeded quantile profiles (a zero-span reference, a
  non-finite displacement) equals JAX's to rtol 1e-12;
- ``DriftTracker`` fed the same seeded epochs of parameter fields (a
  reference epoch, a shifted one, one with entries out of bounds and a NaN,
  an explicit reference) returns the same violation reasons, writes the same
  ``drift`` events (less the envelope), flags its watchdog alike, and its
  ``status()`` and the registries' text equal JAX's.

Every field is drawn from numpy generators seeded with fixed integers.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from ddr_tpu.observability import drift as jdrift
from ddr_tpu.observability import events as jevents
from ddr_tpu.observability import prometheus as jprom
from ddr_tpu.observability.health import HealthConfig as JaxHealthConfig
from ddr_tpu.observability.health import HealthWatchdog as JaxWatchdog
from ddr_tpu.observability.registry import MetricsRegistry as JaxRegistry
from ddr_tpu_torch.observability import drift as tdrift
from ddr_tpu_torch.observability import events as tevents
from ddr_tpu_torch.observability import prometheus as tprom
from ddr_tpu_torch.observability.health import HealthConfig, HealthWatchdog
from ddr_tpu_torch.observability.registry import MetricsRegistry

RANGES = {"n": [0.015, 0.25], "q_spatial": [0.0, 1.0], "p_spatial": [1.0, 200.0]}
ENVELOPE = ("t", "wall", "pid", "seq", "host")


def _fields(seed: int, n: int = 300, shift: float = 0.0, oob: int = 0, nan: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    out = {
        "n": rng.uniform(0.02, 0.2, n) + shift * 0.05,
        "q_spatial": rng.beta(2.0, 5.0, n),
        "p_spatial": np.full(n, 21.0),
    }
    if oob:
        out["q_spatial"][:oob] = 1.5
    if nan:
        out["n"][3] = np.nan
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_index_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ref = np.sort(rng.normal(size=len(tdrift.DRIFT_QUANTILES)))
    now = ref + rng.normal(scale=0.3, size=ref.shape)
    cases = [(now, ref), (ref, ref), (now, np.full_like(ref, 2.0)), (np.full_like(ref, np.inf), ref)]
    for a, b in cases:
        ours, theirs = tdrift.drift_index(a, b), jdrift.drift_index(a, b)
        assert ours == pytest.approx(theirs, rel=1e-12) or (np.isinf(ours) and np.isinf(theirs))
    assert tdrift.DRIFT_QUANTILES == jdrift.DRIFT_QUANTILES


def _events(path) -> list[dict]:
    return [{k: v for k, v in json.loads(line).items() if k not in ENVELOPE}
            for line in path.read_text().splitlines() if line.strip()]


@pytest.mark.parametrize("explicit_reference", [False, True])
def test_drift_tracker_equals_jax(tmp_path, explicit_reference):
    env = {"DDR_HEALTH_MAX_PARAM_DRIFT": "0.2", "DDR_HEALTH_MAX_PARAM_OOB": "3"}
    t_cfg, j_cfg = HealthConfig.from_env(env), JaxHealthConfig.from_env(env)
    t_reg, j_reg = MetricsRegistry(), JaxRegistry()
    t_dog, j_dog = HealthWatchdog(t_cfg, registry=t_reg), JaxWatchdog(j_cfg, registry=j_reg)
    ours = tdrift.DriftTracker(RANGES, config=t_cfg, registry=t_reg, watchdog=t_dog)
    ref = jdrift.DriftTracker(RANGES, config=j_cfg, registry=j_reg, watchdog=j_dog)
    t_rec = tevents.Recorder(tmp_path / "port.jsonl")
    j_rec = jevents.Recorder(tmp_path / "jax.jsonl")
    tevents.activate(t_rec)
    jevents.activate(j_rec)
    try:
        if explicit_reference:
            ours.set_reference(_fields(7))
            ref.set_reference(_fields(7))
        epochs = [_fields(11), _fields(12, shift=0.3), _fields(13, oob=5, nan=True), _fields(14, shift=2.0)]
        for epoch, fields in enumerate(epochs, start=1):
            assert ours.observe(fields, epoch=epoch) == ref.observe(fields, epoch=epoch)
            assert ours.status() == ref.status()
            assert t_dog.status() == j_dog.status()
    finally:
        tevents.deactivate(t_rec)
        jevents.deactivate(j_rec)
        t_rec.close()
        j_rec.close()
    t_ev, j_ev = _events(tmp_path / "port.jsonl"), _events(tmp_path / "jax.jsonl")
    drifts = [[e for e in evs if e["event"] == "drift"] for evs in (t_ev, j_ev)]
    assert drifts[0] == drifts[1] and len(drifts[0]) == 4
    assert any(e["reasons"] for e in drifts[0]), "no epoch violated: the thresholds went untested"
    assert tprom.render_text(t_reg) == jprom.render_text(j_reg)
