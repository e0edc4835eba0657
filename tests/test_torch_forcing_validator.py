"""The port's ``ForcingValidator`` against the JAX package's on seeded
forcing batches with NaN, inf, out-of-range and clean tiles: ``scan``'s
descriptors, ``note``'s verdicts, the bounded ``data_anomaly`` events
(past ``MAX_EVENTS``) and ``summary``, under each policy; and the errors
for a malformed ``DDR_DATA_VALIDATE``. Every comparison is exact."""

from __future__ import annotations

import json

import numpy as np
import pytest

from ddr_tpu.observability import events as jax_events
from ddr_tpu.observability.recovery import ForcingValidator as JaxValidator
from ddr_tpu_torch.observability import events as port_events
from ddr_tpu_torch.observability.recovery import ForcingValidator as PortValidator


def _batches(seed: int, n: int) -> list[np.ndarray]:
    """``n`` (T, N) float32 batches: clean, NaN, +/-inf, past MAX_RUNOFF and
    below MIN_RUNOFF tiles in turn."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.gamma(2.0, 3.0, size=(48, 32)).astype(np.float32)
        kind = i % 5
        if kind == 1:
            q[rng.integers(0, 48, 7), rng.integers(0, 32, 7)] = np.nan
        elif kind == 2:
            q[3, 5], q[10, 1] = np.inf, -np.inf
        elif kind == 3:
            q[rng.integers(0, 48, 4), rng.integers(0, 32, 4)] = 2.0e7
        elif kind == 4:
            q[0, :3] = -5.0
            q[1, 1] = np.nan
        out.append(q)
    return out


def _drive(cls, events_mod, tmp_path, label, policy, batches):
    (tmp_path / label).mkdir()
    rec = events_mod.Recorder(tmp_path / label / "log.jsonl")
    events_mod.activate(rec)
    try:
        v = cls(policy)
        scans, verdicts = [], []
        for b, q in enumerate(batches):
            anomaly = v.scan(q, epoch=1, batch=b, note=None, bad=object())
            scans.append(anomaly)
            if anomaly is not None:
                verdicts.append(v.note(anomaly))
        summary = v.summary()
    finally:
        events_mod.deactivate()
        rec.close()
    lines = [json.loads(line) for line in (tmp_path / label / "log.jsonl").read_text().splitlines()]
    events = [{k: v for k, v in e.items() if k not in ("t", "wall", "seq", "pid", "host")}
              for e in lines if e["event"] == "data_anomaly"]
    return (v.enabled, v.policy), scans, verdicts, summary, events


@pytest.mark.parametrize("policy", ["off", "warn", "quarantine", " Quarantine ", ""])
def test_scan_note_summary_equal_jax(tmp_path, policy):
    batches = _batches(7, 5 * 9)  # 36 anomalous batches: past MAX_EVENTS (32)
    want = _drive(JaxValidator, jax_events, tmp_path, "jax", policy, batches)
    got = _drive(PortValidator, port_events, tmp_path, "port", policy, batches)
    assert got == want
    assert PortValidator.MAX_EVENTS == JaxValidator.MAX_EVENTS == 32
    (enabled, _), scans, verdicts, summary, events = got
    if enabled:
        assert sum(s is not None for s in scans) == 36
        assert len(events) == 32 and summary["events_suppressed"] == 4
        assert scans[1]["nonfinite"] == 7 and scans[3]["out_of_range"] == 4
        assert scans[4]["nonfinite"] == 1 and scans[4]["out_of_range"] == 3
        assert scans[0] is None
    else:
        assert scans == [None] * len(batches) and not events


@pytest.mark.parametrize("env", ["warn", "quarantine", "off", None])
def test_policy_from_the_environment(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("DDR_DATA_VALIDATE", raising=False)
    else:
        monkeypatch.setenv("DDR_DATA_VALIDATE", env)
    assert (PortValidator().policy, PortValidator().enabled) == (JaxValidator().policy, JaxValidator().enabled)


@pytest.mark.parametrize("bad", ["sometimes", "on", "1"])
def test_malformed_policy_raises_as_jax(monkeypatch, bad):
    monkeypatch.setenv("DDR_DATA_VALIDATE", bad)
    with pytest.raises(ValueError) as want:
        JaxValidator()
    with pytest.raises(ValueError) as got:
        PortValidator()
    assert str(got.value) == str(want.value)


def test_isfinite_matches_numpy():
    from ddr_tpu_torch.observability.recovery import _isfinite

    q = _batches(3, 5)[2].astype(np.float64)
    q[0, 0] = np.nan
    np.testing.assert_array_equal(_isfinite(q), np.isfinite(q))
