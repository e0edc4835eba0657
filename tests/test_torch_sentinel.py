"""The port's performance sentinel against the JAX package's
(``ddr_tpu/observability/sentinel.py``), on the same inputs.

- ``SentinelConfig.from_env`` equals JAX's over a table of environments and
  refuses what JAX refuses with JAX's message;
- ``EwmaCusumDetector`` fed the same seeded series (level shifts, drops,
  ramps, spikes, non-finite samples) in each direction gives the same
  transitions and snapshots after every sample;
- ``Sentinel`` fed the same seeded signals, steps and heartbeats gives the
  same transitions, ``status()``, ``active()`` and pipeline summary, the
  event budget included, and tees its ``anomaly`` events into an equal
  registry text (directly and through an ``emit`` callback);
- ``classify_step``, ``BottleneckAttributor``, ``attribute_steps``,
  ``render_attribution`` and ``recommendations`` are equal on seeded step
  events.

Every input is drawn from numpy generators seeded with fixed integers.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from ddr_tpu.observability import prometheus as jprom
from ddr_tpu.observability import sentinel as js
from ddr_tpu.observability.registry import MetricsRegistry as JaxRegistry
from ddr_tpu_torch.observability import prometheus as tprom
from ddr_tpu_torch.observability import sentinel as ts
from ddr_tpu_torch.observability.registry import MetricsRegistry

SENTINEL_ENVIRONS = [
    {},
    {"DDR_SENTINEL_ENABLED": "off", "DDR_SENTINEL_WARMUP": "5"},
    {"DDR_SENTINEL_EWMA_ALPHA": "1.0", "DDR_SENTINEL_CUSUM_K": "0.25", "DDR_SENTINEL_CUSUM_H": "4",
     "DDR_SENTINEL_HYSTERESIS": "2", "DDR_SENTINEL_MIN_SIGMA_FRAC": "0"},
    {"DDR_SENTINEL_MAX_EVENTS": "0", "DDR_SENTINEL_IDLE_FRAC": "0.5", "DDR_SENTINEL_SWEEP_S": "",
     "DDR_SENTINEL_FLAG_WATCHDOG": "yes", "DDR_SENTINEL_FLAG_AFTER": "7", "DDR_SENTINEL_OTHER": "x"},
]


@pytest.mark.parametrize("environ", SENTINEL_ENVIRONS, ids=range(len(SENTINEL_ENVIRONS)))
def test_sentinel_config_from_env_equals_jax(environ):
    assert ts.SentinelConfig.from_env(environ).__dict__ == js.SentinelConfig.from_env(environ).__dict__
    kw = {"warmup": 3, "cusum_h": 2.0}
    assert ts.SentinelConfig.from_env(environ, **kw).__dict__ == js.SentinelConfig.from_env(environ, **kw).__dict__


@pytest.mark.parametrize("environ", [
    {"DDR_SENTINEL_WARMUP": "1"}, {"DDR_SENTINEL_WARMUP": "many"}, {"DDR_SENTINEL_EWMA_ALPHA": "0"},
    {"DDR_SENTINEL_CUSUM_K": "-1"}, {"DDR_SENTINEL_CUSUM_H": "0"}, {"DDR_SENTINEL_HYSTERESIS": "0"},
    {"DDR_SENTINEL_MIN_SIGMA_FRAC": "-0.1"}, {"DDR_SENTINEL_MAX_EVENTS": "-1"},
    {"DDR_SENTINEL_IDLE_FRAC": "1"}, {"DDR_SENTINEL_SWEEP_S": "-1"}, {"DDR_SENTINEL_FLAG_AFTER": "0"},
])
def test_sentinel_config_refuses_what_jax_refuses(environ):
    with pytest.raises(ValueError) as ref:
        js.SentinelConfig.from_env(environ)
    with pytest.raises(ValueError) as ours:
        ts.SentinelConfig.from_env(environ)
    assert str(ours.value) == str(ref.value)


def _series(seed: int, n: int = 160) -> list:
    """A seeded signal: a noisy baseline, then level shifts up and down, a
    ramp, single spikes, and a few non-finite or non-numeric samples."""
    rng = np.random.default_rng(seed)
    base = float(rng.uniform(0.5, 5.0))
    v = base + rng.normal(0.0, 0.05 * base, n)
    v[40:70] += base * rng.uniform(1.0, 4.0)  # sustained rise
    v[90:110] -= base * rng.uniform(0.3, 0.8)  # sustained drop
    v[120:140] += np.linspace(0.0, 3.0 * base, 20)  # ramp
    v[rng.integers(0, n, 4)] *= 20.0  # spikes
    out: list = [float(x) for x in v]
    for i, bad in zip(rng.integers(20, n, 3), (math.nan, math.inf, "oops")):
        out[int(i)] = bad
    return out


DETECTOR_CONFIGS = [
    {},
    {"warmup": 10, "ewma_alpha": 1.0, "cusum_k": 0.5, "cusum_h": 5.0, "hysteresis": 3, "min_sigma_frac": 0.1},
    {"warmup": 5, "ewma_alpha": 0.2, "cusum_h": 3.0, "hysteresis": 1, "min_sigma_frac": 0.0},
]


@pytest.mark.parametrize("direction", ["high", "low", "both"])
@pytest.mark.parametrize("case", range(len(DETECTOR_CONFIGS)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_transitions_equal_jax(direction, case, seed):
    kw = DETECTOR_CONFIGS[case]
    ref = js.EwmaCusumDetector("sig", js.SentinelConfig(**kw), direction)
    out = ts.EwmaCusumDetector("sig", ts.SentinelConfig(**kw), direction)
    fired = 0
    for i, v in enumerate(_series(seed)):
        want = ref.observe(v, step=i)
        assert out.observe(v, step=i) == want, i
        assert out.snapshot() == ref.snapshot(), i
        fired += want is not None
    assert (out.firing, out.episodes) == (ref.firing, ref.episodes)
    if case:  # the tight configurations see the shifts
        assert fired > 0


def test_detector_refuses_an_unknown_direction_as_jax():
    with pytest.raises(ValueError) as ref:
        js.EwmaCusumDetector("x", direction="up")
    with pytest.raises(ValueError) as ours:
        ts.EwmaCusumDetector("x", direction="up")
    assert str(ours.value) == str(ref.value)


def _steps(seed: int, n: int = 60) -> list[dict]:
    """Seeded ``step`` events: phase seconds, some with ``loop_s``, a few
    without phases or with junk values."""
    rng = np.random.default_rng(seed)
    events = []
    for i in range(n):
        phases = {name: float(rng.exponential(scale)) for name, scale in
                  (("data_load", 0.02), ("host_prep", 0.03), ("device_step", 0.05))}
        if i % 7 == 0:
            phases["checkpoint"] = float(rng.exponential(0.2))
        if i % 11 == 0:
            phases["eval"] = float(rng.exponential(0.1))
        if 30 <= i < 40:
            phases["data_load"] *= 20.0  # a data-bound stretch
        e = {"step": i, "phases": phases}
        if i % 3:
            e["loop_s"] = float(phases["device_step"] + rng.exponential(0.04))
        if i % 13 == 5:
            e["phases"] = {"device_step": "n/a", "host_prep": None}
        if i % 17 == 4:
            e.pop("phases")
        events.append(e)
    return events


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("idle_frac", [0.0, 0.25, 0.6])
def test_attribution_equals_jax(seed, idle_frac):
    events = _steps(seed)
    for e in events:
        for loop in (e.get("loop_s"), None, 0.0):
            assert (ts.classify_step(e.get("phases"), loop, idle_frac)
                    == js.classify_step(e.get("phases"), loop, idle_frac))
    out, ref = ts.attribute_steps(events, idle_frac), js.attribute_steps(events, idle_frac)
    assert out == ref
    assert ts.render_attribution(out) == js.render_attribution(ref)
    attr_t, attr_j = ts.BottleneckAttributor(idle_frac), js.BottleneckAttributor(idle_frac)
    for e in events[:20]:
        assert attr_t.add(e.get("phases"), e.get("loop_s")) == attr_j.add(e.get("phases"), e.get("loop_s"))
    assert attr_t.summary() == attr_j.summary()
    assert ts.BOTTLENECK_CLASSES == js.BOTTLENECK_CLASSES and ts.SENTINEL_SIGNALS == js.SENTINEL_SIGNALS
    for verdict in (*js.BOTTLENECK_CLASSES, "unknown", None, "nope"):
        assert ts.recommendations(verdict) == js.recommendations(verdict)
    assert ts.render_attribution({}) == js.render_attribution({})


@pytest.mark.parametrize("max_events", [64, 2])
@pytest.mark.parametrize("seed", [0, 3])
def test_sentinel_equals_jax(seed, max_events):
    """Named signals (per-replica queue depths, as the fleet router feeds
    them), the train loop's steps and heartbeats: the same transitions,
    status and summary, and the same registry text from the anomaly tee."""
    kw = {"warmup": 8, "ewma_alpha": 0.6, "cusum_h": 4.0, "hysteresis": 2, "max_events": max_events}
    jreg, treg = JaxRegistry(const_labels={"host": 0}), MetricsRegistry(const_labels={"host": 0})
    ref = js.Sentinel(js.SentinelConfig(**kw), scope="fleet", registry=jreg)
    out = ts.Sentinel(ts.SentinelConfig(**kw), scope="fleet", registry=treg)
    series = {f"r{k}.queue_depth": _series(seed * 10 + k) for k in range(3)}
    steps = _steps(seed)
    rng = np.random.default_rng(seed)
    now = 100.0
    for i in range(len(steps)):
        for name, values in series.items():
            assert out.observe(name, values[i], step=i, direction="high") == ref.observe(
                name, values[i], step=i, direction="high"), (name, i)
        e = steps[i]
        kw_step = dict(phases=e.get("phases"), loop_s=e.get("loop_s"),
                       seconds=float(rng.exponential(0.1)), rate=float(rng.uniform(10, 100)),
                       compiles=float(i // 10))
        assert out.observe_step(i, **kw_step) == ref.observe_step(i, **kw_step), i
        now += float(rng.exponential(1.0)) * (8.0 if 40 <= i < 50 else 1.0)
        assert out.observe_heartbeat(now=now, step=i) == ref.observe_heartbeat(now=now, step=i)
        assert out.active() == ref.active()
    assert out.status() == ref.status()
    assert out.status()["episodes"] > 0
    assert out.pipeline_summary() == ref.pipeline_summary()
    assert tprom.render_text(treg) == jprom.render_text(jreg)


def test_sentinel_reports_through_its_emit_callback_as_jax():
    """With ``emit`` the transitions go to the callback (the service's
    ``_emit``) and nothing to the registry; disabled, nothing fires."""
    seen: dict[str, list] = {"jax": [], "port": []}
    cfg = {"warmup": 4, "ewma_alpha": 1.0, "cusum_h": 2.0, "hysteresis": 1}
    ref = js.Sentinel(js.SentinelConfig(**cfg), scope="serve", registry=JaxRegistry(),
                      emit=lambda ev, **p: seen["jax"].append((ev, p)))
    out = ts.Sentinel(ts.SentinelConfig(**cfg), scope="serve", registry=MetricsRegistry(),
                      emit=lambda ev, **p: seen["port"].append((ev, p)))
    for i, v in enumerate([1.0, 1.1, 0.9, 1.0] + [9.0] * 4 + [1.0] * 4):
        out.observe("serve_p99_s", v, step=i)
        ref.observe("serve_p99_s", v, step=i)
    assert seen["port"] == seen["jax"] and [p["state"] for _, p in seen["port"]] == ["firing", "resolved"]
    off_t, off_j = ts.Sentinel(ts.SentinelConfig(enabled=False)), js.Sentinel(js.SentinelConfig(enabled=False))
    assert off_t.observe("x", 1.0) is None and off_j.observe("x", 1.0) is None
    assert off_t.observe_step(0, phases={"device_step": 1.0}) == [] == off_j.observe_step(0, phases={})
    assert off_t.status() == off_j.status()
