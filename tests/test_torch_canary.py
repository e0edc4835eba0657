"""The port's canary controller against the JAX package's
(``ddr_tpu/fleet/canary.py``), on the same inputs.

A JAX service and a port service (CPU) hold the same three models, their
weights carried across by ``kan_state_from_flax``: ``default``, a
``candidate`` with the same weights, and a ``worse`` one whose weights take
the same seeded N(0, 1) draws added on both sides.

- the same seeded skill and ensemble evidence fed to both controllers gives
  the same state after every evaluation and an equal ``status()`` (per-arm
  evidence within rtol 1e-6), for promotion on skill parity, rollback on a
  skill or CRPS regression, the sample floor and the watchdog rollback;
- ``arm_for`` answers the same arm for 256 request ids in every state, and
  ``_arm_fraction`` is the same hashlib-stable coordinate;
- routed requests through ``handle`` with observations from the twin give
  the same arms and state sequence, answers within the serving bound: the
  same-weights candidate reaches ``promoted``, the perturbed one
  ``rolled-back``; each transition is one ``canary`` event in the run log;
- a failed shadow forecast keeps the stable answer and is counted.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from ddr_tpu.fleet import canary as jc
from ddr_tpu.fleet.config import FleetConfig as JaxFleetConfig
from ddr_tpu_torch.fleet import canary as tc
from ddr_tpu_torch.fleet.config import FleetConfig
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.observability.events import Recorder, activate, deactivate
from ddr_tpu_torch.serving.batcher import QueueFullError
from tests.test_torch_fleet_group import jax_service, port_service, weights  # noqa: F401 (fixture)
from tests.test_torch_skill import assert_close

@pytest.fixture(scope="module")
def services(weights, tmp_path_factory):  # noqa: F811
    """(JAX service, port service), each with default, candidate and worse."""
    fk, variables, _ = weights
    rng = np.random.default_rng(7)
    worse = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.standard_normal(np.shape(v)).astype(np.asarray(v).dtype), variables)
    jsvc = jax_service(tmp_path_factory.mktemp("canary"), weights, candidate=True)
    jsvc.register_model("worse", fk, worse)
    tsvc = port_service(weights, candidate=True)
    from ddr_tpu_torch.nn.kan import Kan

    kan = Kan([f"a{i}" for i in range(10)], ("n", "q_spatial"))
    kan.load_state_dict(kan_state_from_flax(jax.tree_util.tree_map(np.asarray, worse)))
    tsvc.register_model("worse", kan)
    jsvc.warmup()
    tsvc.warmup()
    yield jsvc, tsvc
    jsvc.close(drain=False)
    tsvc.close(drain=False)


def _pair(services, candidate="candidate", **kw):
    jsvc, tsvc = services
    kw.setdefault("fleet_cfg", None)
    cfg = dict(canary_min_obs=2, canary_weight=1.0)
    return (jc.CanaryController(jsvc, candidate=candidate, **{**kw, "fleet_cfg": JaxFleetConfig.from_env(
                environ={}, **cfg)}),
            tc.CanaryController(tsvc, candidate=candidate, **{**kw, "fleet_cfg": FleetConfig.from_env(
                environ={}, **cfg)}))


def _obs(seed, T=8, G=4):
    return np.random.default_rng(seed).gamma(2.0, 3.0, (T, G))


def test_arm_fraction_and_states_equal_jax():
    assert tc.STATES == jc.STATES == ("shadow", "canary", "promoted", "rolled-back")
    for i in range(200):
        rid = f"req-{i}"
        assert tc._arm_fraction(rid) == jc._arm_fraction(rid)
        assert 0.0 <= tc._arm_fraction(rid) < 1.0


def test_validation_equals_jax(services):
    jsvc, tsvc = services
    for mod, svc in ((jc, jsvc), (tc, tsvc)):
        with pytest.raises(ValueError, match="different"):
            mod.CanaryController(svc, stable="default", candidate="default")
        with pytest.raises(KeyError):
            mod.CanaryController(svc, candidate="missing")
        with pytest.raises(ValueError, match="weight"):
            mod.CanaryController(svc, weight=1.5)


SCRIPTS = {
    # (arm, kind, bias, spread) per step; "eval" re-runs the state machine
    "skill parity promotes": [("both", "skill", 1.0, 0.05)] * 2 + [("eval",)] + [("candidate", "skill", 1.0, 0.05)] * 2
    + [("eval",)],
    "skill regression rolls back": [("stable", "skill", 1.0, 0.05), ("candidate", "skill", 4.0, 2.0)] * 2
    + [("eval",)] + [("candidate", "skill", 1.0, 0.0)] * 4 + [("eval",)],
    "crps regression rolls back": [("stable", "ens", 1.0, 0.01), ("candidate", "ens", 2.0, 0.0),
                                   ("both", "skill", 1.0, 0.05), ("eval",)],
    "crps parity promotes": [("both", "ens", 1.0, 0.01), ("both", "skill", 1.0, 0.05), ("eval",),
                             ("candidate", "ens", 1.0, 0.01), ("candidate", "ens", 1.0, 0.01), ("eval",)],
    "weighted canary": [("both", "skill", 1.0, 0.05)] * 2 + [("eval",)],
}


@pytest.mark.parametrize("min_samples", [8, 1000])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_evidence_equals_jax(services, name, min_samples):
    weight = 0.5 if name == "weighted canary" else None
    ref, out = _pair(services, min_samples=min_samples, weight=weight)
    rng = np.random.default_rng(sorted(SCRIPTS).index(name))
    ids = [f"split-{i}" for i in range(256)]
    for step, action in enumerate(SCRIPTS[name]):
        if action[0] == "eval":
            assert out.evaluate() == ref.evaluate(), step
        else:
            arm, kind, bias, spread = action
            obs = _obs(int(rng.integers(1 << 30)))
            noise = rng.normal(0.0, 1.0, (4,) + obs.shape)
            for a in ("stable", "candidate") if arm == "both" else (arm,):
                if kind == "skill":
                    pred = obs * bias + spread * noise[0] * obs.std()
                    ref.observe(a, pred, obs)
                    out.observe(a, pred, obs)
                else:
                    members = obs[None] * bias + spread * noise
                    ref.observe_ensemble(a, members, obs)
                    out.observe_ensemble(a, members, obs)
        assert out.state == ref.state, step
        assert [out.arm_for(i) for i in ids] == [ref.arm_for(i) for i in ids], step
        assert_close(out.status(), ref.status(), f"step {step}")
    if min_samples == 8:
        want = {"skill parity promotes": "promoted", "skill regression rolls back": "rolled-back",
                "crps regression rolls back": "rolled-back", "crps parity promotes": "promoted",
                "weighted canary": "canary"}[name]
        assert out.state == want
        if name == "weighted canary":
            assert {out.arm_for(i) for i in ids} == {"stable", "candidate"}


def test_watchdog_rollback_ignores_the_floor_as_jax(services, monkeypatch):
    ref, out = _pair(services, min_samples=1000)
    for svc in services:
        monkeypatch.setattr(type(svc.watchdog), "degraded", property(lambda self: True))
    assert out.evaluate() == ref.evaluate() == "rolled-back"
    assert out.status()["transitions"][0]["reason"] == ref.status()["transitions"][0]["reason"] == "watchdog-degraded"


@pytest.mark.parametrize("candidate,final", [("candidate", "promoted"), ("worse", "rolled-back")])
def test_routed_requests_equal_jax(services, tmp_path, candidate, final):
    """Requests through ``handle`` with observations the twin's own stable
    forecasts supply, over four overlapping windows (over windows far apart
    the flow's own swing keeps even the perturbed model's NSE near 0.98):
    the same arms, states and answers (within the serving bound), and one
    ``canary`` event per transition in the run log."""
    ref, out = _pair(services, candidate=candidate, min_samples=8)
    jsvc, tsvc = services
    truth = {t0: jsvc.forecast(network="default", t0=t0, request_id=f"truth-{t0}", timeout=60)["runoff"]
             for t0 in range(0, 8, 2)}
    path = tmp_path / "run_log.canary.jsonl"
    rec = Recorder(path)
    activate(rec)
    try:
        for i, t0 in enumerate(list(truth) * 4):
            obs = np.asarray(truth[t0], dtype=np.float64)
            a = ref.handle(network="default", t0=t0, request_id=f"r-{i}", observations=obs, timeout=60)
            b = out.handle(network="default", t0=t0, request_id=f"r-{i}", observations=obs, timeout=60)
            assert (b["arm"], b["canary_state"]) == (a["arm"], a["canary_state"]), i
            scale = max(np.abs(a["runoff"]).max(), 1e-8)
            np.testing.assert_allclose(b["runoff"], a["runoff"], rtol=1e-5, atol=1e-5 * scale)
            if out.state in ("promoted", "rolled-back"):
                break
    finally:
        deactivate(rec)
        rec.close()
    assert out.state == ref.state == final
    tr_out, tr_ref = out.status()["transitions"], ref.status()["transitions"]
    assert [(t["state_from"], t["state_to"], t["reason"]) for t in tr_out] == [
        (t["state_from"], t["state_to"], t["reason"]) for t in tr_ref]
    events = [json.loads(line) for line in path.read_text().splitlines()]
    canary = [e for e in events if e["event"] == "canary"]
    assert [(e["state_from"], e["state_to"]) for e in canary] == [(t["state_from"], t["state_to"]) for t in tr_out]


def test_a_failed_shadow_keeps_the_stable_answer(services, monkeypatch):
    _, out = _pair(services)
    svc = services[1]
    real = svc.forecast

    def overloaded(**kw):
        if str(kw.get("request_id", "")).endswith("-shadow"):
            raise QueueFullError("queue at capacity; request rejected")
        return real(**kw)

    monkeypatch.setattr(svc, "forecast", overloaded)
    before = svc.metrics.get("ddr_canary_shadow_failures_total").value(model="candidate")
    ans = out.handle(network="default", t0=0, request_id="sf-1", observations=_obs(3, 8, 4), timeout=60)
    assert ans["arm"] == "stable" and ans["runoff"].shape == (8, 4)
    status = out.status()
    assert status["shadow_failures"] == 1
    assert (status["arms"]["stable"]["observations"], status["arms"]["candidate"]["observations"]) == (1, 0)
    assert svc.metrics.get("ddr_canary_shadow_failures_total").value(model="candidate") == before + 1
