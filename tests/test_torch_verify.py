"""The verification plane and ``ddr verify`` of the port against the JAX package's.

- the offline scorers ``crps_ensemble`` (fair and plain, E = 1, ties),
  ``brier_score`` and ``rank_of_obs``, the lead bins and
  ``parse_thresholds``: within 1e-9 (equal where they return integers or
  labels); ``VerifyConfig.from_env`` equals JAX's and refuses what it
  refuses;
- ``ForecastLedger``: the same seeded sequence of ``record_forecast`` and
  ``observe`` calls (both observation forms, unmatched and duplicate
  observations, ring eviction, non-finite members, mixed ensemble sizes)
  gives equal join answers, an equal ``status()`` and scorer sums within
  1e-9, and the ``ddr_verify_*`` series render equal to JAX's; the
  streaming CRPS equals the offline reference within 1e-9;
- the service's single forecasts carry JAX's ``valid_times`` and land in the
  ledger; ``ddr verify --synthetic device=cpu`` and ``--url`` run end to end.

Every input is drawn from numpy generators seeded with fixed integers.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from ddr_tpu.observability import prometheus as jprom
from ddr_tpu.observability import verification as jv
from ddr_tpu.observability.registry import MetricsRegistry as JaxRegistry
from ddr_tpu_torch.observability import prometheus as tprom
from ddr_tpu_torch.observability import verification as tv
from ddr_tpu_torch.observability.registry import MetricsRegistry
from ddr_tpu_torch.scripts import verify as tverify

# ---- the offline scorers ----


@pytest.mark.parametrize("E", [1, 2, 5, 16])
@pytest.mark.parametrize("fair", [True, False])
def test_crps_ensemble_equals_jax(E, fair):
    rng = np.random.default_rng(E)
    members = rng.lognormal(size=(E, 40, 3))
    members[:, 0, 0] = 2.0  # every member tied
    obs = rng.lognormal(size=(40, 3))
    np.testing.assert_allclose(tv.crps_ensemble(members, obs, fair=fair),
                               jv.crps_ensemble(members, obs, fair=fair), rtol=0, atol=1e-9)


def test_brier_score_and_ranks_equal_jax():
    rng = np.random.default_rng(2)
    p, o = rng.uniform(size=500), (rng.uniform(size=500) > 0.7).astype(float)
    assert abs(tv.brier_score(p, o) - jv.brier_score(p, o)) <= 1e-9
    members = rng.integers(0, 4, size=(6, 200)).astype(float)  # ties count low
    obs = rng.integers(0, 4, size=200).astype(float)
    np.testing.assert_array_equal(tv.rank_of_obs(members, obs), jv.rank_of_obs(members, obs))


@pytest.mark.parametrize("edges", [(6.0, 24.0, 72.0), (1.0,), (0.5, 2.5)])
def test_lead_bins_equal_jax(edges):
    assert tv.lead_bin_labels(edges) == jv.lead_bin_labels(edges)
    lead = np.array([0, 0.5, 1, 2.5, 6, 23.9, 24, 100])
    np.testing.assert_array_equal(tv.lead_bin_index(lead, edges), jv.lead_bin_index(lead, edges))


@pytest.mark.parametrize("spec", ["p90", "p90,5.0", " p99.5 , 0 ,12", ["p50", "1e3"], ""])
def test_parse_thresholds_equals_jax(spec):
    assert tv.parse_thresholds(spec) == jv.parse_thresholds(spec)


@pytest.mark.parametrize("spec", ["p100", "p0", "x", "-1", "inf", "p90,p90"])
def test_parse_thresholds_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as ref:
        jv.parse_thresholds(spec)
    with pytest.raises(ValueError) as ours:
        tv.parse_thresholds(spec)
    assert str(ours.value) == str(ref.value)


ENVIRONS = [
    {},
    {"DDR_VERIFY_ENABLED": "no", "DDR_VERIFY_THRESHOLDS": "p75, 3.5"},
    {"DDR_VERIFY_LEAD_BINS": "2,12", "DDR_VERIFY_LEDGER_CAP": "16", "DDR_VERIFY_TOPK": "0",
     "DDR_VERIFY_MIN_SAMPLES": "3", "DDR_VERIFY_CLIM_SAMPLES": "10", "DDR_VERIFY_MIN_CLIM": "4"},
]


@pytest.mark.parametrize("environ", ENVIRONS, ids=range(len(ENVIRONS)))
def test_verify_config_from_env_equals_jax(environ):
    assert tv.VerifyConfig.from_env(environ).__dict__ == jv.VerifyConfig.from_env(environ).__dict__
    kw = {"top_k": 3}
    assert tv.VerifyConfig.from_env(environ, **kw).__dict__ == jv.VerifyConfig.from_env(environ, **kw).__dict__


@pytest.mark.parametrize("environ", [{"DDR_VERIFY_LEAD_BINS": "6,3"}, {"DDR_VERIFY_LEAD_BINS": "a"},
                                     {"DDR_VERIFY_LEDGER_CAP": "0"}, {"DDR_VERIFY_THRESHOLDS": "q9"},
                                     {"DDR_VERIFY_MIN_CLIM": "1"}, {"DDR_VERIFY_CLIM_SAMPLES": "3"},
                                     {"DDR_VERIFY_TOPK": "two"}])
def test_verify_config_refuses_what_jax_refuses(environ):
    with pytest.raises(ValueError) as ref:
        jv.VerifyConfig.from_env(environ)
    with pytest.raises(ValueError) as ours:
        tv.VerifyConfig.from_env(environ)
    assert str(ours.value) == str(ref.value)


# ---- the ledger ----


def _sequence(seed: int):
    """A seeded sequence of ledger calls: forecasts of 1, 4 or 8 members over
    3 networks' gauges, then observations in both forms, some unmatched, some
    repeated, a few non-finite."""
    rng = np.random.default_rng(seed)
    calls = []
    for k in range(30):
        E = [1, 4, 8][int(rng.integers(3))]
        T, G = int(rng.integers(2, 10)), int(rng.integers(1, 5))
        issue = int(rng.integers(0, 40))
        members = rng.lognormal(size=(E, T, G)).astype(np.float32)
        if rng.random() < 0.1:
            members[0, 0, 0] = np.nan
        gids = [str(g) for g in rng.choice(6, size=G, replace=False)]
        calls.append(("record", f"n{int(rng.integers(2))}", f"m{k % 2}", f"r{k}", issue,
                      [issue + 1 + i for i in range(T)], gids, members if E > 1 or k % 3 else members[0]))
        if k % 4 == 3:
            net = f"n{int(rng.integers(2))}"
            if rng.random() < 0.5:
                obs = {str(g): [(int(rng.integers(0, 50)), float(rng.lognormal())) for _ in range(8)]
                       for g in range(4)}
            else:
                obs = []
                for g in range(3):
                    times = list(range(int(rng.integers(0, 30)), 50))
                    obs.append({"gauge": int(g), "times": times,
                                "values": [float(v) for v in rng.lognormal(size=len(times))]})
            if rng.random() < 0.2:  # a missing reading
                if isinstance(obs, dict):
                    obs["0"][0] = (obs["0"][0][0], float("nan"))
                else:
                    obs[0]["values"][0] = float("nan")
            calls.append(("observe", net, obs))
    return calls


def _run(module, registry, seed, cfg_kw):
    ledger = module.ForecastLedger(module.VerifyConfig(**cfg_kw), registry=registry)
    answers = []
    for call in _sequence(seed):
        if call[0] == "record":
            ledger.record_forecast(*call[1:])
        else:
            answers.append(ledger.observe(call[1], call[2], source="test"))
    return ledger, answers


LEDGER_CONFIGS = [
    {"thresholds": ("p50", "1.0"), "min_clim": 2, "clim_samples": 5, "ledger_cap": 6},
    {"thresholds": ("p90",), "lead_bins_h": (2.0, 5.0), "top_k": 2, "min_samples": 1},
]


@pytest.mark.parametrize("case", range(len(LEDGER_CONFIGS)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_equals_jax_after_the_same_calls(case, seed):
    jreg, treg = JaxRegistry(const_labels={"host": 0}), MetricsRegistry(const_labels={"host": 0})
    ref, ref_answers = _run(jv, jreg, seed, LEDGER_CONFIGS[case])
    out, answers = _run(tv, treg, seed, LEDGER_CONFIGS[case])
    assert answers == ref_answers
    assert out.status() == ref.status()
    assert out.scorer.summary() == ref.scorer.summary()
    np.testing.assert_allclose(out.scorer._bin_sums, ref.scorer._bin_sums, rtol=0, atol=1e-9)
    np.testing.assert_allclose(out.scorer._gauge_sums, ref.scorer._gauge_sums, rtol=0, atol=1e-9)
    assert out.status()["matched"] > 0 and out.status()["evicted"] >= 0
    assert tprom.render_text(treg) == jprom.render_text(jreg)


def test_streaming_crps_equals_the_offline_reference():
    """One 8-member forecast joined to its observations: the scorer's raw
    CRPS sum over its samples equals the mean of ``crps_ensemble`` within
    1e-9."""
    rng = np.random.default_rng(5)
    members = rng.lognormal(size=(8, 24, 4)).astype(np.float32)
    truth = rng.lognormal(size=(24, 4))
    ledger = tv.ForecastLedger(tv.VerifyConfig(), registry=MetricsRegistry())
    ledger.record_forecast("n", "m", "r", 0, list(range(1, 25)), [str(g) for g in range(4)], members)
    ledger.observe("n", {str(g): [(t + 1, float(truth[t, g])) for t in range(24)] for g in range(4)})
    sums = ledger.scorer._bin_sums.sum(axis=0)
    ref = float(np.mean(tv.crps_ensemble(members.reshape(8, -1).astype(np.float64), truth.reshape(-1))))
    assert sums[0] == 96 and abs(sums[1] / sums[0] - ref) <= 1e-9
    assert abs(sums[1] / sums[0] - float(np.mean(jv.crps_ensemble(members.reshape(8, -1), truth.reshape(-1))))) <= 1e-9


# ---- the service and the command ----


def test_service_forecasts_feed_the_ledger(tmp_path):
    from ddr_tpu_torch.scripts.loadtest import build_synthetic_service

    svc, _ = build_synthetic_service(32, 6, str(tmp_path), overrides=["device=cpu"])
    try:
        assert svc.stats()["verification"] is None
        ans = svc.forecast(network="default", t0=4, timeout=60)
        assert "valid_times" not in ans  # nothing attached yet
        ledger = tv.ForecastLedger(tv.VerifyConfig(), registry=MetricsRegistry())
        svc.attach_verifier(ledger)
        assert svc.verifier is ledger
        ans = svc.forecast(network="default", t0=4, gauges=[1, 3], timeout=60)
        assert ans["valid_times"] == list(range(5, 11))
        payload = svc.networks()["default"].forcing[0:6]
        hour = svc.forecast(network="default", q_prime=payload, timeout=60)["valid_times"][0] - 1
        import time

        assert abs(hour - time.time() // 3600) <= 1
        ens = svc.ensemble_forecast(network="default", t0=2, members=3)
        assert ens["valid_times"] == list(range(3, 9))
        status = svc.stats()["verification"]
        assert status["forecasts"] == 3 and status["cells_pending"] == 6 * 2 + 6 * 4 + 6 * 4
        join = ledger.observe("default", {"1": [(5, 1.0), (6, 2.0)], "3": [(5, 0.5)]})
        # hours 5 and 6 of gauges 1 and 3 hold the t0=4 forecast and the ensemble
        assert join["matched"] == 6 and join["unmatched"] == 0
        # a feed that raises leaves the answer standing
        svc.attach_verifier(object())
        assert "valid_times" not in svc.forecast(network="default", t0=1, timeout=60)
    finally:
        svc.close()


def test_verify_synthetic_and_live_run_on_the_cpu(tmp_path, capsys):
    code = tverify.main(["--synthetic", "--n", "48", "--horizon", "12", "--members", "6", "--requests", "4",
                         "--out", str(tmp_path), "--label", "syn", "device=cpu"])
    assert code == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report == json.loads((tmp_path / "VERIFY_syn.json").read_text())
    assert report["ordering_ok"] and report["crps"] < report["crps_degraded"]
    assert report["matched_samples"] == 4 * 12 * 4 and report["kernel_launches_during_join"] == 0
    assert report["unmatched_obs"] == 0 and report["device"] == "cpu"

    from ddr_tpu_torch.scripts.loadtest import build_synthetic_service
    from ddr_tpu_torch.serving.http_api import serve_http

    svc, _ = build_synthetic_service(32, 6, str(tmp_path), overrides=["device=cpu"])
    server = serve_http(svc, port=0)
    try:
        assert tverify.main(["--url", server.url, "--out", str(tmp_path), "--label", "none"]) == 1
        ledger = tv.ForecastLedger(tv.VerifyConfig(), registry=MetricsRegistry())
        svc.attach_verifier(ledger)
        ens = svc.ensemble_forecast(network="default", t0=0, members=4)
        ledger.observe("default", {str(g): [(vh, 1.0) for vh in ens["valid_times"]] for g in range(4)})
        capsys.readouterr()
        assert tverify.main(["--url", server.url, "--out", str(tmp_path), "--label", "live"]) == 0
        live = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert live["mode"] == "live" and live["matched_samples"] == 24 and live["crps"] is not None
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    # replay: the synthetic run's joins are verify events of its run log
    capsys.readouterr()
    assert tverify.main([str(tmp_path), "--out", str(tmp_path), "--label", "replay"]) == 0
    replay = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert replay["mode"] == "replay" and replay["files"] == 1 and replay["crps"] is not None
    assert replay == {**tverify.replay_dir(tmp_path), "label": "replay", "device": None}
    (tmp_path / "empty").mkdir()
    assert tverify.main([str(tmp_path / "empty")]) == 1
    assert tverify.main([]) == 2
