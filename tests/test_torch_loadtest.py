"""``ddr loadtest``, SLO tracking and the clients of the port against the JAX package's.

- ``SloTracker``: the same seeded sequence of good/bad observations at given
  instants gives equal ``status()``, burn rates and alert transitions;
  ``SloConfig.from_env`` equals JAX's and refuses what it refuses; window
  labels are equal; ``slo`` events tee into the registry as JAX's do;
- the service counts every terminal decision into its tracker as JAX's
  service does (served, late, shed);
- ``build_report`` and ``render_summary`` from the same outcomes and stats,
  and ``parse_priority_mix``, equal JAX's; ``priority_for`` (which the JAX
  function cannot run on Python 3.12, see its docstring) is fixed by
  ``(seed, i)`` and draws each class within 0.02 of its weight;
- the service's in-process forecasts and ensembles, and ``ddr loadtest
  --synthetic device=cpu``, run end to end: open loop, closed loop,
  ensembles, and over HTTP.

Every input is drawn from numpy generators seeded with fixed integers.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from ddr_tpu.observability import prometheus as jprom
from ddr_tpu.observability import slo as jslo
from ddr_tpu.observability.registry import MetricsRegistry as JaxRegistry
from ddr_tpu.scripts import loadtest as jlt
from ddr_tpu_torch.observability import prometheus as tprom
from ddr_tpu_torch.observability import slo as tslo
from ddr_tpu_torch.observability.registry import MetricsRegistry
from ddr_tpu_torch.scripts import loadtest as tlt

# ---- SLO tracking ----

SLO_CONFIGS = [
    {},
    {"target": 0.9, "windows": (2.0, 10.0, 30.0), "alert_burn_rate": 2.0, "alert_min_samples": 3},
    {"target": 0.999, "latency_s": 0.25, "windows": (5.0, 1.0), "alert_min_samples": 1},
]


@pytest.mark.parametrize("case", range(len(SLO_CONFIGS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_slo_tracker_status_equals_jax(case, seed):
    """Observations at seeded instants (bursts of bad ones included), read
    back at seeded instants: every read equals JAX's."""
    kw = SLO_CONFIGS[case]
    ref, out = jslo.SloTracker(jslo.SloConfig(**kw)), tslo.SloTracker(tslo.SloConfig(**kw))
    rng = np.random.default_rng(seed)
    now = 1000.0
    for step in range(400):
        now += float(rng.exponential(0.2))
        bad_burst = (step // 50) % 3 == 1
        good = bool(rng.random() > (0.6 if bad_burst else 0.02))
        assert out.observe(good, now=now) == ref.observe(good, now=now)
        if step % 7 == 0:
            at = now + float(rng.uniform(0, 3))
            assert out.check_alert(now=at) == ref.check_alert(now=at), step
            assert out.status(now=at) == ref.status(now=at), step
            assert out.burn_rates(now=at) == ref.burn_rates(now=at)
            assert out.attainment(now=at) == ref.attainment(now=at)
    late = now + 4000.0  # every window empty: alerts resolve, attainment None
    assert out.check_alert(now=late) == ref.check_alert(now=late)
    assert out.status(now=late) == ref.status(now=late)
    assert out.alerting == ref.alerting


SLO_ENVIRONS = [
    {},
    {"DDR_SLO_ENABLED": "off", "DDR_SLO_TARGET": "0.95"},
    {"DDR_SLO_LATENCY_MS": "250", "DDR_SLO_WINDOWS": "300, 60,3600", "DDR_SLO_ALERT_BURN": "6"},
    {"DDR_SLO_ALERT_MIN_SAMPLES": "4", "DDR_SLO_TARGET": "", "DDR_SLO_OTHER": "x"},
]


@pytest.mark.parametrize("environ", SLO_ENVIRONS, ids=range(len(SLO_ENVIRONS)))
def test_slo_config_from_env_equals_jax(environ):
    assert tslo.SloConfig.from_env(environ) == tslo.SloConfig(**jslo.SloConfig.from_env(environ).__dict__)
    kw = {"target": 0.5}
    assert tslo.SloConfig.from_env(environ, **kw).__dict__ == jslo.SloConfig.from_env(environ, **kw).__dict__


@pytest.mark.parametrize("environ", [{"DDR_SLO_TARGET": "1.0"}, {"DDR_SLO_TARGET": "high"},
                                     {"DDR_SLO_WINDOWS": "60,-1"}, {"DDR_SLO_WINDOWS": "a"},
                                     {"DDR_SLO_LATENCY_MS": "0"}, {"DDR_SLO_ALERT_BURN": "0"},
                                     {"DDR_SLO_ALERT_MIN_SAMPLES": "0"}])
def test_slo_config_refuses_what_jax_refuses(environ):
    with pytest.raises(ValueError) as ref:
        jslo.SloConfig.from_env(environ)
    with pytest.raises(ValueError) as ours:
        tslo.SloConfig.from_env(environ)
    assert str(ours.value) == str(ref.value)


def test_window_labels_equal_jax():
    for w in (60.0, 0.5, 3600.0, 1e-3):
        assert tslo.window_label(w) == jslo.window_label(w)
    for label in ("300s", "0.5s", "nope", "60"):
        assert tslo.parse_window_label(label) == jslo.parse_window_label(label)


def test_slo_events_tee_as_jax():
    ref, out = JaxRegistry(const_labels={"host": 0}), MetricsRegistry(const_labels={"host": 0})
    for state in ("firing", "resolved", "firing", None):
        record = {"event": "slo", "window": "60s", "burn_rate": 15.0}
        if state is not None:
            record["state"] = state
        jprom.event_tee(dict(record), ref)
        tprom.event_tee(dict(record), out)
        assert tprom.render_text(out) == jprom.render_text(ref).replace(
            "# HELP ddr_compiles_total Step/plan-cache compile misses\n# TYPE ddr_compiles_total counter\n", "")


# ---- the service's SLO accounting ----


def _service_pair(tmp_path):
    """A JAX and a port service over one 32-reach basin, queue_cap 2."""
    import jax
    import jax.numpy as jnp

    from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
    from ddr_tpu.nn.kan import Kan as FlaxKan
    from ddr_tpu.serving.config import ServeConfig as JaxServeConfig
    from ddr_tpu.serving.service import ForecastService as JaxForecastService
    from ddr_tpu.validation.configs import Config as JaxConfig
    from ddr_tpu_torch.geodatazoo.synthetic import make_basin
    from ddr_tpu_torch.nn.convert import kan_state_from_flax
    from ddr_tpu_torch.nn.kan import Kan
    from ddr_tpu_torch.serving.config import ServeConfig
    from ddr_tpu_torch.serving.service import ForecastService
    from ddr_tpu_torch.validation.configs import Config, KanConfig

    names = [f"a{i}" for i in range(10)]
    basin = dict(n_segments=32, n_gauges=2, n_days=2, seed=5, depth=6)
    ours, ref = make_basin(**basin), jax_make_basin(**basin)
    fk = FlaxKan(input_var_names=tuple(names), learnable_parameters=("n", "q_spatial"))
    variables = fk.init(jax.random.PRNGKey(0), jnp.asarray(ref.routing_data.normalized_spatial_attributes))
    kan = Kan(names, ("n", "q_spatial"))
    kan.load_state_dict(kan_state_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    kw = dict(horizon_hours=6, max_batch=2, queue_cap=2, batch_wait_s=0.002)
    jsvc = JaxForecastService(
        JaxConfig(name="t", geodataset="synthetic", mode="testing", kan={"input_var_names": names},
                  experiment={"start_time": "1981/10/01", "end_time": "1981/10/10"},
                  params={"save_path": str(tmp_path)}), JaxServeConfig(**kw))
    tsvc = ForecastService(Config(kan=KanConfig(input_var_names=names)), ServeConfig(**kw), device="cpu")
    jsvc.register_network("b", ref.routing_data, forcing=ref.q_prime)
    jsvc.register_model("default", fk, variables)
    tsvc.register_network("b", ours.routing_data, forcing=ours.q_prime)
    tsvc.register_model("default", kan)
    jsvc.warmup()
    tsvc.warmup()
    return jsvc, tsvc


def test_service_counts_terminal_decisions_as_jax(tmp_path):
    """Served, late (deadline passed while queued: shed) and rejected
    (queue full) requests: the same lifetime good/total counts in both
    trackers, and the port's ``ddr_slo_*`` gauges carry its tracker's
    reads."""
    from ddr_tpu.serving.batcher import QueueFullError as JaxQueueFull
    from ddr_tpu_torch.serving.batcher import QueueFullError

    jsvc, tsvc = _service_pair(tmp_path)
    lifetimes = []
    try:
        for svc, full in ((jsvc, JaxQueueFull), (tsvc, QueueFullError)):
            for t in range(3):
                svc.forecast(network="b", t0=t, timeout=60)
            entered, gate = threading.Event(), threading.Event()
            run = svc._batcher._execute

            def blocked(key, reqs, run=run, entered=entered, gate=gate):
                entered.set()
                gate.wait(timeout=60)
                return run(key, reqs)

            svc._batcher._execute = blocked
            first = svc.submit(network="b", t0=0)
            assert entered.wait(timeout=60)
            late = svc.submit(network="b", t0=1, deadline_s=0.01)
            svc.submit(network="b", t0=2)
            with pytest.raises(full):
                svc.submit(network="b", t0=3)
            time.sleep(0.05)
            gate.set()
            first.result(timeout=60)
            with pytest.raises(Exception):
                late.result(timeout=60)
            deadline = time.monotonic() + 30
            while svc.stats()["slo"]["lifetime"]["total"] < 7 and time.monotonic() < deadline:
                time.sleep(0.01)
            lifetimes.append(svc.stats()["slo"]["lifetime"])
        assert lifetimes[0] == lifetimes[1] == {"good": 5, "total": 7, "attainment": round(5 / 7, 6)}
        text = tprom.render_text(tsvc.metrics)
        assert "ddr_slo_attainment" in text and 'ddr_slo_burn_rate{host="0",window="60s"}' in text
    finally:
        jsvc.close(drain=False)
        tsvc.close(drain=False)


# ---- the report ----


def _outcomes(seed: int):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(int(rng.integers(0, 300))):
        status = ["ok", "ok", "ok", "rejected", "shed:deadline", "shed:queue-full", "error:timeout",
                  "error:http-500"][int(rng.integers(8))]
        lat = float(rng.exponential(0.05))
        q = float(rng.exponential(0.01)) if status == "ok" and rng.random() < 0.9 else None
        ex = float(rng.exponential(0.02)) if status == "ok" and rng.random() < 0.9 else None
        prio = [None, "interactive", "batch", "bulk"][int(rng.integers(4))] if seed % 2 else None
        pairs.append((jlt.Outcome(status, lat, q, ex, prio), tlt.Outcome(status, lat, q, ex, prio)))
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _stats(seed: int, after: bool):
    rng = np.random.default_rng(seed + 100 * after)
    if seed == 2:
        return {}
    return {
        "queue": {"served": int(rng.integers(0, 50)) + 60 * after, "batches": int(rng.integers(0, 9)) + 9 * after},
        "config": {"max_batch": 8},
        "slo": {"target": 0.99,
                "lifetime": {"good": int(rng.integers(0, 40)) + 50 * after, "total": int(rng.integers(40, 50)) + 60 * after},
                "windows": {"60s": {"burn_rate": float(rng.uniform(0, 20))}, "3600s": {"burn_rate": None},
                            "300s": {"burn_rate": 1.5}}},
    }


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_build_report_and_summary_equal_jax(seed):
    jo, to = _outcomes(seed)
    kw = dict(stats_before=_stats(seed, False), stats_after=_stats(seed, True), mode="open",
              target="synthetic", device="cpu", seed=seed)
    ref = jlt.build_report(jo, 3.25 + seed, len(jo) + 3, **kw)
    out = tlt.build_report(to, 3.25 + seed, len(to) + 3, **kw)
    assert out == ref
    assert tlt.render_summary(out) == jlt.render_summary(ref)
    assert tlt._quantile_fields([], "x_") == jlt._quantile_fields([], "x_")


@pytest.mark.parametrize("spec", [None, "", "interactive=0.6,batch=0.3,bulk=0.1", "bulk", "batch=2, interactive",
                                  " interactive = 1 ,bulk=3"])
def test_parse_priority_mix_equals_jax(spec):
    assert tlt.parse_priority_mix(spec) == jlt.parse_priority_mix(spec)


@pytest.mark.parametrize("spec", ["urgent=1", "batch=x", "batch=-1", "batch=0,bulk=0",
                                  "interactive:0.2,batch:0.5"])
def test_parse_priority_mix_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as ref:
        jlt.parse_priority_mix(spec)
    with pytest.raises(ValueError) as ours:
        tlt.parse_priority_mix(spec)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("seed", [0, 7])
def test_priority_for_is_fixed_by_seed_and_index_and_follows_the_mix(seed):
    mix = tlt.parse_priority_mix("interactive=0.2,batch=0.5,bulk=0.3")
    first = [tlt.priority_for(i, mix, seed) for i in range(10_000)]
    assert first == [tlt.priority_for(i, mix, seed) for i in range(10_000)]
    for name, weight in mix:
        assert abs(first.count(name) / len(first) - weight) < 0.02, name
    other = [tlt.priority_for(i, mix, seed + 1) for i in range(200)]
    assert other != first[:200]
    assert tlt.priority_for(3, None, seed) is None and tlt.priority_for(3, [], seed) is None


# ---- end to end on the CPU ----


def test_in_process_service_forecasts_and_ensembles(tmp_path):
    svc, _ = tlt.build_synthetic_service(32, 6, str(tmp_path), overrides=["device=cpu"])
    try:
        assert svc.ready and svc.stats()["ready"]
        ans = svc.forecast(network="default", t0=2, gauges=[1], timeout=60)
        assert ans["runoff"].shape == (6, 1) and np.isfinite(ans["runoff"]).all()
        assert svc.submit(network="default", t0=3).result(timeout=60)["runoff"].shape == (6, 4)
        ens = svc.ensemble_forecast(network="default", t0=2, members=5, percentiles=[25, 75])
        assert ens["runoff"].shape == (2, 6, 4) and ens["members"] == 5
        assert np.all(ens["runoff"][0] <= ens["runoff"][1])
        assert svc.stats()["slo"]["lifetime"]["total"] == 2  # ensembles ride no batch
    finally:
        svc.close()


@pytest.mark.parametrize("environ", [{"DDR_FLEET_ENSEMBLE_SIGMA": "-1"},
                                     {"DDR_FLEET_ENSEMBLE_MAX_MEMBERS": "many"}])
def test_bad_fleet_setting_refuses_ensembles_not_the_service(tmp_path, monkeypatch, environ):
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    svc, _ = tlt.build_synthetic_service(32, 6, str(tmp_path), overrides=["device=cpu"])
    try:
        assert svc.forecast(network="default", t0=1, timeout=60)["runoff"].shape == (6, 4)
        for _ in range(2):  # the runner is built on first use, and again after a refusal
            with pytest.raises(ValueError):
                svc.ensemble_forecast(network="default", t0=1, members=2)
    finally:
        svc.close()


LOADTEST_RUNS = {
    "open": ["--rps", "40", "--duration", "0.6", "--priority-mix", "interactive=0.2,batch=0.5,bulk=0.3"],
    "closed": ["--mode", "closed", "--clients", "3", "--duration", "0.6"],
    "ensemble": ["--mode", "closed", "--clients", "2", "--duration", "0.4", "--ensemble", "4"],
    "deadline": ["--rps", "60", "--duration", "0.5", "--deadline-ms", "0.001"],
}


@pytest.mark.parametrize("name", sorted(LOADTEST_RUNS))
def test_loadtest_synthetic_runs_on_the_cpu(tmp_path, capsys, name):
    code = tlt.main(["--synthetic", "--n", "32", "--horizon", "6", "--out", str(tmp_path), "--label", name,
                     *LOADTEST_RUNS[name], "device=cpu"])
    assert code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert lines[0].startswith(f"loadtest [{report['mode']}] synthetic:")
    assert report == json.loads((tmp_path / f"LOADTEST_{name}.json").read_text())
    assert report["device"] == "cpu" and report["requests"] > 0 and report["errors"] == 0
    assert report["slo_target"] == 0.99
    if name == "deadline":  # every request outlives its deadline in the queue
        assert report["ok"] == 0 and report["sheds_by_reason"].get("deadline") == report["requests"]
        assert report["slo_attainment"] == 0.0
    else:
        assert report["ok"] == report["requests"] and report["slo_attainment"] == 1.0
    if name == "open":
        assert set(report["by_priority"]) <= {"interactive", "batch", "bulk"}
    if name == "ensemble":
        assert report["ensemble_members"] == 4 and report["mean_batch_size"] is None


def test_loadtest_over_http_runs_on_the_cpu(tmp_path, capsys):
    from ddr_tpu_torch.serving.http_api import serve_http

    svc, _ = tlt.build_synthetic_service(32, 6, str(tmp_path), overrides=["device=cpu"])
    server = serve_http(svc, port=0)
    try:
        code = tlt.main(["--url", server.url, "--rps", "40", "--duration", "0.6", "--t0-span", "12",
                         "--priority-mix", "bulk=1,interactive=1", "--out", str(tmp_path), "--label", "http"])
        assert code == 0
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert report["target"] == server.url and report["ok"] == report["requests"] > 0
        assert report["device"] is None  # the server's card is not this process's to name
        # the server's own tracker saw the run (and the unmeasured priming request)
        assert svc.stats()["slo"]["lifetime"]["total"] == report["requests"] + 1
        assert report["slo_attainment"] == 1.0 and report["mean_batch_size"] >= 1
        code = tlt.main(["--url", server.url, "--mode", "closed", "--clients", "2", "--duration", "0.3",
                         "--ensemble", "3", "--out", str(tmp_path), "--label", "http-ens"])
        assert code == 0 and json.loads(capsys.readouterr().out.strip().splitlines()[-1])["errors"] == 0
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
