"""The port's replica group, ``ddr fleet`` and ``ddr loadtest --fleet`` against
the JAX package's.

- In-process groups of two replicas, JAX's over JAX services and the port's
  over port services on the CPU with the same KAN weights (carried across by
  ``kan_state_from_flax``): routed forecasts and ensembles within the
  serving bound of ``tests/test_torch_service.py`` (rtol 1e-5, atol 1e-5 x
  the largest magnitude), ``describe()`` with JAX's keys, and the same
  ejection on kill, readmission on revive, reroute past a dead replica and
  router state (the prober's timing decides which live replica a request
  meets, so picks are compared where the script fixes them:
  ``tests/test_torch_fleet_router.py``);
- ``http=True`` publishes ``DDR_FEDERATE_REPLICAS`` as JAX's group does and
  restores the earlier value on close; a federated scrape of a member
  reports every member up;
- a subprocess group of two ``serve`` workers of the port (``device=cpu``, 64
  reaches) boots, names each worker's slot in ``/v1/stats`` and ``fleet
  status``, answers through the router, survives ``kill_replica`` (the
  request rerouted, the worker ejected) and readmits the worker after
  ``restart_replica``; ``fleet up``'s own pair, booting alongside, answers
  ``/v1/stats`` with its slot, and the command exits 0 on SIGINT and leaves
  no worker;
- ``FleetDriver.stats`` merges as JAX's does, and ``ddr loadtest --fleet 2
  --synthetic device=cpu`` writes a report with JAX's keys, every request
  ok.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddr_tpu.fleet.config import FleetConfig as JaxFleetConfig
from ddr_tpu.fleet.group import ReplicaGroup as JaxReplicaGroup
from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
from ddr_tpu.nn.kan import Kan as FlaxKan
from ddr_tpu.scripts import loadtest as jlt
from ddr_tpu.serving.config import ServeConfig as JaxServeConfig
from ddr_tpu.serving.service import ForecastService as JaxForecastService
from ddr_tpu.validation.configs import Config as JaxConfig
from ddr_tpu_torch import cli
from ddr_tpu_torch.fleet.config import FleetConfig
from ddr_tpu_torch.fleet.group import ReplicaGroup
from ddr_tpu_torch.geodatazoo.synthetic import make_basin
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.scripts import loadtest as tlt
from ddr_tpu_torch.serving.config import ServeConfig
from ddr_tpu_torch.serving.service import ForecastService
from ddr_tpu_torch.validation.configs import Config, KanConfig

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "examples" / "synthetic" / "config.yaml")
NAMES = [f"a{i}" for i in range(10)]
HORIZON = 8
BASIN = dict(n_segments=24, n_gauges=4, n_days=3, seed=1)
SERVE = dict(horizon_hours=HORIZON, max_batch=4, batch_wait_s=0.002)
BOOT_TIMEOUT = 120.0  # a CPU worker imports torch, builds the twin and warms up


def _close(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-8)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


def _wait(predicate, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


@pytest.fixture(scope="module")
def weights():
    """One KAN's weights on both sides: flax variables and the port's module."""
    ref = jax_make_basin(**BASIN)
    fk = FlaxKan(input_var_names=tuple(NAMES), learnable_parameters=("n", "q_spatial"))
    variables = fk.init(jax.random.PRNGKey(0), jnp.asarray(ref.routing_data.normalized_spatial_attributes))
    state = kan_state_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    return fk, variables, state


def jax_service(tmp, weights, candidate=False) -> JaxForecastService:
    fk, variables, _ = weights
    cfg = JaxConfig(name="t", geodataset="synthetic", mode="testing", kan={"input_var_names": NAMES},
                    experiment={"start_time": "1981/10/01", "end_time": "1981/10/10"},
                    params={"save_path": str(tmp)})
    svc = JaxForecastService(cfg, JaxServeConfig(**SERVE))
    svc.register_network("default", jax_make_basin(**BASIN).routing_data, forcing=jax_make_basin(**BASIN).q_prime)
    svc.register_model("default", fk, variables)
    if candidate:
        svc.register_model("candidate", fk, variables)
    svc.warmup()
    return svc


def port_service(weights, candidate=False, state=None) -> ForecastService:
    svc = ForecastService(Config(kan=KanConfig(input_var_names=NAMES)), ServeConfig(**SERVE), device="cpu")
    basin = make_basin(**BASIN)
    svc.register_network("default", basin.routing_data, forcing=basin.q_prime)
    for name in ("default", "candidate") if candidate else ("default",):
        kan = Kan(NAMES, ("n", "q_spatial"))
        kan.load_state_dict(weights[2] if state is None or name == "default" else state)
        svc.register_model(name, kan)
    svc.warmup()
    return svc


def test_inprocess_groups_route_kill_and_readmit_as_jax(weights, tmp_path):
    groups = {
        "jax": JaxReplicaGroup(JaxFleetConfig.from_env(environ={}, replicas=2, probe_s=0.05),
                               builder=lambda i: jax_service(tmp_path, weights), workdir=tmp_path / "j"),
        "port": ReplicaGroup(FleetConfig.from_env(environ={}, replicas=2, probe_s=0.05),
                             builder=lambda i: port_service(weights), workdir=tmp_path / "p"),
    }
    try:
        for g in groups.values():
            g.boot()
        desc = {k: g.describe() for k, g in groups.items()}
        assert desc["port"].keys() == desc["jax"].keys()
        for key in ("group", "mode", "replicas", "federation"):
            assert desc["port"][key] == desc["jax"][key], key
        assert desc["port"]["router"].keys() == desc["jax"]["router"].keys()

        def both(method, **kw):
            return {k: getattr(g, method)(network="default", **kw) for k, g in groups.items()}

        for i, (t0, gauges) in enumerate([(0, None), (5, [1, 3]), (17, [0]), (40, None)]):
            out = both("forecast", t0=t0, gauges=gauges, request_id=f"g-{i}", timeout=60)
            _close(out["jax"]["runoff"], out["port"]["runoff"], f"forecast {i}")
            assert out["port"]["request_id"] == out["jax"]["request_id"] == f"g-{i}"
        ens = both("ensemble", t0=3, members=4, percentiles=[10, 50, 90], seed=2, request_id="ens")
        assert ens["port"]["members"] == ens["jax"]["members"] == 4
        _close(ens["jax"]["runoff"], ens["port"]["runoff"], "ensemble bands")

        def dispatched():
            return {k: [r["dispatched"] for r in g.router.status()["replicas"]] for k, g in groups.items()}

        assert sum(dispatched()["port"]) == sum(dispatched()["jax"]) == 5
        for g in groups.values():
            g.kill_replica(0)
        for k, g in groups.items():  # the prober ejects the dead replica
            assert _wait(lambda: g.router.healthy() == ["fleet-r1"]), k
        before = dispatched()
        out = both("forecast", t0=2, request_id="after-kill", timeout=60)
        _close(out["jax"]["runoff"], out["port"]["runoff"], "forecast after the kill")
        for k, d in dispatched().items():  # only the survivor is dispatched
            assert d == [before[k][0], before[k][1] + 1], k
        for g in groups.values():
            g.restart_replica(0)
        for k, g in groups.items():
            assert _wait(lambda: g.router.healthy() == ["fleet-r0", "fleet-r1"]), k
        statuses = {k: g.router.status() for k, g in groups.items()}
        for s in statuses.values():
            s["replicas"] = [(r["name"], r["ejected"], r["consecutive_failures"], r["inflight"])
                             for r in s["replicas"]]
            s.pop("anomalies")
        assert statuses["port"] == statuses["jax"]
        # with the first replica dead and not yet ejected, a request reroutes
        for g in groups.values():
            g.router.probe_s = 3600.0  # the prober sleeps through what follows
        time.sleep(0.1)
        for g in groups.values():
            g.kill_replica(0)
            g.router._probed_depth["fleet-r1"] = 0
        out = both("forecast", t0=9, request_id="rerouted", timeout=60)
        _close(out["jax"]["runoff"], out["port"]["runoff"], "rerouted forecast")
        assert ([r["consecutive_failures"] for r in groups["port"].router.status()["replicas"]]
                == [r["consecutive_failures"] for r in groups["jax"].router.status()["replicas"]] == [1, 0])
    finally:
        for g in groups.values():
            g.close()


def test_http_fronts_publish_and_restore_federation_as_jax(weights, tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_FEDERATE_REPLICAS", "prior=http://x/metrics")
    group = ReplicaGroup(FleetConfig.from_env(environ={}, replicas=2, probe_s=0.05),
                         builder=lambda i: port_service(weights), workdir=tmp_path, http=True)
    group.boot()
    try:
        published = os.environ["DDR_FEDERATE_REPLICAS"]
        assert re.fullmatch(r"fleet-r0=http://127\.0\.0\.1:\d+/metrics,fleet-r1=http://127\.0\.0\.1:\d+/metrics",
                            published), published
        assert group.describe()["federation"] == published
        group.forecast(network="default", t0=0, timeout=60)
        with urllib.request.urlopen(group.replicas[1].url + "/metrics?federated=1", timeout=30) as resp:
            text = resp.read().decode()
        for label in ("fleet-r0", "fleet-r1", "self"):
            assert f'ddr_federate_up{{replica="{label}"}} 1' in text
        assert 'ddr_requests_total{replica="fleet-r1",' in text
    finally:
        group.close()
    assert os.environ["DDR_FEDERATE_REPLICAS"] == "prior=http://x/metrics"
    # without HTTP fronts nothing is published, as in JAX's group
    monkeypatch.delenv("DDR_FEDERATE_REPLICAS")
    bare = ReplicaGroup(FleetConfig.from_env(environ={}, replicas=1), builder=lambda i: port_service(weights),
                        workdir=tmp_path / "bare").boot()
    try:
        assert "DDR_FEDERATE_REPLICAS" not in os.environ
    finally:
        bare.close()


def test_construction_refuses_what_jax_refuses(tmp_path):
    for mod_group, mod_cfg in ((JaxReplicaGroup, JaxFleetConfig), (ReplicaGroup, FleetConfig)):
        with pytest.raises(ValueError, match="builder"):
            mod_group(mod_cfg.from_env(environ={}))
        with pytest.raises(ValueError, match="serve_args"):
            mod_group(mod_cfg.from_env(environ={}, mode="subprocess"))
        group = mod_group(mod_cfg.from_env(environ={}, replicas=1), builder=lambda i: None, workdir=tmp_path)
        with pytest.raises(RuntimeError, match="boot"):
            group.forecast(network="default", t0=0)


def test_subprocess_workers_survive_a_kill_and_fleet_up_stops_them_on_sigint(tmp_path, capsys):
    # `fleet up`'s pair boots in its own process while this one boots and
    # drills a ReplicaGroup pair: two worker pairs, one boot's wait
    log_path = tmp_path / "up.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "ddr_tpu_torch.cli", "fleet", "up", CONFIG, "device=cpu",
                                 "synthetic_segments=64", f"params.save_path={tmp_path / 'up' / 'run'}",
                                 "--replicas", "2", "--out", str(tmp_path / "up"), "--boot-timeout",
                                 str(BOOT_TIMEOUT)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    urls = []
    try:
        cfg = FleetConfig.from_env(environ={}, replicas=2, mode="subprocess", probe_s=0.1, group="cpu-pair")
        group = ReplicaGroup(cfg, serve_args=[CONFIG, "device=cpu", "synthetic_segments=64",
                                              f"params.save_path={tmp_path / 'run'}"],
                             workdir=tmp_path, boot_timeout=BOOT_TIMEOUT, client_timeout=60.0)
        group.boot()
        pids = group.pids()
        try:
            assert sorted(pids) == [0, 1]
            for i, replica in enumerate(group.replicas):
                stats = replica.stats()
                assert stats["fleet"] == {"group": "cpu-pair", "replica": i, "router": f"local:{os.getpid()}"}
            boot_log = (tmp_path / "replica_0_boot1.out").read_text()
            assert "fleet identity: group 'cpu-pair' replica 0" in boot_log and "serving on cpu" in boot_log
            assert cli.main(["fleet", "status", "--url", group.replicas[1].url]) == 0
            assert "group 'cpu-pair' replica 1" in capsys.readouterr().out
            first = group.forecast(network="default", t0=3)
            assert first["runoff"].shape == (72, 4) and np.isfinite(first["runoff"]).all()

            group.kill_replica(0)
            again = group.forecast(network="default", t0=3)  # rerouted to r1, the same answer
            np.testing.assert_array_equal(again["runoff"], first["runoff"])
            assert _wait(lambda: group.router.healthy() == ["cpu-pair-r1"], 30)
            status = group.router.status()
            assert status["unroutable_errors"] == 0 and status["replicas"][0]["ejected"]

            group.restart_replica(0)
            assert _wait(lambda: group.router.healthy() == ["cpu-pair-r0", "cpu-pair-r1"], BOOT_TIMEOUT)
            before = group.router.status()["replicas"][0]["dispatched"]
            threads = [threading.Thread(target=group.forecast, kwargs={"network": "default", "t0": t})
                       for t in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
            assert group.router.status()["replicas"][0]["dispatched"] > before
            pids = {**pids, **group.pids()}
        finally:
            group.close()
        for pid in pids.values():
            assert not Path(f"/proc/{pid}").exists() or "zombie" in Path(f"/proc/{pid}/status").read_text()

        assert _wait(lambda: "federation: DDR_FEDERATE_REPLICAS=" in log_path.read_text() or proc.poll() is not None,
                     BOOT_TIMEOUT + 30), log_path.read_text()
        assert proc.poll() is None, log_path.read_text()
        urls = re.findall(r"(http://127\.0\.0\.1:\d+)\s*$", log_path.read_text(), re.M)
        assert len(urls) == 2, log_path.read_text()
        stats = json.loads(urllib.request.urlopen(urls[1] + "/v1/stats", timeout=30).read())
        assert stats["fleet"]["group"] == "fleet" and stats["fleet"]["replica"] == 1
    finally:
        proc.send_signal(signal.SIGINT)
        code = proc.wait(timeout=60)
    text = log_path.read_text()
    assert code == 0 and "Traceback" not in text, text
    for url in urls:
        with pytest.raises(OSError):
            urllib.request.urlopen(url + "/healthz", timeout=5)


class _FakeReplica:
    def __init__(self, stats):
        self._stats = stats
        self.service = _FakeService()

    def stats(self):
        if isinstance(self._stats, Exception):
            raise self._stats
        return self._stats


class _FakeService:
    class _Net:
        forcing = np.zeros((30, 4))
        horizon = 6

    class _Cfg:
        deadline_s = 2.0

    serve_cfg = _Cfg()

    def networks(self):
        return {"default": self._Net()}


def test_fleet_driver_stats_merge_as_jax():
    class Group:
        replicas = [_FakeReplica({"config": {"max_batch": 4}, "queue": {"served": 3, "batches": 2, "depth": 1,
                                                                        "note": "x"}}),
                    _FakeReplica(ConnectionError("down")),
                    _FakeReplica({"config": {"max_batch": 8}, "queue": {"served": 5, "batches": 1.5}})]

    out, ref = tlt.FleetDriver(Group()), jlt.FleetDriver(Group())
    assert out.stats() == ref.stats()
    assert out.t0_span == ref.t0_span == 25


def test_loadtest_fleet_writes_jax_report_keys(tmp_path, capsys):
    code = cli.main(["loadtest", "--synthetic", "--fleet", "2", "--n", "32", "--horizon", "6", "--rps", "40",
                     "--duration", "0.6", "--out", str(tmp_path), "--label", "fleet", "device=cpu"])
    assert code == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report == json.loads((tmp_path / "LOADTEST_fleet.json").read_text())
    ref = jlt.build_report([jlt.Outcome("ok", 0.1, 0.01, 0.05)], 1.0, 1, stats_before={}, stats_after={},
                           mode="open", target="fleet:2", fleet=2, device="cpu", rps_target=40.0, clients=None,
                           duration_s=0.6, network="default", model="default", deadline_ms=None, seed=0,
                           priority_mix=None, ensemble_members=None)
    assert set(report) == set(ref)
    assert report["target"] == "fleet:2" and report["fleet"] == 2 and report["device"] == "cpu"
    assert report["requests"] > 0 and report["ok"] == report["requests"] and report["errors"] == 0
    assert cli.main(["loadtest", "--fleet", "2", CONFIG, "device=cpu"]) == 2  # synthetic replicas only
