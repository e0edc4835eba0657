"""The port's fleet router against the JAX package's (``ddr_tpu/fleet/router.py``).

The same scripted fake replicas go through JAX's ``Router`` and the port's:

- a seeded script of dispatches, replica deaths, revivals, application
  errors and probed depths gives the same pick for every request, the same
  exceptions, the same ejections and the same ``status()`` after every step
  (the prober parked on a long cadence, so the script alone moves them);
- with the prober at 20 ms (bounded waits), a dead replica is ejected and
  readmitted on its first good probe, probed depths land in ``status()``,
  and the fleet sentinel carries one queue-depth detector per replica, as
  in JAX; ``DDR_SENTINEL_ENABLED=0`` leaves ``anomalies`` None;
- ``HttpReplica`` folds ``members``/``percentiles``/``seed`` into the body's
  ``ensemble`` object, and a dead URL is a transport error the router
  reroutes.

Every random choice is drawn from numpy generators seeded with fixed integers.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from ddr_tpu.fleet import router as jr
from ddr_tpu_torch.fleet import router as tr
from ddr_tpu_torch.serving.client import HttpForecastClient


class FakeReplica:
    """Scriptable stand-in: ``up=False`` is transport death, ``queue_depth``
    the probed depth, ``app_error`` an application error."""

    def __init__(self, index: int, depth: int = 0):
        self.index = index
        self.name = f"r{index}"
        self.url = None
        self.up = True
        self.queue_depth = depth
        self.app_error: Exception | None = None
        self.calls = 0

    def ready(self) -> bool:
        return self.up

    def depth(self) -> int:
        if not self.up:
            raise ConnectionError(f"{self.name} is down")
        return self.queue_depth

    def forecast(self, **kw) -> dict:
        self.calls += 1
        if not self.up:
            raise ConnectionError(f"{self.name} is down")
        if self.app_error is not None:
            raise self.app_error
        return {"replica": self.name, **kw}

    def ensemble(self, **kw) -> dict:
        return {"ensemble": True, **self.forecast(**kw)}


def _wait(predicate, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _call(router, method: str, **kw):
    try:
        return "ok", getattr(router, method)(**kw)
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return type(e).__name__, None


@pytest.mark.parametrize("eject_after", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_dispatch_equals_jax(seed, eject_after):
    rng = np.random.default_rng(seed)
    fakes = {side: [FakeReplica(i) for i in range(3)] for side in ("jax", "port")}
    routers = {"jax": jr.Router(fakes["jax"], probe_s=30.0, eject_after=eject_after),
               "port": tr.Router(fakes["port"], probe_s=30.0, eject_after=eject_after)}
    try:
        for step in range(120):
            action = rng.choice(["forecast", "forecast", "forecast", "ensemble", "kill", "revive",
                                 "app", "depth"])
            k = int(rng.integers(0, 3))
            depth = int(rng.integers(0, 6))
            outcomes = {}
            for side, router in routers.items():
                fake = fakes[side][k]
                if action == "kill":
                    fake.up = False
                elif action == "revive":
                    fake.up = True
                    fake.app_error = None
                elif action == "app":
                    fake.app_error = ValueError("unknown network")
                elif action == "depth":
                    router._probed_depth[fake.name] = depth
                else:
                    outcomes[side] = _call(router, action, t0=step)
            assert outcomes.get("port") == outcomes.get("jax"), (step, action)
            assert routers["port"].status() == routers["jax"].status(), (step, action)
            assert routers["port"].healthy() == routers["jax"].healthy()
        final = routers["port"].status()
        assert final["unroutable_errors"] > 0 or eject_after > 1
        assert sum(r["dispatched"] for r in final["replicas"]) > 0
    finally:
        for router in routers.values():
            router.close()


def test_router_refuses_an_empty_group_as_jax():
    with pytest.raises(ValueError) as ref:
        jr.Router([])
    with pytest.raises(ValueError) as ours:
        tr.Router([])
    assert str(ours.value) == str(ref.value)
    assert issubclass(tr.NoHealthyReplicaError, RuntimeError)


def test_prober_ejects_readmits_and_reads_depths_as_jax(monkeypatch):
    monkeypatch.setenv("DDR_SENTINEL_WARMUP", "3")
    seen = {}
    for side, mod in (("jax", jr), ("port", tr)):
        a, b = FakeReplica(0, depth=7), FakeReplica(1, depth=1)
        router = mod.Router([a, b], probe_s=0.02, eject_after=2)
        try:
            assert _wait(lambda: router.status()["replicas"][0]["last_probed_depth"] == 7)
            a.up = False
            assert _wait(lambda: router.healthy() == ["r1"])
            assert router.forecast(t0=0)["replica"] == "r1"
            a.up = True
            assert _wait(lambda: router.healthy() == ["r0", "r1"])
            assert _wait(lambda: {"r0.queue_depth", "r1.queue_depth"}
                         <= set((router.status()["anomalies"] or {}).get("signals", {})))
            status = router.status()
            seen[side] = ([r["consecutive_failures"] for r in status["replicas"]],
                          [r["last_probed_depth"] for r in status["replicas"]],
                          status["anomalies"]["scope"], sorted(status["anomalies"]))
        finally:
            router.close()
        assert not router._prober.is_alive()
    assert seen["port"] == seen["jax"] == ([0, 0], [7, 1], "fleet", seen["jax"][3])


def test_disabled_sentinel_leaves_anomalies_none(monkeypatch):
    monkeypatch.setenv("DDR_SENTINEL_ENABLED", "0")
    for mod in (jr, tr):
        router = mod.Router([FakeReplica(0)], probe_s=30.0)
        try:
            assert router.status()["anomalies"] is None
        finally:
            router.close()


def test_http_replica_folds_the_ensemble_triple_into_the_body(monkeypatch):
    sent = []

    def fake_forecast(self, network, **kw):
        sent.append((network, kw))
        return {"runoff": np.zeros((3, 2, 1), np.float32)}

    monkeypatch.setattr(HttpForecastClient, "forecast", fake_forecast)
    rep = tr.HttpReplica("http://127.0.0.1:9/", 0, name="w0")
    assert (rep.url, rep.name) == ("http://127.0.0.1:9", "w0")
    rep.ensemble(network="default", t0=4, members=5, percentiles=[10, 90], seed=2, request_id="e")
    rep.ensemble(network="default", t0=0)
    assert sent == [
        ("default", {"t0": 4, "request_id": "e",
                     "ensemble": {"members": 5, "percentiles": [10.0, 90.0], "seed": 2}}),
        ("default", {"t0": 0, "ensemble": {"members": 8, "percentiles": None, "seed": 0}}),
    ]


def test_a_dead_url_is_rerouted():
    """A worker that is gone refuses the connection: a transport error the
    router counts and reroutes, never the caller's answer."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"
    live = FakeReplica(1)
    router = tr.Router([tr.HttpReplica(dead, 0, timeout=2.0), live], probe_s=30.0, eject_after=1)
    try:
        assert router.forecast(network="default", t0=0)["replica"] == "r1"
        assert router.healthy() == ["r1"]
        assert not router.replicas[0].ready()
    finally:
        router.close()
