"""The port's HTTP forecast front against the JAX package's, side by side.

A JAX server (``ddr_tpu.serving.http_api.serve_http`` over a JAX
``ForecastService``) and the port's (on the CPU) run on port 0 over the same
synthetic basin (``make_basin(96, depth=10, seed=23)``, as
``tests/test_torch_service.py``) with the same KAN weights (carried across by
``kan_state_from_flax``). Both get the same bodies and headers and must give:

- the same status codes and ``reason`` for 200, 400, 404, 429 (a
  ``queue_cap=1`` server with a blocked executor), 503 ``deadline`` and 503
  ``warming``; ``/readyz`` in all four states;
- equal ``/v1/networks``; the JAX ``/v1/stats`` and ``/v1/models`` keys, and
  an equal ``slo`` slice under one clock;
- equal echoed request and trace ids where supplied, of the same form where
  minted, and no trace ids under ``DDR_TRACE=0``;
- runoff within rtol 1e-5, atol 1e-5 x the largest magnitude (the bound of
  ``tests/test_torch_service.py``).

- for ensemble bodies and ``POST /v1/observe`` with a ledger attached:
  the same status codes, answer keys and ``reason``, ensemble bands within
  the runoff bound, and equal join counts.

- ``/v1/stats`` ``fleet`` equal to JAX's, without and with the
  ``DDR_FLEET_*`` identity variables; ``GET /metrics?federated=1`` answering
  200 on both, each with its package's ``federate_text`` over the same
  targets and its own registry.

``POST /v1/profile``, with and without its query, answers 202 with JAX's
body, and both packages refuse a bad ``seconds`` and a second capture alike.
"""

from __future__ import annotations

import http.client
import json
import re
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import urlsplit

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
from ddr_tpu.nn.kan import Kan as FlaxKan
from ddr_tpu.observability.health import HealthConfig as JaxHealthConfig
from ddr_tpu.serving.config import ServeConfig as JaxServeConfig
from ddr_tpu.serving.http_api import serve_http as jax_serve_http
from ddr_tpu.serving.service import ForecastService as JaxForecastService
from ddr_tpu.validation.configs import Config as JaxConfig
from ddr_tpu_torch.geodatazoo.synthetic import make_basin
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.observability.health import HealthConfig
from ddr_tpu_torch.observability.prometheus import CONTENT_TYPE
from ddr_tpu_torch.serving.client import HttpForecastClient, q_prime_json
from ddr_tpu_torch.serving.config import ServeConfig
from ddr_tpu_torch.serving.http_api import MAX_BODY_BYTES, serve_http
from ddr_tpu_torch.serving.service import ForecastService
from ddr_tpu_torch.validation.configs import Config, KanConfig

NAMES = [f"a{i}" for i in range(10)]
HORIZON = 12
BASIN = dict(n_segments=96, n_gauges=4, n_days=2, seed=23, depth=10)
HEX16 = re.compile(r"[0-9a-f]{16}")


def _close(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-8)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


class Pair:
    """A JAX service and a port service on the same basin and weights, each
    behind its HTTP front."""

    def __init__(self, tmp, warm=True, health=None, **serve_kw):
        serve_kw.setdefault("max_batch", 4)
        serve_kw.setdefault("batch_wait_s", 0.002)
        ours, ref = make_basin(**BASIN), jax_make_basin(**BASIN)
        self.basin = ours
        fk = FlaxKan(input_var_names=tuple(NAMES), learnable_parameters=("n", "q_spatial"))
        variables = fk.init(jax.random.PRNGKey(0), jnp.asarray(ref.routing_data.normalized_spatial_attributes))
        kan = Kan(NAMES, ("n", "q_spatial"))
        kan.load_state_dict(kan_state_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
        jcfg = JaxConfig(name="t", geodataset="synthetic", mode="testing", kan={"input_var_names": NAMES},
                         experiment={"start_time": "1981/10/01", "end_time": "1981/10/10"},
                         params={"save_path": str(tmp)})
        self.jax = JaxForecastService(jcfg, JaxServeConfig(horizon_hours=HORIZON, **serve_kw),
                                      health_cfg=None if health is None else JaxHealthConfig(**health))
        self.port = ForecastService(Config(kan=KanConfig(input_var_names=NAMES)),
                                    ServeConfig(horizon_hours=HORIZON, **serve_kw), device="cpu",
                                    health_cfg=None if health is None else HealthConfig(**health))
        self.jax.register_network("basin", ref.routing_data, forcing=ref.q_prime)
        self.jax.register_model("default", fk, variables)
        self.port.register_network("basin", ours.routing_data, forcing=ours.q_prime)
        self.port.register_model("default", kan)
        if warm:
            self.warmup()
        self.servers = [jax_serve_http(self.jax, port=0), serve_http(self.port, port=0)]
        self.urls = [s.url for s in self.servers]

    def warmup(self):
        self.jax.warmup()
        self.port.warmup()

    def both(self, method, path, body=None, headers=None, raw=None):
        """The same request to both servers -> [(status, headers, json), ...]."""
        return [_request(url, method, path, body, headers, raw) for url in self.urls]

    def close(self):
        for s in self.servers:
            s.shutdown()
            s.server_close()
        self.jax.close(drain=False)
        self.port.close(drain=False)


def _request(url, method, path, body=None, headers=None, raw=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = resp.read()
            status, hdrs = resp.status, resp.headers
    except urllib.error.HTTPError as e:
        payload, status, hdrs = e.read(), e.code, e.headers
    ctype = hdrs.get("Content-Type", "")
    return status, hdrs, (json.loads(payload or b"{}") if ctype == "application/json" else payload.decode())


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("serve"))
    yield p
    p.close()


def _payload(basin, seed):
    rng = np.random.default_rng(seed)
    return (basin.q_prime[10 : 10 + HORIZON] * rng.uniform(0.5, 2.0, size=(HORIZON, 96))).astype(np.float32)


FORECASTS = [
    ({"t0": 0}, {}),
    ({"t0": 7, "gauges": [1, 3]}, {"X-DDR-Request-Id": "req-7"}),
    ({"t0": 30, "priority": "interactive"}, {"X-DDR-Request-Id": "id with spaces\tand\x7ftabs",
                                             "X-DDR-Trace-Id": "trace-abc"}),
    ({"t0": 20, "priority": "bulk", "deadline_ms": 20000}, {"X-DDR-Trace-Id": "t" * 100}),
    ({"q_prime": "payload", "gauges": [0]}, {"X-DDR-Request-Id": "payload-1"}),
]


@pytest.mark.parametrize("case", range(len(FORECASTS)))
def test_forecast_answers_equal_jax(pair, case):
    body, headers = FORECASTS[case]
    if body.get("q_prime") == "payload":
        body = {**body, "q_prime": _payload(pair.basin, case).tolist()}
    (jc, jh, jb), (pc, ph, pb) = pair.both("POST", "/v1/forecast", {"network": "basin", **body}, headers)
    assert jc == pc == 200, (jb, pb)
    assert set(jb) <= set(pb), set(jb) - set(pb)
    for key in ("network", "model", "version", "engine"):
        assert pb[key] == jb[key], key
    _close(jb["runoff"], pb["runoff"], f"case {case}")
    rid = headers.get("X-DDR-Request-Id")
    if rid is None:
        assert HEX16.fullmatch(pb["request_id"]) and HEX16.fullmatch(jb["request_id"])
    else:
        assert pb["request_id"] == jb["request_id"] == ph["X-DDR-Request-Id"] == jh["X-DDR-Request-Id"]
    assert ph["X-DDR-Request-Id"] == pb["request_id"]
    tid = headers.get("X-DDR-Trace-Id")
    if tid is None:
        assert HEX16.fullmatch(pb["trace_id"]) and HEX16.fullmatch(jb["trace_id"])
    else:
        assert pb["trace_id"] == jb["trace_id"] == ph["X-DDR-Trace-Id"] == jh["X-DDR-Trace-Id"]
    assert pb["queue_s"] >= 0 and pb["execute_s"] > 0


ERRORS = {
    "invalid json": (None, b"{not json"),
    "not an object": ([1, 2], None),
    "no network": ({"t0": 0}, None),
    "unknown network": ({"network": "nope"}, None),
    "unknown model": ({"network": "basin", "model": "nope"}, None),
    "t0 out of range": ({"network": "basin", "t0": 10_000}, None),
    "q_prime and t0": ({"network": "basin", "t0": 0, "q_prime": [[0.0] * 96] * HORIZON}, None),
    "q_prime shape": ({"network": "basin", "q_prime": [[0.0] * 5] * 3}, None),
    "q_prime dict": ({"network": "basin", "q_prime": {"a": 1}}, None),
    "gauges out of range": ({"network": "basin", "gauges": [99]}, None),
    "gauges empty": ({"network": "basin", "gauges": []}, None),
    "bad priority": ({"network": "basin", "priority": "urgent"}, None),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_errors_map_as_jax(pair, name):
    body, raw = ERRORS[name]
    (jc, jh, jb), (pc, ph, pb) = pair.both("POST", "/v1/forecast", body, {"X-DDR-Request-Id": f"e-{name}"},
                                           raw=raw)
    assert pc == jc and pc in (400, 404), (name, jc, jb, pc, pb)
    assert pb.get("reason") == jb.get("reason")
    assert pb["request_id"] == jb["request_id"] == ph["X-DDR-Request-Id"] == f"e-{name}".replace(" ", "")
    assert "error" in pb


def test_body_size_limits_map_as_jax(pair):
    for length in (0, MAX_BODY_BYTES + 1):
        codes = []
        for url in pair.urls:
            u = urlsplit(url)
            conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
            conn.putrequest("POST", "/v1/forecast")
            conn.putheader("Content-Length", str(length))
            conn.endheaders()
            resp = conn.getresponse()
            codes.append((resp.status, json.loads(resp.read())["error"]))
            conn.close()
        assert codes[0] == codes[1] and codes[0][0] == 400


def test_get_endpoints_equal_jax(pair):
    (jc, _, jb), (pc, _, pb) = pair.both("GET", "/healthz")
    assert jc == pc == 200 and jb == pb == {"status": "ok"}
    (jc, _, jb), (pc, _, pb) = pair.both("GET", "/readyz")
    assert jc == pc == 200 and jb == pb == {"status": "ready"}
    (jc, _, jb), (pc, _, pb) = pair.both("GET", "/v1/networks")
    assert jc == pc == 200 and jb == pb
    (jc, _, jb), (pc, _, pb) = pair.both("GET", "/v1/models")
    assert jc == pc == 200 and jb["models"].keys() == pb["models"].keys()
    for name, info in jb["models"].items():
        assert info.keys() == pb["models"][name].keys() and info["version"] == pb["models"][name]["version"]
    assert pb["models"]["default"]["programs"] == {}
    (jc, _, jb), (pc, _, pb) = pair.both("GET", "/v1/stats")
    assert jc == pc == 200 and set(jb) <= set(pb), set(jb) - set(pb)
    assert pb["config"] == jb["config"] and pb["networks"] == jb["networks"]
    assert set(jb["queue"]) <= set(pb["queue"]) and set(jb["health"]) <= set(pb["health"])
    # no XLA compile cache on the port; the sentinel's slice has JAX's keys
    # and scope; no skill tracker attached on either side
    assert pb["compiles"] is None
    assert pb["sentinel"].keys() == jb["sentinel"].keys() and pb["sentinel"]["scope"] == jb["sentinel"]["scope"]
    assert pb["skill"] is None and jb["skill"] is None
    assert pb["fleet"] == jb["fleet"]
    # no ledger attached on either side
    assert pb["verification"] is None and jb["verification"] is None
    # the SLO slice: JAX's keys, and JAX's values when both trackers read at one instant
    assert pb["slo"].keys() == jb["slo"].keys()
    now = time.monotonic()
    assert pair.port.slo.status(now=now) == pair.jax.slo.status(now=now)
    (jc, jh, _), (pc, ph, text) = pair.both("GET", "/metrics")
    assert jc == pc == 200 and jh["Content-Type"] == ph["Content-Type"] == CONTENT_TYPE
    assert "ddr_requests_total" in text and "ddr_health_status" in text
    for path in ("/nope", "/v1/forecast"):
        (jc, _, jb), (pc, _, pb) = pair.both("GET", path)
        assert jc == pc == 404 and jb == pb
    (jc, _, jb), (pc, _, pb) = pair.both("POST", "/nope", {})
    assert jc == pc == 404 and jb == pb
    (jc, _, jb), (pc, _, pb) = pair.both("POST", "/v1/observe", {"network": "basin", "observations": []})
    assert jc == pc == 404 and jb == pb


def _wait_for_captures(timeout: float = 30.0) -> None:
    """Until neither package's profiler capture runs."""
    from ddr_tpu.observability import spans as jax_spans
    from ddr_tpu_torch.observability import spans

    deadline = time.monotonic() + timeout
    while jax_spans.trace_active() or spans.trace_active():
        assert time.monotonic() < deadline, "a profiler capture did not end"
        time.sleep(0.05)


@pytest.mark.parametrize("request_kind", ["profile-default", "profile"])
def test_unported_requests_answer_501_naming_their_item(pair, request_kind, tmp_path, monkeypatch):
    """``POST /v1/profile`` (once refused with 501): both servers answer 202
    with the same body, and each writes its trace under the metrics dir."""
    monkeypatch.setenv("DDR_METRICS_DIR", str(tmp_path))
    path = "/v1/profile" if request_kind == "profile-default" else "/v1/profile?seconds=1"
    _wait_for_captures()
    (jc, _, jb), (pc, _, pb) = pair.both("POST", path, {})
    _wait_for_captures()
    assert jc == pc == 202 and pb == jb
    assert pb == {"status": "capturing", "seconds": 2.0 if request_kind == "profile-default" else 1.0,
                  "trace_dir": str(tmp_path)}
    assert list(tmp_path.glob("capture_*.json"))


@pytest.mark.parametrize("query", ["seconds=0", "seconds=-1", "seconds=abc", "seconds=61"])
def test_profile_refusals_equal_jax(pair, query, tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_METRICS_DIR", str(tmp_path))
    _wait_for_captures()
    (jc, _, jb), (pc, _, pb) = pair.both("POST", f"/v1/profile?{query}", {})
    assert jc == pc == 400 and pb == jb


def test_profile_during_a_capture_answers_409_as_jax(pair, tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_METRICS_DIR", str(tmp_path))
    _wait_for_captures()
    for url in pair.urls:
        first = _request(url, "POST", "/v1/profile?seconds=1", {})
        second = _request(url, "POST", "/v1/profile?seconds=1", {})
        assert first[0] == 202 and second[0] == 409 and "already running" in second[2]["error"]
    _wait_for_captures()


IDENTITY = {"DDR_FLEET_GROUP": "east", "DDR_FLEET_REPLICA": "1", "DDR_FLEET_ROUTER": "local:42"}


def test_stats_fleet_identity_equals_jax(pair, monkeypatch):
    for k, v in IDENTITY.items():
        monkeypatch.setenv(k, v)
    (jc, _, jb), (pc, _, pb) = pair.both("GET", "/v1/stats")
    assert jc == pc == 200 and pb["fleet"] == jb["fleet"] == {"group": "east", "replica": 1, "router": "local:42"}
    monkeypatch.setenv("DDR_FLEET_REPLICA", "r-one")
    monkeypatch.delenv("DDR_FLEET_ROUTER")
    (_, _, jb), (_, _, pb) = pair.both("GET", "/v1/stats")
    assert pb["fleet"] == jb["fleet"] == {"group": "east", "replica": "r-one"}


def test_federated_metrics_answer_as_jax(pair, monkeypatch):
    """Each server federates the other and a dead target: 200 with the
    exposition type, and the text its own package's ``federate_text`` gives
    for the same targets and its registry."""
    from ddr_tpu.observability import federate as jfed
    from ddr_tpu_torch.observability import federate as tfed

    monkeypatch.setenv("DDR_FEDERATE_REPLICAS", f"jax={pair.urls[0]},port={pair.urls[1]},dead=127.0.0.1:9")
    texts = [_request(url, "GET", "/metrics?federated=1") for url in pair.urls]
    for code, headers, _ in texts:
        assert code == 200 and headers["Content-Type"] == CONTENT_TYPE
    targets = tfed.replicas_from_env()
    assert targets == jfed.replicas_from_env()
    assert texts[0][2] == jfed.federate_text(targets, local=("self", pair.jax.metrics))
    assert texts[1][2] == tfed.federate_text(targets, local=("self", pair.port.metrics))
    for _, _, text in texts:
        for label, up in (("jax", 1), ("port", 1), ("dead", 0), ("self", 1)):
            assert f'ddr_federate_up{{replica="{label}"}} {up}' in text


ENSEMBLES = {
    "default": ({"t0": 3, "ensemble": {"members": 4}}, {"X-DDR-Request-Id": "ens-1"}),
    "percentiles and gauges": ({"t0": 20, "gauges": [0, 2],
                                "ensemble": {"members": 6, "percentiles": [5, 50, 95], "seed": 7}},
                               {"X-DDR-Request-Id": "ens-2", "X-DDR-Trace-Id": "trace-ens"}),
    "q_prime": ({"q_prime": "payload", "ensemble": {"members": 3, "seed": 1}}, {"X-DDR-Request-Id": "ens-3"}),
}


@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_ensemble_answers_equal_jax(pair, name):
    """The same ensemble body to both servers: the same keys, request id,
    members and percentiles, bands and member mean within the runoff bound;
    a replayed request id answers the same bands."""
    body, headers = ENSEMBLES[name]
    if body.get("q_prime") == "payload":
        body = {**body, "q_prime": _payload(pair.basin, 5).tolist()}
    (jc, jh, jb), (pc, ph, pb) = pair.both("POST", "/v1/forecast", {"network": "basin", **body}, headers)
    assert jc == pc == 200, (jb, pb)
    assert set(jb) == set(pb), set(jb) ^ set(pb)
    for key in ("request_id", "members", "seed", "percentiles", "network", "model", "version",
                "ensemble_nonfinite_members"):
        assert pb[key] == jb[key], key
    assert pb["engine"] == jb["engine"] and pb["engine"].endswith(f":ensemble{pb['members']}")
    assert ph["X-DDR-Request-Id"] == jh["X-DDR-Request-Id"] == headers["X-DDR-Request-Id"]
    assert np.asarray(pb["runoff"]).shape == np.asarray(jb["runoff"]).shape
    _close(jb["runoff"], pb["runoff"], f"ensemble {name} bands")
    _close(jb["mean"], pb["mean"], f"ensemble {name} mean")
    assert set(pb["worst"]["gauges"]) == set(jb["worst"]["gauges"])
    again = HttpForecastClient(pair.urls[1]).forecast("basin", request_id=headers["X-DDR-Request-Id"],
                                                      **{k: v for k, v in body.items()})
    np.testing.assert_array_equal(again["runoff"], np.asarray(pb["runoff"], np.float32))


ENSEMBLE_ERRORS = {
    "not an object": {"t0": 0, "ensemble": 4},
    "members zero": {"t0": 0, "ensemble": {"members": 0}},
    "members over the cap": {"t0": 0, "ensemble": {"members": 65}},
    "members not a number": {"t0": 0, "ensemble": {"members": "many"}},
    "percentile above 100": {"t0": 0, "ensemble": {"percentiles": [50, 101]}},
    "percentiles empty": {"t0": 0, "ensemble": {"percentiles": []}},
    "percentiles not a list": {"t0": 0, "ensemble": {"percentiles": 50}},
    "t0 out of range": {"t0": 10_000, "ensemble": {}},
    "q_prime and t0": {"t0": 0, "q_prime": [[0.0] * 96] * HORIZON, "ensemble": {}},
    "gauges out of range": {"gauges": [9], "ensemble": {}},
    "unknown model": {"model": "nope", "ensemble": {}},
    "unknown network": {"network": "nope", "ensemble": {}},
}


@pytest.mark.parametrize("name", sorted(ENSEMBLE_ERRORS))
def test_ensemble_errors_map_as_jax(pair, name):
    body = {"network": "basin", **ENSEMBLE_ERRORS[name]}
    (jc, _, jb), (pc, _, pb) = pair.both("POST", "/v1/forecast", body, {"X-DDR-Request-Id": f"ee-{name}"})
    assert pc == jc and pc in (400, 404), (name, jc, jb, pc, pb)
    assert pb.keys() == jb.keys() and pb.get("reason") == jb.get("reason")
    assert pb["request_id"] == jb["request_id"] == f"ee-{name}".replace(" ", "")


def test_observe_with_a_ledger_answers_as_jax(tmp_path):
    """With a ledger attached to each service: single and ensemble answers
    carry the same ``valid_times``; ``POST /v1/observe`` answers the same
    join counts (a re-post counts duplicates), the same 400s for malformed
    bodies, and the two ledgers' rollups agree in their counts."""
    from ddr_tpu.observability.registry import MetricsRegistry as JaxRegistry
    from ddr_tpu.observability.verification import ForecastLedger as JaxLedger
    from ddr_tpu.observability.verification import VerifyConfig as JaxVerifyConfig
    from ddr_tpu_torch.observability.registry import MetricsRegistry
    from ddr_tpu_torch.observability.verification import ForecastLedger, VerifyConfig

    p = Pair(tmp_path)
    try:
        p.jax.attach_verifier(JaxLedger(JaxVerifyConfig(thresholds=("p90", "0.5")), registry=JaxRegistry()))
        p.port.attach_verifier(ForecastLedger(VerifyConfig(thresholds=("p90", "0.5")), registry=MetricsRegistry()))
        single = p.both("POST", "/v1/forecast", {"network": "basin", "t0": 4})
        ens = p.both("POST", "/v1/forecast", {"network": "basin", "t0": 4, "ensemble": {"members": 4}},
                     {"X-DDR-Request-Id": "obs-ens"})
        for (jc, _, jb), (pc, _, pb) in (single, ens):
            assert jc == pc == 200 and pb["valid_times"] == jb["valid_times"] == list(range(5, 5 + HORIZON))
        truth = np.asarray(single[0][2]["runoff"])
        observations = [{"gauge": str(g), "times": list(range(5, 5 + HORIZON)),
                         "values": [float(v) for v in truth[:, g]]} for g in range(truth.shape[1])]
        observations.append({"gauge": 0, "times": [999], "values": [1.0]})  # nothing issued there
        for _ in range(2):  # the second post finds every key already matched
            (jc, _, jb), (pc, _, pb) = p.both("POST", "/v1/observe",
                                              {"network": "basin", "observations": observations})
            assert jc == pc == 200 and pb == jb, (jb, pb)
        for bad in ({"observations": []}, {"network": "basin"}, [1],
                    {"network": "basin", "observations": [{"gauge": 0, "times": [1, 2], "values": [1.0]}]},
                    {"network": "basin", "observations": [{"times": [1], "values": [1.0]}]}):
            (jc, _, jb), (pc, _, pb) = p.both("POST", "/v1/observe", bad)
            assert jc == pc == 400 and jb.keys() == pb.keys(), (bad, jb, pb)
        (jc, _, jb), (pc, _, pb) = p.both("POST", "/v1/observe", raw=b"{oops")
        assert jc == pc == 400
        (_, _, js), (_, _, ps) = p.both("GET", "/v1/stats")
        jv, pv = js["verification"], ps["verification"]
        assert pv.keys() == jv.keys() and pv["scorer"].keys() == jv["scorer"].keys()
        for key in ("forecasts", "cells_pending", "matched", "unmatched_obs", "duplicate_obs", "evicted"):
            assert pv[key] == jv[key], key
        assert pv["scorer"]["samples"] == jv["scorer"]["samples"] == 2 * HORIZON * truth.shape[1]
        np.testing.assert_allclose(pv["scorer"]["scores"]["crps"], jv["scorer"]["scores"]["crps"],
                                   rtol=1e-4, atol=1e-6)
    finally:
        p.close()


def test_http_client_reads_the_port_server(pair):
    client = HttpForecastClient(pair.urls[1])
    assert client.healthy() and client.ready() and client.stats()["ready"]
    ans = client.forecast("basin", t0=3, gauges=[2], priority="interactive", request_id="c-1")
    inproc = pair.port.forecast(network="basin", t0=3, gauges=[2], timeout=60)
    assert ans["request_id"] == "c-1" and ans["runoff"].dtype == np.float32
    # the same kernel on the same shapes: JSON carries float32 values exactly
    np.testing.assert_array_equal(ans["runoff"], inproc["runoff"])
    # a payload in the client's 9-digit encoding reaches the service as the same float32 values
    q = _payload(pair.basin, 9)
    ans = client.forecast("basin", q_prime=q, request_id="c-2")
    np.testing.assert_array_equal(ans["runoff"], pair.port.forecast(network="basin", q_prime=q, timeout=60)["runoff"])
    code, body = client.forecast_response("basin", model="nope")
    assert code == 404 and body["request_id"]
    assert not HttpForecastClient("http://127.0.0.1:9").healthy()


def test_trace_ids_are_suppressed_under_ddr_trace_0(pair, monkeypatch):
    monkeypatch.setenv("DDR_TRACE", "0")
    results = pair.both("POST", "/v1/forecast", {"network": "basin", "t0": 1},
                        {"X-DDR-Trace-Id": "would-be-adopted", "X-DDR-Request-Id": "r0"})
    for code, hdrs, body in results:
        assert code == 200 and "trace_id" not in body and hdrs.get("X-DDR-Trace-Id") is None
        assert body["request_id"] == hdrs["X-DDR-Request-Id"] == "r0"
    errors = pair.both("POST", "/v1/forecast", {"network": "nope"})
    for code, hdrs, body in errors:
        assert code == 404 and "trace_id" not in body and HEX16.fullmatch(body["request_id"])


def test_readyz_in_all_four_states_equals_jax(tmp_path, monkeypatch):
    # warming, then ready after warmup
    p = Pair(tmp_path / "a", warm=False)
    try:
        (jc, _, jb), (pc, _, pb) = p.both("GET", "/readyz")
        assert jc == pc == 503 and jb == pb == {"status": "warming"}
        (jc, _, jb), (pc, _, pb) = p.both("POST", "/v1/forecast", {"network": "basin", "t0": 0},
                                          {"X-DDR-Request-Id": "w"})
        assert jc == pc == 503 and jb["status"] == pb["status"] == "warming" and pb["request_id"] == "w"
        p.warmup()
        (jc, _, jb), (pc, _, pb) = p.both("GET", "/readyz")
        assert jc == pc == 200 and jb == pb == {"status": "ready"}
    finally:
        p.close()
    # warmup-failed: terminal
    p = Pair(tmp_path / "b", warm=False)
    try:
        for svc in (p.jax, p.port):
            monkeypatch.setattr(svc, "_run_batch", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("OOM")))
            with pytest.raises(RuntimeError):
                svc.warmup()
        (jc, _, jb), (pc, _, pb) = p.both("GET", "/readyz")
        assert jc == pc == 503 and jb == pb == {"status": "warmup-failed", "error": "RuntimeError: OOM"}
        assert p.port.stats()["warmup_error"] == "RuntimeError: OOM"
    finally:
        p.close()
    # unhealthy: every batch violates a discharge ceiling of 1e-9
    p = Pair(tmp_path / "c", health=dict(max_discharge=1e-9, bad_batches=1))
    try:
        results = p.both("POST", "/v1/forecast", {"network": "basin", "t0": 0})
        assert [r[0] for r in results] == [200, 200]
        (jc, _, jb), (pc, _, pb) = p.both("GET", "/readyz")
        assert jc == pc == 503 and jb == pb == {"status": "unhealthy", "consecutive_bad": 1}
        text = _request(p.urls[1], "GET", "/metrics")[2]
        assert "ddr_health_status{host=\"0\"} 0" in text
        assert 'ddr_health_violations_total{host="0",reason="discharge-max"}' in text
    finally:
        p.close()


def test_429_and_503_deadline_equal_jax(tmp_path):
    """A queue_cap=1 server whose executor is blocked on a first request: a
    second request with a 50 ms deadline queues, a third is refused 429 with
    Retry-After; once the executor is released, the first answers 200 and the
    second is shed 503 ``deadline``."""
    p = Pair(tmp_path, queue_cap=1)
    outcomes = []
    try:
        for svc, url in ((p.jax, p.urls[0]), (p.port, p.urls[1])):
            entered, gate = threading.Event(), threading.Event()
            run = svc._batcher._execute

            def blocked(key, reqs, run=run, entered=entered, gate=gate):
                entered.set()
                gate.wait(timeout=60)
                return run(key, reqs)

            svc._batcher._execute = blocked
            res = {}

            def post(name, body, headers):
                res[name] = _request(url, "POST", "/v1/forecast", {"network": "basin", **body}, headers)

            first = threading.Thread(target=post, args=("first", {"t0": 0}, {}))
            first.start()
            assert entered.wait(timeout=60)
            second = threading.Thread(target=post, args=("second", {"t0": 1, "deadline_ms": 50},
                                                         {"X-DDR-Request-Id": "late"}))
            second.start()
            deadline = time.monotonic() + 30
            while svc._batcher.stats()["depth"] < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            post("third", {"t0": 2, "priority": "interactive"}, {"X-DDR-Request-Id": "r-429"})
            time.sleep(0.1)  # past the second request's deadline
            gate.set()
            first.join(timeout=60)
            second.join(timeout=60)
            outcomes.append(res)
    finally:
        p.close()
    ref, ours = outcomes
    for name in ("first", "second", "third"):
        assert ours[name][0] == ref[name][0], name
        assert ours[name][2].get("reason") == ref[name][2].get("reason"), name
    assert [ours[n][0] for n in ("first", "second", "third")] == [200, 503, 429]
    assert ours["second"][2]["reason"] == "deadline" and ours["second"][2]["request_id"] == "late"
    assert ours["third"][2]["reason"] == "queue-full" and ours["third"][1]["Retry-After"] == "1"
    assert ours["third"][2]["request_id"] == ours["third"][1]["X-DDR-Request-Id"] == "r-429"


def test_q_prime_json_carries_every_float32_exactly():
    """Values over the whole float32 range, subnormals and signed zeros
    included, parse back (through float64, as the server parses) to the same
    bits; the text is shorter than ``json.dumps`` of the float64 values; a
    non-finite payload falls back to ``json.dumps``."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal(200_000) * 10.0 ** rng.integers(-44, 38, 200_000)).astype(np.float32)
    x[:6] = [0.0, -0.0, 1.4e-45, 1.1754942e-38, 3.4028235e38, -3.4028235e38]
    q = x.reshape(200, 1000)
    text = q_prime_json(q)
    back = np.asarray(json.loads(text), dtype=np.float32)
    assert np.array_equal(back.view(np.uint32), q.view(np.uint32))
    assert len(text) < 0.8 * len(json.dumps(q.tolist()))
    bad = q[:2].copy()
    bad[0, 0] = np.nan
    assert q_prime_json(bad) == json.dumps(bad.tolist())
