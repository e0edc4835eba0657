"""The port's metrics federation against the JAX package's
(``ddr_tpu/observability/federate.py``), byte for byte.

- ``parse_replicas`` and ``inject_label`` give JAX's output on a table of
  specs and sample lines (labels, timestamps, escapes, garbage);
  ``replicas_from_env`` and ``max_series_from_env`` read the same
  environments as JAX's;
- ``federate_text`` over live scrape targets (standard-library HTTP servers
  answering fixed exposition text, histogram children included), a dead
  target, the series cap, and a local registry filled by the same seeded
  operations on both sides gives JAX's text byte for byte;
- ``GET /metrics?federated=1`` on the port's server answers 200 with that
  text, its own registry as ``replica="self"``.
"""

from __future__ import annotations

import socket
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from ddr_tpu.observability import federate as jfed
from ddr_tpu.observability.registry import MetricsRegistry as JaxRegistry
from ddr_tpu_torch.observability import federate as tfed
from ddr_tpu_torch.observability.registry import MetricsRegistry

SPECS = [
    "", "a=http://h:9100,b=h2:9100/metrics", "h1:9100, ,h2:9101/custom",
    'we"ird\\=http://x:1/metrics,https://secure:443', "http://bare:80", "x=y=z:1",
    "lab el=127.0.0.1:8080/metrics,lab\nel=127.0.0.1:8081",
]


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_parse_replicas_equals_jax(spec, monkeypatch):
    assert tfed.parse_replicas(spec) == jfed.parse_replicas(spec)
    monkeypatch.setenv("DDR_FEDERATE_REPLICAS", spec)
    assert tfed.replicas_from_env() == jfed.replicas_from_env()


LINES = [
    "ddr_requests_total 3", 'ddr_requests_total{status="ok",host="0"} 12', "m{} 1.5", "m 2 1700000000",
    'm{a="x\\"y"} NaN', "# HELP m help", "not a sample", "", "m +Inf", 'bucket_le{le="0.5"} 4',
    "9bad 1", "m{a=\"b\"}", "metric:name_1 -3.25e-05",
]


@pytest.mark.parametrize("value", ["self", 'r"0', "back\\slash", "fleet-r1"])
def test_inject_label_equals_jax(value):
    for line in LINES:
        assert tfed.inject_label(line, "replica", value) == jfed.inject_label(line, "replica", value), line


@pytest.mark.parametrize("raw", [None, "", "50", "0", "-3", "lots"])
def test_max_series_from_env_equals_jax(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("DDR_FEDERATE_MAX_SERIES", raising=False)
    else:
        monkeypatch.setenv("DDR_FEDERATE_MAX_SERIES", raw)
    assert tfed.max_series_from_env() == jfed.max_series_from_env()
    assert tfed.DEFAULT_MAX_SERIES == jfed.DEFAULT_MAX_SERIES


def _fill(registry, seed: int) -> None:
    """Seeded operations on one registry: counters, gauges, histograms."""
    rng = np.random.default_rng(seed)
    c = registry.counter("ddr_requests_total", "Forecast requests", labels=("status",))
    g = registry.gauge("ddr_queue_depth", "Queue depth")
    h = registry.histogram("ddr_request_latency_seconds", "Latency", labels=("network",),
                           buckets=(0.01, 0.1, 1.0))
    for _ in range(20):
        c.inc(float(rng.integers(1, 4)), status=str(rng.choice(["ok", "shed"])))
        h.observe(float(rng.exponential(0.2)), network=str(rng.choice(["a", "b"])))
    g.set(float(rng.integers(0, 9)))


TARGET_TEXT = [
    "# HELP ddr_requests_total Forecast requests\n# TYPE ddr_requests_total counter\n"
    'ddr_requests_total{host="0",status="ok"} 41\n'
    "# HELP ddr_batch_seconds Batch wall\n# TYPE ddr_batch_seconds histogram\n"
    'ddr_batch_seconds_bucket{le="0.1"} 3\nddr_batch_seconds_bucket{le="+Inf"} 5\n'
    "ddr_batch_seconds_sum 0.7\nddr_batch_seconds_count 5\n"
    "# TYPE ddr_summary summary\nddr_summary{quantile=\"0.5\"} 2\nddr_summary_sum 9\nddr_summary_count 4\n"
    "garbage line here\n\nddr_untyped 7 1700000000\n",
    "# HELP ddr_requests_total A different help text\n# TYPE ddr_requests_total counter\n"
    'ddr_requests_total{host="1",status="shed"} 2\n'
    "ddr_batch_seconds_count 9\n# TYPE ddr_queue_depth gauge\nddr_queue_depth 3\n",
]


class _Text(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        data = self.server.text.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture(scope="module")
def targets():
    """Two live scrape targets and one dead address."""
    servers = []
    for text in TARGET_TEXT:
        srv = ThreadingHTTPServer(("127.0.0.1", 0), _Text)
        srv.text = text
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    yield [(f"r{i}", f"http://127.0.0.1:{s.server_address[1]}/metrics") for i, s in enumerate(servers)] + [
        ("dead", f"http://127.0.0.1:{dead}/metrics")]
    for srv in servers:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("max_series", [None, 5, 1, 0])
@pytest.mark.parametrize("local", [False, True])
def test_federate_text_equals_jax(targets, max_series, local):
    lt, lj = None, None
    if local:
        treg, jreg = MetricsRegistry(const_labels={"host": 0}), JaxRegistry(const_labels={"host": 0})
        _fill(treg, 5)
        _fill(jreg, 5)
        lt, lj = ("self", treg), ("self", jreg)
    out = tfed.federate_text(targets, timeout=2.0, max_series=max_series, local=lt)
    ref = jfed.federate_text(targets, timeout=2.0, max_series=max_series, local=lj)
    assert out == ref
    assert 'ddr_federate_up{replica="dead"} 0' in out and 'ddr_federate_up{replica="r0"} 1' in out
    if max_series is None:
        # histogram children file under their family's one header
        assert out.count("# TYPE ddr_batch_seconds histogram") == 1
        assert 'ddr_batch_seconds_count{replica="r1"} 9' in out
    else:  # the cap drops the overflow and says how much
        assert "ddr_federate_dropped_series 0\n" not in out


def test_federated_metrics_endpoint_answers_the_federated_text(targets, monkeypatch):
    from ddr_tpu_torch.observability.prometheus import CONTENT_TYPE
    from ddr_tpu_torch.serving.http_api import serve_http

    class Svc:  # what the handler reads of a service on this path
        metrics = MetricsRegistry(const_labels={"host": 0})

    _fill(Svc.metrics, 9)
    spec = ",".join(f"{label}={url}" for label, url in targets)
    monkeypatch.setenv("DDR_FEDERATE_REPLICAS", spec)
    server = serve_http(Svc(), host="127.0.0.1", port=0)
    try:
        with urllib.request.urlopen(server.url + "/metrics?federated=1", timeout=30) as resp:
            assert resp.status == 200 and resp.headers["Content-Type"] == CONTENT_TYPE
            text = resp.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    jreg = JaxRegistry(const_labels={"host": 0})
    _fill(jreg, 9)
    assert text == jfed.federate_text(jfed.parse_replicas(spec), local=("self", jreg))
    assert 'ddr_federate_up{replica="self"} 1' in text
