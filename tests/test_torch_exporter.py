"""The port's standalone Prometheus exporter and the training events' metric
mapping, against the JAX package's (``ddr_tpu/observability/prometheus.py``).

- ``run_telemetry`` with ``DDR_PROM_PORT=0`` starts the exporter on an
  ephemeral port and stamps it as ``prom_port`` on ``run_start``, as JAX's
  does; the port answers ``GET /metrics`` with the live registry (a step
  emitted inside the run is counted) and 404 elsewhere;
- a malformed or unbindable ``DDR_PROM_PORT`` starts nothing in either
  package, and a second start returns the running exporter;
- the same seeded ``step``, ``eval`` and ``heartbeat`` records (with phases,
  prefetch depths, a missing loss) through each package's ``event_tee`` give
  the same exposition text, byte for byte, and so do the two exporters
  serving those registries.

Every record is drawn from numpy generators seeded with fixed integers.
"""

from __future__ import annotations

import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from ddr_tpu.observability import events as jevents
from ddr_tpu.observability import prometheus as jprom
from ddr_tpu.observability.registry import MetricsRegistry as JaxRegistry
from ddr_tpu_torch.observability import events as tevents
from ddr_tpu_torch.observability import prometheus as tprom
from ddr_tpu_torch.observability.registry import MetricsRegistry


@pytest.fixture(autouse=True)
def _no_exporters():
    tprom.stop_exporter()
    jprom.stop_exporter()
    yield
    tprom.stop_exporter()
    jprom.stop_exporter()


def _get(url: str) -> tuple[int, str, str]:
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _records(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        kind = ("step", "eval", "heartbeat")[int(rng.integers(3))]
        if kind == "step":
            rec = {"event": "step", "engine": ["single", "stacked"][int(rng.integers(2))],
                   "seconds": float(rng.uniform(0.001, 3.0)),
                   "phases": {"data_load": float(rng.uniform(0, 0.2)), "device_step": float(rng.uniform(0, 2)),
                              "checkpoint": float(rng.uniform(0, 0.05)), "bad": "x"}}
            if i % 4:
                rec["loss"] = float(rng.uniform(0.1, 5.0))
        elif kind == "eval":
            rec = {"event": "eval", "seconds": float(rng.uniform(0, 1))}
        else:
            rec = {"event": "heartbeat", "step": i}
            if i % 3:
                rec["prefetch_depth"] = int(rng.integers(0, 4))
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_training_events_expose_as_jax(seed):
    ours, ref = MetricsRegistry(const_labels={"host": 0}), JaxRegistry(const_labels={"host": 0})
    for rec in _records(seed):
        tprom.event_tee(dict(rec), ours)
        jprom.event_tee(dict(rec), ref)
    text = tprom.render_text(ours)
    assert text == jprom.render_text(ref)
    assert "ddr_steps_total" in text and "ddr_heartbeats_total" in text and "ddr_evals_total" in text


def test_exporters_serve_the_same_text():
    ours, ref = MetricsRegistry(), JaxRegistry()
    for rec in _records(3):
        tprom.event_tee(dict(rec), ours)
        jprom.event_tee(dict(rec), ref)
    t_srv = tprom.start_exporter(0, host="127.0.0.1", registry=ours)
    j_srv = jprom.start_exporter(0, host="127.0.0.1", registry=ref)
    assert tprom.start_exporter(0) is t_srv  # one exporter a process
    t_code, t_type, t_text = _get(t_srv.url)
    j_code, j_type, j_text = _get(j_srv.url)
    assert t_code == j_code == 200 and t_type == j_type == tprom.CONTENT_TYPE
    assert t_text == j_text
    assert _get(t_srv.url.replace("/metrics", "/nope"))[0] == _get(j_srv.url.replace("/metrics", "/nope"))[0] == 404


def test_run_telemetry_stamps_the_exporters_port(tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_PROM_PORT", "0")
    starts = {}
    for name, events, prom in (("port", tevents, tprom), ("jax", jevents, jprom)):
        with events.run_telemetry(None, "train", base_dir=tmp_path / name) as rec:
            rec.emit("step", engine="single", seconds=0.5, loss=1.0, phases={"device_step": 0.4})
            first = json.loads((tmp_path / name / "run_log.train.jsonl").read_text().splitlines()[0])
            starts[name] = first
            code, _, text = _get(f"http://127.0.0.1:{first['prom_port']}/metrics")
            assert code == 200 and 'ddr_steps_total{engine="single"' in text
        prom.stop_exporter()
    for first in starts.values():
        assert first["event"] == "run_start" and isinstance(first["prom_port"], int) and first["prom_port"] > 0
    assert starts["port"].keys() == starts["jax"].keys()


@pytest.mark.parametrize("value", ["nine", "taken"])
def test_bad_prom_port_starts_nothing(monkeypatch, value):
    busy = socket.socket()
    busy.bind(("0.0.0.0", 0))
    busy.listen(1)
    try:
        monkeypatch.setenv("DDR_PROM_PORT", value if value != "taken" else str(busy.getsockname()[1]))
        assert tprom.maybe_start_exporter_from_env() is None
        assert jprom.maybe_start_exporter_from_env() is None
    finally:
        busy.close()
    monkeypatch.delenv("DDR_PROM_PORT")
    assert tprom.maybe_start_exporter_from_env() is None
