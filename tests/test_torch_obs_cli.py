"""``ddr obs`` on the port (``ddr_tpu_torch/observability/obs_cli.py``)
against the JAX package's command.

- ``federate --once`` over two live exporters (each a seeded registry served
  by the port's standalone exporter) and a dead address prints JAX's text,
  with ``replica`` labels, and exits as JAX's does without targets;
- ``federate --port 0`` answers ``GET /metrics`` with the federated text of
  the same targets and 404 elsewhere, as JAX's aggregator does;
- ``bottleneck`` on seeded step logs (with and without ``loop_s``, every
  bottleneck class) and on a log without steps prints JAX's text and exits
  with JAX's code.

Every value is drawn from numpy generators seeded with fixed integers.
"""

from __future__ import annotations

import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from ddr_tpu.observability import obs_cli as jobs
from ddr_tpu_torch.observability import obs_cli as tobs
from ddr_tpu_torch.observability.prometheus import MetricsHTTPServer
from ddr_tpu_torch.observability.registry import MetricsRegistry


def _fill(registry: MetricsRegistry, seed: int) -> None:
    rng = np.random.default_rng(seed)
    c = registry.counter("ddr_steps_total", "Training steps", labels=("engine",))
    h = registry.histogram("ddr_step_seconds", "Step wall", labels=("engine",), buckets=(0.01, 0.1, 1.0))
    g = registry.gauge("ddr_prefetch_depth", "Prefetch depth")
    for _ in range(10):
        engine = str(rng.choice(["single", "stacked"]))
        c.inc(engine=engine)
        h.observe(float(rng.exponential(0.2)), engine=engine)
    g.set(float(rng.integers(0, 4)))


@pytest.fixture(scope="module")
def targets():
    """Two live exporters of seeded registries, and a dead address."""
    import threading

    servers = []
    for seed in (0, 1):
        reg = MetricsRegistry(const_labels={"host": seed})
        _fill(reg, seed)
        srv = MetricsHTTPServer(reg, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    yield ",".join([f"r{i}={s.url}" for i, s in enumerate(servers)] + [f"dead=http://127.0.0.1:{dead}/metrics"])
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _run(mod, argv, capsys) -> tuple[int, str]:
    code = mod.main(argv)
    return code, capsys.readouterr().out


def test_federate_once_equals_jax(targets, capsys):
    ours = _run(tobs, ["federate", "--once", "--replicas", targets, "--timeout", "2"], capsys)
    ref = _run(jobs, ["federate", "--once", "--replicas", targets, "--timeout", "2"], capsys)
    assert ours == ref and ours[0] == 0
    text = ours[1]
    assert 'replica="r0"' in text and 'replica="r1"' in text and 'ddr_federate_up{replica="dead"} 0' in text


def test_federate_without_targets_exits_as_jax(monkeypatch, capsys):
    monkeypatch.delenv("DDR_FEDERATE_REPLICAS", raising=False)
    assert _run(tobs, ["federate", "--once"], capsys) == _run(jobs, ["federate", "--once"], capsys)
    assert tobs.main(["federate", "--once"]) == 2


def _get(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


def test_federate_port_zero_answers_as_jax(targets):
    from ddr_tpu.observability.federate import parse_replicas

    answers = []
    for mod in (tobs, jobs):
        srv = mod.serve_federation(parse_replicas(targets), host="127.0.0.1", port=0, scrape_timeout=2.0)
        try:
            answers.append((_get(srv.url), _get(srv.url.replace("/metrics", "/nope"))[0]))
        finally:
            srv.shutdown()
            srv.server_close()
    assert answers[0] == answers[1]
    (code, text), missing = answers[0]
    assert code == 200 and 'replica="r1"' in text and missing == 404


def _step_log(path, seed: int, loop_s: bool) -> None:
    rng = np.random.default_rng(seed)
    lines = [{"event": "run_start", "t": 0.0, "wall": 100.0, "host": 0, "pid": 1, "seq": 0, "cmd": "train"}]
    for i in range(30):
        phases = {"data_load": float(rng.exponential(0.05)), "host_prep": float(rng.exponential(0.2)),
                  "device_step": float(rng.exponential(0.3)), "eval": float(rng.exponential(0.01)),
                  "checkpoint": float(rng.exponential(0.4 if i % 5 == 0 else 0.02))}
        step = {"event": "step", "t": float(i + 1), "wall": 101.0 + i, "host": 0, "pid": 1, "seq": i + 1,
                "epoch": 1, "batch": i, "loss": 1.0, "phases": phases}
        if loop_s:
            step["loop_s"] = sum(phases.values()) * float(rng.uniform(0.6, 1.4))
        lines.append(step)
    path.write_text("".join(json.dumps(e) + "\n" for e in lines) + "not json\n")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("loop_s", [True, False])
def test_bottleneck_equals_jax(tmp_path, capsys, seed, loop_s):
    path = tmp_path / "run_log.train.jsonl"
    _step_log(path, seed, loop_s)
    ours = _run(tobs, ["bottleneck", str(path)], capsys)
    ref = _run(jobs, ["bottleneck", str(tmp_path), "--idle-frac", "0.25"], capsys)
    assert ours == ref and ours[0] == 0 and "pipeline verdict" in ours[1]
    assert _run(tobs, ["bottleneck", str(path), "--idle-frac", "0.6"], capsys) == _run(
        jobs, ["bottleneck", str(path), "--idle-frac", "0.6"], capsys)


def test_bottleneck_without_steps_exits_as_jax(tmp_path, capsys):
    path = tmp_path / "run_log.serve.jsonl"
    path.write_text(json.dumps({"event": "run_start", "t": 0.0, "wall": 1.0, "host": 0, "pid": 1, "seq": 0}) + "\n")
    assert _run(tobs, ["bottleneck", str(path)], capsys) == _run(jobs, ["bottleneck", str(path)], capsys)
    assert tobs.main(["bottleneck", str(path)]) == 1
    assert tobs.main(["bottleneck", str(tmp_path / "missing.jsonl")]) == jobs.main(
        ["bottleneck", str(tmp_path / "missing.jsonl")]) == 2
