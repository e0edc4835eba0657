"""The port's run recorder against the JAX package's, on the CPU.

The event vocabulary and schema version are JAX's, and every literal
``emit("...")`` in the port names a registered type (an ``ast`` scan, as the
JAX package's lint rule does). ``PhaseTimer``, ``summarize_phases``,
``Throughput`` and the ``Recorder`` give JAX's results for the same calls
under one fake clock, ``span`` JAX's events and trace ids, and
``DDR_PROFILE_DIR`` a ``torch.profiler`` trace holding the spans.
``replay_dir`` on the same files equals JAX's. Each command's run log is
held to JAX's in ``tests/test_torch_run_logs.py``.
"""

from __future__ import annotations

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest

from ddr_tpu.observability import events as jev
from ddr_tpu.observability import phases as jph
from ddr_tpu.observability import throughput as jtp
from ddr_tpu.scripts import verify as jax_verify
from ddr_tpu_torch.observability import events as tev
from ddr_tpu_torch.observability import phases as tph
from ddr_tpu_torch.observability import throughput as ttp
from ddr_tpu_torch.scripts import verify

ROOT = Path(__file__).resolve().parents[1]
def _events(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def test_event_vocabulary_equals_jax():
    assert tev.EVENT_TYPES == jev.EVENT_TYPES
    assert tev.SCHEMA_VERSION == jev.SCHEMA_VERSION == 5
    assert tph.STEP_PHASES == jph.STEP_PHASES


def test_every_emitted_event_is_registered():
    sites = []
    for path in sorted((ROOT / "ddr_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("emit", "_emit") and node.args
                    and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
                sites.append((f"{path.relative_to(ROOT)}:{node.lineno}", node.args[0].value))
    unknown = [(where, name) for where, name in sites if name not in tev.EVENT_TYPES]
    assert not unknown, unknown
    names = {name for _, name in sites}
    assert {"run_start", "run_end", "step", "eval", "span", "heartbeat", "health", "recovery", "verify",
            "serve_request", "serve_batch", "serve_shed", "slo"} <= names, names


class _Clock:
    """``time.perf_counter`` stepping by the given increments."""

    def __init__(self, steps):
        self.now, self.steps = 100.0, list(steps)

    def __call__(self):
        self.now += self.steps.pop(0) if self.steps else 0.25
        return self.now


def _drive_timer(module, monkeypatch):
    monkeypatch.setattr(module.time, "perf_counter", _Clock([0.0, 0.5, 0.0, 1.25, 0.0, 0.125, 0.0, 2.0]))
    timer = module.PhaseTimer()
    step: dict[str, float] = {}
    with timer.phase("data_load", into=step):
        pass
    with timer.phase("device_step", into=step):
        pass
    with timer.phase("data_load", into=step):
        pass
    with pytest.raises(KeyError):
        with timer.phase("checkpoint"):
            raise KeyError("the phase is recorded on the way out")
    return timer.totals(), timer.summary(), step


def test_phase_timer_and_summary_match_jax(monkeypatch):
    assert _drive_timer(tph, monkeypatch) == _drive_timer(jph, monkeypatch)
    steps = [
        {"phases": {"data_load": 0.5, "device_step": 2.0, "eval": 0.25}, "loop_s": 3.0},
        {"phases": {"data_load": 0.25, "device_step": "1.5", "checkpoint": None}, "loop_s": 2.0},
        {"phases": {"host_prep": 0.125}},
        {"phases": "not a dict", "loop_s": 1.0},
        {"loop_s": 0.0, "phases": {"device_step": 1.0}},
        {},
    ]
    assert tph.summarize_phases(steps) == jph.summarize_phases(steps)
    assert tph.summarize_phases([]) == jph.summarize_phases([]) == {}


def test_throughput_matches_jax(monkeypatch):
    out = []
    for module in (ttp, jtp):
        tp = module.Throughput(label="train")
        rates = [tp.record(64, 24, s) for s in (0.5, 0.0, -1.0, math.nan, 2e-7, 1.5)]
        monkeypatch.setattr(module.time, "perf_counter", _Clock([0.0, 0.75]))
        with tp.batch(10, 5):
            pass
        out.append((rates, tp.total_reach_timesteps, tp.total_seconds, tp.batches, tp.last_rate,
                    tp.last_seconds, tp.rate, tp.format()))
    assert out[0] == out[1]
    assert ttp.MIN_BATCH_SECONDS == jtp.MIN_BATCH_SECONDS


def _strip(ev: dict) -> dict:
    return {k: v for k, v in ev.items() if k not in ("t", "wall", "pid", "duration_s")}


def _drive_recorder(module, path, **kw):
    rec = module.Recorder(path, tags={"cell": "x"}, **kw)
    seen = []
    rec.add_hook(seen.append)
    rec.add_hook(seen.append)  # the same hook twice is one hook
    for i in range(40):
        rec.emit("step", epoch=1, batch=i, loss=np.float32(0.5 + i), note=Path("a/b"))
    rec.record_span("outer/inner", 0.25)
    rec.emit("not-a-type", x=1)
    rec.merge_summary("phases", {"device_step": 1.0})
    rec.close(status="interrupted")
    rec.emit("step", late=True)  # after close: dropped
    rec.close()
    return seen


def test_recorder_matches_jax(tmp_path):
    """The same emits, flush cadence and size bound: the same lines, the
    same rotated segments, the same hook records and ``run_end`` rollup."""
    for kw in ({}, {"flush_every": 7, "max_bytes": 20000}):
        ours = _drive_recorder(tev, tmp_path / "port" / "run_log.x.jsonl", **kw)
        ref = _drive_recorder(jev, tmp_path / "jax" / "run_log.x.jsonl", **kw)
        assert [_strip(e) for e in ours] == [_strip(e) for e in ref]
        files = sorted(p.name for p in (tmp_path / "jax").iterdir())
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files
        for name in files:
            assert [_strip(e) for e in _events(tmp_path / "port" / name)] == [
                _strip(e) for e in _events(tmp_path / "jax" / name)], name
        if kw:
            assert len(files) > 1  # the bound rotated the log
    for status, exc in (("ok", None), ("interrupted", KeyboardInterrupt), ("error:ValueError", ValueError)):
        logs = []
        for module, side in ((tev, "port"), (jev, "jax")):
            base = tmp_path / f"rt_{side}_{status}"
            try:
                with module.run_telemetry(None, "cmd", base_dir=base, mode="x") as rec:
                    assert module.get_recorder() is rec
                    rec.emit("eval", batch=0)
                    if exc is not None:
                        raise exc()
            except (KeyboardInterrupt, ValueError):
                pass
            assert module.get_recorder() is None
            logs.append([_strip(e) for e in _events(base / "run_log.cmd.jsonl")])
        assert logs[0] == logs[1] and logs[0][-1]["status"] == status
    with tev.run_telemetry(None, "cmd") as rec:  # no directory: telemetry off
        assert rec is None and tev.get_recorder() is None


def test_replay_dir_matches_jax(tmp_path):
    """Both packages' ``verify --synthetic`` logs, one of them with a torn
    line, folded by both ``replay_dir``s: the same rollup."""
    vf = ["--synthetic", "--n", "32", "--horizon", "6", "--members", "4", "--requests", "3", "--label", "x"]
    assert verify.main([*vf, "--out", str(tmp_path / "port"), "device=cpu"]) == 0
    assert jax_verify.main([*vf, "--out", str(tmp_path / "jax"), "--n", "48"]) == 0
    logs = tmp_path / "logs"
    logs.mkdir()
    (logs / "run_log.verify.jsonl").write_text((tmp_path / "port" / "run_log.verify.jsonl").read_text()
                                               + "{torn line\n\n")
    (logs / "run_log.verify.host1.jsonl").write_text((tmp_path / "jax" / "run_log.verify.jsonl").read_text())
    (logs / "run_log.train.jsonl").write_text('{"event": "step"}\n')
    ours, ref = verify.replay_dir(logs), jax_verify.replay_dir(logs)
    assert ours == ref and ours["files"] == 2 and ours["matched_samples"] > 0
    assert verify.replay_dir(tmp_path / "jax_vf_missing") is None is jax_verify.replay_dir(tmp_path / "missing")


def _drive_spans(spans_module, events_module, base, trace_on, monkeypatch):
    monkeypatch.setenv("DDR_TRACE", "1" if trace_on else "0")

    @spans_module.spanned("decorated")
    def work():
        return 3

    with events_module.run_telemetry(None, "spans", base_dir=base):
        with spans_module.span("outer"):
            with spans_module.span("inner"):
                pass
            with spans_module.span("quiet", emit=False):
                assert work() == 3
        with pytest.raises(ValueError):
            with spans_module.span("raises"):
                raise ValueError("the span is recorded on the way out")
    return [e for e in _events(base / "run_log.spans.jsonl") if e["event"] == "span"]


@pytest.mark.parametrize("trace_on", [True, False])
def test_spans_match_jax(tmp_path, monkeypatch, trace_on):
    """Nested paths, parents, ``emit=False``, the decorator and a raising body:
    the same span events as JAX's, trace ids only while ``DDR_TRACE`` is on."""
    from ddr_tpu.observability import spans as jsp
    from ddr_tpu_torch.observability import spans as tsp

    ours = _drive_spans(tsp, tev, tmp_path / "port", trace_on, monkeypatch)
    ref = _drive_spans(jsp, jev, tmp_path / "jax", trace_on, monkeypatch)
    assert [(e["name"], sorted(e)) for e in ours] == [(e["name"], sorted(e)) for e in ref]
    assert [e["name"] for e in ours] == ["outer/inner", "outer/quiet/decorated", "outer", "raises"]
    if trace_on:
        by_name = {e["name"]: e for e in ours}
        assert by_name["outer/inner"]["parent_id"] == by_name["outer"]["span_id"]
        assert by_name["outer/inner"]["trace_id"] == by_name["outer"]["trace_id"]
        assert "parent_id" not in by_name["raises"]


def test_profile_dir_writes_a_torch_trace(tmp_path, monkeypatch):
    """``DDR_PROFILE_DIR`` runs ``torch.profiler`` over a ``trace()`` block
    (nested blocks start nothing), and spans show on its timeline."""
    import torch

    from ddr_tpu_torch.observability import spans as tsp

    monkeypatch.setenv("DDR_PROFILE_DIR", str(tmp_path / "prof"))
    with tsp.trace():
        assert tsp.trace_active()
        with tsp.trace(), tsp.span("ddr-test-region"):
            torch.ones(64).sum()
    assert not tsp.trace_active()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "ddr-test-region" for e in trace["traceEvents"])
    monkeypatch.delenv("DDR_PROFILE_DIR")
    with tsp.trace():  # no directory: no profiler
        assert not tsp.trace_active()
