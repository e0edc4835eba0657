"""Each command's run log, the port's against the JAX package's, on the CPU
synthetic twin: ``ddr train`` event for event (the same sequence of non-span
types, the same span names under the same parents, the same keys and step
fields), ``ddr test``, ``ddr route``, ``ddr loadtest`` and ``ddr verify
--synthetic`` by event types and keys. Timings, pids and device fields are
set aside.

JAX's logs hold events the port does not write, named below
(:data:`JAX_ONLY_EVENTS`, :func:`jax_only_span`): the XLA compile events
and program cards (the port builds kernels with ``nvcc`` and has no compile
cache to track; only ``ddr profile`` writes cards), the spans JAX emits
while tracing its jitted step (once per compile), and the second ``eval``
phase a JAX step spends drawing its validation plot (matplotlib). Skill,
drift and heartbeat events, and the skill, drift, pipeline and sentinel
rollups, are in both.
"""

from __future__ import annotations

import collections
import json
from pathlib import Path

import numpy as np
import pytest

from ddr_tpu.scripts import loadtest as jax_loadtest
from ddr_tpu.scripts import router as jax_router
from ddr_tpu.scripts import test as jax_test
from ddr_tpu.scripts import train as jax_train
from ddr_tpu.scripts import verify as jax_verify
from ddr_tpu_torch.scripts import loadtest, router, test, train, verify

CONFIG = "examples/synthetic/config.yaml"
#: Event types of JAX's logs that the port does not write.
JAX_ONLY_EVENTS = {"compile", "program_card"}
#: JAX's run_end rollup of its compile cache.
JAX_ONLY_SUMMARY = {"compile"}
#: Fields whose values are timings, process ids, device names or run paths.
SET_ASIDE = {"t", "wall", "pid", "seconds", "loop_s", "reach_timesteps_per_sec", "duration_s", "device",
             "phases", "span_id", "summary", "thread"}


def jax_only_span(name: str) -> bool:
    """Spans JAX emits while tracing its jitted step: the route's core and
    the step's loss closure."""
    return name.endswith("wavefront-core") or name == "step-single/loss"


def _events(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def _same_keys(ours: list[dict], ref: list[dict], label: str) -> None:
    """The same event types (less the JAX-only ones) and, per type, the same keys."""
    keys = [collections.defaultdict(set), collections.defaultdict(set)]
    for k, evs in zip(keys, (ours, ref)):
        for e in evs:
            if e["event"] not in JAX_ONLY_EVENTS and not (e["event"] == "span" and jax_only_span(e["name"])):
                k[e["event"]] |= set(e)
    assert dict(keys[0]) == dict(keys[1]), label
    a = {k for k in ours[-1]["summary"]}
    b = {k for k in ref[-1]["summary"]} - JAX_ONLY_SUMMARY
    assert a == b, (label, a ^ b)
    assert ours[0]["event"] == "run_start" and ours[-1]["event"] == "run_end"
    assert ours[-1]["status"] == ref[-1]["status"] == "ok"
    assert {k: v for k, v in ours[0].items() if k not in SET_ASIDE} == {
        k: v for k, v in ref[0].items() if k not in SET_ASIDE}, label


def test_train_run_log_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DDR_RUN_ID", "twin")  # one trace seed for both runs
    ov = [CONFIG, "synthetic_segments=32", "experiment.epochs=1"]
    monkeypatch.setenv("DDR_METRICS_DIR", str(tmp_path / "jax"))
    assert jax_train.main([*ov, f"params.save_path={tmp_path / 'jax_run'}"]) == 0
    monkeypatch.setenv("DDR_METRICS_DIR", str(tmp_path / "port"))
    assert train.main([*ov, "device=cpu", f"params.save_path={tmp_path / 'port_run'}"]) == 0
    ours, ref = (_events(tmp_path / side / "run_log.train.jsonl") for side in ("port", "jax"))
    _same_keys(ours, ref, "train")

    def kept(evs):
        return [e for e in evs if e["event"] not in JAX_ONLY_EVENTS]

    assert [e["event"] for e in kept(ours) if e["event"] != "span"] == [
        e["event"] for e in kept(ref) if e["event"] != "span"]
    spans = []
    for evs in (ours, ref):
        c = collections.Counter((e["name"], e["trace_id"], e.get("parent_id")) for e in evs
                                if e["event"] == "span" and not jax_only_span(e["name"]))
        spans.append(c)
    # JAX's step spends a second eval phase drawing its validation plot
    plots = collections.Counter({k: v // 2 for k, v in spans[1].items() if k[0] == "phase/eval"})
    spans[1] = +(spans[1] - plots)
    assert spans[0] == spans[1]
    steps = [[e for e in evs if e["event"] == "step"] for evs in (ours, ref)]
    assert len(steps[0]) == len(steps[1]) >= 2
    for a, b in zip(*steps):
        assert {k: v for k, v in a.items() if k not in SET_ASIDE | {"seq", "loss"}} == {
            k: v for k, v in b.items() if k not in SET_ASIDE | {"seq", "loss"}}
        assert set(a["phases"]) == set(b["phases"]) == {"data_load", "host_prep", "device_step", "eval",
                                                        "checkpoint"}
        assert a["loop_s"] >= a["phases"]["device_step"] > 0 and np.isfinite(a["loss"])
    summary = ours[-1]["summary"]
    assert summary["throughput"]["batches"] == len(steps[0])
    assert summary["phases"]["phases"]["device_step"]["count"] == len(steps[0])
    assert summary["events"]["step"] == len(steps[0])


EVAL_OVERRIDES = [CONFIG, "synthetic_segments=32", "experiment.end_time=1981/10/22", "experiment.batch_size=6"]


@pytest.mark.parametrize("command", ["test", "route"])
def test_evaluation_run_logs_match_jax(tmp_path, monkeypatch, command):
    ours_main, ref_main = {"test": (test.main, jax_test.main), "route": (router.main, jax_router.main)}[command]
    monkeypatch.setenv("DDR_METRICS_DIR", str(tmp_path / "jax"))
    assert ref_main([*EVAL_OVERRIDES, f"params.save_path={tmp_path / 'jax_run'}"]) == 0
    monkeypatch.setenv("DDR_METRICS_DIR", str(tmp_path / "port"))
    assert ours_main([*EVAL_OVERRIDES, "device=cpu", f"params.save_path={tmp_path / 'port_run'}"]) == 0
    ours, ref = (_events(tmp_path / side / f"run_log.{command}.jsonl") for side in ("port", "jax"))
    _same_keys(ours, ref, command)
    evals = [[{k: v for k, v in e.items() if k not in SET_ASIDE | {"seq"}} for e in evs if e["event"] == "eval"]
             for evs in (ours, ref)]
    assert evals[0] == evals[1] and len(evals[0]) >= 3
    span = {"test": "eval-batch", "route": "route-batch"}[command]
    assert [e["name"] for e in ours if e["event"] == "span"] == [span] * len(evals[0])


def test_service_run_logs_match_jax(tmp_path, monkeypatch):
    """``ddr loadtest`` and ``ddr verify --synthetic``: the event types and
    keys of the service's decisions, spans, joins and rollups."""
    args = ["--synthetic", "--n", "32", "--horizon", "6"]
    lt = [*args, "--rps", "30", "--duration", "0.5", "--label", "x"]
    vf = [*args, "--members", "4", "--requests", "3", "--label", "x"]
    monkeypatch.delenv("DDR_METRICS_DIR", raising=False)
    assert jax_loadtest.main([*lt, "--out", str(tmp_path / "jax_lt")]) == 0
    assert loadtest.main([*lt, "--out", str(tmp_path / "port_lt"), "device=cpu"]) == 0
    assert jax_verify.main([*vf, "--out", str(tmp_path / "jax_vf")]) == 0
    assert verify.main([*vf, "--out", str(tmp_path / "port_vf"), "device=cpu"]) == 0
    for cmd, sub in (("loadtest", "lt"), ("verify", "vf")):
        ours = _events(tmp_path / f"port_{sub}" / f"run_log.{cmd}.jsonl")
        ref = _events(tmp_path / f"jax_{sub}" / f"run_log.{cmd}.jsonl")
        _same_keys(ours, ref, cmd)
        assert ours[-1]["summary"]["serve"].keys() == ref[-1]["summary"]["serve"].keys()
    verifies = [[e for e in _events(tmp_path / f"{side}_vf" / "run_log.verify.jsonl") if e["event"] == "verify"]
                for side in ("port", "jax")]
    assert [len(v) for v in verifies] == [len(verifies[1])] * 2 and verifies[0]
