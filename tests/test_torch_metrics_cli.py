"""``ddr metrics`` on the port (``ddr_tpu_torch/observability/metrics_cli.py``)
against the JAX package's command, on the same run logs.

The logs: the CPU twin's ``ddr train`` run log written by each package (32
reaches, one epoch, with skill, drift, heartbeats and the sentinel's
rollups), the port's ``ddr test`` log, a copy of the port's train log with
corrupt and half-written lines, a log rotated into segments
(``DDR_METRICS_MAX_MB``), and a directory of two host logs. On each:

- ``load_events`` gives the same events and corrupt-line count;
- ``summarize`` prints JAX's text (the same clock for stall detection);
- ``tail -n N`` prints JAX's lines;
- ``trace`` gives JAX's Perfetto dict, with a slice per step;
- ``main`` exits as JAX's does for ``summarize``, ``tail`` and ``trace
  --out``, and for a missing log.

``follow`` prints the lines a growing file gains, as JAX's does under the
same scripted polls, and in real time within its own bound.
"""

from __future__ import annotations

import io
import json
import shutil
import threading
import time

import pytest

from ddr_tpu.observability import metrics_cli as jcli
from ddr_tpu.scripts import train as jax_train
from ddr_tpu_torch.observability import metrics_cli as tcli
from ddr_tpu_torch.observability.events import Recorder
from ddr_tpu_torch.scripts import test as port_test
from ddr_tpu_torch.scripts import train as port_train

CONFIG = "examples/synthetic/config.yaml"
TWIN = [CONFIG, "synthetic_segments=32", "experiment.epochs=1"]


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """name -> path of every log the cases read."""
    root = tmp_path_factory.mktemp("metrics_cli")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("DDR_RUN_ID", "twin")
        mp.setenv("DDR_HEARTBEAT_EVERY", "1")
        mp.setenv("DDR_METRICS_DIR", str(root / "jax"))
        assert jax_train.main([*TWIN, f"params.save_path={root / 'jax_run'}"]) == 0
        mp.setenv("DDR_METRICS_DIR", str(root / "port"))
        assert port_train.main([*TWIN, "device=cpu", f"params.save_path={root / 'port_run'}"]) == 0
        mp.setenv("DDR_METRICS_DIR", str(root / "port_test"))
        assert port_test.main([CONFIG, "synthetic_segments=32", "experiment.end_time=1981/10/22", "device=cpu",
                               f"params.save_path={root / 'port_test_run'}"]) == 0
    finally:
        mp.undo()
    train_log = root / "port" / "run_log.train.jsonl"
    corrupt = root / "corrupt" / "run_log.train.jsonl"
    corrupt.parent.mkdir()
    lines = train_log.read_text().splitlines(keepends=True)
    corrupt.write_text("".join(lines[:5]) + "not json\n\n" + "".join(lines[5:-1]) + lines[-1][:40])
    rotated = root / "rotated" / "run_log.serve.jsonl"
    rec = Recorder(rotated, max_bytes=8192)
    for i in range(200):
        rec.emit("serve_request", status="ok" if i % 7 else "shed:deadline", network="basin", model="default",
                 latency_s=0.01 * (i % 13), queue_s=0.001 * (i % 5), execute_s=0.005, slo_ok=bool(i % 7))
    rec.close()
    hosts = root / "hosts"
    hosts.mkdir()
    shutil.copy(train_log, hosts / "run_log.train.jsonl")
    sidecar = [json.loads(line) for line in train_log.read_text().splitlines()]
    for e in sidecar:
        e["host"] = 1
        e["wall"] = e["wall"] + 0.25
    (hosts / "run_log.train.host1.jsonl").write_text("".join(json.dumps(e) + "\n" for e in sidecar))
    return {"jax-train": root / "jax" / "run_log.train.jsonl", "port-train": train_log,
            "port-test": root / "port_test" / "run_log.test.jsonl", "corrupt": corrupt,
            "rotated": rotated, "hosts": hosts}


CASES = ["jax-train", "port-train", "port-test", "corrupt", "rotated", "hosts"]


def _both(fn_name, *args, **kwargs) -> tuple[str, str, object, object]:
    outs = []
    for mod in (tcli, jcli):
        buf = io.StringIO()
        rc = getattr(mod, fn_name)(*args, out=buf, **kwargs)
        outs.append((buf.getvalue(), rc))
    return outs[0][0], outs[1][0], outs[0][1], outs[1][1]


@pytest.mark.parametrize("case", CASES)
def test_load_and_summarize_equal_jax(logs, case):
    events, bad = tcli.load_events(logs[case])
    assert (events, bad) == jcli.load_events(logs[case])
    assert bad == (2 if case == "corrupt" else 0)
    if case == "rotated":
        # the first segment, the newest ones and the active file survive
        assert len(list(logs[case].parent.glob("*.seg*.jsonl"))) >= 2 and events[-1]["event"] == "run_end"
        assert events[0]["seq"] == 0 and len(events) < 200 + 1
    now = time.time()
    ours, ref, rc, jrc = _both("summarize", events, bad, now=now)
    assert (ours, rc) == (ref, jrc) and rc == 0
    if case.endswith("train") or case in ("corrupt", "hosts"):
        steps = sum(e["event"] == "step" for e in events)
        assert f"steps    : {steps}" in ours and steps >= 2


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [5, 40])
def test_tail_equals_jax(logs, case, n):
    events, _ = tcli.load_events(logs[case])
    ours, ref, rc, jrc = _both("tail", events, n=n)
    assert (ours, rc) == (ref, jrc) and len(ours.splitlines()) == min(n, len(events))


@pytest.mark.parametrize("case", CASES)
def test_perfetto_trace_equals_jax(logs, case):
    events, _ = tcli.load_events(logs[case])
    ours = tcli.perfetto_trace(events)
    assert ours == jcli.perfetto_trace(events)
    json.dumps(ours)  # serialisable as written
    steps = sum(e["event"] == "step" for e in events)
    slices = [e for e in ours["traceEvents"] if e.get("ph") == "X" and str(e.get("name")).startswith("step")]
    assert len(slices) >= steps


@pytest.mark.parametrize("command", ["summarize", "tail", "trace", "missing"])
def test_main_exits_as_jax(logs, tmp_path, capsys, command):
    path = str(logs["port-train"])
    argv = {"summarize": ["summarize", path], "tail": ["tail", path, "-n", "3"],
            "trace": ["trace", path, "--out", str(tmp_path / "{}.json")],
            "missing": ["summarize", str(tmp_path / "nope.jsonl")]}[command]
    codes, texts = [], []
    for name, mod in (("port", tcli), ("jax", jcli)):
        run = [a.format(name) for a in argv]
        codes.append(mod.main(run))
        texts.append(capsys.readouterr().out)
    assert codes[0] == codes[1] == (1 if command == "missing" else 0) or codes[0] == codes[1] == 2
    if command == "trace":
        assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
    elif command != "missing":
        assert texts[0] == texts[1]


def _scripted_follow(mod, monkeypatch, path, actions) -> tuple[int, str]:
    calls = [0]

    def scripted_sleep(_s):
        i = calls[0]
        calls[0] += 1
        if i < len(actions):
            actions[i]()

    monkeypatch.setattr(mod.time, "sleep", scripted_sleep)
    out = io.StringIO()
    rc = mod.follow(path, n=3, interval=0.0, out=out, max_polls=len(actions))
    monkeypatch.undo()
    return rc, out.getvalue()


def test_follow_prints_new_lines_as_jax(logs, tmp_path, monkeypatch):
    src = logs["port-train"].read_text().splitlines(keepends=True)
    outs = []
    for name, mod in (("port", tcli), ("jax", jcli)):
        path = tmp_path / name / "run_log.train.jsonl"
        path.parent.mkdir()
        path.write_text("".join(src[:6]))

        def append(lines, path=path):
            return lambda: path.open("a").write("".join(lines))

        actions = [append(src[6:9]), append(["garbage\n", src[9][:30]]), append([src[9][30:]]), lambda: None]
        outs.append(_scripted_follow(mod, monkeypatch, path, actions))
    assert outs[0] == outs[1] and outs[0][0] == 0
    assert len(outs[0][1].splitlines()) == 3 + 4


def test_follow_keeps_up_with_a_growing_file(logs, tmp_path):
    """Real polls at 20 ms against a writer appending every 10 ms: every
    event is printed, and the follow ends by its poll bound well inside 20 s."""
    src = logs["port-train"].read_text().splitlines(keepends=True)
    path = tmp_path / "run_log.train.jsonl"
    path.write_text(src[0])
    out = io.StringIO()
    done = threading.Event()

    def writer():
        for line in src[1:]:
            with path.open("a") as f:
                f.write(line)
            time.sleep(0.01)
        done.set()

    w = threading.Thread(target=writer)
    f = threading.Thread(target=lambda: tcli.follow(path, n=5, interval=0.02, out=out, max_polls=150))
    t0 = time.monotonic()
    w.start()
    f.start()
    w.join(timeout=20)
    f.join(timeout=20)
    assert done.is_set() and not f.is_alive() and time.monotonic() - t0 < 20
    assert len(out.getvalue().splitlines()) == len(src)
