"""``ddr chaos`` on the port: the kill-and-resume drills of
``ddr_tpu/scripts/chaos.py``.

Robustness claims are only real when something kills the process. This
harness does, and measures the recovery with the run logs:

- **``ddr chaos train``**: a golden (uninterrupted) synthetic training run in
  a subprocess, then a chaotic twin that is SIGKILLed (or SIGTERMed,
  ``--signal term``: the graceful preemption path) after each of ``--kills``
  mini-batches and resumed from its own ``saved_models/`` each time. The
  check is step-exact: every (epoch, mini-batch) loss of the golden run must
  reappear in the chaotic run within ``--tolerance``, and the final
  checkpoints' parameters must match, so the epoch and mini-batch cursor, the
  optimizer state and the loader's RNG must all have been restored.
  ``--nan-storm`` runs the self-healing drill instead: one non-finite storm
  at each nan fault site (:data:`DEFAULT_NAN_STORM`), each answered by a
  recovery event, the run finishing within ``--tolerance`` of the golden one.
- **``ddr chaos serve --synthetic``**: a ``ddr serve`` replica in a
  subprocess under open-loop load (the ``ddr loadtest`` machinery), SIGKILLed
  mid-run and restarted; the record holds the seconds from the kill to
  ``/readyz`` 200, the error and shed rates of the storm and the attainment
  after the restart. ``--kill-replica`` kills one member of a 2-replica
  group behind the router instead and requires its ejection, ``ddr_federate_up
  0`` on the survivor's federated scrape, and its readmission.

Each drill writes one flat ``CHAOS_<label>.json`` record with the JAX
command's keys, prints a summary and the record as the last line, and (under
a run log: ``--out`` or ``DDR_METRICS_DIR``) emits one ``chaos`` event per
kill and recovery.

    python -m ddr_tpu_torch.cli chaos train --kills 1,2 --out runs/chaos
    python -m ddr_tpu_torch.cli chaos train --signal term --kills 1
    python -m ddr_tpu_torch.cli chaos train --nan-storm --segments 32 device=cpu
    python -m ddr_tpu_torch.cli chaos serve --synthetic --rps 20 --duration 8 --kill-after 2

Trailing ``a.b=c`` overrides (``device=cpu``) reach every subprocess's
config, as in ``ddr fleet`` and ``ddr loadtest``; without ``device=cpu`` the
subprocesses train and serve on the card. Departures from the JAX command:
``--reshard`` (the elastic mesh-change drill) needs sharded state and raises
``NotImplementedError`` naming ROADMAP A.13; the port has no XLA compile
cache, so no cache directory is stamped into the subprocesses, and the
nan-storm's ``compile_events_*`` count the ``compile`` events the port never
emits, 0 on both sides; the attempts that will be killed are paced
(:data:`KILL_PACE_MS`: the main thread sleeps 0.5 s before each step through
a ``slow@device.step`` fault plan), because on the card a step takes tens of ms
and an unpaced attempt runs past its kill point, or finishes, before the
harness's poll sees its step and kills it (the JAX command relies on the
CPU's slower steps; the record's ``pace_ms`` says what was used, and the
seconds of a resume that is killed again include one pace); the record's
``device`` names the card (or ``cpu``) where JAX's names the platform; the
train record adds each resume's seconds, the checkpoints the resumes took and
the ``preempt`` events seen, and a SIGTERM drill passes only with one
``preempt`` event a kill; and the drill's Perfetto timeline is written (the
JAX command hands the merged log to ``perfetto_trace`` in a form it does not
take, so its ``trace`` stays None).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable

log = logging.getLogger(__name__)

__all__ = ["DEFAULT_KILLS", "DEFAULT_NAN_STORM", "main", "render_summary"]

#: Default mini-batch indices (0-based, epoch 1) after which the train-mode
#: subprocess is killed: resuming once proves the save worked, resuming twice
#: proves the resumed state saves correctly too.
DEFAULT_KILLS = (1, 2)

#: The ``--nan-storm`` fault plan: one non-finite storm at each of the three
#: nan sites, each answered by another layer of the self-healing stack. The
#: drill config yields 4 mini-batches an epoch, so with mini-batch 1
#: quarantined the executed steps are 0, 1 (mini-batch 2) and 2 (mini-batch 3):
#:
#: - ``data.forcings`` at prefetch call 1 (mini-batch 1): caught on the host by
#:   the ``DDR_DATA_VALIDATE=quarantine`` scan; the tile never reaches the
#:   card, and the drop is a ladder ``skip``;
#: - ``device.step`` at executed step 1: the card routes non-finite inflow, the
#:   watchdog's ``non-finite`` gate trips and the supervisor restores the
#:   pre-step snapshot;
#: - ``device.grads`` at executed step 2: the synchronised gradient norm goes
#:   non-finite after the update applied, which the snapshot unwinds.
DEFAULT_NAN_STORM = "nan@data.forcings=1:n=1;nan@device.step=1:n=1;nan@device.grads=2:n=1"

#: The pace of a train attempt that will be killed: the loop sleeps this long
#: before each step (a ``slow@device.step`` fault plan, unless ``DDR_FAULTS`` is
#: set), so the harness's 0.1 s poll sees the step it kills after before the
#: next one starts. The prefetch pool runs ahead, so a pace on the data load
#: would not hold the steps apart.
KILL_PACE_MS = 500.0


def _emit_chaos(**payload: Any) -> None:
    from ddr_tpu_torch.observability.events import get_recorder

    rec = get_recorder()
    if rec is not None:
        rec.emit("chaos", **payload)


def _export_trace(log_dir: Path, out: Path) -> str | None:
    """The drill's merged run logs as a Perfetto timeline (where the kill
    landed, what stalled after it); a post-mortem nicety, never fatal."""
    try:
        from ddr_tpu_torch.observability.metrics_cli import load_events, perfetto_trace

        events, _ = load_events(log_dir)
        doc = perfetto_trace(events)
        if not doc["traceEvents"]:
            return None
        out.write_text(json.dumps(doc), encoding="utf-8")
        log.info(f"drill timeline written to {out} (open it at https://ui.perfetto.dev)")
        return str(out)
    except Exception as e:  # noqa: BLE001 - never fails the drill
        log.debug(f"perfetto export of {log_dir} skipped: {e}")
        return None


def _read_jsonl(path: Path) -> list[dict]:
    """Best-effort JSONL parse (a log mid-write has a torn last line)."""
    if not path.exists():
        return []
    events = []
    for line in path.read_text(errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(ev, dict):
            events.append(ev)
    return events


def _step_losses(events: list[dict]) -> dict[tuple[int, int], float]:
    """``step`` events -> {(epoch, mini_batch): loss}."""
    out: dict[tuple[int, int], float] = {}
    for e in events:
        if e.get("event") == "step" and e.get("loss") is not None:
            out[(int(e.get("epoch", 0)), int(e.get("batch", 0)))] = float(e["loss"])
    return out


def _yaml_text(tree: dict, indent: int = 0) -> str:
    """``tree`` as block YAML that the port's ``yaml_subset`` reader reads
    back as PyYAML reads ``yaml.safe_dump`` of it (the card machine has no
    ``yaml``): strings double-quoted, nested mappings and lists of scalars
    as blocks."""

    def scalar(v: Any) -> str:
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int, float)):
            return repr(v)
        return json.dumps(str(v))

    pad = " " * indent
    lines = []
    for key, value in tree.items():
        if isinstance(value, dict):
            lines.append(f"{pad}{key}:\n{_yaml_text(value, indent + 2)}")
        elif isinstance(value, (list, tuple)):
            lines.append(f"{pad}{key}:\n" + "".join(f"{pad}  - {scalar(v)}\n" for v in value).rstrip("\n"))
        else:
            lines.append(f"{pad}{key}: {scalar(value)}")
    return "\n".join(lines) + ("\n" if indent == 0 else "")


# ---------------------------------------------------------------------------
# Train mode.
# ---------------------------------------------------------------------------


def _train_cfg_dict(save_path: Path, checkpoint: Path | None, args) -> dict:
    cfg: dict[str, Any] = {
        "name": "chaos",
        "geodataset": "synthetic",
        "mode": "training",
        "synthetic_segments": args.segments,
        "kan": {"input_var_names": [f"a{i}" for i in range(10)]},
        "experiment": {
            "start_time": "1981/10/01",
            "end_time": "1981/10/20",
            "rho": 8,
            "batch_size": 1,
            "epochs": args.epochs,
            "warmup": 1,
            "learning_rate": {1: 0.01},
            # shuffle off: the loader draws no permutation, so a mid-epoch
            # resume replays the same batch sequence
            "shuffle": False,
        },
        "params": {"save_path": str(save_path)},
    }
    if checkpoint is not None:
        cfg["experiment"]["checkpoint"] = str(checkpoint)
    return cfg


def _subprocess_env(workdir: Path) -> dict[str, str]:
    """The drill subprocesses' environment: the caller's, less
    ``DDR_METRICS_DIR`` (each subprocess writes its run log under its own
    save path). The port has no compile cache to stamp."""
    env = dict(os.environ)
    env.pop("DDR_METRICS_DIR", None)
    return env


def _launch(argv: list[str], env: dict[str, str], log_path: Path) -> subprocess.Popen:
    with log_path.open("ab") as fh:
        return subprocess.Popen([sys.executable, "-m", "ddr_tpu_torch.cli", *argv],
                                stdout=fh, stderr=subprocess.STDOUT, env=env)


def _stop(proc: subprocess.Popen) -> None:
    """SIGKILL a drill's own child if it still runs, and reap it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def _wait_for(predicate: Callable[[], bool], proc: subprocess.Popen | None, timeout: float,
              poll_s: float = 0.1) -> bool:
    """Poll ``predicate`` until true, the process dies or the timeout passes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        if proc is not None and proc.poll() is not None:
            return predicate()  # one last look at what it left behind
        time.sleep(poll_s)
    return False


def _write_cfg(path: Path, tree: dict) -> Path:
    path.write_text(_yaml_text(tree))
    return path


def _params_delta(golden: Path, chaos: Path) -> float:
    """Largest |difference| between the newest checkpoints' KAN weights of
    two runs; inf when either has none."""
    import numpy as np

    from ddr_tpu_torch.training import latest_checkpoint, load_state

    g_ckpt, c_ckpt = latest_checkpoint(golden), latest_checkpoint(chaos)
    if g_ckpt is None or c_ckpt is None:
        return float("inf")
    g, c = load_state(g_ckpt)["params"], load_state(c_ckpt)["params"]
    return max((float(np.max(np.abs(np.asarray(g[k]) - np.asarray(c[k])))) for k in g), default=0.0)


def _device_platform(overrides: list[str]) -> str | None:
    """``cpu`` when an override asks for it, else the card's name."""
    for o in overrides:
        key, _, value = o.partition("=")
        if key.strip() == "device":
            if value.strip().startswith("cpu"):
                return "cpu"
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else None


def run_chaos_train(args) -> dict[str, Any]:
    """The golden run, then kill/resume cycles; returns the CHAOS record."""
    if getattr(args, "reshard", None):
        raise NotImplementedError(
            "ddr chaos train --reshard resumes on another device mesh, which needs sharded state "
            "(ROADMAP A.13)")
    workdir = Path(args.out) / f"chaos_train_{args.label}"
    workdir.mkdir(parents=True, exist_ok=True)
    env = _subprocess_env(workdir)
    overrides = list(getattr(args, "overrides", []) or [])
    kills = [int(k) for k in str(args.kills).split(",") if k.strip() != ""]
    sig = signal.SIGTERM if args.signal == "term" else signal.SIGKILL
    if getattr(args, "tolerance", None) is None:
        args.tolerance = 1e-4

    # ---- golden: the uninterrupted reference trajectory ----
    golden_dir = workdir / "golden"
    golden_cfg = _write_cfg(workdir / "golden.yaml", _train_cfg_dict(golden_dir, None, args))
    log.info(f"chaos train: golden run -> {golden_dir}")
    proc = _launch(["train", str(golden_cfg), *overrides], env, workdir / "golden.out")
    try:
        rc = proc.wait(timeout=args.timeout)
    finally:
        _stop(proc)
    golden_steps = _step_losses(_read_jsonl(golden_dir / "run_log.train.jsonl"))
    if rc != 0 or not golden_steps:
        raise RuntimeError(f"golden training run failed (rc={rc}, {len(golden_steps)} steps); "
                           f"see {workdir / 'golden.out'}")

    # ---- chaos: kill after each target mini-batch, resume, repeat ----
    chaos_dir = workdir / "chaos"
    # experiment.checkpoint is the run's OWN saved_models: the first attempt
    # finds it empty and starts fresh, every later one resumes from the newest
    # checkpoint that verifies (torn or corrupt ones skipped)
    chaos_cfg = _write_cfg(workdir / "chaos.yaml",
                           _train_cfg_dict(chaos_dir, chaos_dir / "saved_models", args))
    # every attempt that will be killed is paced, so that the kill lands after
    # the mini-batch it names: on a card a step takes tens of ms, and an
    # unpaced attempt runs past its kill point, or to its end, before the
    # kill arrives. A sleep before the step changes no number.
    victim_env = env if env.get("DDR_FAULTS") else dict(env, DDR_FAULTS=f"slow@device.step:ms={KILL_PACE_MS:g}")
    chaos_steps: dict[tuple[int, int], float] = {}
    chaos_log = chaos_dir / "run_log.train.jsonl"
    recoveries: list[float] = []
    killed_at: list[int] = []
    preempts: list[dict] = []
    resumed_from: list[str] = []

    def _harvest() -> list[dict]:
        # each relaunch truncates the run log: harvest while its process lives
        events = _read_jsonl(chaos_log)
        chaos_steps.update(_step_losses(events))
        for e in events:
            if e.get("event") == "preempt" and e not in preempts:
                preempts.append(e)
        return events

    def _max_batch_seen() -> int:
        _harvest()
        return max((b for _, b in chaos_steps), default=-1)

    # one live subprocess at a time: killed at each target, and the resumed
    # process is the next kill's victim (the last one runs to its end)
    proc = _launch(["train", str(chaos_cfg), *overrides], victim_env if kills else env, workdir / "chaos_1.out")
    try:
        for n, kill_batch in enumerate(kills, start=1):
            if not _wait_for(lambda: _max_batch_seen() >= kill_batch, proc, args.timeout):
                raise RuntimeError(f"chaos attempt {n} never reached mini-batch {kill_batch}; "
                                   f"see {workdir}/chaos_*.out")
            # the step event can outrun the async checkpoint writer: wait
            # (briefly) for the mini-batch's blob, so the kill tests
            # crash-after-save and the resume starts at kill_batch + 1
            saved = chaos_dir / "saved_models"
            _wait_for(lambda b=kill_batch: any(saved.glob(f"_*_epoch_*_mb_{b}.pkl")), proc, 15.0)
            t_kill = time.monotonic()
            proc.send_signal(sig)
            try:
                # graceful drill: the handler drains and saves; give it the
                # grace window an orchestrator would
                proc.wait(timeout=args.timeout if sig is signal.SIGTERM else 30.0)
            except subprocess.TimeoutExpired:
                _stop(proc)
            killed_at.append(kill_batch)
            _harvest()
            log.info(f"chaos train: kill {n} after mini-batch {kill_batch} ({args.signal})")
            _emit_chaos(mode="train", action="kill", attempt=n, batch=kill_batch, signal=args.signal)
            # resume: from the kill to the new process's first step event (its
            # pid: each attempt truncates the log, so the pid says "the new
            # process made progress")
            proc = _launch(["train", str(chaos_cfg), *overrides], victim_env if n < len(kills) else env,
                           workdir / f"chaos_{n + 1}.out")

            def _resumed(pid: int = proc.pid) -> bool:
                return any(e.get("event") == "step" and e.get("pid") == pid for e in _harvest())

            resumed = _wait_for(_resumed, proc, args.timeout)
            recovery = time.monotonic() - t_kill
            if not resumed:
                raise RuntimeError(f"resume {n} produced no new step within {args.timeout}s; "
                                   f"see {workdir / f'chaos_{n + 1}.out'}")
            out_text = (workdir / f"chaos_{n + 1}.out").read_text(errors="replace")
            resumed_from.extend(line.split("Resuming from ", 1)[1].split(" at epoch", 1)[0]
                                for line in out_text.splitlines() if "Resuming from " in line)
            recoveries.append(recovery)
            _emit_chaos(mode="train", action="resume", attempt=n, recovery_s=round(recovery, 3))
        # the last resumed process runs to its end
        rc = proc.wait(timeout=args.timeout)
    finally:
        _stop(proc)
    _harvest()
    if rc != 0:
        raise RuntimeError(f"final resumed run failed (rc={rc}); see {workdir}")

    # ---- the check: step-exact trajectory, then the final weights ----
    missing = sorted(set(golden_steps) - set(chaos_steps))
    deltas = {k: abs(chaos_steps[k] - golden_steps[k]) for k in golden_steps if k in chaos_steps}
    loss_delta = max(deltas.values()) if deltas else float("inf")
    params_delta = _params_delta(golden_dir / "saved_models", chaos_dir / "saved_models")
    passed = not missing and loss_delta <= args.tolerance and params_delta <= args.tolerance
    if sig is signal.SIGTERM:
        # the graceful path must have saved and announced itself
        passed = passed and len(preempts) == len(killed_at)
    return {
        "kind": "chaos",
        "schema_version": 1,
        "mode": "train",
        "label": args.label,
        "device": _device_platform(overrides),
        "signal": args.signal,
        "reshard": None,
        "reshard_events": None,
        "kills": killed_at,
        "steps_golden": len(golden_steps),
        "steps_chaos": len(chaos_steps),
        "steps_missing": len(missing),
        "loss_delta": round(loss_delta, 9) if deltas else None,
        "params_max_abs_delta": None if params_delta == float("inf") else round(params_delta, 9),
        "recovery_s": round(max(recoveries), 3) if recoveries else None,
        "mean_recovery_s": round(sum(recoveries) / len(recoveries), 3) if recoveries else None,
        "recoveries_s": [round(r, 3) for r in recoveries],
        "pace_ms": KILL_PACE_MS if victim_env is not env else 0.0,
        "preempt_events": len(preempts),
        "resumed_from": [Path(p).name for p in resumed_from],
        "trace": _export_trace(chaos_dir, workdir / "chaos_trace.json"),
        "tolerance": args.tolerance,
        "passed": passed,
    }


def run_chaos_nan_storm(args) -> dict[str, Any]:
    """The self-healing drill (no kills): a golden run, then a faulted twin
    with ``DDR_FAULTS`` injecting one non-finite storm at each nan site
    (:data:`DEFAULT_NAN_STORM`). The twin must finish (rc 0), answer every
    storm with at least one ``recovery`` event and land its final weights
    within ``--tolerance`` of the golden run's."""
    if getattr(args, "reshard", None):
        raise SystemExit("--nan-storm and --reshard are separate drills")
    # epoch 1 takes the storms; epoch 2 is the clean rejoin the weights are scored on
    args.epochs = max(args.epochs, 2)
    workdir = Path(args.out) / f"chaos_train_{args.label}"
    workdir.mkdir(parents=True, exist_ok=True)
    env = _subprocess_env(workdir)
    overrides = list(getattr(args, "overrides", []) or [])
    # the self-healing stack armed the same way in both runs: recovery on a
    # clean run must change nothing
    env["DDR_RECOVERY_ENABLED"] = "1"
    env["DDR_DATA_VALIDATE"] = "quarantine"
    env.setdefault("DDR_HEALTH_ENABLED", "1")
    faults = DEFAULT_NAN_STORM
    if getattr(args, "tolerance", None) is None:
        # recovery drops whole updates the golden run applied, so the gate is
        # "back in the golden basin after the clean epoch", not bit-exactness
        args.tolerance = 0.1

    golden_dir = workdir / "golden"
    golden_cfg = _write_cfg(workdir / "golden.yaml", _train_cfg_dict(golden_dir, None, args))
    log.info(f"chaos nan-storm: golden run -> {golden_dir}")
    proc = _launch(["train", str(golden_cfg), *overrides], env, workdir / "golden.out")
    try:
        rc = proc.wait(timeout=args.timeout)
    finally:
        _stop(proc)
    golden_events = _read_jsonl(golden_dir / "run_log.train.jsonl")
    golden_steps = _step_losses(golden_events)
    if rc != 0 or not golden_steps:
        raise RuntimeError(f"golden training run failed (rc={rc}, {len(golden_steps)} steps); "
                           f"see {workdir / 'golden.out'}")

    # ---- the storm: the same config plus DDR_FAULTS, one process, no kills ----
    chaos_dir = workdir / "chaos"
    chaos_cfg = _write_cfg(workdir / "chaos.yaml", _train_cfg_dict(chaos_dir, None, args))
    chaos_env = dict(env, DDR_FAULTS=faults)
    log.info(f"chaos nan-storm: faulted run -> {chaos_dir} ({faults})")
    _emit_chaos(mode="train", action="nan-storm", faults=faults)
    proc = _launch(["train", str(chaos_cfg), *overrides], chaos_env, workdir / "chaos_1.out")
    try:
        rc = proc.wait(timeout=args.timeout)
    finally:
        _stop(proc)
    events = _read_jsonl(chaos_dir / "run_log.train.jsonl")
    chaos_steps = _step_losses(events)

    def _count(evts: list[dict], kind: str) -> int:
        return sum(1 for e in evts if e.get("event") == kind)

    fault_events = _count(events, "fault")
    recoveries = [e for e in events if e.get("event") == "recovery"]
    stages: dict[str, int] = {}
    for e in recoveries:
        stages[str(e.get("stage"))] = stages.get(str(e.get("stage")), 0) + 1
    # the port writes no `compile` events (it has no compile cache): both 0
    compile_golden = _count(golden_events, "compile")
    compile_chaos = _count(events, "compile")
    finite_losses = [v for _, v in sorted(chaos_steps.items()) if math.isfinite(v)]
    final_loss = finite_losses[-1] if finite_losses else None
    params_delta = _params_delta(golden_dir / "saved_models", chaos_dir / "saved_models")
    n_clauses = len([c for c in faults.split(";") if c.strip()])
    passed = (
        rc == 0
        and fault_events == n_clauses
        and len(recoveries) >= fault_events
        and final_loss is not None
        and params_delta <= args.tolerance
        and compile_chaos <= compile_golden
    )
    return {
        "kind": "chaos",
        "schema_version": 1,
        "mode": "train",
        "label": args.label,
        "device": _device_platform(overrides),
        "signal": None,
        "reshard": None,
        "nan_storm": True,
        "faults": faults,
        "fault_events": fault_events,
        "recovery_events": len(recoveries),
        "recovery_stages": stages,
        "rollbacks": stages.get("rollback", 0),
        "data_anomalies": _count(events, "data_anomaly"),
        "steps_golden": len(golden_steps),
        "steps_chaos": len(chaos_steps),
        "compile_events_golden": compile_golden,
        "compile_events_chaos": compile_chaos,
        "final_loss": round(final_loss, 6) if final_loss is not None else None,
        "params_max_abs_delta": None if params_delta == float("inf") else round(params_delta, 9),
        "trace": _export_trace(chaos_dir, workdir / "chaos_trace.json"),
        "tolerance": args.tolerance,
        "passed": passed,
    }


# ---------------------------------------------------------------------------
# Serve mode.
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_cfg_dict(save_path: Path, args) -> dict:
    return {
        "name": "chaos_serve",
        "geodataset": "synthetic",
        "mode": "testing",
        "synthetic_segments": args.segments,
        "kan": {"input_var_names": [f"a{i}" for i in range(10)]},
        "experiment": {"start_time": "1981/10/01", "end_time": "1981/10/10", "rho": 8},
        "params": {"save_path": str(save_path)},
    }


def run_chaos_serve(args) -> dict[str, Any]:
    """SIGKILL and restart one serving replica under load; returns the record."""
    if not args.synthetic and not args.url:
        raise SystemExit("ddr chaos serve needs --synthetic (or a --url target)")
    if args.url:
        raise SystemExit("ddr chaos serve only supports --synthetic targets: killing a server it "
                         "did not launch is not a drill, it is an outage")
    from ddr_tpu_torch.scripts.loadtest import HttpDriver, build_report, run_open_loop
    from ddr_tpu_torch.serving.client import HttpForecastClient

    workdir = Path(args.out) / f"chaos_serve_{args.label}"
    workdir.mkdir(parents=True, exist_ok=True)
    overrides = list(getattr(args, "overrides", []) or [])
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    env = _subprocess_env(workdir)
    env.update({
        "DDR_SERVE_HOST": "127.0.0.1",
        "DDR_SERVE_PORT": str(port),
        "DDR_SERVE_HORIZON_HOURS": str(args.horizon),
        "DDR_SERVE_MAX_BATCH": "4",
    })
    cfg_path = _write_cfg(workdir / "serve.yaml", _serve_cfg_dict(workdir / "run", args))
    client = HttpForecastClient(url, timeout=5.0)

    def _boot(attempt: int) -> subprocess.Popen:
        return _launch(["serve", str(cfg_path), *overrides], env, workdir / f"serve_{attempt}.out")

    proc = _boot(1)
    try:
        if not _wait_for(client.ready, proc, args.boot_timeout, poll_s=0.25):
            raise RuntimeError(f"replica never became ready within {args.boot_timeout}s; "
                               f"see {workdir / 'serve_1.out'}")

        # ---- the storm: open-loop load, one SIGKILL and a restart mid-run ----
        driver = HttpDriver(url, t0_span=24, timeout_s=5.0)
        timeline: list[tuple[float, Any]] = []
        tl_lock = threading.Lock()

        def fire(i: int):
            o = driver.fire(i)
            with tl_lock:
                timeline.append((time.monotonic(), o))
            return o

        load_done: dict[str, Any] = {}

        def _load() -> None:
            outcomes, wall, offered = run_open_loop(fire, args.rps, args.duration, seed=args.seed,
                                                    max_inflight=args.max_inflight)
            load_done.update(outcomes=outcomes, wall=wall, offered=offered)

        loader = threading.Thread(target=_load, name="ddr-chaos-load")
        loader.start()
        time.sleep(max(0.0, args.kill_after))
        t_kill = time.monotonic()
        _stop(proc)
        _emit_chaos(mode="serve", action="kill", signal="kill", at_s=args.kill_after)
        log.info("chaos serve: replica SIGKILLed; restarting")
        proc = _boot(2)
        recovered = _wait_for(client.ready, proc, args.boot_timeout, poll_s=0.1)
        t_ready = time.monotonic()
        recovery_s = t_ready - t_kill
        _emit_chaos(mode="serve", action="recovered" if recovered else "recovery-timeout",
                    recovery_s=round(recovery_s, 3))
        loader.join(timeout=args.duration + args.boot_timeout + 60.0)
        if recovered and not any(t >= t_ready for t, _ in timeline):
            # the load window closed before the restart: a short probe burst
            # gives the verdict its post-restart evidence (timeline only)
            for i in range(10):
                fire(10_000 + i)
        stats = driver.stats() if recovered else {}
        proc.terminate()
        try:
            proc.wait(timeout=15.0)
        except subprocess.TimeoutExpired:
            pass
    finally:
        _stop(proc)

    outcomes = load_done.get("outcomes") or [o for _, o in timeline]
    wall = load_done.get("wall") or max(args.duration, 1e-9)
    offered = load_done.get("offered") or len(outcomes)
    report = build_report(outcomes, wall, offered, stats_after=stats, mode="open", target=url,
                          device=_device_platform(overrides), rps_target=args.rps,
                          duration_s=args.duration, seed=args.seed)
    # the client's good fraction of everything that completed after /readyz
    # came back: the new process's own SLO tracker misses the outage
    post = [o for t, o in timeline if t >= t_ready]
    post_att = round(sum(1 for o in post if o.ok) / len(post), 6) if post else None
    report.update({
        "kind": "chaos",
        "mode": "serve",
        "label": args.label,
        "kill_after_s": args.kill_after,
        "recovery_s": round(recovery_s, 3),
        "recovered": bool(recovered),
        "post_restart_requests": len(post),
        "post_restart_attainment": post_att,
        "passed": bool(recovered and post and post_att and post_att > 0.5),
    })
    return report


def run_chaos_serve_fleet(args) -> dict[str, Any]:
    """``--kill-replica``: a 2-replica group, one member SIGKILLed under
    open-loop load. Requires (a) the router ejects it and reroutes, (b) the
    error rate stays at most 0.2, (c) the survivor's federated scrape reports
    ``ddr_federate_up 0`` for the dead member and (d) the member is
    readmitted after its restart. Returns the record."""
    if not args.synthetic:
        raise SystemExit("ddr chaos serve --kill-replica needs --synthetic")
    import urllib.request

    from ddr_tpu_torch.fleet.config import FleetConfig
    from ddr_tpu_torch.fleet.group import ReplicaGroup
    from ddr_tpu_torch.fleet.router import NoHealthyReplicaError
    from ddr_tpu_torch.scripts.loadtest import Outcome, build_report, run_open_loop

    workdir = Path(args.out) / f"chaos_fleet_{args.label}"
    workdir.mkdir(parents=True, exist_ok=True)
    overrides = list(getattr(args, "overrides", []) or [])
    cfg_path = _write_cfg(workdir / "serve.yaml", _serve_cfg_dict(workdir / "run", args))
    fleet_cfg = FleetConfig.from_env(replicas=2, mode="subprocess", group="chaos", probe_s=0.25)
    group = ReplicaGroup(fleet_cfg, serve_args=[str(cfg_path), *overrides], workdir=workdir,
                         boot_timeout=args.boot_timeout,
                         extra_env={"DDR_SERVE_HORIZON_HOURS": str(args.horizon), "DDR_SERVE_MAX_BATCH": "4"})
    victim, survivor = 1, 0

    def _replica_row(index: int) -> dict[str, Any]:
        return group.router.status()["replicas"][index]

    def _federated_up() -> dict[str, str]:
        """The survivor's federated scrape: {replica label: '0' or '1'}."""
        with urllib.request.urlopen(f"{group.replicas[survivor].url}/metrics?federated=1",
                                    timeout=10.0) as resp:
            text = resp.read().decode("utf-8", "replace")
        up: dict[str, str] = {}
        for line in text.splitlines():
            if line.startswith("ddr_federate_up{"):
                label = line.split('replica="', 1)[1].split('"', 1)[0]
                up[label] = line.rsplit(" ", 1)[1]
        return up

    timeline: list[tuple[float, Any]] = []
    tl_lock = threading.Lock()

    def fire(i: int) -> Outcome:
        start = time.monotonic()
        try:
            group.forecast(network="default", model="default", t0=i % 24, request_id=f"cf-{i}")
            o = Outcome("ok", time.monotonic() - start)
        except NoHealthyReplicaError:
            o = Outcome("error:unroutable", time.monotonic() - start)
        except Exception as e:  # noqa: BLE001 - an error is a data point here
            o = Outcome(f"error:{type(e).__name__}", time.monotonic() - start)
        with tl_lock:
            timeline.append((time.monotonic(), o))
        return o

    try:
        group.boot()
        load_done: dict[str, Any] = {}

        def _load() -> None:
            outcomes, wall, offered = run_open_loop(fire, args.rps, args.duration, seed=args.seed,
                                                    max_inflight=args.max_inflight)
            load_done.update(outcomes=outcomes, wall=wall, offered=offered)

        loader = threading.Thread(target=_load, name="ddr-chaos-fleet-load")
        loader.start()
        time.sleep(max(0.0, args.kill_after))
        t_kill = time.monotonic()
        group.kill_replica(victim)
        _emit_chaos(mode="serve", action="kill", signal="kill", at_s=args.kill_after, fleet=True,
                    replica=victim)
        ejected = _wait_for(lambda: bool(_replica_row(victim)["ejected"]), None, 30.0, poll_s=0.1)
        eject_s = time.monotonic() - t_kill
        fed_up = _federated_up() if ejected else {}
        dead_label = group.replicas[victim].name
        live_label = group.replicas[survivor].name
        federation_saw_dead = fed_up.get(dead_label) == "0" and fed_up.get(live_label) == "1"
        log.info(f"chaos fleet: eject {'ok' if ejected else 'TIMEOUT'} in {eject_s:.2f}s; "
                 f"federated scrape sees {fed_up}")

        group.restart_replica(victim)
        readmitted = _wait_for(lambda: not _replica_row(victim)["ejected"], None, args.boot_timeout,
                               poll_s=0.25)
        t_ready = time.monotonic()
        recovery_s = t_ready - t_kill
        _emit_chaos(mode="serve", fleet=True, replica=victim,
                    action="recovered" if readmitted else "recovery-timeout",
                    recovery_s=round(recovery_s, 3))
        loader.join(timeout=args.duration + args.boot_timeout + 60.0)
        if readmitted and not any(t >= t_ready for t, _ in timeline):
            # the load window closed before the readmission: a probe burst
            for i in range(10):
                fire(10_000 + i)
        router_status = group.router.status()
    finally:
        group.close()

    outcomes = load_done.get("outcomes") or [o for _, o in timeline]
    wall = load_done.get("wall") or max(args.duration, 1e-9)
    offered = load_done.get("offered") or len(outcomes)
    report = build_report(outcomes, wall, offered, mode="open", target="fleet:router",
                          device=_device_platform(overrides), rps_target=args.rps,
                          duration_s=args.duration, seed=args.seed)
    post = [o for t, o in timeline if t >= t_ready]
    post_att = round(sum(1 for o in post if o.ok) / len(post), 6) if post else None
    error_rate = float(report.get("error_rate") or 0.0)
    report.update({
        "kind": "chaos",
        "mode": "serve",
        "fleet": True,
        "label": args.label,
        "replicas": 2,
        "killed_replica": victim,
        "kill_after_s": args.kill_after,
        "eject_s": round(eject_s, 3),
        "ejected": bool(ejected),
        "federate_up": fed_up,
        "federation_saw_dead": bool(federation_saw_dead),
        "recovery_s": round(recovery_s, 3),
        "recovered": bool(readmitted),
        "dispatched": {r["name"]: r["dispatched"] for r in router_status["replicas"]},
        "post_restart_requests": len(post),
        "post_restart_attainment": post_att,
        "passed": bool(ejected and federation_saw_dead and readmitted and error_rate <= 0.2
                       and post and post_att and post_att > 0.5),
    })
    return report


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------


def render_summary(report: dict[str, Any]) -> str:
    lines = [f"chaos [{report['mode']}] {report.get('label')}: "
             + ("PASSED" if report.get("passed") else "FAILED")]
    if report["mode"] == "train":
        if report.get("nan_storm"):
            lines.append(f"  storm    {report.get('fault_events')} injected fault(s) -> "
                         f"{report.get('recovery_events')} recovery action(s) "
                         f"{report.get('recovery_stages')}")
            lines.append(f"  rejoin   params {report.get('params_max_abs_delta')} "
                         f"(tolerance {report.get('tolerance')}), final loss {report.get('final_loss')}")
            lines.append(f"  compiles golden {report.get('compile_events_golden')} / "
                         f"chaos {report.get('compile_events_chaos')}")
            return "\n".join(lines)
        if report.get("reshard"):
            lines.append(f"  reshard  {report['reshard']} devices — "
                         f"{report.get('reshard_events')} reshard event(s) logged")
        lines.append(f"  kills    {report.get('kills')} ({report.get('signal')}) — "
                     f"{report.get('steps_chaos')}/{report.get('steps_golden')} steps covered, "
                     f"{report.get('steps_missing')} missing")
        lines.append(f"  deltas   loss {report.get('loss_delta')}  params "
                     f"{report.get('params_max_abs_delta')}  (tolerance {report.get('tolerance')})")
        lines.append(f"  recovery max {report.get('recovery_s')}s")
    elif report.get("fleet"):
        lines.append(f"  fleet    killed replica {report.get('killed_replica')} of "
                     f"{report.get('replicas')}: ejected in {report.get('eject_s')}s, "
                     f"re-admitted in {report.get('recovery_s')}s")
        lines.append(f"  federate survivor scrape saw the dead member: "
                     f"{report.get('federation_saw_dead')} ({report.get('federate_up')})")
        lines.append(f"  traffic  {report.get('requests')} requests through the router, "
                     f"ok {report.get('ok')}, errors {report.get('errors')} (rate {report.get('error_rate')})")
        att = report.get("post_restart_attainment")
        lines.append("  post-restart attainment " + ("-" if att is None else f"{100 * att:.2f}%")
                     + f" over {report.get('post_restart_requests')} requests")
    else:
        lines.append(f"  recovery {report.get('recovery_s')}s after SIGKILL at t={report.get('kill_after_s')}s")
        lines.append(f"  traffic  {report.get('requests')} requests, ok {report.get('ok')}, "
                     f"errors {report.get('errors')} (rate {report.get('error_rate')})")
        att = report.get("post_restart_attainment")
        lines.append("  post-restart attainment " + ("-" if att is None else f"{100 * att:.2f}%")
                     + f" over {report.get('post_restart_requests')} requests")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ddr chaos",
        description="Kill-and-resume verification: prove training resumes step-exactly after SIGKILL "
        "and serving recovers under load; writes a CHAOS_*.json record.",
    )
    sub = parser.add_subparsers(dest="mode")

    p_train = sub.add_parser("train", help="kill/resume a real training subprocess")
    p_train.add_argument("--kills", default=",".join(map(str, DEFAULT_KILLS)),
                         help="comma-separated mini-batch indices to kill after "
                         f"(default {','.join(map(str, DEFAULT_KILLS))})")
    p_train.add_argument("--signal", choices=("kill", "term"), default="kill",
                         help="kill -9 (hard preemption) or SIGTERM (graceful drill)")
    p_train.add_argument("--reshard", default=None, metavar="W1:W2",
                         help="the JAX command's elastic mesh-change drill; needs sharded state "
                         "(ROADMAP A.13), so it raises here")
    p_train.add_argument("--segments", type=int, default=48, help="synthetic reach count (default 48)")
    p_train.add_argument("--epochs", type=int, default=1)
    p_train.add_argument("--tolerance", type=float, default=None,
                         help="max |loss/params delta| against the golden run (default 1e-4; 0.1 "
                         "with --nan-storm)")
    p_train.add_argument("--timeout", type=float, default=600.0,
                         help="per-subprocess wall ceiling, seconds")
    p_train.add_argument("--nan-storm", action="store_true", dest="nan_storm",
                         help="self-healing drill instead of kill/resume: one non-finite storm at "
                         "each nan fault site, a recovery event per storm and a final-params rejoin "
                         "within --tolerance (at least 2 epochs, so a clean epoch can rejoin)")

    p_serve = sub.add_parser("serve", help="kill/restart a serving replica under load")
    p_serve.add_argument("--synthetic", action="store_true",
                         help="launch a synthetic-basin ddr serve subprocess")
    p_serve.add_argument("--url", default=None, help=argparse.SUPPRESS)
    p_serve.add_argument("--segments", type=int, default=64)
    p_serve.add_argument("--horizon", type=int, default=16, help="forecast horizon, hours (default 16)")
    p_serve.add_argument("--rps", type=float, default=10.0)
    p_serve.add_argument("--duration", type=float, default=10.0, help="load window, seconds (default 10)")
    p_serve.add_argument("--kill-after", type=float, default=3.0,
                         help="SIGKILL the replica this many seconds into the load")
    p_serve.add_argument("--kill-replica", action="store_true", dest="kill_replica",
                         help="fleet drill: a 2-replica group behind the router, one member "
                         "SIGKILLed under load; requires ejection, a bounded error rate, "
                         "ddr_federate_up 0 on the survivor's federated scrape and readmission")
    p_serve.add_argument("--max-inflight", type=int, default=32)
    p_serve.add_argument("--seed", type=int, default=0)
    p_serve.add_argument("--boot-timeout", type=float, default=300.0,
                         help="readiness ceiling per boot, seconds")

    for p in (p_train, p_serve):
        p.add_argument("overrides", nargs="*", metavar="a.b=c",
                       help="overrides of every subprocess's config (device=cpu and the like)")
        p.add_argument("--label", default=None,
                       help="report name suffix (CHAOS_<label>.json; default timestamp)")
        p.add_argument("--out", default=None, help="report/work directory (default: DDR_METRICS_DIR or .)")
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    if not args.mode:
        parser.print_help()
        return 2
    bad = [o for o in args.overrides if "=" not in o]
    if bad:
        print(f"ddr chaos: overrides take the form a.b=c, got {bad}", file=sys.stderr)
        return 2

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args.out = args.out or os.environ.get("DDR_METRICS_DIR") or "."
    args.label = args.label or time.strftime("%Y%m%d-%H%M%S")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    from ddr_tpu_torch.observability.events import run_telemetry

    with run_telemetry(None, "chaos", base_dir=str(out_dir), mode=args.mode):
        if args.mode == "train" and getattr(args, "nan_storm", False):
            report = run_chaos_nan_storm(args)
        elif args.mode == "train":
            report = run_chaos_train(args)
        elif getattr(args, "kill_replica", False):
            report = run_chaos_serve_fleet(args)
        else:
            report = run_chaos_serve(args)
        _emit_chaos(mode=args.mode, action="report", passed=report["passed"])

    path = out_dir / f"CHAOS_{args.label}.json"
    path.write_text(json.dumps(report, indent=2) + "\n")
    log.info(f"chaos report written to {path}")
    print(render_summary(report))
    print(json.dumps(report))  # the last stdout line stays machine-readable
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
