"""``ddr chaos`` on the port: the JAX command's unit cases against the
port's (the log harvest, the drill config, the summary of every mode, the
CLI's refusals), ``--reshard`` naming ROADMAP A.13, and the drills
themselves on the CPU: ``chaos train --segments 32 --kills 1 device=cpu``
(step-exact: the losses and final weights of the resumed run equal the
golden run's within the command's default tolerance, 1e-4) and ``chaos
serve --synthetic --segments 32 device=cpu`` (the replica restarts and
answers after the kill). Each drill runs under its own subprocess
deadline (``--timeout``, ``--boot-timeout``), and the harness kills its own
children in ``finally`` blocks."""

from __future__ import annotations

import json

import pytest

from ddr_tpu.scripts import chaos as jax_chaos
from ddr_tpu_torch import cli
from ddr_tpu_torch.scripts import chaos
from ddr_tpu_torch.validation.yaml_subset import safe_load

#: The keys of the JAX command's train record (``ddr_tpu/scripts/chaos.py``).
JAX_TRAIN_KEYS = {"kind", "schema_version", "mode", "label", "device", "signal", "reshard", "reshard_events",
                  "kills", "steps_golden", "steps_chaos", "steps_missing", "loss_delta",
                  "params_max_abs_delta", "recovery_s", "mean_recovery_s", "trace", "tolerance", "passed"}
JAX_SERVE_KEYS = {"kind", "mode", "label", "kill_after_s", "recovery_s", "recovered", "post_restart_requests",
                  "post_restart_attainment", "passed", "requests", "ok", "errors", "error_rate", "shed_rate"}


def test_read_jsonl_equals_jax(tmp_path):
    p = tmp_path / "log.jsonl"
    p.write_text('{"event": "step", "loss": 1.0}\n\n[1, 2]\n{"event": "st')
    assert chaos._read_jsonl(p) == jax_chaos._read_jsonl(p) == [{"event": "step", "loss": 1.0}]
    assert chaos._read_jsonl(tmp_path / "missing.jsonl") == jax_chaos._read_jsonl(tmp_path / "missing.jsonl") == []


def test_step_losses_equal_jax():
    events = [
        {"event": "step", "epoch": 1, "batch": 0, "loss": 2.0},
        {"event": "step", "epoch": 1, "batch": 1, "loss": 1.5},
        {"event": "heartbeat", "epoch": 1},
        {"event": "step", "epoch": 1, "batch": 2, "loss": None},
        {"event": "step", "epoch": 1, "batch": 1, "loss": 1.4},  # the last wins
    ]
    assert chaos._step_losses(events) == jax_chaos._step_losses(events) == {(1, 0): 2.0, (1, 1): 1.4}


@pytest.mark.parametrize("checkpoint", [None, "run/saved_models"])
def test_train_cfg_equals_jax_and_reads_back(tmp_path, checkpoint):
    class A:
        segments, epochs = 32, 2

    ck = None if checkpoint is None else tmp_path / checkpoint
    got = chaos._train_cfg_dict(tmp_path / "run", ck, A)
    assert got == jax_chaos._train_cfg_dict(tmp_path / "run", ck, A)
    # the block YAML the port writes reads back as the dict (PyYAML agrees)
    import yaml

    text = chaos._yaml_text(got)
    assert safe_load(text) == yaml.safe_load(text) == json.loads(json.dumps(got), object_hook=_int_keys)


def _int_keys(d):
    return {int(k) if k.isdigit() else k: v for k, v in d.items()}


def test_serve_cfg_equals_jax(tmp_path):
    class A:
        segments = 64

    got = chaos._serve_cfg_dict(tmp_path, A)
    assert got == jax_chaos._serve_cfg_dict(tmp_path, A)
    assert safe_load(chaos._yaml_text(got)) == got


def test_subprocess_env_stamps_no_compile_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("DDR_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.setenv("DDR_METRICS_DIR", "/nope")
    env = chaos._subprocess_env(tmp_path)
    assert "DDR_METRICS_DIR" not in env and "DDR_COMPILE_CACHE_DIR" not in env


TRAIN = {"mode": "train", "label": "x", "passed": True, "kills": [1, 2], "signal": "kill", "steps_chaos": 4,
         "steps_golden": 4, "steps_missing": 0, "loss_delta": 0.0, "params_max_abs_delta": 0.0,
         "tolerance": 1e-4, "recovery_s": 3.2}
STORM = {"mode": "train", "label": "n", "passed": True, "nan_storm": True, "fault_events": 3,
         "recovery_events": 3, "recovery_stages": {"skip": 3}, "params_max_abs_delta": 0.07,
         "tolerance": 0.1, "final_loss": 0.19, "compile_events_golden": 0, "compile_events_chaos": 0}
SERVE = {"mode": "serve", "label": "y", "passed": False, "recovery_s": 9.9, "kill_after_s": 3.0, "requests": 10,
         "ok": 2, "errors": 8, "error_rate": 0.8, "post_restart_attainment": None, "post_restart_requests": 0}
FLEET = {"mode": "serve", "fleet": True, "label": "z", "passed": True, "killed_replica": 1, "replicas": 2,
         "eject_s": 0.4, "recovery_s": 6.2, "federation_saw_dead": True,
         "federate_up": {"chaos-r0": "1", "chaos-r1": "0"}, "requests": 85, "ok": 85, "errors": 0,
         "error_rate": 0.0, "post_restart_attainment": 1.0, "post_restart_requests": 12}


@pytest.mark.parametrize("report", [TRAIN, {**TRAIN, "reshard": "4:2", "reshard_events": 1}, STORM, SERVE, FLEET],
                         ids=["train", "train-reshard", "nan-storm", "serve", "fleet"])
def test_render_summary_equals_jax(report):
    assert chaos.render_summary(report) == jax_chaos.render_summary(report)


def test_cli_refusals_equal_jax(capsys):
    assert chaos.main([]) == jax_chaos.main([]) == 2
    capsys.readouterr()
    for fn in (chaos.run_chaos_serve, jax_chaos.run_chaos_serve):
        with pytest.raises(SystemExit, match="needs --synthetic"):
            fn(type("A", (), {"synthetic": False, "url": None})())
        with pytest.raises(SystemExit, match="only supports --synthetic"):
            fn(type("A", (), {"synthetic": False, "url": "http://x"})())
    for fn in (chaos.run_chaos_serve_fleet, jax_chaos.run_chaos_serve_fleet):
        with pytest.raises(SystemExit, match="needs --synthetic"):
            fn(type("A", (), {"synthetic": False})())
    assert chaos.main(["train", "oops"]) == 2


def test_reshard_names_its_item(tmp_path):
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.13"):
        chaos.main(["train", "--reshard", "4:2", "--out", str(tmp_path), "--label", "r", "device=cpu"])
    assert not (tmp_path / "CHAOS_r.json").exists()


def test_chaos_is_dispatched():
    from ddr_tpu_torch.cli import _COMMANDS, _NOT_PORTED

    assert _COMMANDS["chaos"] == "ddr_tpu_torch.scripts.chaos" and "chaos" not in _NOT_PORTED


def test_chaos_train_kill_and_resume_on_the_cpu(tmp_path):
    rc = cli.main(["chaos", "train", "--segments", "32", "--kills", "1", "--timeout", "240", "--label", "e2e",
                   "--out", str(tmp_path), "device=cpu"])
    report = json.loads((tmp_path / "CHAOS_e2e.json").read_text())
    assert rc == 0 and report["passed"] is True, report
    assert JAX_TRAIN_KEYS <= report.keys()
    assert report["device"] == "cpu" and report["kills"] == [1] and report["steps_missing"] == 0
    assert report["steps_chaos"] == report["steps_golden"] == 4
    assert report["loss_delta"] <= 1e-4 and report["params_max_abs_delta"] <= 1e-4
    assert report["recovery_s"] > 0 and report["resumed_from"] == ["_chaos_epoch_1_mb_1.pkl"]
    assert report["pace_ms"] == chaos.KILL_PACE_MS  # the killed attempt was paced
    events = chaos._read_jsonl(tmp_path / "run_log.chaos.jsonl")
    actions = [e["action"] for e in events if e["event"] == "chaos"]
    assert actions == ["kill", "resume", "report"]


def test_chaos_serve_kill_and_restart_on_the_cpu(tmp_path):
    rc = cli.main(["chaos", "serve", "--synthetic", "--segments", "32", "--rps", "8", "--duration", "5",
                   "--kill-after", "1.5", "--boot-timeout", "120", "--label", "se2e", "--out", str(tmp_path),
                   "device=cpu"])
    report = json.loads((tmp_path / "CHAOS_se2e.json").read_text())
    assert rc == 0 and report["passed"] is True, report
    assert JAX_SERVE_KEYS <= report.keys()
    assert report["recovered"] is True and report["recovery_s"] > 0
    assert report["post_restart_requests"] > 0 and report["post_restart_attainment"] > 0.5
    assert report["device"] == "cpu"
