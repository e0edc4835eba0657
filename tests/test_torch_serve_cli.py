"""``python -m ddr_tpu_torch.cli serve`` end to end on the CPU.

The command runs in a subprocess on the example config with ``device=cpu``
and ``DDR_SERVE_PORT`` set to a free port. It must reach ``/readyz`` 200,
answer every GET endpoint, answer a ``t0`` forecast equal to
``build_service``'s in-process answer for the same config, hot-reload the
checkpoints that the port's ``ddr train`` writes into its ``saved_models/``
while it serves (its answer then equals a fresh service's built from the
newest one), and stop cleanly on SIGINT with exit code 0. Without
``device=cpu`` and without a card it raises.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from ddr_tpu_torch import cli
from ddr_tpu_torch.scripts.common import parse_cli
from ddr_tpu_torch.scripts.serve import build_service
from ddr_tpu_torch.serving.client import HttpForecastClient
from ddr_tpu_torch.serving.config import ServeConfig
from ddr_tpu_torch.training import latest_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "examples" / "synthetic" / "config.yaml")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _in_process(save_path: Path, *overrides: str) -> np.ndarray:
    cfg = parse_cli([CONFIG, "device=cpu", f"params.save_path={save_path}", *overrides], mode="testing")
    svc = build_service(cfg, ServeConfig(), watch=False)
    try:
        return svc.forecast(network="default", t0=100, timeout=60)["runoff"]
    finally:
        svc.close()


def test_serve_command_answers_hot_reloads_and_stops(tmp_path):
    port = _free_port()
    run = tmp_path / "run"
    log_path = tmp_path / "serve.log"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DDR_", "PYTHON"))}
    env.update(DDR_SERVE_PORT=str(port), DDR_SERVE_RELOAD_POLL_MS="100")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ddr_tpu_torch.cli", "serve", CONFIG, "device=cpu",
             f"params.save_path={run}"], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        client = HttpForecastClient(url)
        deadline = time.monotonic() + 180
        while not client.ready():
            assert proc.poll() is None, log_path.read_text()
            assert time.monotonic() < deadline, log_path.read_text()
            time.sleep(0.2)
        for path in ("/healthz", "/readyz", "/metrics", "/v1/models", "/v1/networks", "/v1/stats"):
            assert _get(url + path)[0] == 200, path
        nets = json.loads(_get(url + "/v1/networks")[1])["networks"]
        assert nets == {"default": {"n_reaches": 64, "horizon": 72, "engine": "default:wavefront",
                                    "n_outputs": 4}}
        first = client.forecast("default", t0=100, request_id="cli-1")
        assert first["version"] == 1 and first["request_id"] == "cli-1"
        np.testing.assert_array_equal(first["runoff"], _in_process(tmp_path / "inproc"))

        # ddr train writes its checkpoints into the directory the server watches
        assert cli.main(["train", CONFIG, "device=cpu", f"params.save_path={run}"]) == 0
        newest = latest_checkpoint(run / "saved_models")
        assert newest is not None
        deadline = time.monotonic() + 60
        while json.loads(_get(url + "/v1/models")[1])["models"]["default"]["source"] != str(newest):
            assert time.monotonic() < deadline, log_path.read_text()
            time.sleep(0.1)
        reloaded = client.forecast("default", t0=100)
        assert reloaded["version"] >= 2
        fresh = _in_process(tmp_path / "fresh", f"experiment.checkpoint={newest}")
        np.testing.assert_array_equal(reloaded["runoff"], fresh)
        assert not np.array_equal(reloaded["runoff"], first["runoff"])
        metrics = _get(url + "/metrics")[1]
        assert f'ddr_model_version{{host="0",model="default"}} {reloaded["version"]}' in metrics
        assert 'ddr_hot_reloads_total{host="0",model="default"}' in metrics
        assert 'ddr_requests_total{host="0",model="default",network="default",status="ok"} 2' in metrics
    finally:
        proc.send_signal(signal.SIGINT)
        code = proc.wait(timeout=60)
    text = log_path.read_text()
    assert code == 0, text
    assert "shutting down forecast service" in text and "forecast service stopped" in text
    assert "Traceback" not in text, text


def test_serve_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["serve", CONFIG, f"params.save_path={tmp_path}"])
