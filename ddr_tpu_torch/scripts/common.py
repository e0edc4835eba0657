"""Shared script scaffolding: argv -> Config, model construction, observation
alignment, and the sequential evaluation loop of ``ddr test``, ``ddr route``
and ``ddr benchmark``. The port's copy of ``ddr_tpu/scripts/common.py``,
single-process (the JAX package's ``is_primary_process`` has no use before
ROADMAP A.13)."""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geodatazoo.loader import DataLoader
from ddr_tpu_torch.io.readers import StreamflowReader
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.observability.events import get_recorder
from ddr_tpu_torch.observability.spans import span
from ddr_tpu_torch.observability.throughput import Throughput
from ddr_tpu_torch.routing.model import dmc
from ddr_tpu_torch.training import load_state
from ddr_tpu_torch.validation.configs import Config, load_config

log = logging.getLogger(__name__)

__all__ = [
    "build_kan",
    "daily_observation_targets",
    "evaluate_hourly",
    "get_flow_fn",
    "kan_arch",
    "load_kan",
    "parse_cli",
    "setup_run",
    "split_config_argv",
    "timed",
]

def split_config_argv(argv: list[str] | None) -> tuple[str | None, list[str]]:
    """``[config.yaml] [a.b=c ...]`` -> ``(path, overrides)``."""
    path = None
    overrides: list[str] = []
    for a in argv or []:
        if "=" in a:
            overrides.append(a)
        elif path is None:
            path = a
        else:
            raise SystemExit(f"unexpected argument {a!r}")
    return path, overrides


def parse_cli(argv: list[str] | None, mode: str) -> Config:
    """``[config.yaml] [a.b=c ...]`` -> validated Config with ``mode`` forced
    and the run directories created."""
    path, overrides = split_config_argv(argv)
    overrides.append(f"mode={mode}")
    return setup_run(load_config(path, overrides))


def setup_run(cfg: Config) -> Config:
    """Create ``<save_path>/saved_models``, configure logging, and check that
    ``cfg.device`` exists (a missing card raises; the CPU is used only when
    the config asks for it)."""
    (Path(cfg.params.save_path) / "saved_models").mkdir(parents=True, exist_ok=True)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    resolve_device(cfg.device)
    return cfg


def build_kan(cfg: Config, device: str | torch.device | None = None) -> Kan:
    """The KAN of ``cfg.kan`` with fresh weights drawn from a generator seeded
    with ``cfg.seed``, on ``device`` (default ``cfg.device``)."""
    generator = torch.Generator().manual_seed(cfg.seed)
    model = Kan(
        input_var_names=tuple(cfg.kan.input_var_names),
        learnable_parameters=tuple(cfg.kan.learnable_parameters),
        hidden_size=cfg.kan.hidden_size,
        num_hidden_layers=cfg.kan.num_hidden_layers,
        grid=cfg.kan.grid,
        k=cfg.kan.k,
        grid_range=tuple(cfg.kan.grid_range),
        generator=generator,
    )
    return model.to(resolve_device(cfg.device if device is None else device))


def kan_arch(cfg: Config) -> dict:
    """Architecture fingerprint stored in and checked against checkpoints:
    the same parameter shapes under another ``grid_range`` or input order
    would compute another function."""
    return {
        "model": "kan",
        "input_var_names": list(cfg.kan.input_var_names),
        "learnable_parameters": list(cfg.kan.learnable_parameters),
        "hidden_size": cfg.kan.hidden_size,
        "num_hidden_layers": cfg.kan.num_hidden_layers,
        "grid": cfg.kan.grid,
        "k": cfg.kan.k,
        "grid_range": list(cfg.kan.grid_range),
    }


def get_flow_fn(cfg: Config, dataset: Any) -> Callable[..., np.ndarray]:
    """The lateral-inflow source: the dataset's own generator (synthetic) or
    a :class:`~ddr_tpu_torch.io.readers.StreamflowReader` over the
    configured store."""
    if hasattr(dataset, "streamflow"):
        return dataset.streamflow
    return StreamflowReader(cfg)


def daily_observation_targets(rd: Any) -> tuple[np.ndarray, np.ndarray]:
    """Batch observations -> ``(obs_daily, mask)``, both ``(D-2, G)``: a
    D-day window's tau-trimmed daily prediction covers observation days
    ``1..D-2``; NaN gaps become masked zeros."""
    obs = np.asarray(rd.observations.streamflow, dtype=np.float32)  # (G, D)
    target = obs[:, 1:-1].T  # (D-2, G)
    mask = np.isfinite(target)
    return np.where(mask, target, 0.0).astype(np.float32), mask


def load_kan(cfg: Config, params: Any = None, purpose: str = "evaluation") -> Kan:
    """The KAN of ``cfg`` on ``cfg.device`` with ``params`` (a state dict of
    tensors or numpy leaves), else the weights of ``cfg.experiment.checkpoint``,
    else fresh weights (with a warning naming ``purpose``)."""
    kan = build_kan(cfg)
    if params is None and cfg.experiment.checkpoint:
        params = load_state(cfg.experiment.checkpoint, expected_arch=kan_arch(cfg))["params"]
    if params is None:
        log.warning(f"Creating new spatial model for {purpose}.")
    else:
        kan.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
    return kan.eval()


def evaluate_hourly(
    cfg: Config,
    dataset: Any,
    flow: Callable[..., np.ndarray],
    kan: Kan,
    routing_model: Any = None,
) -> np.ndarray:
    """Sequential chunked inference with carried discharge state -> hourly
    gauge predictions ``(G, T_hourly)``, the loop ``ddr test`` and the
    benchmark share. Each chunk maps the KAN and routes with
    ``carry_state=i > 0``, so every chunk after the first starts from the
    previous one's final discharge (the scan's ``q_init``). Each chunk is an
    ``eval-batch`` span and one ``eval`` event of the active run recorder;
    its reach-timesteps per second and host milliseconds, synchronised on its
    result, are logged, and the loop's rate at the end."""
    dev = resolve_device(cfg.device)
    routing_model = routing_model or dmc(cfg, device=dev)
    loader = DataLoader(dataset, batch_size=cfg.experiment.batch_size, shuffle=False)
    n_gauges = len(dataset.routing_data.observations.gage_ids)
    predictions = np.zeros((n_gauges, len(dataset.dates.hourly_time_range)), dtype=np.float32)
    throughput = Throughput(label="evaluate")
    rec = get_recorder()
    for i, rd in enumerate(loader):
        q_prime = np.asarray(flow(routing_dataclass=rd), dtype=np.float32)
        with throughput.batch(rd.n_segments, q_prime.shape[0]), span("eval-batch"), torch.no_grad():
            raw = kan(torch.as_tensor(rd.normalized_spatial_attributes, device=dev))
            out = routing_model.forward(rd, q_prime, raw, carry_state=i > 0)
            chunk = out["runoff"].cpu().numpy()  # synchronises
        predictions[:, rd.dates.hourly_indices] = chunk
        log.info(f"evaluate batch {i}: {throughput.last_rate:,.0f} reach-timesteps/s "
                 f"({throughput.last_seconds * 1e3:.3f} ms, {q_prime.shape[0]} h)")
        if rec is not None:
            rec.emit(
                "eval",
                batch=i,
                n_reaches=int(rd.n_segments),
                n_timesteps=int(q_prime.shape[0]),
                seconds=round(throughput.last_seconds, 6),
                reach_timesteps_per_sec=round(throughput.last_rate, 1),
            )
    throughput.log_summary()
    return predictions


@contextmanager
def timed(label: str):
    """Log the minutes the block took."""
    start = time.perf_counter()
    try:
        yield
    finally:
        log.info(f"{label}: {(time.perf_counter() - start) / 60:.3f} minutes elapsed")
