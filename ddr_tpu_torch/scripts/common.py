"""Shared script scaffolding: argv -> Config, model construction, observation
alignment. The port's copy of ``ddr_tpu/scripts/common.py``."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.validation.configs import Config, load_config

log = logging.getLogger(__name__)

__all__ = [
    "build_kan",
    "daily_observation_targets",
    "get_flow_fn",
    "kan_arch",
    "parse_cli",
    "setup_run",
    "split_config_argv",
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
    """The lateral-inflow source: the dataset's own generator. The store
    reader of the real-data datasets is not ported yet."""
    if hasattr(dataset, "streamflow"):
        return dataset.streamflow
    raise NotImplementedError(
        "reading lateral inflow from a streamflow store is not ported yet (ROADMAP A.8)"
    )


def daily_observation_targets(rd: Any) -> tuple[np.ndarray, np.ndarray]:
    """Batch observations -> ``(obs_daily, mask)``, both ``(D-2, G)``: a
    D-day window's tau-trimmed daily prediction covers observation days
    ``1..D-2``; NaN gaps become masked zeros."""
    obs = np.asarray(rd.observations.streamflow, dtype=np.float32)  # (G, D)
    target = obs[:, 1:-1].T  # (D-2, G)
    mask = np.isfinite(target)
    return np.where(mask, target, 0.0).astype(np.float32), mask
