"""Minimal configuration for the serving and training slices: plain dataclasses.

Field names and defaults follow the JAX package's pydantic ``params``,
``kan`` and ``experiment`` sections (the ``experiment`` fields the train step
reads), so a config written for one reads the same in the other.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Config", "ExperimentConfig", "KanConfig", "Params"]


@dataclasses.dataclass
class Params:
    """Physical parameter config."""

    attribute_minimums: dict[str, float] = dataclasses.field(
        default_factory=lambda: {
            "discharge": 0.0001,
            "slope": 0.001,
            "velocity": 0.01,
            "depth": 0.01,
            "bottom_width": 0.01,
        }
    )
    parameter_ranges: dict[str, list[float]] = dataclasses.field(
        default_factory=lambda: {
            "n": [0.015, 0.25],
            "q_spatial": [0.0, 1.0],
            "p_spatial": [1.0, 200.0],
        }
    )
    log_space_parameters: list[str] = dataclasses.field(default_factory=lambda: ["p_spatial"])
    defaults: dict[str, float] = dataclasses.field(default_factory=lambda: {"p_spatial": 21})
    tau: int = 3  # routing timestep offset of the daily trim


@dataclasses.dataclass
class KanConfig:
    """KAN architecture config."""

    input_var_names: list[str]
    learnable_parameters: list[str] = dataclasses.field(default_factory=lambda: ["n", "q_spatial"])
    hidden_size: int = 11
    num_hidden_layers: int = 1
    grid: int = 3
    k: int = 3
    grid_range: list[float] = dataclasses.field(default_factory=lambda: [-2.0, 2.0])


@dataclasses.dataclass
class ExperimentConfig:
    """Training experiment config (the fields the train step reads)."""

    batch_size: int = 1
    epochs: int = 1
    learning_rate: dict[int, float] = dataclasses.field(
        default_factory=lambda: {1: 0.005, 3: 0.001}
    )  # epoch -> learning rate, the latest at or before an epoch applies
    rho: int | None = None  # days per random training window
    warmup: int = 3  # days excluded from the loss while routing spins up


@dataclasses.dataclass
class Config:
    kan: KanConfig
    params: Params = dataclasses.field(default_factory=Params)
    experiment: ExperimentConfig = dataclasses.field(default_factory=ExperimentConfig)
