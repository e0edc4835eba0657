"""Shared script utilities: the port's copy of ``ddr_tpu/scripts_utils.py``
(daily aggregation, the learning-rate schedule, NaN-safe summaries).

``compute_daily_runoff`` applies the tau-dependent boundary trim: start
``13 + tau`` hours (spin-up and timezone offset), end ``-11 + tau``. A D-day
window spans ``(D - 1) * 24`` hourly steps, so the trim leaves ``D - 2``
daily blocks aligned with observation days ``1..D-2``.
"""

from __future__ import annotations

import numpy as np
import torch

from ddr_tpu_torch.io.functions import downsample

__all__ = ["compute_daily_runoff", "resolve_learning_rate", "safe_mean", "safe_percentile"]


def compute_daily_runoff(hourly_predictions, tau: int) -> np.ndarray:
    """``(G, T_hours)`` hourly discharge (numpy or tensor) -> ``(G, num_days)``
    daily means, tau-trimmed."""
    sliced = torch.as_tensor(hourly_predictions)[:, (13 + tau) : (-11 + tau)]
    num_days = sliced.shape[1] // 24
    sliced = sliced[:, : num_days * 24]
    return downsample(sliced, rho=num_days).cpu().numpy()


def resolve_learning_rate(schedule: dict[int, float], epoch: int) -> float:
    """Latest scheduled learning rate at or before ``epoch``."""
    applicable = [e for e in schedule if e <= epoch]
    if not applicable:
        return schedule[min(schedule)]
    return schedule[max(applicable)]


def safe_percentile(values: np.ndarray, q: float) -> float:
    """Percentile of the finite values; NaN when there are none."""
    finite = np.asarray(values)[np.isfinite(np.asarray(values))]
    return float(np.percentile(finite, q)) if finite.size else float("nan")


def safe_mean(values: np.ndarray) -> float:
    """Mean of the finite values; NaN when there are none."""
    finite = np.asarray(values)[np.isfinite(np.asarray(values))]
    return float(finite.mean()) if finite.size else float("nan")
