"""Metric summary logging: the port's copy of ``ddr_tpu/validation/utils.py``."""

from __future__ import annotations

import logging
from typing import Any

import numpy as np

from ddr_tpu_torch.scripts_utils import safe_mean, safe_percentile

__all__ = ["log_metrics", "metrics_summary"]

log = logging.getLogger(__name__)


def metrics_summary(metrics: Any) -> dict[str, dict[str, float]]:
    """Median, mean, p25 and p75 of the headline metrics over the gauges."""
    out: dict[str, dict[str, float]] = {}
    for name in ("nse", "rmse", "kge", "corr", "pbias", "fhv", "flv"):
        values = np.asarray(getattr(metrics, name))
        out[name] = {
            "median": safe_percentile(values, 50),
            "mean": safe_mean(values),
            "p25": safe_percentile(values, 25),
            "p75": safe_percentile(values, 75),
        }
    return out


def log_metrics(metrics: Any, header: str = "") -> None:
    """Log the metric table of a :class:`~ddr_tpu_torch.validation.metrics.Metrics`."""
    summary = metrics_summary(metrics)
    lines = [header or "Evaluation metrics:"]
    lines.append(f"{'metric':>8} | {'median':>8} | {'mean':>8} | {'p25':>8} | {'p75':>8}")
    lines.append("-" * 50)
    for name, row in summary.items():
        lines.append(
            f"{name:>8} | {row['median']:8.3f} | {row['mean']:8.3f} | "
            f"{row['p25']:8.3f} | {row['p75']:8.3f}"
        )
    log.info("\n".join(lines))
