"""Attribute-normalization statistics with a JSON cache: the port's copy of
``ddr_tpu/io/statistics.py``.

:func:`set_statistics` takes ``{attribute_name: (N,) values}`` and gives
per-attribute min/max/mean/std/p10/p90, cached as
``{geodataset}_attribute_statistics_{store_name}.json`` in the configured
statistics directory; the file is byte for byte the JAX package's. The
statistics come back as a plain mapping ``{name: {statistic: value}}``
(the JAX package wraps the same mapping in a DataFrame).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Mapping

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["set_statistics", "compute_statistics"]


def compute_statistics(attrs: Mapping[str, np.ndarray]) -> dict[str, dict[str, float]]:
    out: dict[str, dict[str, float]] = {}
    for name, data in attrs.items():
        data = np.asarray(data, dtype=np.float64)
        out[name] = {
            "min": float(np.nanmin(data)),
            "max": float(np.nanmax(data)),
            "mean": float(np.nanmean(data)),
            "std": float(np.nanstd(data)),
            "p10": float(np.nanpercentile(data, 10)),
            "p90": float(np.nanpercentile(data, 90)),
        }
    return out


def set_statistics(cfg: Any, attrs: Mapping[str, np.ndarray]) -> dict[str, dict[str, float]]:
    """Compute, or load from the cache, the per-attribute statistics. The
    cache key is the geodataset and the attribute store's name, so a store's
    statistics are computed once across runs and commands."""
    attributes_name = Path(str(cfg.data_sources.attributes)).name
    statistics_path = Path(cfg.data_sources.statistics)
    statistics_path.mkdir(parents=True, exist_ok=True)
    geodataset = getattr(cfg.geodataset, "value", str(cfg.geodataset))
    stats_file = statistics_path / f"{geodataset}_attribute_statistics_{attributes_name}.json"

    if stats_file.exists():
        log.info(f"Reading Attribute Statistics from file: {stats_file.name}")
        with open(stats_file) as f:
            payload = json.load(f)
    else:
        log.info(f"Reading {geodataset} attributes to construct statistics")
        payload = compute_statistics(attrs)
        with open(stats_file, "w") as f:
            json.dump(payload, f, indent=2)
    return payload
