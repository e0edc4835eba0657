"""Batch-time network assembly from the prebuilt gauge subsets: the port's
copy of ``ddr_tpu/io/builders.py``."""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
from scipy import sparse

from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.io.readers import ObservationSet

log = logging.getLogger(__name__)

__all__ = ["construct_network_matrix", "create_hydrofabric_observations", "upstream_closure"]


def construct_network_matrix(
    batch: list[str], subsets: zarrlite.ZarrGroup
) -> tuple[sparse.coo_matrix, list, list]:
    """Union the per-gauge COO subsets of ``batch`` into one full-size COO,
    coordinates deduplicated across gauges; the gauge indices and catchments
    come from each subset's attrs (a gauge lacking either is skipped)."""
    coordinates: set[tuple[int, int]] = set()
    output_idx: list = []
    output_wb: list = []
    attrs: dict = {}
    for _id in batch:
        try:
            gauge_root = subsets[str(_id)]
        except KeyError:
            log.info(f"Cannot find gage {_id} in subsets zarr store. Skipping")
            continue
        assert isinstance(gauge_root, zarrlite.ZarrGroup)
        rows = gauge_root["indices_0"].read()
        cols = gauge_root["indices_1"].read()
        coordinates.update(zip(rows.tolist(), cols.tolist()))
        attrs = dict(gauge_root.attrs)
        if "gage_idx" in attrs and "gage_catchment" in attrs:
            output_idx.append(attrs["gage_idx"])
            output_wb.append(attrs["gage_catchment"])
        else:
            log.info(f"Cannot find gauge attributes for gage {_id}. Skipping")
    if not attrs:
        raise KeyError(f"none of the batch gauges {batch} exist in the subsets store")
    if coordinates:
        r, c = map(list, zip(*coordinates))
    else:
        r, c = [], []
    shape = tuple(attrs["shape"])
    coo = sparse.coo_matrix((np.ones(len(r)), (r, c)), shape=shape)
    return coo, output_idx, output_wb


def create_hydrofabric_observations(
    dates: Any, gage_ids: np.ndarray, observations: ObservationSet
) -> ObservationSet:
    """The observations of this batch's gauges over its days."""
    obs = observations.sel_gages(list(gage_ids))
    time_index = {t: i for i, t in enumerate(np.asarray(observations.time))}
    cols = np.asarray([time_index[t] for t in np.asarray(dates.batch_daily_time_range)])
    return ObservationSet(list(gage_ids), dates.batch_daily_time_range, obs.streamflow[:, cols])


def upstream_closure(
    rows: np.ndarray, cols: np.ndarray, n: int, targets: np.ndarray
) -> np.ndarray:
    """Every reach upstream of ``targets``, the targets included: a
    vectorized reverse breadth-first search over the edge list (edge
    ``cols[i] -> rows[i]``), O(E) a wave."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    in_set = np.zeros(n, dtype=bool)
    in_set[np.asarray(targets, dtype=np.int64)] = True
    frontier = in_set.copy()
    while frontier.any():
        hit = frontier[rows]
        srcs = cols[hit]
        new = np.zeros(n, dtype=bool)
        new[srcs] = True
        frontier = new & ~in_set
        in_set |= new
    return np.flatnonzero(in_set)
