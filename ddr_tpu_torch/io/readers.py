"""Data-source readers: the port's copy of ``ddr_tpu/io/readers.py`` on numpy
and the standard library. Binsparse adjacency, the gauge CSV (read with the
``csv`` module), the gauge filters and flow scaling, and the lateral-inflow
and observation readers over the hydro stores. Everything they return is
host numpy.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Any

import numpy as np
from scipy import sparse

from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.io.stores import HydroStore, open_hydro_store

log = logging.getLogger(__name__)

__all__ = [
    "read_coo",
    "read_zarr",
    "convert_ft3_s_to_m3_s",
    "csv_column",
    "read_gage_info",
    "derive_gage_reference_columns",
    "filter_gages_by_area_threshold",
    "filter_gages_by_da_valid",
    "filter_headwater_gages",
    "compute_flow_scale_factor",
    "build_flow_scale_tensor",
    "naninfmean",
    "fill_nans",
    "ObservationSet",
    "StreamflowReader",
    "USGSObservationReader",
]


def read_coo(path: Path | str, key: str) -> tuple[sparse.coo_matrix, zarrlite.ZarrGroup]:
    """One gauge's binsparse COO subgroup and the subgroup."""
    from ddr_tpu_torch.engine.core import read_coo_arrays

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Cannot find file: {path}")
    root = zarrlite.open_group(path)
    try:
        gauge_root = root[key]
    except KeyError as e:
        raise KeyError(f"Cannot find key: {key}") from e
    assert isinstance(gauge_root, zarrlite.ZarrGroup)
    coo, _ = read_coo_arrays(gauge_root)
    return coo, gauge_root


def read_zarr(path: Path | str) -> zarrlite.ZarrGroup:
    """Open a zarr group."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Cannot find file: {path}")
    return zarrlite.open_group(path)


def convert_ft3_s_to_m3_s(flow_rates_ft3_s: np.ndarray) -> np.ndarray:
    return flow_rates_ft3_s * 0.0283168


def csv_column(values: list[str]) -> np.ndarray:
    """One CSV column as ``pandas.read_csv`` types it: int64 when every cell
    is an integer, float64 when every cell is a number or empty (empty is
    NaN), bool when every cell is ``True``/``False``, else the text."""
    cells = [v.strip() for v in values]
    try:
        return np.asarray([int(v) for v in cells], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.asarray([float(v) if v else np.nan for v in cells], dtype=np.float64)
    except ValueError:
        pass
    truth = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}
    if cells and all(v in truth for v in cells):
        return np.asarray([truth[v] for v in cells], dtype=bool)
    return np.asarray([v if v else np.nan for v in values], dtype=object)


def read_gage_info(gage_info_path: Path | str) -> dict[str, list]:
    """Gauge CSV -> column dict, each column typed as ``pandas.read_csv``
    types it, ``STAID`` read as text and zero-padded to 8 characters. A
    missing ``STANAME`` falls back to the unpadded ``STAID``; the optional
    columns are kept when present."""
    expected = ["STAID", "STANAME", "DRAIN_SQKM", "LAT_GAGE", "LNG_GAGE"]
    optional = [
        "COMID",
        "COMID_DRAIN_SQKM",
        "ABS_DIFF",
        "COMID_UNITAREA_SQKM",
        "DA_VALID",
        "FLOW_SCALE",
    ]
    try:
        with open(gage_info_path, newline="") as f:
            reader = csv.reader(f, delimiter=",")
            header = next(reader)
            rows = list(reader)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"File not found: {gage_info_path}") from e

    raw = {name: [r[j] for r in rows] for j, name in enumerate(header)}
    missing = set(expected) - set(raw)
    if missing and missing != {"STANAME"}:
        raise KeyError(f"The CSV file is missing the following headers: {sorted(missing)}")

    def column(name: str) -> list:
        if name == "STAID" or (name == "STANAME" and name not in header):
            return [v if v else np.nan for v in raw["STAID"]]  # text, never a number
        return csv_column(raw[name]).tolist()

    out: dict[str, list] = {field: column(field) for field in expected}
    out["STAID"] = [str(s).zfill(8) for s in out["STAID"]]
    for col in optional:
        if col in raw:
            out[col] = column(col)
    return out


def derive_gage_reference_columns(table: dict[str, Any]) -> dict[str, Any]:
    """Derive the ABS_DIFF / DA_VALID / FLOW_SCALE gauge-reference columns
    from raw drainage areas, over a column mapping (name -> values, as
    :func:`read_gage_info` returns). Requires ``DRAIN_SQKM``,
    ``COMID_DRAIN_SQKM`` and ``COMID_UNITAREA_SQKM``:

    - ``ABS_DIFF`` = |DRAIN_SQKM - COMID_DRAIN_SQKM|
    - ``DA_VALID`` = ABS_DIFF <= max(COMID_UNITAREA_SQKM, 100 km²)
    - ``FLOW_SCALE`` = (unit - ABS_DIFF) / unit when the gauge sits upstream
      of the catchment outlet (DRAIN < COMID_DRAIN) and the mismatch is
      inside one unit area; 1.0 otherwise.

    Returns a copy with the three columns added as numpy arrays (float64,
    bool, float64). A NaN area compares false, as in pandas.
    """
    required = {"DRAIN_SQKM", "COMID_DRAIN_SQKM", "COMID_UNITAREA_SQKM"}
    missing = required - set(table)
    if missing:
        raise KeyError(f"gage table is missing columns: {sorted(missing)}")
    out = dict(table)
    drain = np.asarray(table["DRAIN_SQKM"], dtype=np.float64)
    unit = np.asarray(table["COMID_UNITAREA_SQKM"], dtype=np.float64)
    diff = drain - np.asarray(table["COMID_DRAIN_SQKM"], dtype=np.float64)
    abs_diff = np.abs(diff)
    with np.errstate(invalid="ignore", divide="ignore"):
        out["ABS_DIFF"] = abs_diff
        # pandas' clip(lower=) keeps a NaN a NaN, so its comparison is False
        out["DA_VALID"] = abs_diff <= np.where(np.isnan(unit), np.nan, np.maximum(unit, 100.0))
        scale = (unit - abs_diff) / unit
        out["FLOW_SCALE"] = np.where((diff < 0) & (abs_diff < unit), scale, 1.0)
    return out


def filter_gages_by_area_threshold(
    gage_ids: np.ndarray, gage_dict: dict[str, list], threshold: float
) -> tuple[np.ndarray, int]:
    """Drop gauges whose |gauge area - catchment area| exceeds ``threshold`` km^2."""
    if "ABS_DIFF" not in gage_dict:
        raise KeyError("gage_dict must contain 'ABS_DIFF' key for area threshold filtering")
    abs_diff = {str(s): d for s, d in zip(gage_dict["STAID"], gage_dict["ABS_DIFF"])}
    keep = np.array([abs_diff.get(g, np.inf) <= threshold for g in gage_ids], dtype=bool)
    return gage_ids[keep], int(len(gage_ids) - keep.sum())


def filter_gages_by_da_valid(
    gage_ids: np.ndarray, gage_dict: dict[str, list]
) -> tuple[np.ndarray, int]:
    """Keep only the gauges whose DA_VALID flag is truthy."""
    if "DA_VALID" not in gage_dict:
        raise KeyError("gage_dict must contain 'DA_VALID' key for DA_VALID filtering")
    valid = {str(s): v for s, v in zip(gage_dict["STAID"], gage_dict["DA_VALID"])}
    keep = np.array([bool(valid.get(g, False)) for g in gage_ids], dtype=bool)
    return gage_ids[keep], int(len(gage_ids) - keep.sum())


def filter_headwater_gages(
    gage_ids: np.ndarray, gages_adjacency: zarrlite.ZarrGroup
) -> tuple[np.ndarray, int]:
    """Drop the gauges with no subset store or a single-reach one (empty
    ``indices_0``): routing is trivial there."""
    keep = np.ones(len(gage_ids), dtype=bool)
    for i, gid in enumerate(gage_ids):
        if gid not in gages_adjacency:
            keep[i] = False
            continue
        sub = gages_adjacency[gid]
        assert isinstance(sub, zarrlite.ZarrGroup)
        if sub["indices_0"].shape[0] == 0:
            keep[i] = False
    return gage_ids[keep], int(len(gage_ids) - keep.sum())


def compute_flow_scale_factor(
    drain_sqkm: float, comid_drain_sqkm: float, comid_unitarea_sqkm: float
) -> float:
    """The share of Q' to keep when a gauge sits partway through its
    catchment; 1.0 means no scaling."""
    if np.isnan(drain_sqkm) or np.isnan(comid_drain_sqkm) or np.isnan(comid_unitarea_sqkm):
        return 1.0
    if comid_unitarea_sqkm <= 0:
        return 1.0
    diff = drain_sqkm - comid_drain_sqkm
    if diff >= 0:
        return 1.0
    if abs(diff) >= comid_unitarea_sqkm:
        return 1.0
    return (comid_unitarea_sqkm - abs(diff)) / comid_unitarea_sqkm


def build_flow_scale_tensor(
    batch: list[str],
    gage_dict: dict[str, list],
    gage_compressed_indices: list[int],
    num_segments: int,
) -> np.ndarray:
    """Per-segment Q' scale: 1.0 except at the gauge segments that need the
    partial-drainage-area correction, from the FLOW_SCALE column when the
    CSV has one, else from the raw areas."""
    flow_scale = np.ones(num_segments, dtype=np.float32)
    staid_to_idx = {str(s): i for i, s in enumerate(gage_dict["STAID"])}

    if "FLOW_SCALE" in gage_dict:
        for staid, seg_idx in zip(batch, gage_compressed_indices):
            di = staid_to_idx.get(str(staid).zfill(8))
            if di is None:
                continue
            val = gage_dict["FLOW_SCALE"][di]
            if isinstance(val, float) and np.isnan(val):
                continue
            flow_scale[seg_idx] = val
        return flow_scale

    if "COMID_DRAIN_SQKM" not in gage_dict or "COMID_UNITAREA_SQKM" not in gage_dict:
        return flow_scale

    for staid, seg_idx in zip(batch, gage_compressed_indices):
        di = staid_to_idx.get(str(staid).zfill(8))
        if di is None:
            continue
        flow_scale[seg_idx] = compute_flow_scale_factor(
            drain_sqkm=gage_dict["DRAIN_SQKM"][di],
            comid_drain_sqkm=gage_dict["COMID_DRAIN_SQKM"][di],
            comid_unitarea_sqkm=gage_dict["COMID_UNITAREA_SQKM"][di],
        )
    return flow_scale


def naninfmean(arr: np.ndarray) -> Any:
    """Mean of the finite values; NaN if there are none."""
    finite = arr[np.isfinite(arr)]
    return np.mean(finite) if finite.size else np.nan


def fill_nans(attr: np.ndarray, row_means: np.ndarray | None = None) -> np.ndarray:
    """NaN -> the global mean, or the per-row means when given (float64)."""
    attr = np.asarray(attr, dtype=np.float64)
    if row_means is None:
        return np.where(np.isnan(attr), np.nanmean(attr), attr)
    row_means = np.asarray(row_means, dtype=np.float64)
    if attr.ndim == 2 and row_means.ndim == 1 and row_means.size > 1:
        row_means = row_means[:, None]
    return np.where(np.isnan(attr), row_means, attr)


class ObservationSet:
    """Observed streamflow for a batch: ``streamflow`` ``(n_gauges, n_days)``
    in m^3/s with NaN gaps, ``gage_ids`` the zero-padded STAIDs, ``time``
    the days."""

    def __init__(self, gage_ids: list[str], time: np.ndarray, streamflow: np.ndarray) -> None:
        self.gage_ids = [str(g).zfill(8) for g in gage_ids]
        self.time = time
        self.streamflow = streamflow

    def sel_gages(self, gage_ids: list[str]) -> "ObservationSet":
        idx = {g: i for i, g in enumerate(self.gage_ids)}
        rows = [idx[str(g).zfill(8)] for g in gage_ids]
        return ObservationSet(gage_ids, self.time, self.streamflow[rows])


class StreamflowReader:
    """Lateral-inflow (q') reader over a hydro store.

    ``forward(routing_dataclass=rd)`` returns float32 ``(n_timesteps,
    n_divides)``: an hourly store is indexed by the batch's hours; a daily
    store is repeated x24 and trimmed to the batch's hourly window. Divides
    the store lacks get 0.001 m^3/s.
    """

    def __init__(self, cfg: Any) -> None:
        self.cfg = cfg
        self.store: HydroStore = open_hydro_store(cfg.data_sources.streamflow)
        self.is_hourly = bool(
            getattr(cfg.data_sources, "is_hourly", False) or self.store.is_hourly
        )
        self.divide_id_to_index = self.store.id_to_index

    def forward(self, **kwargs: Any) -> np.ndarray:
        rd = kwargs["routing_dataclass"]
        valid_rows, divide_mask = [], []
        for i, divide_id in enumerate(rd.divide_ids):
            row = self.divide_id_to_index.get(divide_id)
            if row is None:
                # numpy scalars and int-vs-str ids: normalise before giving up
                row = self.divide_id_to_index.get(
                    int(divide_id) if str(divide_id).isdigit() else str(divide_id)
                )
            if row is not None:
                valid_rows.append(row)
                divide_mask.append(i)
            else:
                log.info(f"{divide_id} missing from the streamflow dataset")
        assert len(valid_rows) != 0, "No valid divide IDs found in this batch. Throwing error"

        dates = rd.dates
        if self.is_hourly:
            hours = np.asarray(dates.batch_hourly_time_range).astype("datetime64[s]") - self.store.start_date
            time_idx = hours // np.timedelta64(3600, "s")
        else:
            time_idx = dates.numerical_time_range - self.store.time_offset_days
        time_idx = np.asarray(time_idx, dtype=np.int64)
        n_time = self.store.n_time("Qr")
        assert time_idx[0] >= 0, (
            f"Adjusted time index {time_idx[0]} is negative. Store starts "
            f"{self.store.start_date}, requested dates start before store coverage."
        )
        assert time_idx[-1] < n_time, (
            f"Adjusted time index {time_idx[-1]} exceeds store length {n_time}."
        )

        data = self.store.select("Qr", np.asarray(valid_rows), time_idx)  # (n_valid, T*)
        if not self.is_hourly:
            n_hourly = len(dates.batch_hourly_time_range)
            data = np.repeat(data.astype(np.float32), 24, axis=1)[:, :n_hourly]
        out = np.full((data.shape[1], len(rd.divide_ids)), 0.001, dtype=np.float32)
        out[:, divide_mask] = data.T
        return out

    __call__ = forward


class USGSObservationReader:
    """USGS observation store reader: the gauge CSV's STAIDs by the batch's
    days."""

    def __init__(self, cfg: Any) -> None:
        self.cfg = cfg
        self.store = open_hydro_store(cfg.data_sources.observations)
        if cfg.data_sources.gages is None:
            raise ValueError("data_sources.gages must be set for USGSObservationReader")
        self.gage_dict = read_gage_info(Path(cfg.data_sources.gages))

    def read_data(self, dates: Any) -> ObservationSet:
        padded = [str(g).zfill(8) for g in self.gage_dict["STAID"]]
        rows = []
        for g in padded:
            if g not in self.store.id_to_index:
                raise KeyError(f"gage {g} not present in the observation store")
            rows.append(self.store.id_to_index[g])
        time_idx = dates.numerical_time_range - self.store.time_offset_days
        n_time = self.store.n_time("streamflow")
        assert time_idx[0] >= 0, (
            f"Adjusted time index {time_idx[0]} is negative. Observation store starts "
            f"{self.store.start_date}, requested dates start before store coverage."
        )
        assert time_idx[-1] < n_time, (
            f"Adjusted time index {time_idx[-1]} exceeds observation store length {n_time}."
        )
        data = self.store.select("streamflow", np.asarray(rows), time_idx)
        return ObservationSet(padded, dates.batch_daily_time_range, data)
