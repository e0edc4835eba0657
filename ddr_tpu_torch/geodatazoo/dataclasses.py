"""Batch contracts between the data layer and the routing engine: the port's
copy of ``ddr_tpu/geodatazoo/dataclasses.py`` on numpy and the standard library.

Gauge records (:class:`Gauge`, :class:`MERITGauge`, gathered in a
:class:`GaugeSet`) are validated dataclasses; :class:`Dates` keeps its day and
hour ranges as numpy ``datetime64`` arrays, and draws and indexes batch
windows exactly as the JAX package's pandas form does, so one
``np.random.Generator`` state gives the same windows in both;
:class:`RoutingData` is the one batch contract handed to the engine, its
arrays on the host.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np

__all__ = ["Dates", "Gauge", "GaugeSet", "MERITGauge", "RoutingData", "validate_gages"]

DAILY_FORMAT = "%Y/%m/%d"
ORIGIN_START_DATE = "1980/01/01"  # day 0 of the streamflow stores


@dataclasses.dataclass
class Gauge:
    """One USGS gauge row: ``STAID`` zero-padded to 8 characters, a positive
    drainage area; further CSV columns land in ``extra``."""

    STAID: str
    DRAIN_SQKM: float
    STANAME: str = ""
    LAT_GAGE: float | None = None
    LNG_GAGE: float | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.STAID = str(self.STAID).strip().zfill(8)
        self.STANAME = str(self.STANAME).strip()
        self.DRAIN_SQKM = float(self.DRAIN_SQKM)
        if not self.DRAIN_SQKM > 0:
            raise ValueError(f"gauge {self.STAID}: DRAIN_SQKM must be > 0, got {self.DRAIN_SQKM}")
        for name in ("LAT_GAGE", "LNG_GAGE"):
            value = getattr(self, name)
            if value is not None:
                setattr(self, name, None if str(value).strip() == "" else float(value))

    #: the columns a row must have
    _REQUIRED = ("STAID", "DRAIN_SQKM")

    @classmethod
    def model_validate(cls, row: dict[str, Any]) -> "Gauge":
        """A gauge from one CSV row (a mapping of column name to text)."""
        known = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        missing = [name for name in cls._REQUIRED if name not in row]
        if missing:
            raise ValueError(f"gauge row {row!r}: missing {missing}")
        kwargs = {k: v for k, v in row.items() if k in known}
        return cls(**kwargs, extra={k: v for k, v in row.items() if k not in known})


@dataclasses.dataclass
class MERITGauge(Gauge):
    """A MERIT gauge: a :class:`Gauge` with the COMID of its catchment."""

    COMID: int | None = None

    _REQUIRED = ("STAID", "DRAIN_SQKM", "COMID")

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.COMID is None:
            raise ValueError(f"gauge {self.STAID}: COMID is required")
        self.COMID = int(self.COMID)


@dataclasses.dataclass
class GaugeSet:
    gauges: list[Gauge]


def validate_gages(file_path: str | Path, gauge_type: type[Gauge] = Gauge) -> GaugeSet:
    """A gauge CSV as a validated :class:`GaugeSet`."""
    with Path(file_path).open() as f:
        return GaugeSet(gauges=[gauge_type.model_validate(row) for row in csv.DictReader(f)])


def _day(text: str) -> np.datetime64:
    return np.datetime64(datetime.strptime(text, DAILY_FORMAT).date(), "D")


def _hours(first_day: np.datetime64, last_day: np.datetime64) -> np.ndarray:
    """Hours from the first day's midnight up to, not including, the last's;
    one hour when they are the same day (as ``pandas.date_range(...,
    inclusive="left")`` gives)."""
    first, last = first_day.astype("datetime64[h]"), last_day.astype("datetime64[h]")
    return np.arange(first, max(last, first + np.timedelta64(1, "h")))


def _indexer(full: np.ndarray, part: np.ndarray) -> np.ndarray:
    """Positions of ``part`` in the evenly spaced ``full`` range, those
    outside it dropped (``pandas.Index.get_indexer`` then ``>= 0``)."""
    if not full.size or not part.size:
        return np.zeros(0, dtype=np.int64)
    idx = (part - full[0]).astype(np.int64)
    return idx[(idx >= 0) & (idx < full.size)]


@dataclasses.dataclass
class Dates:
    """Time windows of training and inference batches.

    ``daily_time_range`` spans the experiment period, both ends included;
    ``hourly_time_range`` its hours up to the last day's midnight. A batch
    window is a random ``rho``-day slice (training,
    :meth:`calculate_time_period`) or an explicit chunk (sequential
    inference, :meth:`set_date_range`); ``numerical_time_range`` holds its
    days counted from the stores' 1980/01/01 origin, ``daily_indices`` and
    ``hourly_indices`` its positions in the full ranges.
    """

    start_time: str
    end_time: str
    rho: int | None = None

    daily_time_range: Any = None
    hourly_time_range: Any = None
    batch_daily_time_range: Any = None
    batch_hourly_time_range: Any = None
    daily_indices: Any = None
    hourly_indices: Any = None
    numerical_time_range: Any = None

    def __post_init__(self) -> None:
        first, last = _day(self.start_time), _day(self.end_time)
        self.daily_time_range = np.arange(first, last + np.timedelta64(1, "D"))
        if self.rho is not None and self.rho > len(self.daily_time_range):
            raise ValueError("rho must be smaller than the routed period between start and end times")
        self.hourly_time_range = _hours(first, last)
        self.set_batch_time(self.daily_time_range)

    def set_batch_time(self, daily_time_range: np.ndarray) -> None:
        self.batch_daily_time_range = daily_time_range
        self.batch_hourly_time_range = _hours(daily_time_range[0], daily_time_range[-1])
        origin = _day(ORIGIN_START_DATE)
        d0 = int((daily_time_range[0] - origin).astype(np.int64))
        d1 = int((daily_time_range[-1] - origin).astype(np.int64))
        self.numerical_time_range = np.arange(d0, d1 + 1)
        self.daily_indices = _indexer(self.daily_time_range, self.batch_daily_time_range)
        self.hourly_indices = _indexer(self.hourly_time_range, self.batch_hourly_time_range)

    def calculate_time_period(self, rng: np.random.Generator | None = None) -> None:
        """Draw a random ``rho``-day batch window (training). The last window
        of the period can be drawn, so ``rho`` equal to the period is one window."""
        if self.rho is None:
            return
        rng = rng or np.random.default_rng()
        start = int(rng.integers(0, len(self.daily_time_range) - self.rho + 1))
        self.set_batch_time(self.daily_time_range[start : start + self.rho])

    def set_date_range(self, chunk: np.ndarray) -> None:
        """Select an explicit daily chunk (sequential inference)."""
        self.set_batch_time(self.daily_time_range[chunk])

    def snapshot(self) -> "Dates":
        """An independent Dates holding the CURRENT batch window.
        :meth:`set_batch_time` rebinds whole attributes and never mutates the
        arrays, so a shallow copy freezes this window: a later draw on the
        dataset's shared Dates cannot move a batch already in flight (the
        invariant that lets batches be prepared ahead)."""
        return copy.copy(self)

    def create_time_windows(self) -> np.ndarray:
        """Sequential ``rho``-day day-index windows for chunked inference."""
        if self.rho is None:
            raise ValueError("rho must be set to create time windows")
        num = len(self.daily_time_range) // self.rho
        return np.arange(num * self.rho).reshape(num, self.rho)


@dataclasses.dataclass
class RoutingData:
    """One routing problem: topology, channel attributes, dates and gauges.
    N is the number of reaches in this batch's subgraph."""

    n_segments: int = 0
    adjacency_rows: np.ndarray | None = None  # (E,) downstream index per edge
    adjacency_cols: np.ndarray | None = None  # (E,) upstream index per edge
    spatial_attributes: np.ndarray | None = None  # (num_attrs, N) raw
    normalized_spatial_attributes: np.ndarray | None = None  # (N, num_attrs) KAN input
    length: np.ndarray | None = None  # (N,) meters
    slope: np.ndarray | None = None  # (N,) m/m
    side_slope: np.ndarray | None = None  # (N,) observed z, or None
    top_width: np.ndarray | None = None  # (N,) observed bankfull width, or None
    x: np.ndarray | None = None  # (N,) Muskingum storage weight
    dates: Dates | None = None
    observations: Any = None  # ObservationSet or None
    divide_ids: np.ndarray | None = None  # (N,) dataset ids in compressed order
    outflow_idx: list[np.ndarray] | None = None  # ragged per-gauge inflow columns
    gage_catchment: list[str] | None = None  # matched gauge STAIDs
    flow_scale: np.ndarray | None = None  # (N,) partial-drainage-area correction
