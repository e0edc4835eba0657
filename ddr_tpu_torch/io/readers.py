"""Observation containers: the port's copy of ``ddr_tpu/io/readers.py``'s
:class:`ObservationSet`. The store readers come with the real-data path
(ROADMAP A.8)."""

from __future__ import annotations

import numpy as np

__all__ = ["ObservationSet"]


class ObservationSet:
    """Observed streamflow for a batch: ``streamflow`` ``(n_gauges, n_days)``
    in m^3/s with NaN gaps, ``gage_ids`` the zero-padded STAIDs, ``time``
    the days."""

    def __init__(self, gage_ids: list[str], time: np.ndarray, streamflow: np.ndarray) -> None:
        self.gage_ids = [str(g).zfill(8) for g in gage_ids]
        self.time = time
        self.streamflow = streamflow
