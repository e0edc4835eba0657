"""The MERIT-Hydro geodataset: the port's copy of ``ddr_tpu/geodatazoo/merit.py``.

Integer COMID divide ids; ``length_m`` and ``slope`` come from the conus
adjacency store the engine builder wrote; Muskingum ``x`` is the constant
0.3; top width and side slope come from the learned power laws, so those
fields stay None. The batching lives in :class:`BaseGeoDataset`.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ddr_tpu_torch.geodatazoo.base import BaseGeoDataset

__all__ = ["Merit"]


class Merit(BaseGeoDataset):
    flowpath_vars = {
        "length": "length_m",
        "slope": "slope",
        "top_width": None,
        "side_slope": None,
        "x": None,  # the constant default_x
    }
    default_x = 0.3

    def _attribute_key(self, divide_id: Any) -> int:
        return int(divide_id)

    def _make_divide_ids(self, order_ids: np.ndarray) -> np.ndarray:
        return np.asarray(order_ids)
