"""The NOAA-OWP/Lynker Hydrofabric v2.2 geodataset: the port's copy of
``ddr_tpu/geodatazoo/lynker.py``.

Divide ids are the strings ``cat-{id}``, joined to the attribute and
streamflow stores. Per-reach length, slope, top width, side slope and
Muskingum ``x`` come from the conus adjacency store the engine builder wrote
from the ``flowpath-attributes-ml`` table (a NaN takes the store's mean, as
every flowpath array does, :class:`BaseGeoDataset`), and each gauge union's
inflow segments are checked against the stored downstream ``toid``. The
batching lives in :class:`BaseGeoDataset`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
from scipy import sparse

from ddr_tpu_torch.geodatazoo.base import BaseGeoDataset

__all__ = ["LynkerHydrofabric"]


class LynkerHydrofabric(BaseGeoDataset):
    flowpath_vars = {
        "length": "length_m",
        "slope": "slope",
        "top_width": "top_width",
        "side_slope": "side_slope",
        "x": "muskingum_x",
    }
    use_da_valid = False

    def _attribute_key(self, divide_id: Any) -> str:
        return str(divide_id)

    def _make_divide_ids(self, order_ids: np.ndarray) -> np.ndarray:
        return np.array([f"cat-{_id}" for _id in order_ids])

    def _validate_outflow(
        self,
        coo: sparse.coo_matrix,
        gage_idx: list,
        gage_catchment: list,
        outflow_idx: list[np.ndarray],
        active_indices: np.ndarray,
    ) -> None:
        """Assert that each non-headwater gauge's inflow segments drain (by
        ``toid``) into the waterbody the gauge sits on. Headwater gauges
        refer to themselves and are left out."""
        toid = self._toid()
        if toid is None:
            return

        def _wb_num(x: Any) -> str:
            # "wb-123", "123" and int32 123 all compare by their numeric part
            return str(x).split("-")[-1]

        inflow_rows: list[int] = []
        expected_wb: list[str] = []
        for i, _idx in enumerate(gage_idx):
            if coo.nnz > 0 and np.isin(coo.row, _idx).any():
                inflow_rows.extend(outflow_idx[i].tolist())
                expected_wb.append(_wb_num(gage_catchment[i]))
        if not inflow_rows:
            return
        compressed_toid = np.asarray(toid)[active_indices]
        seen: list[str] = []
        for _id in compressed_toid[inflow_rows]:
            num = _wb_num(_id)
            if num not in seen:
                seen.append(num)
        assert np.array_equal(np.array(seen), np.array(expected_wb)), (
            "Gage WB don't match up with indices"
        )

    def _toid(self) -> np.ndarray | None:
        """The downstream waterbody ids, read once (validation only: ``toid``
        is not a RoutingData field)."""
        if not hasattr(self, "_toid_cache"):
            self._toid_cache = (
                np.asarray(self.conus_adjacency["toid"].read())
                if "toid" in self.conus_adjacency
                else None
            )
        return self._toid_cache
