"""Binsparse COO zarr I/O and the geodataset order-converter registry: the
port's copy of ``ddr_tpu/engine/core.py``, on the port's
:mod:`~ddr_tpu_torch.io.zarrlite`.

A lower-triangular adjacency matrix is a zarr v3 group holding
``indices_0`` (downstream row), ``indices_1`` (upstream column), ``values``
and ``order`` arrays, with ``format``/``shape``/``geodataset``/``data_types``
attributes; a gauge subset adds ``gage_catchment``/``gage_idx``. The
geodataset's own ids (MERIT integer COMIDs, Lynker ``wb-*`` strings)
round-trip through ``order`` by the geodataset's converter. The groups hold
the JAX package's arrays and attributes exactly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Protocol

import numpy as np
from scipy import sparse

from ddr_tpu_torch.io import zarrlite

__all__ = [
    "OrderConverter",
    "MeritOrderConverter",
    "LynkerOrderConverter",
    "get_converter",
    "register_converter",
    "list_geodatasets",
    "coo_to_zarr",
    "coo_from_zarr",
    "read_coo_arrays",
    "coo_to_zarr_group",
    "coo_from_zarr_group",
]


class OrderConverter(Protocol):
    """Maps domain ids to and from the int32 ``order`` array stored in zarr."""

    def to_zarr(self, ids: list) -> np.ndarray: ...

    def from_zarr(self, order: np.ndarray) -> list: ...


class MeritOrderConverter:
    """MERIT COMIDs are plain integers."""

    def to_zarr(self, comids: list) -> np.ndarray:
        return np.asarray(list(comids), dtype=np.int32)

    def from_zarr(self, order: np.ndarray) -> list:
        return [int(v) for v in np.asarray(order)]


class LynkerOrderConverter:
    """Lynker ``wb-{int}`` ids store their numeric part. ``to_zarr`` takes
    any ``prefix-number`` id (``ghost-N`` terminals, float-formatted
    ``wb-123.0``); ``from_zarr`` always gives ``wb-{n}``."""

    prefix = "wb-"

    def to_zarr(self, wb_ids: list) -> np.ndarray:
        out = np.empty(len(wb_ids), dtype=np.int32)
        for i, wb in enumerate(wb_ids):
            parts = str(wb).split("-")
            if len(parts) < 2:
                raise ValueError(f"expected 'prefix-number' id, got {wb!r}")
            out[i] = int(float(parts[1]))
        return out

    def from_zarr(self, order: np.ndarray) -> list:
        return [f"{self.prefix}{int(v)}" for v in np.asarray(order)]


_CONVERTERS: dict[str, OrderConverter] = {
    "merit": MeritOrderConverter(),
    "lynker": LynkerOrderConverter(),
    "hydrofabric_v2.2": LynkerOrderConverter(),
    "synthetic": MeritOrderConverter(),
}


def get_converter(geodataset: str) -> OrderConverter:
    try:
        return _CONVERTERS[geodataset]
    except KeyError:
        raise ValueError(
            f"unknown geodataset {geodataset!r}; known: {sorted(_CONVERTERS)}"
        ) from None


def register_converter(geodataset: str, converter: OrderConverter) -> None:
    _CONVERTERS[geodataset] = converter


def list_geodatasets() -> list[str]:
    return sorted(_CONVERTERS)


def _write_coo(
    group: zarrlite.ZarrGroup,
    coo: sparse.coo_matrix,
    zarr_order: np.ndarray,
    geodataset: str | None,
) -> None:
    row = np.asarray(coo.row, dtype=np.int32)
    col = np.asarray(coo.col, dtype=np.int32)
    data = np.asarray(coo.data, dtype=np.uint8)
    group.create_array("indices_0", row)
    group.create_array("indices_1", col)
    group.create_array("values", data)
    group.create_array("order", zarr_order)
    attrs = {
        "format": "COO",
        "shape": [int(coo.shape[0]), int(coo.shape[1])],
        "data_types": {
            "indices_0": str(row.dtype),
            "indices_1": str(col.dtype),
            "values": str(data.dtype),
        },
    }
    if geodataset is not None:
        attrs["geodataset"] = geodataset
    group.attrs.update(attrs)


def coo_to_zarr(
    coo: sparse.coo_matrix, ts_order: list, out_path: Path | str, geodataset: str
) -> None:
    """Write a lower-triangular COO adjacency as a binsparse zarr group."""
    converter = get_converter(geodataset)
    root = zarrlite.create_group(out_path)
    _write_coo(root, coo.tocoo(), converter.to_zarr(ts_order), geodataset)


def coo_from_zarr(zarr_path: Path | str) -> tuple[sparse.coo_matrix, list]:
    """Read a binsparse group, its converter named by its ``geodataset``
    attribute."""
    root = zarrlite.open_group(zarr_path)
    if "geodataset" not in root.attrs:
        raise ValueError(
            f"{zarr_path} lacks 'geodataset' metadata; re-build it or read generically"
        )
    converter = get_converter(root.attrs["geodataset"])
    coo, order = read_coo_arrays(root)
    return coo, converter.from_zarr(order)


def read_coo_arrays(group: zarrlite.ZarrGroup) -> tuple[sparse.coo_matrix, np.ndarray]:
    """The COO matrix and the raw ``order`` array of one binsparse group: the
    one reader of the format (``io.readers`` calls it too)."""
    shape = tuple(group.attrs["shape"])
    coo = sparse.coo_matrix(
        (group["values"].read(), (group["indices_0"].read(), group["indices_1"].read())),
        shape=shape,
    )
    return coo, group["order"].read()


def coo_to_zarr_group(
    root: zarrlite.ZarrGroup,
    name: str,
    coo: sparse.coo_matrix,
    ts_order: list,
    geodataset: str,
    gage_catchment: int | str | None = None,
    gage_idx: int | None = None,
) -> zarrlite.ZarrGroup:
    """Write a gauge-subset COO matrix as the subgroup ``name`` of ``root``."""
    converter = get_converter(geodataset)
    sub = root.create_group(str(name))
    _write_coo(sub, coo.tocoo(), converter.to_zarr(ts_order), geodataset)
    if gage_catchment is not None:
        sub.attrs["gage_catchment"] = gage_catchment
    if gage_idx is not None:
        sub.attrs["gage_idx"] = int(gage_idx)
    return sub


def coo_from_zarr_group(group: zarrlite.ZarrGroup) -> tuple[sparse.coo_matrix, list]:
    """Read one (sub)group; its converter is named by its ``geodataset``
    attribute (default merit)."""
    converter = get_converter(group.attrs.get("geodataset", "merit"))
    coo, order = read_coo_arrays(group)
    return coo, converter.from_zarr(order)
