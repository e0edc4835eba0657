"""Offline preprocessing that builds the binsparse zarr adjacency stores: the
port's copy of ``ddr_tpu/engine/`` (the MERIT builders and their order
converters), on numpy, scipy and the standard library."""

from ddr_tpu_torch.engine.core import (
    LynkerOrderConverter,
    MeritOrderConverter,
    OrderConverter,
    coo_from_zarr,
    coo_from_zarr_group,
    coo_to_zarr,
    coo_to_zarr_group,
    get_converter,
    list_geodatasets,
    register_converter,
)

__all__ = [
    "LynkerOrderConverter",
    "MeritOrderConverter",
    "OrderConverter",
    "coo_from_zarr",
    "coo_from_zarr_group",
    "coo_to_zarr",
    "coo_to_zarr_group",
    "get_converter",
    "list_geodatasets",
    "register_converter",
]
