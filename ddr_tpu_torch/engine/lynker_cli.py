"""Build the Lynker Hydrofabric v2.2 adjacency stores from a GeoPackage: the
port's copy of ``ddr_tpu/engine/lynker_cli.py``.

Usage::

    python -m ddr_tpu_torch.engine.lynker_cli <hydrofabric.gpkg> [--path PATH] [--gages CSV] [--ghost]

Writes ``hydrofabric_v2.2_conus_adjacency.zarr`` (with the flowpath
attribute arrays) and, with ``--gages``,
``hydrofabric_v2.2_gages_conus_adjacency.zarr``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ddr_tpu_torch.engine.lynker import (
    build_gauge_adjacencies,
    build_lynker_hydrofabric_adjacency,
    read_gpkg_table,
)
from ddr_tpu_torch.geodatazoo.dataclasses import validate_gages

__all__ = ["main"]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Create a lower triangular adjacency matrix from hydrofabric data."
    )
    parser.add_argument("pkg", type=Path, help="Path to the hydrofabric geopackage")
    parser.add_argument("--path", type=Path, default=Path("data/"), help="Output directory")
    parser.add_argument("--gages", type=Path, default=None, help="Gauge CSV")
    parser.add_argument("--ghost", action="store_true", help="Insert ghost terminal nodes")
    args = parser.parse_args(argv)

    fp = read_gpkg_table(args.pkg, "flowpaths", ["id", "toid", "tot_drainage_areasqkm"])
    network = read_gpkg_table(args.pkg, "network", ["id", "toid", "hl_uri"])

    out_path = args.path / "hydrofabric_v2.2_conus_adjacency.zarr"
    build_lynker_hydrofabric_adjacency(fp, network, out_path, attributes=args.pkg, ghost=args.ghost)
    if args.gages is not None:
        gauge_set = validate_gages(args.gages)
        build_gauge_adjacencies(
            fp,
            network,
            out_path,
            gauge_set,
            args.path / "hydrofabric_v2.2_gages_conus_adjacency.zarr",
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
