"""Build the MERIT adjacency stores from a flowpath table: the port's copy of
``ddr_tpu/engine/merit_cli.py``.

Usage::

    python -m ddr_tpu_torch.engine.merit_cli <flowpaths.csv> [--path PATH] [--gages CSV]

writes ``PATH/merit_conus_adjacency.zarr`` and, with ``--gages``,
``PATH/merit_gages_conus_adjacency.zarr``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ddr_tpu_torch.engine.merit import _load_fp, build_gauge_adjacencies, build_merit_adjacency
from ddr_tpu_torch.geodatazoo.dataclasses import MERITGauge, validate_gages

__all__ = ["main"]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Create lower triangular adjacency matrices from MERIT hydrofabric data."
    )
    parser.add_argument("flowpaths", type=Path, help="Flowpath table (CSV)")
    parser.add_argument("--path", type=Path, default=Path("data/"), help="Output directory")
    parser.add_argument("--gages", type=Path, default=None, help="Gauge CSV (STAID, COMID, ...)")
    args = parser.parse_args(argv)

    fp = _load_fp(args.flowpaths)
    out_path = args.path / "merit_conus_adjacency.zarr"
    build_merit_adjacency(fp, out_path)
    if args.gages is not None:
        gauge_set = validate_gages(args.gages, gauge_type=MERITGauge)
        build_gauge_adjacencies(
            fp, out_path, gauge_set, args.path / "merit_gages_conus_adjacency.zarr"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
