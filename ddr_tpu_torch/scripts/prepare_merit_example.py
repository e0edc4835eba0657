"""Build every store of the MERIT example (``examples/merit_basin/``) with
the port: offline, deterministic, no external data. The port's copy of the
example's ``prepare.py``.

    python -m ddr_tpu_torch.scripts.prepare_merit_example <example dir>

reads ``<dir>/flowpaths.csv`` and writes five stores under ``<dir>/data/``:
the conus adjacency and the per-gauge subsets through the engine builders,
then the attribute, lateral-inflow and observation stores drawn from
``default_rng(7)`` in the order ``prepare.py`` draws them, so the stores
are the JAX package's, array for array. The adjacency stores are built once
(a finished gauge store is kept); the other three are written anew.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np

from ddr_tpu_torch.engine.merit import build_gauge_adjacencies, build_merit_adjacency, read_flowpaths
from ddr_tpu_torch.geodatazoo.dataclasses import GaugeSet, MERITGauge
from ddr_tpu_torch.io.stores import write_attribute_store, write_hydro_store

__all__ = ["ATTRS", "N_DAYS", "START_DATE", "lateral_inflows", "main", "prepare"]

N_DAYS = 400  # 1981-09-25 onward: covers the example config's window
START_DATE = "1981/09/25"
ATTRS = [f"a{i}" for i in range(8)]
GAUGES = GaugeSet(
    gauges=[
        MERITGauge(STAID="11111111", STANAME="mid-basin", DRAIN_SQKM=120, COMID=107),
        MERITGauge(STAID="22222222", STANAME="outlet", DRAIN_SQKM=400, COMID=110),
    ]
)


def lateral_inflows(rng: np.random.Generator, n: int, n_days: int = N_DAYS) -> np.ndarray:
    """Daily lateral inflow ``(n, n_days)`` float32: a seasonal cycle plus
    gamma storm pulses on 15% of days, drawn reach by reach."""
    t = np.arange(n_days)
    seasonal = 1.0 + 0.5 * np.sin(2 * np.pi * t / 365.0)
    qr = np.empty((n, n_days), dtype=np.float32)
    for i in range(n):
        storms = rng.gamma(2.0, 0.6, n_days) * (rng.random(n_days) < 0.15)
        qr[i] = (0.4 * seasonal + storms).astype(np.float32)
    return qr


def prepare(example: Path) -> Path:
    """Write the example's stores under ``example/data``; returns that directory."""
    example = Path(example)
    data = example / "data"
    fp = read_flowpaths(example / "flowpaths.csv")
    comids = fp["COMID"].tolist()
    rng = np.random.default_rng(7)

    data.mkdir(exist_ok=True)
    conus = data / "merit_conus_adjacency.zarr"
    gages_store = data / "merit_gages_adjacency.zarr"
    # the gauge store is built last: an interrupted first run builds both again
    if not gages_store.exists():
        if conus.exists():
            shutil.rmtree(conus)
        build_merit_adjacency(fp, conus)
        build_gauge_adjacencies(fp, conus, GAUGES, gages_store)

    write_attribute_store(
        data / "attributes.zarr",
        comids,
        {name: rng.normal(loc=5.0, scale=2.0, size=len(comids)).astype(np.float32) for name in ATTRS},
    )
    qr = lateral_inflows(rng, len(comids))
    write_hydro_store(
        data / "streamflow.zarr", comids, START_DATE, "D", {"Qr": qr}, units={"Qr": "m3 s-1"}
    )

    # observations: each gauge's accumulated upstream inflow, times a draw in [0.9, 1.1)
    upstream = {
        "11111111": [101, 102, 103, 104, 105, 106, 107],
        "22222222": comids,
    }
    pos = {c: i for i, c in enumerate(comids)}
    obs = np.stack(
        [qr[[pos[c] for c in ups]].sum(axis=0) * rng.uniform(0.9, 1.1) for ups in upstream.values()]
    ).astype(np.float32)
    write_hydro_store(
        data / "observations.zarr",
        list(upstream),
        START_DATE,
        "D",
        {"streamflow": obs},
        id_dim="gage_id",
        units={"streamflow": "m3 s-1"},
    )
    return data


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m ddr_tpu_torch.scripts.prepare_merit_example <example dir>",
              file=sys.stderr)
        return 2
    print(f"stores written under {prepare(Path(argv[0]))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
