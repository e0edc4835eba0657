"""MERIT-Hydro hydrofabric builders: the port's copy of
``ddr_tpu/engine/merit.py``, on numpy, scipy and the standard library.

The input is a flowpath table with ``COMID``, ``NextDownID``, ``up1``-``up4``
and optionally ``lengthkm``/``slope`` columns: a CSV path, read with the
``csv`` module, or a mapping of column name to numpy array. The upstream
dictionary, the cycle repair and the adjacency assembly are the JAX
package's, so the stores they write hold its arrays and attributes exactly.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Mapping

import numpy as np
from scipy import sparse

from ddr_tpu_torch.engine import graph as G
from ddr_tpu_torch.engine.core import coo_to_zarr, coo_to_zarr_group
from ddr_tpu_torch.geodatazoo.dataclasses import GaugeSet
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.io.readers import csv_column

log = logging.getLogger(__name__)

__all__ = [
    "FlowpathTable",
    "build_upstream_dict",
    "create_adjacency_matrix",
    "write_merit_flowpath_attributes",
    "build_merit_adjacency",
    "build_gauge_adjacencies",
    "read_flowpaths",
]

UP_COLS = ("up1", "up2", "up3", "up4")

#: A flowpath table: column name -> one numpy array per column, all of one length.
FlowpathTable = Mapping[str, np.ndarray]


def read_flowpaths(path: str | Path) -> dict[str, np.ndarray]:
    """A CSV flowpath table as columns, each typed as ``pandas.read_csv``
    types it (:func:`~ddr_tpu_torch.io.readers.csv_column`)."""
    path = Path(path)
    if path.suffix == ".parquet":
        raise NotImplementedError(
            f"{path}: reading a parquet flowpath table needs a parquet reader, which the port does "
            "not have (it stands on the standard library, numpy and scipy); convert it to CSV"
        )
    with path.open(newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return {name: csv_column([r[j] for r in rows]) for j, name in enumerate(header)}


def _load_fp(fp: FlowpathTable | str | Path) -> FlowpathTable:
    if isinstance(fp, (str, Path)):
        return read_flowpaths(fp)
    return fp


def _n_rows(fp: FlowpathTable) -> int:
    return len(fp["COMID"])


def _int_column(col: np.ndarray) -> np.ndarray:
    """``Series.fillna(0).astype(np.int64)``."""
    col = np.asarray(col)
    if col.dtype.kind == "f" or col.dtype == object:
        col = np.asarray(col, dtype=np.float64)
        col = np.where(np.isnan(col), 0.0, col)
    return col.astype(np.int64)


def build_upstream_dict(fp: FlowpathTable) -> dict[int, list[int]]:
    """Downstream COMID -> sorted upstream COMIDs from the up1-up4 columns
    (entries <= 0 mean no upstream reach). Keys keep their first-seen order,
    up1's rows first, which fixes the stored edge order."""
    out: dict[int, list[int]] = {}
    comid = _int_column(fp["COMID"])
    for col in UP_COLS:
        if col not in fp:
            continue
        up = _int_column(fp[col])
        valid = up > 0
        for dn, u in zip(comid[valid].tolist(), up[valid].tolist()):
            out.setdefault(dn, []).append(u)
    return {dn: sorted(ups) for dn, ups in out.items()}


def _edges_and_ids(
    upstream_dict: dict[int, list[int]],
) -> tuple[np.ndarray, np.ndarray, list[int], dict[int, int]]:
    """Edge arrays (src = upstream -> dst = downstream) over a sorted COMID index."""
    ids = sorted({c for dn, ups in upstream_dict.items() for c in (dn, *ups)})
    idx = {c: i for i, c in enumerate(ids)}
    src, dst = [], []
    for dn in sorted(upstream_dict):
        for up in upstream_dict[dn]:
            src.append(idx[up])
            dst.append(idx[dn])
    return np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64), ids, idx


def create_adjacency_matrix(fp: FlowpathTable) -> tuple[sparse.coo_matrix, list[int]]:
    """Lower-triangular COO adjacency and the topological COMID order. A
    cycle is repaired by dropping every flowpath on it and building again;
    COMIDs in no connection are appended after the connected order; a reach
    that drains into two reaches raises ``AssertionError``."""
    upstream_dict = build_upstream_dict(fp)
    if not upstream_dict:
        raise ValueError("No upstream connections found in the data")
    log.info(f"Found {len(upstream_dict)} downstream nodes with upstream connections")

    src, dst, ids, _ = _edges_and_ids(upstream_dict)
    cyc = G.cycle_nodes(src, dst, len(ids))
    if cyc.size:
        cycle_comids = {ids[i] for i in cyc}
        log.warning(
            f"DAG has cycle(s): removing {len(cycle_comids)} flowpaths involved in cycles"
        )
        keep = ~np.isin(_int_column(fp["COMID"]), np.fromiter(cycle_comids, dtype=np.int64))
        fp_filtered = {name: np.asarray(col)[keep] for name, col in fp.items()}
        log.info(f"Dataset reduced from {_n_rows(fp)} to {_n_rows(fp_filtered)} flowpaths")
        return create_adjacency_matrix(fp_filtered)

    order = G.topological_sort(src, dst, len(ids))
    id_order = [ids[i] for i in order]

    all_comids = {int(c) for c in np.asarray(fp["COMID"])}
    isolated = sorted(all_comids - set(id_order))
    if isolated:
        log.info(f"Adding {len(isolated)} isolated COMIDs (no upstream/downstream connections)")
    id_order = id_order + isolated
    pos = {c: i for i, c in enumerate(id_order)}

    downstream: dict[int, int] = {}
    rows, cols = [], []
    for dn, ups in upstream_dict.items():
        for up in ups:
            if up in downstream and downstream[up] != dn:
                raise AssertionError(f"Node {up} has multiple successors, not dendritic")
            downstream[up] = dn
            rows.append(pos[dn])
            cols.append(pos[up])

    matrix = sparse.coo_matrix(
        (np.ones(len(rows), dtype=np.uint8), (rows, cols)),
        shape=(len(id_order), len(id_order)),
        dtype=np.uint8,
    )
    assert np.all(matrix.row >= matrix.col), "Matrix is not lower triangular"
    return matrix, id_order


def write_merit_flowpath_attributes(fp: FlowpathTable, out_path: Path) -> None:
    """Write ``length_m`` (lengthkm * 1000) and ``slope``, aligned to the
    store's ``order`` (NaN for a COMID the table lacks)."""
    root = zarrlite.open_group(out_path)
    order = np.asarray(root["order"].read())
    comid_col = _int_column(fp["COMID"])
    lookup = {int(c): i for i, c in enumerate(comid_col)}
    row_idx = np.array([lookup.get(int(c), -1) for c in order])
    found = row_idx >= 0

    if "lengthkm" in fp:
        length_m = np.full(len(order), np.nan, dtype=np.float32)
        length_m[found] = np.asarray(fp["lengthkm"], dtype=np.float64)[row_idx[found]] * 1000.0
        root.create_array("length_m", length_m)
    if "slope" in fp:
        slope = np.full(len(order), np.nan, dtype=np.float32)
        slope[found] = np.asarray(fp["slope"], dtype=np.float64)[row_idx[found]]
        root.create_array("slope", slope)
    if "lengthkm" not in fp and "slope" not in fp:
        log.warning("MERIT table has neither 'lengthkm' nor 'slope'; skipping attribute write")
        return
    log.info(f"MERIT flowpath attributes written to zarr at {out_path}")


def build_merit_adjacency(fp: FlowpathTable | str | Path, out_path: Path) -> Path:
    """Flowpath table -> the binsparse conus adjacency store, with the
    flowpath attributes."""
    fp = _load_fp(fp)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if out_path.exists():
        raise FileExistsError(f"Cannot create zarr store {out_path}. One already exists")

    log.info(f"Creating adjacency matrix for {_n_rows(fp)} flowpaths")
    matrix, ts_order = create_adjacency_matrix(fp)
    log.info(f"Matrix shape: {matrix.shape}, nnz: {matrix.nnz}")
    coo_to_zarr(matrix, ts_order, out_path, "merit")
    write_merit_flowpath_attributes(fp, out_path)
    return out_path


def build_gauge_adjacencies(
    fp: FlowpathTable | str | Path,
    merit_zarr_path: Path,
    gauge_set: GaugeSet,
    out_path: Path,
) -> Path:
    """Per-gauge upstream-subset stores, conus-indexed: each gauge's group
    holds the subset's edges in conus index space, the subset's COMIDs as
    ``order``, and ``gage_catchment``/``gage_idx`` attributes. A gauge whose
    COMID the conus store lacks is skipped with a warning."""
    fp = _load_fp(fp)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if out_path.exists():
        raise FileExistsError(f"Cannot create zarr store {out_path}. One already exists")

    upstream_dict = build_upstream_dict(fp)
    src, dst, ids, idx = _edges_and_ids(upstream_dict)

    merit_root = zarrlite.open_group(merit_zarr_path)
    ts_order = np.asarray(merit_root["order"].read())
    merit_mapping = {int(c): i for i, c in enumerate(ts_order)}
    n_conus = len(ts_order)

    root = zarrlite.create_group(out_path)
    for gauge in gauge_set.gauges:
        staid = gauge.STAID
        origin_comid = int(gauge.COMID)
        if origin_comid not in merit_mapping:
            log.warning(
                f"COMID {origin_comid} for gauge {staid} not found in MERIT adjacency "
                "matrix. Skipping."
            )
            continue

        if origin_comid in idx:
            mask = G.ancestors_mask(src, dst, len(ids), np.array([idx[origin_comid]]))
            subset_comids = [ids[i] for i in np.flatnonzero(mask)]
        else:
            subset_comids = [origin_comid]

        subset_set = set(subset_comids)
        row_idx, col_idx = [], []
        for dn, ups in upstream_dict.items():
            if dn not in subset_set:
                continue
            for up in ups:
                if up in subset_set:
                    row_idx.append(merit_mapping[dn])
                    col_idx.append(merit_mapping[up])
        coo = sparse.coo_matrix(
            (np.ones(len(row_idx), dtype=np.uint8), (row_idx, col_idx)),
            shape=(n_conus, n_conus),
            dtype=np.uint8,
        )
        assert np.all(coo.row >= coo.col), "Matrix is not lower triangular"

        coo_to_zarr_group(
            root,
            staid,
            coo,
            sorted(subset_comids, key=lambda c: merit_mapping.get(c, np.inf)),
            "merit",
            gage_catchment=origin_comid,
            gage_idx=merit_mapping[origin_comid],
        )
    log.info(f"MERIT Gauge adjacency matrices written to {out_path}")
    return out_path
