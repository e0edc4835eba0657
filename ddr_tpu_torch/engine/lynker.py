"""Lynker Hydrofabric v2.2 builders: the port's copy of ``ddr_tpu/engine/lynker.py``.

The inputs are the hydrofabric's ``flowpaths``, ``network`` and
``flowpath-attributes-ml`` tables as column mappings (name -> list of
values, the port's stand-in for the JAX package's DataFrames), or a
GeoPackage path read with ``sqlite3``. A NULL cell is None, as
``pandas.read_sql_query`` leaves it in a text column; ids are compared as
``str(value)``, as ``astype(str)`` spells them. The wb->nex->wb collapse, the
origin lookup with its drainage-area tie-break, ghost terminal nodes and the
dendritic topological assembly are JAX's; the topological order comes from
:mod:`ddr_tpu_torch.engine.graph` (numpy and ``heapq``, the smallest ready
index first), so every store index equals JAX's. ``toid`` is stored as the
numeric part of the downstream waterbody (int32).
"""

from __future__ import annotations

import logging
import math
import sqlite3
from pathlib import Path
from typing import Any, Mapping

import numpy as np
from scipy import sparse

from ddr_tpu_torch.engine import graph as G
from ddr_tpu_torch.engine.core import coo_to_zarr, coo_to_zarr_group
from ddr_tpu_torch.geodatazoo.dataclasses import Gauge, GaugeSet
from ddr_tpu_torch.io import zarrlite

log = logging.getLogger(__name__)

__all__ = [
    "read_gpkg_table",
    "preprocess_river_network",
    "find_origin",
    "subset",
    "create_matrix",
    "write_flowpath_attributes",
    "build_lynker_hydrofabric_adjacency",
    "build_gauge_adjacencies",
]

#: A table: column name -> the column's values, one per row.
Table = Mapping[str, list]


def read_gpkg_table(gpkg_path: Path | str, table: str, columns: list[str]) -> dict[str, list]:
    """Read ``columns`` of one GeoPackage (sqlite) table as a column mapping."""
    with sqlite3.connect(gpkg_path) as conn:
        cols = ", ".join(f'"{c}"' for c in columns)
        rows = conn.execute(f"SELECT {cols} FROM '{table}'").fetchall()
    return {name: [r[j] for r in rows] for j, name in enumerate(columns)}


def _is_na(value: Any) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def _float(value: Any) -> float:
    return math.nan if value is None else float(value)


def _pairs(table: Table, *columns: str) -> list[tuple]:
    return list(zip(*(table[c] for c in columns)))


def preprocess_river_network(network: Table) -> dict[str, list[str]]:
    """Collapse wb->nex->wb chains into direct wb->wb connectivity:
    ``{downstream_wb: sorted upstream_wbs}``."""
    net = [(str(i), str(t)) for i, t in _pairs(network, "id", "toid") if not _is_na(t)]
    nex_map = {i: t for i, t in net if i.startswith("nex-") and t.startswith("wb-")}

    connections: set[tuple[str, str]] = {
        (t, i) for i, t in net if i.startswith("wb-") and t.startswith("wb-")
    }
    for up, nex in net:
        if up.startswith("wb-") and nex.startswith("nex-"):
            dn = nex_map.get(nex)
            if dn is not None:
                connections.add((dn, up))

    out: dict[str, list[str]] = {}
    for dn, up in connections:
        out.setdefault(dn, []).append(up)
    return {dn: sorted(ups) for dn, ups in out.items()}


def find_origin(gauge: Gauge, fp: Table, network: Table) -> str:
    """The flowpath id (``wb-*``) the gauge sits on, through the network's
    ``hl_uri`` ``gages-{STAID}`` entries; several matches are decided by the
    drainage area nearest the gauge's (the first of equals in table order,
    as pandas' ``sort_values`` leaves them)."""
    target = f"gages-{gauge.STAID}"
    matches: list[str] = []
    for i, uri in _pairs(network, "id", "hl_uri"):
        if uri == target and str(i) not in matches:
            matches.append(str(i))
    if not matches:
        raise ValueError(f"no flowpath found for gauge {gauge.STAID}")
    if len(matches) == 1:
        return matches[0]
    cand = [(str(i), abs(_float(a) - gauge.DRAIN_SQKM))
            for i, a in _pairs(fp, "id", "tot_drainage_areasqkm") if str(i) in matches]
    if not cand:
        raise IndexError(f"no flowpath row for the matches of gauge {gauge.STAID}: {matches}")
    diff = np.asarray([d for _, d in cand], dtype=np.float64)
    finite = np.flatnonzero(~np.isnan(diff))
    # pandas sorts the non-NaN values with numpy's quicksort and puts NaNs last
    ranked = list(finite[np.argsort(diff[finite], kind="quicksort")]) + list(
        np.flatnonzero(np.isnan(diff)))
    return cand[int(ranked[0])][0]


def subset(origin: str, wb_network_dict: dict[str, list[str]]) -> list[tuple[str, str]]:
    """Every upstream ``(downstream_id, upstream_id)`` connection from
    ``origin`` (an explicit stack: CONUS subsets exceed Python's recursion
    limit)."""
    seen: set[str] = set()
    connections: list[tuple[str, str]] = []
    stack = [origin]
    while stack:
        current = stack.pop()
        if current in seen:
            continue
        seen.add(current)
        for up in wb_network_dict.get(current, []):
            connections.append((current, up))
            if up not in seen:
                stack.append(up)
    return connections


def create_matrix(fp: Table, network: Table, ghost: bool = False) -> tuple[sparse.coo_matrix, list[str]]:
    """The lower-triangular adjacency over flowpaths: nodes are waterbodies,
    each nexus a directed edge. ``ghost=True`` appends a terminal node for
    each flowpath that drains into an unmapped nexus, so several outlets
    stay apart."""
    fp_ids = [str(v) for v in fp["id"]]
    fp_toid = [str(v) for v in fp["toid"]]
    nexus_to_wb: dict[str, str] = {}
    for i, t in _pairs(network, "id", "toid"):
        nexus_to_wb.setdefault(str(i), str(t))  # the first row of each id

    ids: list[str] = list(fp_ids)
    pos = {wb: i for i, wb in enumerate(ids)}
    ghost_counter = 0
    src, dst = [], []
    downstream_of: dict[str, str] = {}
    for wb, nex in zip(fp_ids, fp_toid):
        ds_wb = nexus_to_wb.get(nex)
        if ds_wb is None or ds_wb == "None":
            if ghost and not wb.startswith("ghost-"):
                ghost_id = f"ghost-{ghost_counter}"
                ghost_counter += 1
                pos[ghost_id] = len(ids)
                ids.append(ghost_id)
                nexus_to_wb[nex] = ghost_id
                ds_wb = ghost_id
            else:
                continue  # terminal
        if ds_wb not in pos:
            continue
        assert wb not in downstream_of, f"Node {wb} has multiple successors, not dendritic"
        downstream_of[wb] = ds_wb
        src.append(pos[wb])
        dst.append(pos[ds_wb])

    order = G.topological_sort(np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64), len(ids))
    id_order = [ids[i] for i in order]
    new_pos = {wb: i for i, wb in enumerate(id_order)}

    rows = [new_pos[downstream_of[wb]] for wb in downstream_of]
    cols = [new_pos[wb] for wb in downstream_of]
    matrix = sparse.coo_matrix(
        (np.ones(len(rows), dtype=np.uint8), (rows, cols)),
        shape=(len(id_order), len(id_order)),
        dtype=np.uint8,
    )
    assert np.all(matrix.row >= matrix.col), "Matrix is not lower triangular"
    return matrix, id_order


def _wb_num(wb: str) -> int:
    return int(float(str(wb).split("-")[1]))


def write_flowpath_attributes(source: Path | str | Mapping[str, Table], out_path: Path | str) -> None:
    """Write ``length_m``, ``slope``, ``top_width``, ``side_slope`` and
    ``muskingum_x`` (from ``Length_m``, ``So``, ``TopWdth``, ``ChSlp``,
    ``MusX``; float32, NaN where a reach has no row) and ``toid`` aligned to
    the store's ``order``. ``source`` is a GeoPackage path or
    ``{"flowpath-attributes-ml": t, "flowpaths": t, "network": t (optional)}``.

    ``toid`` is the numeric part of the downstream waterbody: a flowpath
    whose ``toid`` is a nexus is resolved through the network's nex->wb hop,
    so the value compares directly with gauge waterbody ids (0 for none)."""
    network_df: Table | None
    if isinstance(source, (str, Path)):
        attr_df = read_gpkg_table(Path(source), "flowpath-attributes-ml",
                                  ["id", "Length_m", "So", "TopWdth", "ChSlp", "MusX"])
        fp_df = read_gpkg_table(Path(source), "flowpaths", ["id", "toid"])
        try:
            network_df = read_gpkg_table(Path(source), "network", ["id", "toid"])
        except Exception:
            network_df = None
    else:
        attr_df = source["flowpath-attributes-ml"]
        fp_df = source["flowpaths"]
        network_df = source.get("network")

    root = zarrlite.open_group(out_path)
    order = np.asarray(root["order"].read())

    attr_lookup = {_wb_num(str(i)): k for k, i in enumerate(attr_df["id"])}
    arrays = {
        "length_m": "Length_m",
        "slope": "So",
        "top_width": "TopWdth",
        "side_slope": "ChSlp",
        "muskingum_x": "MusX",
    }
    row_idx = np.array([attr_lookup.get(int(s), -1) for s in order], dtype=np.int64)
    found = row_idx >= 0
    for name, column in arrays.items():
        data = np.asarray([_float(v) for v in attr_df[column]], dtype=np.float64)
        out = np.full(len(order), np.nan, dtype=np.float32)
        out[found] = data[row_idx[found]]
        root.create_array(name, out)

    nex_to_wb: dict[str, str] = {}
    if network_df is not None:
        for i, t in _pairs(network_df, "id", "toid"):
            if not _is_na(t) and str(i).startswith("nex-") and str(t).startswith("wb-"):
                nex_to_wb[str(i)] = str(t)

    fp_lookup = {_wb_num(str(i)): str(t) for i, t in _pairs(fp_df, "id", "toid")}
    toid = np.zeros(len(order), dtype=np.int32)
    for i, seg in enumerate(order):
        t = fp_lookup.get(int(seg))
        if t and t.startswith("nex-"):
            t = nex_to_wb.get(t)
        if t and "-" in t:
            toid[i] = _wb_num(t)
    root.create_array("toid", toid)
    log.info(f"Flowpath attributes written to zarr at {out_path}")


def build_lynker_hydrofabric_adjacency(
    fp: Table,
    network: Table,
    out_path: Path | str,
    attributes: Path | str | Mapping[str, Table] | None = None,
    ghost: bool = False,
) -> Path:
    """Hydrofabric tables -> the binsparse conus store (and its flowpath
    attribute arrays when ``attributes`` is given)."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if out_path.exists():
        raise FileExistsError(f"Cannot create zarr store {out_path}. One already exists")
    matrix, ts_order = create_matrix(fp, network, ghost=ghost)
    log.info(f"Matrix shape: {matrix.shape}, nnz: {matrix.nnz}")
    coo_to_zarr(matrix, ts_order, out_path, "lynker")
    if attributes is not None:
        write_flowpath_attributes(attributes, out_path)
    return out_path


def build_gauge_adjacencies(
    fp: Table,
    network: Table,
    conus_zarr_path: Path | str,
    gauge_set: GaugeSet,
    out_path: Path | str,
) -> Path:
    """One conus-indexed subset group per gauge: the gauge's upstream
    connections, its ``order`` sorted by conus index, its origin as
    ``gage_catchment``. A gauge with no flowpath, or whose origin the conus
    store lacks, is skipped with a warning."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if out_path.exists():
        raise FileExistsError(f"Cannot create zarr store {out_path}. One already exists")

    wb_dict = preprocess_river_network(network)
    conus_root = zarrlite.open_group(conus_zarr_path)
    conus_order = np.asarray(conus_root["order"].read())
    conus_mapping = {f"wb-{int(v)}": i for i, v in enumerate(conus_order)}
    n_conus = len(conus_order)

    root = zarrlite.create_group(out_path)
    for gauge in gauge_set.gauges:
        try:
            origin = find_origin(gauge, fp, network)
        except ValueError:
            log.warning(f"no flowpath found for gauge {gauge.STAID}. Skipping.")
            continue
        origin_key = f"wb-{_wb_num(origin)}"
        if origin_key not in conus_mapping:
            log.warning(f"{origin} for gauge {gauge.STAID} not found in CONUS adjacency. Skipping.")
            continue

        connections = subset(origin, wb_dict)
        row_idx = [conus_mapping[f"wb-{_wb_num(dn)}"] for dn, _ in connections]
        col_idx = [conus_mapping[f"wb-{_wb_num(up)}"] for _, up in connections]
        coo = sparse.coo_matrix(
            (np.ones(len(row_idx), dtype=np.uint8), (row_idx, col_idx)),
            shape=(n_conus, n_conus),
            dtype=np.uint8,
        )
        assert np.all(coo.row >= coo.col), "Matrix is not lower triangular"

        wb_set = {origin_key} | {f"wb-{_wb_num(x)}" for pair in connections for x in pair}
        ts_order = sorted(wb_set, key=lambda w: conus_mapping.get(w, np.inf))
        coo_to_zarr_group(
            root,
            gauge.STAID,
            coo,
            ts_order,
            "lynker",
            gage_catchment=origin_key,
            gage_idx=conus_mapping[origin_key],
        )
    log.info(f"Lynker gauge adjacency matrices written to {out_path}")
    return out_path
