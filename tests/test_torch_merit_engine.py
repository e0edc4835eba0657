"""The port's MERIT engine builders against the JAX package's, on the CPU.

The same flowpath tables go through ``ddr_tpu.engine.merit`` and
``ddr_tpu_torch.engine.merit``: the example's ``flowpaths.csv`` and a
seeded random MERIT table of a few hundred reaches with a three-reach
cycle (and a tributary into it), an isolated COMID, NaN cells and gauges at
an outlet, inside the basin, at a headwater, at the isolated COMID and at a
COMID the table lacks. Every array and every attribute of both adjacency
stores must equal JAX's exactly. The JAX package builds its graphs with its
native C++ core where ``g++`` is found and with numpy otherwise; the port
takes the numpy path only, so both JAX paths are held against it. The graph
functions are held against JAX's on random DAGs, and the error cases
(a reach draining into two, a table with no connection, an existing store,
a cycle in ``topological_sort``) must raise the same type.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np
import pytest

from ddr_tpu.engine import graph as jax_graph
from ddr_tpu.engine import merit as jax_merit
from ddr_tpu.engine import merit_cli as jax_merit_cli
from ddr_tpu.geodatazoo.dataclasses import MERITGauge as JaxMERITGauge
from ddr_tpu.geodatazoo.dataclasses import validate_gages as jax_validate_gages
from ddr_tpu_torch.engine import core, graph, merit, merit_cli
from ddr_tpu_torch.geodatazoo.dataclasses import MERITGauge, validate_gages
from ddr_tpu_torch.io import zarrlite

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "merit_basin"
HEADER = ["COMID", "NextDownID", "up1", "up2", "up3", "up4", "lengthkm", "slope"]


def assert_stores_equal(ours: Path, ref: Path) -> int:
    """Every ``zarr.json`` (attributes and array metadata) and every decoded
    array of two store trees equal; returns the number of arrays."""
    metas = sorted(p.relative_to(ours) for p in ours.rglob("zarr.json"))
    assert metas == sorted(p.relative_to(ref) for p in ref.rglob("zarr.json"))
    n = 0
    for rel in metas:
        a, b = json.loads((ours / rel).read_text()), json.loads((ref / rel).read_text())
        assert a == b, rel
    def walk(ga, gb, path):
        nonlocal n
        assert sorted(ga.keys()) == sorted(gb.keys()), path
        for k in ga.keys():
            if hasattr(ga[k], "shape"):
                x, y = ga[k].read(), gb[k].read()
                assert x.dtype == y.dtype and x.shape == y.shape, f"{path}/{k}"
                assert x.tobytes() == y.tobytes(), f"{path}/{k}"
                n += 1
            else:
                walk(ga[k], gb[k], f"{path}/{k}")
    walk(zarrlite.open_group(ours), zarrlite.open_group(ref), ours.name)
    return n


def random_table(seed: int, n: int = 300, non_dendritic: bool = False) -> list[list[str]]:
    """A MERIT flowpath table: a random tree of ``n`` reaches (fan-in <= 4,
    unsorted COMIDs), a three-reach cycle with a tributary into it, one
    isolated COMID, empty up cells and a NaN length; ``non_dendritic`` lists
    one reach as upstream of two."""
    rng = np.random.default_rng(seed)
    comids = rng.choice(np.arange(10_000, 99_999), size=n + 5, replace=False)
    tree, extra = comids[:n], comids[n:]
    ups: dict[int, list[int]] = {int(c): [] for c in comids}
    down: dict[int, int] = {}
    for i in range(n - 1):  # reach i drains to a later reach with room
        for _ in range(50):
            j = int(rng.integers(i + 1, min(n, i + 12)))
            if len(ups[int(tree[j])]) < 4:
                break
        ups[int(tree[j])].append(int(tree[i]))
        down[int(tree[i])] = int(tree[j])
    x1, x2, x3, trib, lone = (int(c) for c in extra)
    ups[x1] += [x3, trib]
    ups[x2] += [x1]
    ups[x3] += [x2]
    if non_dendritic:
        ups[int(tree[-1])].append(int(tree[0]))  # tree[0] already drains elsewhere
    rows = []
    for c in rng.permutation(comids):
        c = int(c)
        u = ups[c][:4] + [0] * (4 - len(ups[c][:4]))
        cells = [str(v) if v or rng.random() < 0.5 else "" for v in u]
        length = "" if c == int(tree[5]) else f"{rng.uniform(0.2, 9.0):.4f}"
        rows.append([str(c), str(down.get(c, 0)), *cells, length, f"{rng.uniform(1e-4, 0.05):.6f}"])
    return rows


def write_table(path: Path, rows: list[list[str]]) -> Path:
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        w.writerows(rows)
    return path


def write_gauges(path: Path, comids: list[int]) -> Path:
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["STAID", "STANAME", "DRAIN_SQKM", "LAT_GAGE", "LNG_GAGE", "COMID"])
        for i, c in enumerate(comids):
            w.writerow([f"{1000 + i}", f"gauge {i}", 10 + i, 40.0, -75.0, c])
    return path


@pytest.fixture(params=["jax-native", "jax-numpy"])
def jax_path(request, monkeypatch):
    """The JAX package's graph core as it loads itself, and its numpy path."""
    if request.param == "jax-numpy":
        monkeypatch.setattr(jax_graph, "_NATIVE", None)
        monkeypatch.setattr(jax_graph, "_NATIVE_TRIED", True)
    return request.param


def _tables(tmp_path):
    rows = random_table(seed=11)
    return {"example": EXAMPLE / "flowpaths.csv", "random": write_table(tmp_path / "fp.csv", rows)}


def _gauge_comids(name, path):
    if name == "example":
        return [110, 107, 101, 999]
    fp = merit.read_flowpaths(path)
    matrix, order = merit.create_adjacency_matrix(fp)
    outlet = order[np.flatnonzero(np.bincount(matrix.row, minlength=len(order)))[-1]]
    headwater = next(c for c in order if c not in set(np.asarray(order)[matrix.row]))
    return [outlet, order[len(order) // 2], headwater, order[-1], 123]  # order[-1]: the isolated COMID


@pytest.mark.parametrize("table", ["example", "random"])
def test_adjacency_stores_equal_jax(tmp_path, jax_path, table):
    path = _tables(tmp_path)[table]
    gauges = write_gauges(tmp_path / "gages.csv", _gauge_comids(table, path))
    for pkg, m, v, g in (("port", merit, validate_gages, MERITGauge),
                         ("jax", jax_merit, jax_validate_gages, JaxMERITGauge)):
        out = tmp_path / pkg
        m.build_merit_adjacency(path, out / "conus.zarr")
        m.build_gauge_adjacencies(path, out / "conus.zarr", v(gauges, gauge_type=g), out / "gages.zarr")
    assert assert_stores_equal(tmp_path / "port" / "conus.zarr", tmp_path / "jax" / "conus.zarr") == 6
    n = assert_stores_equal(tmp_path / "port" / "gages.zarr", tmp_path / "jax" / "gages.zarr")
    # the gauge at the COMID the table lacks is skipped; each other one has four arrays
    assert n == 4 * (3 if table == "example" else 4)


def test_random_table_exercises_the_repair_paths(tmp_path, caplog):
    """The random table has a cycle to drop, an isolated COMID and NaN cells:
    the port logs the repair, the cycle's reaches are gone and its tributary
    and the isolated COMID sit at the end of the order."""
    rows = random_table(seed=11)
    path = write_table(tmp_path / "fp.csv", rows)
    fp = merit.read_flowpaths(path)
    assert fp["up2"].dtype == np.float64 and np.isnan(fp["up2"]).any()
    assert np.isnan(fp["lengthkm"]).sum() == 1 and fp["COMID"].dtype == np.int64
    with caplog.at_level("INFO", logger=merit.__name__):
        matrix, order = merit.create_adjacency_matrix(fp)
    assert "DAG has cycle(s): removing 3 flowpaths" in caplog.text
    assert "Adding 2 isolated COMIDs" in caplog.text
    assert len(order) == len(rows) - 3 and matrix.nnz == len(order) - 2 - 1
    assert np.all(matrix.row > matrix.col)


def test_parquet_table_names_the_missing_reader(tmp_path):
    with pytest.raises(NotImplementedError, match="parquet"):
        merit.build_merit_adjacency(tmp_path / "fp.parquet", tmp_path / "out.zarr")


@pytest.mark.parametrize("case", ["non-dendritic", "no-connections", "store-exists"])
def test_error_cases_raise_the_same_type(tmp_path, case):
    if case == "non-dendritic":
        path = write_table(tmp_path / "fp.csv", random_table(seed=3, n=60, non_dendritic=True))
    else:
        path = write_table(tmp_path / "fp.csv", [["1", "2", "0", "0", "0", "0", "1.0", "0.01"],
                                                 ["2", "0", "0", "0", "0", "0", "1.0", "0.01"]])
    if case == "store-exists":
        path = EXAMPLE / "flowpaths.csv"
    errors = []
    for pkg, m in (("port", merit), ("jax", jax_merit)):
        out = tmp_path / pkg / "conus.zarr"
        if case == "store-exists":
            out.mkdir(parents=True)
        with pytest.raises(Exception) as info:
            m.build_merit_adjacency(path, out)
        errors.append(info.type)
    assert errors[0] is errors[1] and errors[0] in (AssertionError, ValueError, FileExistsError)


def _random_dag(seed: int, n: int = 200, cycle: bool = False):
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for i in range(n - 1):
        for j in rng.choice(np.arange(i + 1, n), size=min(int(rng.integers(1, 3)), n - 1 - i), replace=False):
            src.append(i)
            dst.append(int(j))
    perm = rng.permutation(n)  # hide the order in the labels
    src, dst = perm[np.asarray(src)], perm[np.asarray(dst)]
    if cycle:
        a, b, c = (int(v) for v in rng.choice(n, 3, replace=False))
        src, dst = np.concatenate([src, [a, b, c]]), np.concatenate([dst, [b, c, a]])
    return src, dst, n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graph_functions_equal_jax(jax_path, seed):
    src, dst, n = _random_dag(seed)
    np.testing.assert_array_equal(graph.topological_sort(src, dst, n), jax_graph.topological_sort(src, dst, n))
    np.testing.assert_array_equal(graph.longest_path_levels(src, dst, n),
                                  jax_graph.longest_path_levels(src, dst, n))
    targets = np.array([seed, n - 1 - seed])
    np.testing.assert_array_equal(graph.ancestors_mask(src, dst, n, targets),
                                  jax_graph.ancestors_mask(src, dst, n, targets))
    assert graph.cycle_nodes(src, dst, n).size == 0 == jax_graph.cycle_nodes(src, dst, n).size
    src_c, dst_c, _ = _random_dag(seed, n=40, cycle=True)
    if jax_path == "jax-numpy":  # the peel keeps reaches between cycles; the native core does not
        np.testing.assert_array_equal(graph.cycle_nodes(src_c, dst_c, 40), jax_graph.cycle_nodes(src_c, dst_c, 40))
    for fn in (graph.topological_sort, jax_graph.topological_sort):
        with pytest.raises(ValueError, match="cycle"):
            fn(src_c, dst_c, 40)


def test_tie_breaking_takes_the_smallest_ready_index():
    # 3 and 1 are ready first; 0 becomes ready after 1, and goes before 3
    src, dst = np.array([1, 2]), np.array([0, 0])
    np.testing.assert_array_equal(graph.topological_sort(src, dst, 4), [1, 2, 0, 3])


def test_cycle_nodes_on_a_dendritic_cycle_equal_the_native_core(jax_path):
    fp = merit.read_flowpaths(EXAMPLE / "flowpaths.csv")
    up = merit.build_upstream_dict(fp)
    up[101] = [110]  # the outlet drains into a headwater: one cycle through the mainstem
    src, dst, ids, _ = merit._edges_and_ids(up)
    ours = [ids[i] for i in graph.cycle_nodes(src, dst, len(ids))]
    assert ours == [ids[i] for i in jax_graph.cycle_nodes(src, dst, len(ids))] == [101, 103, 107, 108, 109, 110]


def test_order_converters_and_coo_round_trip(tmp_path):
    fp = merit.read_flowpaths(EXAMPLE / "flowpaths.csv")
    matrix, order = merit.create_adjacency_matrix(fp)
    core.coo_to_zarr(matrix, order, tmp_path / "a.zarr", "merit")
    coo, back = core.coo_from_zarr(tmp_path / "a.zarr")
    assert back == order and (coo.toarray() == matrix.toarray()).all()
    root = zarrlite.create_group(tmp_path / "b.zarr")
    core.coo_to_zarr_group(root, "g", matrix, [f"wb-{c}" for c in order], "lynker", gage_catchment="wb-7", gage_idx=3)
    coo, back = core.coo_from_zarr_group(zarrlite.open_group(tmp_path / "b.zarr")["g"])
    assert back == [f"wb-{c}" for c in order]
    assert core.get_converter("hydrofabric_v2.2").to_zarr(["ghost-4", "wb-12.0"]).tolist() == [4, 12]
    with pytest.raises(ValueError, match="unknown geodataset"):
        core.get_converter("nope")
    assert core.list_geodatasets() == ["hydrofabric_v2.2", "lynker", "merit", "synthetic"]


def test_merit_cli_writes_jax_stores(tmp_path, jax_path):
    gauges = EXAMPLE / "gages.csv"
    assert merit_cli.main([str(EXAMPLE / "flowpaths.csv"), "--path", str(tmp_path / "port"),
                           "--gages", str(gauges)]) == 0
    assert jax_merit_cli.main([str(EXAMPLE / "flowpaths.csv"), "--path", str(tmp_path / "jax"),
                               "--gages", str(gauges)]) == 0
    for store in ("merit_conus_adjacency.zarr", "merit_gages_conus_adjacency.zarr"):
        assert assert_stores_equal(tmp_path / "port" / store, tmp_path / "jax" / store) > 0


def test_gauge_records_validate_like_jax(tmp_path):
    path = write_gauges(tmp_path / "g.csv", [101, 110])
    ours, ref = validate_gages(path, gauge_type=MERITGauge), jax_validate_gages(path, gauge_type=JaxMERITGauge)
    assert [(g.STAID, g.STANAME, g.DRAIN_SQKM, g.COMID) for g in ours.gauges] == [
        (g.STAID, g.STANAME, g.DRAIN_SQKM, g.COMID) for g in ref.gauges] == [
        ("00001000", "gauge 0", 10.0, 101), ("00001001", "gauge 1", 11.0, 110)]
    with pytest.raises(ValueError, match="COMID"):
        MERITGauge.model_validate({"STAID": "1", "DRAIN_SQKM": "3"})
