"""The Lynker hydrofabric path of the port against the JAX package's, on the CPU.

A GeoPackage-style sqlite file in ``tmp_path`` holds ``flowpaths``,
``network`` (``wb-``/``nex-`` ids, ``hl_uri`` gauges) and
``flowpath-attributes-ml``: JAX's ``tests/engine/test_lynker_build.py``
network, then a 13-flowpath basin with two gauges, a NULL ``toid``, a NULL
``MusX``, a flowpath with no attribute row, two outlets into one unmapped
nexus (the ghost case) and a gauge that sits on two equal flowpaths (the tie
case). The builders and ``lynker_cli`` give stores array for array equal to
JAX's; ``LynkerHydrofabric`` collates the same routing data as JAX's,
per-reach Muskingum ``x`` included, and raises the same outflow assertion;
``ddr train`` takes two steps whose losses match JAX's within the train
CLI's bounds (rtol 1e-5 for epoch 1, 3e-4 for epoch 2,
``tests/test_torch_train_cli.py``). ``derive_gage_reference_columns`` is
held to JAX's on a table that hits each branch.
"""

from __future__ import annotations

import logging
import re
import sqlite3
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from ddr_tpu.engine import lynker as jl
from ddr_tpu.engine.lynker_cli import main as jax_lynker_cli
from ddr_tpu.geodatazoo.dataclasses import Gauge as JaxGauge
from ddr_tpu.geodatazoo.dataclasses import GaugeSet as JaxGaugeSet
from ddr_tpu.geodatazoo.lynker import LynkerHydrofabric as JaxLynker
from ddr_tpu.io import zarrlite as jax_zarrlite
from ddr_tpu.io.readers import derive_gage_reference_columns as jax_derive
from ddr_tpu.scripts import train as jax_train_script
from ddr_tpu.scripts.common import build_kan as jax_build_kan
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch.engine import lynker as tl
from ddr_tpu_torch.engine.lynker_cli import main as lynker_cli
from ddr_tpu_torch.geodatazoo.dataclasses import Gauge, GaugeSet
from ddr_tpu_torch.geodatazoo.lynker import LynkerHydrofabric
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.io.readers import derive_gage_reference_columns
from ddr_tpu_torch.io.stores import write_attribute_store, write_hydro_store
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.scripts import train as train_script
from ddr_tpu_torch.scripts.common import kan_arch
from ddr_tpu_torch.training import save_state
from ddr_tpu_torch.validation.configs import load_config
from ddr_tpu_torch.validation.enums import GeoDataset
from tests.test_torch_merit_dataset import assert_same_routing_data

# JAX's test network: wb-1, wb-2 -> nex-10 -> wb-3; wb-3, wb-4 -> nex-11 -> wb-5; wb-5 -> nex-12
SMALL_FP = {"id": ["wb-1", "wb-2", "wb-3", "wb-4", "wb-5"],
            "toid": ["nex-10", "nex-10", "nex-11", "nex-11", "nex-12"],
            "tot_drainage_areasqkm": [10.0, 12.0, 30.0, 8.0, 55.0]}
SMALL_NET = {"id": ["wb-1", "wb-2", "wb-3", "wb-4", "wb-5", "nex-10", "nex-11", "nex-12"],
             "toid": ["nex-10", "nex-10", "nex-11", "nex-11", "nex-12", "wb-3", "wb-5", None],
             "hl_uri": [None, None, "gages-11111111", None, "gages-22222222", None, None, None]}

# the basin: (flowpath, its nexus, the waterbody the nexus feeds or None)
BASIN = [
    (1, 101, 3), (2, 101, 3), (3, 102, 5), (4, 102, 5), (6, 103, 8), (7, 103, 8),
    (5, 104, 9), (8, 104, 9), (9, 105, 11), (10, 105, 11), (11, 106, None), (12, 106, None),
    (13, 107, 10),
]
GAUGES = {"01000005": 5, "01000011": 11}
TIE_GAUGE = "01000067"  # on wb-6 and wb-7, whose drainage areas are equal
ATTRS = ["a0", "a1", "a2"]
START, END, STORE_START, STORE_DAYS = "1981/10/01", "1981/11/30", "1981/09/25", 80


def _gpkg(path: Path, fp: dict, net: dict, attrs: dict | None) -> Path:
    with sqlite3.connect(path) as conn:
        pd.DataFrame(fp).to_sql("flowpaths", conn, index=False)
        pd.DataFrame(net).to_sql("network", conn, index=False)
        if attrs is not None:
            pd.DataFrame(attrs).to_sql("flowpath-attributes-ml", conn, index=False)
    return path


def _basin_tables(rng: np.random.Generator) -> tuple[dict, dict, dict]:
    ids = [f"wb-{w}" for w, _, _ in BASIN]
    up = {w: [u for u, _, d in BASIN if d == w] for w, _, _ in BASIN}

    def area(w):
        return 10.0 + sum(area(u) for u in up[w])

    fp = {"id": ids, "toid": [f"nex-{n}" for _, n, _ in BASIN],
          "tot_drainage_areasqkm": [area(w) for w, _, _ in BASIN]}
    nexus = sorted({(n, d) for _, n, d in BASIN})
    hl = {w: f"gages-{g}" for g, w in GAUGES.items()} | {6: f"gages-{TIE_GAUGE}", 7: f"gages-{TIE_GAUGE}"}
    net = {"id": ids + [f"nex-{n}" for n, _ in nexus],
           "toid": fp["toid"] + [None if d is None else f"wb-{d}" for _, d in nexus],
           "hl_uri": [hl.get(w) for w, _, _ in BASIN] + [None] * len(nexus)}
    keep = [i for i, (w, _, _) in enumerate(BASIN) if w != 13]  # wb-13 has no attribute row
    n = len(keep)
    musx = rng.uniform(0.1, 0.45, n).astype(object)
    musx[2] = None
    attrs = {"id": [ids[i] for i in keep], "Length_m": rng.uniform(800.0, 4000.0, n),
             "So": rng.uniform(1e-3, 0.02, n), "TopWdth": rng.uniform(3.0, 40.0, n),
             "ChSlp": rng.uniform(0.5, 4.0, n), "MusX": list(musx)}
    return fp, net, attrs


@pytest.fixture(scope="module")
def fabric(tmp_path_factory):
    """The basin's GeoPackage, both packages' stores built by their CLIs, and
    the attribute, streamflow and observation stores a run reads."""
    root = tmp_path_factory.mktemp("lynker")
    rng = np.random.default_rng(23)
    fp, net, attrs = _basin_tables(rng)
    gpkg = _gpkg(root / "hydrofabric.gpkg", fp, net, attrs)
    gages = root / "gages.csv"
    area = dict(zip(fp["id"], fp["tot_drainage_areasqkm"]))
    gages.write_text("STAID,STANAME,DRAIN_SQKM,LAT_GAGE,LNG_GAGE\n" + "".join(
        f"{g},site {g},{area[f'wb-{w}'] * 1.02},40.0,-75.0\n" for g, w in GAUGES.items()))
    assert lynker_cli([str(gpkg), "--path", str(root / "port"), "--gages", str(gages)]) == 0
    assert jax_lynker_cli([str(gpkg), "--path", str(root / "jax"), "--gages", str(gages)]) == 0

    cat_ids = [f"cat-{w}" for w, _, _ in BASIN]
    write_attribute_store(root / "attributes.zarr", cat_ids,
                          {a: rng.normal(size=len(cat_ids)).astype(np.float32) for a in ATTRS})
    write_hydro_store(root / "streamflow.zarr", cat_ids, STORE_START, "D",
                      {"Qr": rng.uniform(0.1, 3.0, (len(cat_ids), STORE_DAYS)).astype(np.float32)})
    write_hydro_store(root / "observations.zarr", list(GAUGES), STORE_START, "D",
                      {"streamflow": rng.uniform(1.0, 40.0, (len(GAUGES), STORE_DAYS)).astype(np.float32)},
                      id_dim="gage_id")
    (root / "config.yaml").write_text(f"""name: lynker_test
geodataset: lynker_hydrofabric
mode: training
kan:
  input_var_names: [{", ".join(ATTRS)}]
  learnable_parameters: [n, q_spatial]
  hidden_size: 11
  num_hidden_layers: 1
  grid: 3
  k: 3
experiment:
  start_time: {START}
  end_time: {END}
  epochs: 2
  batch_size: 2
  rho: 15
  warmup: 2
  learning_rate: {{1: 0.01, 2: 0.003}}
  max_area_diff_sqkm: null
params:
  save_path: output
data_sources:
  attributes: {root / "attributes.zarr"}
  conus_adjacency: {root / "port" / "hydrofabric_v2.2_conus_adjacency.zarr"}
  gages_adjacency: {root / "port" / "hydrofabric_v2.2_gages_conus_adjacency.zarr"}
  streamflow: {root / "streamflow.zarr"}
  observations: {root / "observations.zarr"}
  gages: {gages}
""")
    return {"root": root, "gpkg": gpkg, "fp": fp, "net": net, "attrs": attrs, "gages": gages}


def _same_group(a, b, label):
    """Two zarr groups (either package's reader) equal: attributes, and each
    array's dtype, shape and bytes (NaN where NaN)."""
    assert sorted(a.keys()) == sorted(b.keys()), label
    assert dict(a.attrs) == dict(b.attrs), label
    for name in b.keys():
        x, y = a[name], b[name]
        if hasattr(y, "keys"):
            _same_group(x, y, f"{label}/{name}")
            continue
        x, y = np.asarray(x[:]), np.asarray(y[:])
        assert x.dtype == y.dtype and x.shape == y.shape, (label, name, x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes(), (label, name, x, y)


def test_gpkg_reader_types_as_pandas(fabric):
    """The sqlite reader gives the builders pandas' values: NULL as None in a
    text column and as NaN once a numeric column is taken as floats."""
    net = tl.read_gpkg_table(fabric["gpkg"], "network", ["id", "toid", "hl_uri"])
    ref = jl.read_gpkg_table(fabric["gpkg"], "network", ["id", "toid", "hl_uri"])
    assert list(net) == list(ref.columns)
    for col in net:
        assert [None if v is None else str(v) for v in net[col]] == [
            None if pd.isna(v) else str(v) for v in ref[col]], col
    attrs = tl.read_gpkg_table(fabric["gpkg"], "flowpath-attributes-ml", ["id", "MusX"])
    jattrs = jl.read_gpkg_table(fabric["gpkg"], "flowpath-attributes-ml", ["id", "MusX"])
    np.testing.assert_array_equal(np.asarray([np.nan if v is None else v for v in attrs["MusX"]], float),
                                  jattrs["MusX"].to_numpy(dtype=np.float64))


@pytest.mark.parametrize("table", ["small", "basin"])
def test_graph_functions_match_jax(fabric, table):
    fp, net = (SMALL_FP, SMALL_NET) if table == "small" else (fabric["fp"], fabric["net"])
    jfp, jnet = pd.DataFrame(fp), pd.DataFrame(net)
    wb = tl.preprocess_river_network(net)
    assert wb == jl.preprocess_river_network(jnet)
    for origin in sorted(wb):
        assert tl.subset(origin, wb) == jl.subset(origin, wb)
    for ghost in (False, True):
        m, order = tl.create_matrix(fp, net, ghost=ghost)
        jm, jorder = jl.create_matrix(jfp, jnet, ghost=ghost)
        assert order == jorder
        np.testing.assert_array_equal(m.row, jm.row)
        np.testing.assert_array_equal(m.col, jm.col)
    # ghost: the outlets into one unmapped nexus (two in the basin) share one ghost terminal
    m, order = tl.create_matrix(fp, net, ghost=True)
    assert [w for w in order if w.startswith("ghost-")] == ["ghost-0"]
    assert m.nnz == len(fp["id"])  # every flowpath has a successor once the ghost is in


def test_find_origin_and_its_tie_break_match_jax(fabric):
    fp, net = fabric["fp"], fabric["net"]
    jfp, jnet = pd.DataFrame(fp), pd.DataFrame(net)
    # equal drainage areas on wb-6 and wb-7: the first row wins, as pandas' sort leaves it
    for cls, fn, f, n in ((Gauge, tl.find_origin, fp, net), (JaxGauge, jl.find_origin, jfp, jnet)):
        assert fn(cls(STAID=TIE_GAUGE, STANAME="t", DRAIN_SQKM=11.0), f, n) == "wb-6"
        with pytest.raises(ValueError):
            fn(cls(STAID="09999999", STANAME="x", DRAIN_SQKM=5.0), f, n)
    # unequal areas: the nearest wins (JAX's own test case)
    small = {**SMALL_NET, "hl_uri": [None, None, "gages-33333333", "gages-33333333", None, None, None, None]}
    assert tl.find_origin(Gauge(STAID="33333333", DRAIN_SQKM=9.0), SMALL_FP, small) == "wb-4"
    assert jl.find_origin(JaxGauge(STAID="33333333", STANAME="x", DRAIN_SQKM=9.0), pd.DataFrame(SMALL_FP),
                          pd.DataFrame(small)) == "wb-4"
    fp_nan = {**fp, "tot_drainage_areasqkm": [None if w == "wb-6" else a
                                              for w, a in zip(fp["id"], fp["tot_drainage_areasqkm"])]}
    got = tl.find_origin(Gauge(STAID=TIE_GAUGE, DRAIN_SQKM=11.0), fp_nan, net)
    assert got == jl.find_origin(JaxGauge(STAID=TIE_GAUGE, STANAME="t", DRAIN_SQKM=11.0),
                                 pd.DataFrame(fp_nan), jnet) == "wb-7"
    with pytest.raises(AssertionError, match="not dendritic"):
        tl.create_matrix({k: v + [v[0]] for k, v in SMALL_FP.items()} | {"toid": SMALL_FP["toid"] + ["nex-11"]},
                         SMALL_NET)


@pytest.mark.parametrize("table,ghost", [("small", False), ("small", True), ("basin", False), ("basin", True)])
def test_builders_write_jax_stores(fabric, tmp_path, table, ghost):
    """The conus store with its attribute arrays and ``toid``, and the gauge
    subsets, from in-memory tables and from the GeoPackage: equal to JAX's."""
    if table == "small":
        gpkg = _gpkg(tmp_path / "small.gpkg", {k: v for k, v in SMALL_FP.items() if k != "tot_drainage_areasqkm"},
                     {k: v for k, v in SMALL_NET.items() if k != "hl_uri"},
                     {"id": SMALL_FP["id"], "Length_m": [1000.0, 1500.0, 2000.0, 900.0, 3000.0],
                      "So": [0.01, 0.012, 0.007, 0.02, 0.004], "TopWdth": [5.0, 6.0, 12.0, 4.0, 20.0],
                      "ChSlp": [1.0, 1.2, 2.0, 0.8, 2.5], "MusX": [0.25, 0.3, 0.28, 0.22, 0.35]})
        fp, net = SMALL_FP, SMALL_NET
        gauges = [("11111111", 30.0), ("22222222", 55.0)]
    else:
        gpkg, fp, net = fabric["gpkg"], fabric["fp"], fabric["net"]
        gauges = [(g, 50.0) for g in (*GAUGES, TIE_GAUGE, "09999999")]
    ours = tl.build_lynker_hydrofabric_adjacency(fp, net, tmp_path / "port.zarr", attributes=gpkg, ghost=ghost)
    ref = jl.build_lynker_hydrofabric_adjacency(pd.DataFrame(fp), pd.DataFrame(net), tmp_path / "jax.zarr",
                                                attributes=gpkg, ghost=ghost)
    _same_group(zarrlite.open_group(ours), jax_zarrlite.open_group(ref), "conus")
    sub = tl.build_gauge_adjacencies(fp, net, ours, GaugeSet([Gauge(STAID=g, DRAIN_SQKM=a) for g, a in gauges]),
                                     tmp_path / "port_gages.zarr")
    jsub = jl.build_gauge_adjacencies(pd.DataFrame(fp), pd.DataFrame(net), ref,
                                      JaxGaugeSet(gauges=[JaxGauge(STAID=g, STANAME="s", DRAIN_SQKM=a)
                                                          for g, a in gauges]), tmp_path / "jax_gages.zarr")
    _same_group(zarrlite.open_group(sub), jax_zarrlite.open_group(jsub), "gauges")
    # tables handed in memory write the same attribute arrays as the GeoPackage
    mem = tl.build_lynker_hydrofabric_adjacency(fp, net, tmp_path / "mem.zarr", ghost=ghost, attributes={
        "flowpath-attributes-ml": tl.read_gpkg_table(gpkg, "flowpath-attributes-ml",
                                                     ["id", "Length_m", "So", "TopWdth", "ChSlp", "MusX"]),
        "flowpaths": fp, "network": net})
    _same_group(zarrlite.open_group(mem), jax_zarrlite.open_group(ref), "conus from tables")
    with pytest.raises(FileExistsError):
        tl.build_lynker_hydrofabric_adjacency(fp, net, ours)


def test_lynker_cli_matches_jax(fabric):
    root = fabric["root"]
    for name in ("hydrofabric_v2.2_conus_adjacency.zarr", "hydrofabric_v2.2_gages_conus_adjacency.zarr"):
        _same_group(zarrlite.open_group(root / "port" / name), jax_zarrlite.open_group(root / "jax" / name), name)
    conus = zarrlite.open_group(root / "port" / "hydrofabric_v2.2_conus_adjacency.zarr")
    order = [int(v) for v in conus["order"].read()]
    x = conus["muskingum_x"].read()
    assert np.isnan(x[order.index(13)]) and np.isnan(x[order.index(3)])  # no row; NULL MusX
    assert conus["toid"].read()[order.index(3)] == 5 and conus["toid"].read()[order.index(11)] == 0


def _configs(fabric, *extra):
    path, save = fabric["root"] / "config.yaml", fabric["root"] / "runs"
    cfg = load_config(path, ["device=cpu", f"params.save_path={save / 'port'}",
                             f"data_sources.statistics={save / 'port_stats'}", *extra], save_config=False)
    jcfg = jax_load_config(path, [f"params.save_path={save / 'jax'}",
                                  f"data_sources.statistics={save / 'jax_stats'}", *extra], save_config=False)
    return cfg, jcfg


def test_dataset_collates_equal_jax(fabric):
    cfg, jcfg = _configs(fabric)
    ours = GeoDataset.lynker_hydrofabric.get_dataset_class(cfg)
    ref = JaxLynker(jcfg)
    assert isinstance(ours, LynkerHydrofabric)
    for batch in (list(GAUGES), [list(GAUGES)[1]]):
        a, b = ours.collate_fn(list(batch)), ref.collate_fn(list(batch))
        assert_same_routing_data(a, b)
        assert all(str(d).startswith("cat-") for d in a.divide_ids)
        assert a.top_width is not None and a.side_slope is not None
    # per-reach x from MusX; wb-3's NULL and wb-13's missing row take the store's mean
    rd = ours.collate_fn(list(GAUGES))
    x_store = zarrlite.open_group(fabric["root"] / "port" / "hydrofabric_v2.2_conus_adjacency.zarr")[
        "muskingum_x"].read()
    filled = [i for i, d in enumerate(rd.divide_ids) if d in ("cat-3", "cat-13")]
    assert len(filled) == 2 and not np.isnan(rd.x).any()
    np.testing.assert_allclose(rd.x[filled], np.nanmean(x_store.astype(np.float64)), rtol=1e-6)
    assert len(np.unique(rd.x)) == rd.n_segments - 1
    # the dendritic assertion: a corrupted toid fails both packages' collate
    for ds in (ours, ref):
        toid = np.array(ds._toid(), copy=True)
        toid[:] = 9999
        ds._toid_cache = toid
        with pytest.raises(AssertionError, match="Gage WB"):
            ds.collate_fn(list(GAUGES))
    cfg, jcfg = _configs(fabric, "mode=testing")
    assert_same_routing_data(LynkerHydrofabric(cfg).routing_data, JaxLynker(jcfg).routing_data)


class _Losses(logging.Handler):
    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        m = re.match(r"epoch \d+ mini-batch \d+: loss=(\S+) \(", record.getMessage())
        if m:
            self.losses.append(float(m.group(1)))


def test_train_two_steps_match_jax(fabric):
    """JAX's loop trains 2 epochs of one step from its initial weights; the
    port's resumes from those weights at epoch 1, mini-batch 0."""
    cfg, jcfg = _configs(fabric)
    losses = []
    original = jax_train_script.make_batch_train_step

    def recording(*args, **kwargs):
        step = original(*args, **kwargs)

        def wrapped(*a):
            out = step(*a)
            losses.append(float(out[2]))
            return out

        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train_script, "make_batch_train_step", recording)
    try:
        jax_train_script.train(jcfg)
    finally:
        mp.undo()
    _, init = jax_build_kan(jcfg)
    cfg.experiment.checkpoint = save_state(fabric["root"] / "init", cfg.name, 1, 0, kan_state_from_flax(init),
                                           None, arch=kan_arch(cfg))
    handler = _Losses()
    logger = logging.getLogger(train_script.__name__)
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        train_script.train(cfg)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    got, want = np.asarray(handler.losses), np.asarray(losses)
    print(f"lynker train: port {got.tolist()} jax {want.tolist()}")
    assert len(got) == len(want) == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got[:1], want[:1], rtol=1e-5, atol=0, err_msg="epoch 1 loss")
    np.testing.assert_allclose(got[1:], want[1:], rtol=3e-4, atol=0, err_msg="epoch 2 loss")


def test_derive_gage_reference_columns_matches_jax():
    """Upstream inside one unit area (scaled), downstream, upstream beyond a
    unit area, a unit area under 100 km² (DA_VALID by the floor), NaN areas."""
    table = {"STAID": ["01", "02", "03", "04", "05", "06"],
             "DRAIN_SQKM": [90.0, 130.0, 10.0, 50.0, np.nan, 75.0],
             "COMID_DRAIN_SQKM": [100.0, 120.0, 300.0, 130.0, 80.0, 80.0],
             "COMID_UNITAREA_SQKM": [40.0, 40.0, 50.0, 60.0, 30.0, np.nan]}
    ours = derive_gage_reference_columns(table)
    ref = jax_derive(pd.DataFrame(table))
    for col in ("ABS_DIFF", "DA_VALID", "FLOW_SCALE"):
        assert np.asarray(ours[col]).dtype == ref[col].to_numpy().dtype, col
        np.testing.assert_array_equal(np.asarray(ours[col]), ref[col].to_numpy(), err_msg=col)
    assert ours["STAID"] == table["STAID"] and "ABS_DIFF" not in table
    for missing in ("DRAIN_SQKM", "COMID_UNITAREA_SQKM"):
        with pytest.raises(KeyError, match="missing"):
            derive_gage_reference_columns({k: v for k, v in table.items() if k != missing})
        with pytest.raises(KeyError, match="missing"):
            jax_derive(pd.DataFrame({k: v for k, v in table.items() if k != missing}))
