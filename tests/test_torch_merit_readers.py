"""The port's readers, statistics and batch builders against the JAX
package's, on the CPU.

On the example's stores (prepared by the port, whose stores equal JAX's,
``tests/test_torch_merit_stores.py``) and on seeded hourly and daily stores:
``StreamflowReader`` and ``USGSObservationReader`` give bit-equal arrays
for the same windows (daily stores repeated x24, hourly ones indexed by
hour, 0.001 for a divide the store lacks); the statistics cache file is
byte-equal; the gauge CSV reads to the same columns and types (STAID as
padded text); the gauge filters, the flow-scale vector, ``naninfmean``,
``fill_nans`` and the batch builders give equal results.
"""

from __future__ import annotations

import csv
import math
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from ddr_tpu.geodatazoo.dataclasses import Dates as JaxDates
from ddr_tpu.geodatazoo.dataclasses import RoutingData as JaxRoutingData
from ddr_tpu.io import builders as jax_builders
from ddr_tpu.io import readers as jax_readers
from ddr_tpu.io import statistics as jax_statistics
from ddr_tpu.io import zarrlite as jax_zarrlite
from ddr_tpu_torch.geodatazoo.dataclasses import Dates, RoutingData
from ddr_tpu_torch.io import builders, readers, statistics, stores, zarrlite
from ddr_tpu_torch.scripts.prepare_merit_example import prepare

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "merit_basin"


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    dst = tmp_path_factory.mktemp("merit_readers") / "merit_basin"
    shutil.copytree(EXAMPLE, dst, ignore=shutil.ignore_patterns("data", "output"))
    prepare(dst)
    return dst


def _cfg(example, **sources):
    d = example / "data"
    base = dict(streamflow=str(d / "streamflow.zarr"), observations=str(d / "observations.zarr"),
                gages=str(example / "gages.csv"), attributes=str(d / "attributes.zarr"),
                statistics=example / "stats", is_hourly=False)
    base.update(sources)
    return SimpleNamespace(data_sources=SimpleNamespace(**base), geodataset="merit", s3_region=None)


def _windows(seed, start="1981/10/01", end="1982/03/31", rho=15, n=6):
    """Pairs of (port, JAX) Dates on the same windows: ``n`` random rho-day
    draws, then the full period and a two-day chunk."""
    ours, ref = Dates(start_time=start, end_time=end, rho=rho), JaxDates(start_time=start, end_time=end, rho=rho)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(n):
        ours.calculate_time_period(ra)
        ref.calculate_time_period(rb)
        yield ours.snapshot(), ref.snapshot()
    for chunk in (np.arange(len(ours.daily_time_range)), np.array([4, 5])):
        ours.set_date_range(chunk)
        ref.set_date_range(chunk)
        yield ours.snapshot(), ref.snapshot()


@pytest.mark.parametrize("ids", [[101, 103, 107, 110], [112, 5555, 101]], ids=["known", "one-missing"])
def test_streamflow_reader_daily_equals_jax(example, ids):
    cfg = _cfg(example)
    ours, ref = readers.StreamflowReader(cfg), jax_readers.StreamflowReader(cfg)
    divide_ids = np.asarray(ids, dtype=np.int32)
    for d_ours, d_ref in _windows(3):
        a = ours(routing_dataclass=RoutingData(divide_ids=divide_ids, dates=d_ours))
        b = ref(routing_dataclass=JaxRoutingData(divide_ids=divide_ids, dates=d_ref))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (len(d_ours.batch_hourly_time_range), len(ids))
        assert a.tobytes() == b.tobytes()
    if 5555 in ids:
        assert (a[:, 1] == np.float32(0.001)).all()


@pytest.mark.parametrize("flag", ["store-freq", "config-flag"])
def test_streamflow_reader_hourly_equals_jax(tmp_path, flag):
    rng = np.random.default_rng(8)
    ids = ["a1", "b2", "c3"]
    qr = rng.gamma(2.0, 0.5, (3, 24 * 200)).astype(np.float32)
    stores.write_hydro_store(tmp_path / "h.zarr", ids, "1981-09-30", "h" if flag == "store-freq" else "D", {"Qr": qr})
    cfg = _cfg(tmp_path, streamflow=str(tmp_path / "h.zarr"), is_hourly=flag == "config-flag")
    ours, ref = readers.StreamflowReader(cfg), jax_readers.StreamflowReader(cfg)
    assert ours.is_hourly and ref.is_hourly
    divide_ids = np.asarray(["c3", "zz", "a1"])
    for d_ours, d_ref in _windows(4, start="1981/10/02", end="1982/02/01", rho=9):
        a = ours(routing_dataclass=RoutingData(divide_ids=divide_ids, dates=d_ours))
        b = ref(routing_dataclass=JaxRoutingData(divide_ids=divide_ids, dates=d_ref))
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_streamflow_reader_refuses_a_window_outside_the_store(example):
    cfg = _cfg(example)
    early = Dates(start_time="1981/09/01", end_time="1981/10/10")
    with pytest.raises(AssertionError, match="negative"):
        readers.StreamflowReader(cfg)(routing_dataclass=RoutingData(divide_ids=np.array([101]), dates=early))
    late = Dates(start_time="1982/10/01", end_time="1982/11/10")
    with pytest.raises(AssertionError, match="exceeds store length"):
        readers.StreamflowReader(cfg)(routing_dataclass=RoutingData(divide_ids=np.array([101]), dates=late))
    with pytest.raises(AssertionError, match="No valid divide"):
        readers.StreamflowReader(cfg)(routing_dataclass=RoutingData(divide_ids=np.array([7]), dates=early))


def test_observation_reader_equals_jax(example):
    cfg = _cfg(example)
    ours, ref = readers.USGSObservationReader(cfg), jax_readers.USGSObservationReader(cfg)
    for d_ours, d_ref in _windows(5):
        a, b = ours.read_data(d_ours), ref.read_data(d_ref)
        assert a.gage_ids == b.gage_ids == ["11111111", "22222222"]
        assert a.streamflow.tobytes() == b.streamflow.tobytes()
        np.testing.assert_array_equal(np.asarray(a.time, "datetime64[D]"), np.asarray(b.time, "datetime64[D]"))
        sub_a, sub_b = a.sel_gages(["22222222"]), b.sel_gages(["22222222"])
        assert sub_a.streamflow.tobytes() == sub_b.streamflow.tobytes()
    with pytest.raises(ValueError, match="gages"):
        readers.USGSObservationReader(_cfg(example, gages=None))


def test_statistics_file_is_byte_equal(example, tmp_path):
    attrs = stores.open_attribute_store(example / "data" / "attributes.zarr").as_mapping()
    attrs["with_nan"] = np.array([1.0, np.nan, 3.0, 10.0])
    ours = statistics.set_statistics(_cfg(example, statistics=tmp_path / "p"), attrs)
    ref = jax_statistics.set_statistics(_cfg(example, statistics=tmp_path / "j"), attrs)
    name = "merit_attribute_statistics_attributes.zarr.json"
    assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    for attr, stats in ours.items():
        for stat, value in stats.items():
            assert value == ref.loc[stat, attr]
    assert statistics.set_statistics(_cfg(example, statistics=tmp_path / "p"), {}) == ours  # the cache


GAGE_CSVS = {
    "example": None,
    "no-staname": [["STAID", "DRAIN_SQKM", "LAT_GAGE", "LNG_GAGE", "COMID", "DA_VALID"],
                   ["1234567", "12.5", "40.1", "-75.2", "107", "True"],
                   ["00001234", "3", "41", "-76", "110", "False"]],
    "optional-columns": [["STAID", "STANAME", "DRAIN_SQKM", "LAT_GAGE", "LNG_GAGE", "COMID", "COMID_DRAIN_SQKM",
                          "ABS_DIFF", "COMID_UNITAREA_SQKM", "FLOW_SCALE", "EXTRA"],
                         ["01013500", "Fish River", "2252.7", "", "-68.58", "71", "2260.1", "7.4", "30", "0.75", "x"],
                         ["1013501", "", "5", "47.2", "-68.5", "72", "", "", "", "", "y"]],
}


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def _same_value(a, b) -> bool:
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(GAGE_CSVS))
def test_gage_info_reads_as_jax_reads_it(tmp_path, name):
    rows = GAGE_CSVS[name]
    path = EXAMPLE / "gages.csv" if rows is None else _write_csv(tmp_path / "g.csv", rows)
    ours, ref = readers.read_gage_info(path), jax_readers.read_gage_info(path)
    assert list(ours) == list(ref)
    for col in ref:
        assert len(ours[col]) == len(ref[col]) and all(map(_same_value, ours[col], ref[col])), (col, ours[col], ref[col])
    assert all(len(s) == 8 for s in ours["STAID"])


def test_gage_info_errors_as_jax(tmp_path):
    bad = _write_csv(tmp_path / "bad.csv", [["STAID", "DRAIN_SQKM"], ["1", "2"]])
    for fn in (readers.read_gage_info, jax_readers.read_gage_info):
        with pytest.raises(KeyError, match="missing the following headers"):
            fn(bad)
        with pytest.raises(FileNotFoundError):
            fn(tmp_path / "none.csv")


def test_gauge_filters_equal_jax(example, tmp_path):
    path = _write_csv(tmp_path / "g.csv", GAGE_CSVS["optional-columns"][:2] + [
        ["22222222", "b", "5", "1", "1", "110", "9", "60", "5", "", ""],
        ["11111111", "c", "5", "1", "1", "107", "9", "3", "5", "", ""],
        ["33333333", "d", "5", "1", "1", "101", "9", "1", "5", "", ""]])
    gd = readers.read_gage_info(path)
    ids = np.array(gd["STAID"])
    for threshold in (5.0, 50.0):
        a, b = readers.filter_gages_by_area_threshold(ids, gd, threshold), \
            jax_readers.filter_gages_by_area_threshold(ids, gd, threshold)
        assert a[0].tolist() == b[0].tolist() and a[1] == b[1]
    gd_valid = dict(gd, DA_VALID=[True, False, 1, 0])
    a, b = readers.filter_gages_by_da_valid(ids, gd_valid), jax_readers.filter_gages_by_da_valid(ids, gd_valid)
    assert a[0].tolist() == b[0].tolist() == ["01013500", "11111111"] and a[1] == b[1] == 2
    path = example / "data" / "merit_gages_adjacency.zarr"
    a = readers.filter_headwater_gages(ids, zarrlite.open_group(path))
    b = jax_readers.filter_headwater_gages(ids, jax_zarrlite.open_group(path))
    assert a[0].tolist() == b[0].tolist() == ["22222222", "11111111"] and a[1] == b[1] == 2
    for fn in (readers.filter_gages_by_area_threshold, jax_readers.filter_gages_by_area_threshold):
        with pytest.raises(KeyError):
            fn(ids, {"STAID": []}, 1.0)


@pytest.mark.parametrize("columns", ["flow-scale", "areas", "none"])
def test_flow_scale_vector_equals_jax(columns):
    gd = {"STAID": ["00000001", "00000002", "00000003"], "DRAIN_SQKM": [80.0, 100.0, float("nan")]}
    if columns == "flow-scale":
        gd["FLOW_SCALE"] = [0.5, float("nan"), 0.25]
    elif columns == "areas":
        gd["COMID_DRAIN_SQKM"] = [100.0, 90.0, 100.0]
        gd["COMID_UNITAREA_SQKM"] = [40.0, 40.0, 40.0]
    batch, idx = ["1", "00000002", "3", "9"], [4, 0, 2, 1]
    a = readers.build_flow_scale_tensor(batch, gd, idx, 6)
    b = jax_readers.build_flow_scale_tensor(batch, gd, idx, 6)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("args", [(80, 100, 40), (100, 90, 40), (50, 100, 40), (80, 100, 0), (float("nan"), 1, 1)])
def test_flow_scale_factor_equals_jax(args):
    assert readers.compute_flow_scale_factor(*args) == jax_readers.compute_flow_scale_factor(*args)


def test_nan_helpers_equal_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7))
    x[0, 2] = x[2, 5] = np.nan
    x[1, 1] = np.inf
    assert readers.naninfmean(x) == jax_readers.naninfmean(x)
    assert np.isnan(readers.naninfmean(np.array([np.nan, np.inf])))
    for means in (None, np.array([1.0, 2.0, 3.0]), np.float32(4.5)):
        a, b = readers.fill_nans(x, row_means=means), jax_readers.fill_nans(x, row_means=means)
        assert a.tobytes() == b.tobytes()


def test_batch_builders_equal_jax(example):
    path = example / "data" / "merit_gages_adjacency.zarr"
    adj, jax_adj = zarrlite.open_group(path), jax_zarrlite.open_group(path)
    for batch in (["11111111", "22222222"], ["22222222", "missing", "11111111"], ["11111111"]):
        a, b = builders.construct_network_matrix(batch, adj), jax_builders.construct_network_matrix(batch, jax_adj)
        np.testing.assert_array_equal(a[0].row, b[0].row)
        np.testing.assert_array_equal(a[0].col, b[0].col)
        assert a[0].shape == b[0].shape and a[1:] == b[1:]
    with pytest.raises(KeyError):
        builders.construct_network_matrix(["nope"], adj)
    cfg = _cfg(example)
    obs_ours = readers.USGSObservationReader(cfg).read_data(Dates(start_time="1981/10/01", end_time="1982/03/31"))
    obs_ref = jax_readers.USGSObservationReader(cfg).read_data(JaxDates(start_time="1981/10/01", end_time="1982/03/31"))
    for d_ours, d_ref in _windows(6):
        a = builders.create_hydrofabric_observations(d_ours, np.array(["22222222"]), obs_ours)
        b = jax_builders.create_hydrofabric_observations(d_ref, np.array(["22222222"]), obs_ref)
        assert a.gage_ids == b.gage_ids and a.streamflow.tobytes() == b.streamflow.tobytes()
    conus = zarrlite.open_group(example / "data" / "merit_conus_adjacency.zarr")
    rows, cols = conus["indices_0"].read(), conus["indices_1"].read()
    for targets in ([11], [6, 3], [0]):
        np.testing.assert_array_equal(builders.upstream_closure(rows, cols, 12, np.array(targets)),
                                      jax_builders.upstream_closure(rows, cols, 12, np.array(targets)))


def test_read_coo_and_read_zarr_equal_jax(example):
    path = example / "data" / "merit_gages_adjacency.zarr"
    a, b = readers.read_coo(path, "11111111"), jax_readers.read_coo(path, "11111111")
    assert (a[0].toarray() == b[0].toarray()).all() and dict(a[1].attrs) == dict(b[1].attrs)
    for fn in (readers.read_coo, jax_readers.read_coo):
        with pytest.raises(KeyError, match="Cannot find key"):
            fn(path, "nope")
        with pytest.raises(FileNotFoundError):
            fn(example / "none.zarr", "x")
    with pytest.raises(FileNotFoundError):
        readers.read_zarr(example / "none.zarr")
    assert readers.convert_ft3_s_to_m3_s(np.array([10.0]))[0] == jax_readers.convert_ft3_s_to_m3_s(np.array([10.0]))[0]
