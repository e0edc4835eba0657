"""The port's store layer against the JAX package's, on the CPU.

``python -m ddr_tpu_torch.scripts.prepare_merit_example`` against the
example's own ``prepare.py``, run in a subprocess on a copy of the example
(never under ``examples/``): all five stores equal array for array, bit for
bit, with equal ``zarr.json`` attributes. Then the hydro and attribute
stores: every ``start_date`` spelling the JAX writer accepts reads to the
same first day and offset, each package reads the other's stores, and a
URI with no backend fails as JAX's does (``s3://`` RuntimeError, another
scheme ValueError); a zarr v2 group is refused by name.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from ddr_tpu.io import stores as jax_stores
from ddr_tpu_torch.io import stores
from ddr_tpu_torch.scripts import prepare_merit_example
from tests.test_torch_merit_engine import assert_stores_equal

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "merit_basin"
STORES = ("merit_conus_adjacency.zarr", "merit_gages_adjacency.zarr", "attributes.zarr",
          "streamflow.zarr", "observations.zarr")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The example prepared by JAX's ``prepare.py`` (a subprocess) and by the
    port's module, each in its own copy."""
    tmp = tmp_path_factory.mktemp("merit_stores")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    out = {}
    for name in ("jax", "port"):
        dst = tmp / name
        shutil.copytree(EXAMPLE, dst, ignore=shutil.ignore_patterns("data", "output"))
        cmd = ["prepare.py"] if name == "jax" else ["-m", "ddr_tpu_torch.scripts.prepare_merit_example", "."]
        proc = subprocess.run([sys.executable, *cmd], cwd=dst, capture_output=True, text=True, env=env,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        out[name] = dst / "data"
    return out


@pytest.mark.parametrize("store", STORES)
def test_prepared_store_equals_jax(prepared, store):
    n = assert_stores_equal(prepared["port"] / store, prepared["jax"] / store)
    assert n == {"merit_conus_adjacency.zarr": 6, "merit_gages_adjacency.zarr": 8, "attributes.zarr": 8,
                 "streamflow.zarr": 1, "observations.zarr": 1}[store]


def test_prepare_keeps_a_finished_adjacency_and_rewrites_the_rest(tmp_path):
    dst = tmp_path / "ex"
    shutil.copytree(EXAMPLE, dst, ignore=shutil.ignore_patterns("data", "output"))
    prepare_merit_example.prepare(dst)
    conus = (dst / "data" / "merit_conus_adjacency.zarr" / "order" / "zarr.json").stat().st_mtime_ns
    shutil.rmtree(dst / "data" / "streamflow.zarr")
    assert prepare_merit_example.main([str(dst)]) == 0
    assert (dst / "data" / "merit_conus_adjacency.zarr" / "order" / "zarr.json").stat().st_mtime_ns == conus
    assert stores.open_hydro_store(dst / "data" / "streamflow.zarr").n_time() == prepare_merit_example.N_DAYS
    assert prepare_merit_example.main([]) == 2


@pytest.mark.parametrize("text", ["1981/09/25", "1981-09-25", "19810925", "1981/9/5", "1981-09-25 06:00:00",
                                  "1981-09-25T06:30", "2001-01-01"])
def test_start_dates_read_as_pandas_reads_them(tmp_path, text):
    """Each spelling writes the same ``YYYY/MM/DD`` as JAX's writer, and the
    first day, the offset from 1980/01/01 and the hours of a store read the
    same in both packages (a time of day is dropped by the writer)."""
    data = np.arange(12, dtype=np.float32).reshape(2, 6)
    ours = stores.write_hydro_store(tmp_path / "p.zarr", [1, 2], text, "h", {"Qr": data})
    ref = jax_stores.write_hydro_store(tmp_path / "j.zarr", [1, 2], text, "h", {"Qr": data})
    assert ours.group.attrs["start_date"] == ref.group.attrs["start_date"]
    for a, b in ((ours, ref), (stores.open_hydro_store(tmp_path / "j.zarr"), jax_stores.open_hydro_store(tmp_path / "p.zarr"))):
        assert a.start_date == np.datetime64(b.start_date.to_datetime64(), "s")
        assert a.time_offset_days == b.time_offset_days and a.is_hourly == b.is_hourly
        np.testing.assert_array_equal(a.select("Qr", np.array([1, 0]), np.array([5, 0])),
                                      b.select("Qr", np.array([1, 0]), np.array([5, 0])))
    assert stores.parse_timestamp(text) == np.datetime64(pd.Timestamp(text).to_datetime64(), "s")


def test_attribute_store_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    attrs = {f"a{i}": rng.normal(size=7) for i in range(3)}
    ours = stores.write_attribute_store(tmp_path / "p.zarr", list(range(7)), attrs)
    ref = jax_stores.write_attribute_store(tmp_path / "j.zarr", list(range(7)), attrs)
    assert assert_stores_equal(tmp_path / "p.zarr", tmp_path / "j.zarr") == 3
    assert ours.attribute_names == ref.attribute_names
    np.testing.assert_array_equal(ours.matrix(["a2", "a0"]), ref.matrix(["a2", "a0"]))
    assert ours.id_to_index == ref.id_to_index
    with pytest.raises(ValueError, match=r"expected \(7,\)"):
        stores.write_attribute_store(tmp_path / "bad.zarr", list(range(7)), {"x": np.zeros(3)})
    with pytest.raises(ValueError, match=r"expected \(2, T\)"):
        stores.write_hydro_store(tmp_path / "bad2.zarr", [1, 2], "1981/01/01", "D", {"Qr": np.zeros(4)})


@pytest.mark.parametrize("uri,error", [("s3://bucket/streamflow", RuntimeError),
                                       ("gs://bucket/streamflow", ValueError),
                                       ("file://remote-host/x.zarr", ValueError)])
def test_unregistered_uris_fail_as_jax_does(monkeypatch, uri, error):
    # JAX registers its S3 opener on first use: keep that out of this process's later tests
    monkeypatch.setattr(jax_stores, "_STORE_BACKENDS", {})
    with pytest.raises(error) as ours:
        stores.open_hydro_store(uri)
    with pytest.raises(error):
        jax_stores.open_hydro_store(uri)
    if uri.startswith("s3"):
        assert "ROADMAP A.8" in str(ours.value)


def test_registered_backend_and_file_uri_open_the_store(tmp_path, monkeypatch):
    monkeypatch.setattr(stores, "_STORE_BACKENDS", {})
    stores.write_hydro_store(tmp_path / "s.zarr", ["a"], "1990/01/01", "D", {"Qr": np.ones((1, 3))})
    seen = []

    def opener(uri):
        seen.append(uri)
        return stores.zarrlite.open_group(tmp_path / "s.zarr")

    stores.register_store_backend("MEM", opener)
    assert stores.open_hydro_store("mem://anything").ids == ["a"] and seen == ["mem://anything"]
    stores.unregister_store_backend("mem")
    with pytest.raises(ValueError, match="No backend registered for mem://"):
        stores.open_hydro_store("mem://anything")
    assert stores.open_hydro_store(f"file://{tmp_path / 's.zarr'}").n_time() == 3


def test_zarr_v2_store_is_refused_by_name(tmp_path):
    (tmp_path / "v2.zarr").mkdir()
    (tmp_path / "v2.zarr" / ".zgroup").write_text('{"zarr_format": 2}')
    with pytest.raises(NotImplementedError, match="A.8"):
        stores.open_attribute_store(tmp_path / "v2.zarr")
