"""The port's ``io/zarrlite.py`` against the JAX package's, on the CPU.

Each case writes one store tree with one package and reads it with the
other, and writes the same arrays and attributes with both and compares the
files byte for byte. gzip stamps the current second into each member's
header, so the byte comparisons pin the clock gzip reads to one value (both
packages compress through the same standard ``gzip`` module). The inputs
cover every dtype zarrlite takes, one chunk and a split chunk grid with
ragged edges, gzip on and off, NaN and infinite fill values, a 0-d and a
zero-length array, and nested groups with attributes.
"""

from __future__ import annotations

import gzip
import json

import numpy as np
import pytest

from ddr_tpu.io import zarrlite as jax_zarrlite
from ddr_tpu_torch.io import zarrlite

DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float16", "float32", "float64"]


class _FixedClock:
    @staticmethod
    def time():
        return 1_700_000_000.0


def _data(dtype: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return rng.integers(max(info.min, -1000), min(info.max, 1000), size=shape, dtype=dtype)
    a = rng.normal(size=shape).astype(dtype)
    a.reshape(-1)[:: 7] = np.nan
    return a


def _write_tree(mod, path, seed: int, compress: bool, chunks) -> None:
    root = mod.create_group(path, attributes={"title": "twin", "seed": seed})
    for i, dtype in enumerate(DTYPES):
        fill = np.nan if dtype.startswith("float") else 0
        root.create_array(dtype, _data(dtype, (13, 7), seed + i), chunks=chunks, compress=compress,
                          fill_value=fill, attributes={"dtype": dtype})
    sub = root.create_group("runs", attributes={"gage_ids": ["00000001", "00000002"]})
    deeper = sub.create_group("deeper")
    deeper.create_array("scalar", np.array(3.5, dtype=np.float32), compress=compress)
    deeper.create_array("empty", np.zeros((0, 4), dtype=np.float32), compress=compress)
    deeper.create_array("inf_fill", shape=(5, 3), dtype=np.float64, chunks=(2, 2),
                        fill_value=-np.inf, compress=compress)
    sub.attrs.update({"units": "m3/s", "time": ["1981-10-02 00:00:00"]})
    sub.attrs["nested"] = {"a": [1, 2], "b": None}


def _read_tree(mod, path) -> dict:
    def walk(group, prefix=""):
        out = {f"{prefix}@attrs": dict(group.attrs)}
        for name, arr in group.arrays():
            out[prefix + name] = (arr.read(), dict(arr.attrs), arr.chunks, arr.fill_value)
        for name, sub in group.groups():
            out.update(walk(sub, f"{prefix}{name}/"))
        return out

    return walk(mod.open_group(path))


def _same_tree(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        if key.endswith("@attrs"):
            assert a[key] == b[key], key
            continue
        (xa, atta, ca, fa), (xb, attb, cb, fb) = a[key], b[key]
        assert xa.dtype == xb.dtype and xa.shape == xb.shape, key
        np.testing.assert_array_equal(xa, xb, err_msg=key)
        assert atta == attb and ca == cb, key
        assert (fa == fb) or (np.isnan(fa) and np.isnan(fb)), key


def _files(path) -> dict:
    return {str(p.relative_to(path)): p.read_bytes() for p in sorted(path.rglob("*")) if p.is_file()}


CASES = [(True, None), (False, None), (True, (4, 3)), (False, (5, 7))]


@pytest.mark.parametrize("compress,chunks", CASES)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_store(tmp_path, writer, compress, chunks):
    write, read = (zarrlite, jax_zarrlite) if writer == "port" else (jax_zarrlite, zarrlite)
    _write_tree(write, tmp_path / "s.zarr", 3, compress, chunks)
    _same_tree(_read_tree(read, tmp_path / "s.zarr"), _read_tree(write, tmp_path / "s.zarr"))
    # the values read back are the values written, NaNs and edge chunks included
    root = read.open_group(tmp_path / "s.zarr")
    for i, dtype in enumerate(DTYPES):
        np.testing.assert_array_equal(root[dtype][:], _data(dtype, (13, 7), 3 + i))
    inf = root["runs"]["deeper"]["inf_fill"][:]
    assert inf.shape == (5, 3) and np.all(inf == -np.inf)
    assert float(root["runs"]["deeper"]["scalar"][()]) == 3.5
    assert root["runs"]["deeper"]["empty"][:].shape == (0, 4)


@pytest.mark.parametrize("compress,chunks", CASES)
def test_both_packages_write_identical_files(tmp_path, monkeypatch, compress, chunks):
    monkeypatch.setattr(gzip, "time", _FixedClock)
    _write_tree(zarrlite, tmp_path / "port.zarr", 11, compress, chunks)
    _write_tree(jax_zarrlite, tmp_path / "jax.zarr", 11, compress, chunks)
    port, ref = _files(tmp_path / "port.zarr"), _files(tmp_path / "jax.zarr")
    assert port.keys() == ref.keys()
    assert len(port) > len(DTYPES)
    for name in ref:
        assert port[name] == ref[name], name


def test_large_arrays_split_their_leading_axis_alike(tmp_path, monkeypatch):
    """Past 2**24 elements both packages split the leading axis the same way."""
    monkeypatch.setattr(gzip, "time", _FixedClock)
    a = np.arange((1 << 24) + 4096, dtype=np.uint8).reshape(-1, 4096)
    for mod, name in ((zarrlite, "port"), (jax_zarrlite, "jax")):
        mod.create_group(tmp_path / name).create_array("a", a, compress=False)
    meta = json.loads((tmp_path / "port" / "a" / "zarr.json").read_text())
    assert meta["chunk_grid"]["configuration"]["chunk_shape"] == [4096, 4096]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_rewriting_a_store_drops_stale_children_alike(tmp_path):
    for mod in (zarrlite, jax_zarrlite):
        path = tmp_path / mod.__name__.split(".")[0]
        root = mod.create_group(path)
        root.create_array("old", np.ones(3))
        root.create_group("old_group")
        root = mod.create_group(path)
        assert list(root.keys()) == []
        (tmp_path / f"{path.name}-plain").mkdir()
        (tmp_path / f"{path.name}-plain" / "file").write_text("x")
        with pytest.raises(FileExistsError):
            mod.create_group(tmp_path / f"{path.name}-plain")
