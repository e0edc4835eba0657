"""Minimal zarr-v3 array store (read and write) on numpy and the standard
library: the port's copy of ``ddr_tpu/io/zarrlite.py``.

It writes the on-disk zarr v3 core spec directly: ``zarr.json`` metadata
documents, a regular chunk grid under ``c/`` with the default ``/`` key
separator, the ``bytes`` (little-endian) codec, and the ``gzip`` codec via
the standard ``gzip`` module. For the same arrays and attributes its stores
are byte for byte the JAX package's, and each package reads the other's
(``tests/test_torch_zarrlite.py``).

Supported: numeric and bool dtypes, N-D regular chunking, group
hierarchies, JSON attributes, NaN/Inf fill values. Not supported: sharding,
v2 stores, variable-length strings, other chunk key encodings.
"""

from __future__ import annotations

import gzip
import json
import math
import shutil
from pathlib import Path
from typing import Any, Iterator

import numpy as np

__all__ = ["ZarrArray", "ZarrGroup", "create_group", "open_group", "open_array"]

_DTYPE_NAMES = {
    "bool": "?",
    "int8": "b",
    "int16": "<i2",
    "int32": "<i4",
    "int64": "<i8",
    "uint8": "B",
    "uint16": "<u2",
    "uint32": "<u4",
    "uint64": "<u8",
    "float16": "<f2",
    "float32": "<f4",
    "float64": "<f8",
}


def _dtype_to_name(dtype: np.dtype) -> str:
    name = np.dtype(dtype).name
    if name not in _DTYPE_NAMES:
        raise TypeError(f"zarrlite does not support dtype {dtype!r}")
    return name


def _encode_fill(value: Any, dtype: np.dtype) -> Any:
    if np.issubdtype(dtype, np.floating):
        f = float(value)
        if math.isnan(f):
            return "NaN"
        if math.isinf(f):
            return "Infinity" if f > 0 else "-Infinity"
        return f
    if np.issubdtype(dtype, np.bool_):
        return bool(value)
    return int(value)


def _decode_fill(value: Any, dtype: np.dtype) -> Any:
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


class _Attrs(dict):
    """Dict of group/array attributes that writes through to ``zarr.json``."""

    def __init__(self, node: "_Node", data: dict) -> None:
        super().__init__(data)
        self._node = node

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, value)
        self._node._flush_attrs()

    def __delitem__(self, key: str) -> None:
        super().__delitem__(key)
        self._node._flush_attrs()

    def update(self, *args, **kwargs) -> None:  # type: ignore[override]
        super().update(*args, **kwargs)
        self._node._flush_attrs()

    def pop(self, *args):  # type: ignore[override]
        out = super().pop(*args)
        self._node._flush_attrs()
        return out

    def popitem(self):  # type: ignore[override]
        out = super().popitem()
        self._node._flush_attrs()
        return out

    def setdefault(self, key: str, default: Any = None) -> Any:  # type: ignore[override]
        out = super().setdefault(key, default)
        self._node._flush_attrs()
        return out

    def clear(self) -> None:  # type: ignore[override]
        super().clear()
        self._node._flush_attrs()


class _Node:
    def __init__(self, path: Path, meta: dict) -> None:
        self.path = Path(path)
        self._meta = meta
        self.attrs = _Attrs(self, meta.get("attributes", {}))

    def _flush_attrs(self) -> None:
        self._meta["attributes"] = dict(self.attrs)
        (self.path / "zarr.json").write_text(json.dumps(self._meta, indent=2))


class ZarrArray(_Node):
    """A zarr v3 array node; reads lazily per chunk, writes whole arrays."""

    def __init__(self, path: Path, meta: dict) -> None:
        super().__init__(path, meta)
        self.shape = tuple(meta["shape"])
        self.dtype = np.dtype(_DTYPE_NAMES[meta["data_type"]])
        self.chunks = tuple(meta["chunk_grid"]["configuration"]["chunk_shape"])
        self.fill_value = _decode_fill(meta.get("fill_value", 0), self.dtype)
        key_enc = meta.get("chunk_key_encoding", {"name": "default"})
        sep = key_enc.get("configuration", {}).get("separator", "/")
        if key_enc.get("name") != "default" or sep != "/":
            # Refuse rather than silently resolve no chunk files and return fill.
            raise NotImplementedError(
                f"chunk_key_encoding {key_enc!r} not supported (default with '/' only)"
            )
        self._codecs = meta.get("codecs", [{"name": "bytes"}])
        self._endian = "<"
        for codec in self._codecs:
            if codec["name"] not in ("bytes", "gzip"):
                raise NotImplementedError(f"codec {codec['name']!r} not supported")
            if codec["name"] == "bytes":
                endian = codec.get("configuration", {}).get("endian", "little")
                if endian not in ("little", "big"):
                    raise NotImplementedError(
                        f"bytes codec endian {endian!r} not supported "
                        "('little' or 'big' only)"
                    )
                self._endian = {"little": "<", "big": ">"}[endian]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def _chunk_file(self, idx: tuple[int, ...]) -> Path:
        return self.path.joinpath("c", *map(str, idx)) if idx else self.path / "c"

    def _decode_chunk(self, raw: bytes) -> np.ndarray:
        for codec in reversed(self._codecs):
            if codec["name"] == "gzip":
                raw = gzip.decompress(raw)
        arr = np.frombuffer(raw, dtype=self.dtype.newbyteorder(self._endian))
        return arr.astype(self.dtype, copy=False).reshape(self.chunks)

    def _encode_chunk(self, chunk: np.ndarray) -> bytes:
        raw = np.ascontiguousarray(chunk, dtype=self.dtype.newbyteorder(self._endian)).tobytes()
        for codec in self._codecs:
            if codec["name"] == "gzip":
                raw = gzip.compress(raw, compresslevel=codec.get("configuration", {}).get("level", 5))
        return raw

    def read(self) -> np.ndarray:
        """Materialize the full array."""
        out = np.full(self.shape, self.fill_value, dtype=self.dtype)
        if not self.shape:
            f = self._chunk_file(())
            return self._decode_chunk(f.read_bytes()).reshape(()) if f.exists() else out
        grid = [range((s + c - 1) // c) for s, c in zip(self.shape, self.chunks)]
        for idx in np.ndindex(*[len(r) for r in grid]):
            f = self._chunk_file(idx)
            if not f.exists():
                continue
            chunk = self._decode_chunk(f.read_bytes())
            sel = tuple(
                slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, self.chunks, self.shape)
            )
            trim = tuple(slice(0, sl.stop - sl.start) for sl in sel)
            out[sel] = chunk[trim]
        return out

    def write(self, data: np.ndarray) -> None:
        data = np.asarray(data, dtype=self.dtype).reshape(self.shape)
        if not self.shape:
            self._chunk_file(()).write_bytes(self._encode_chunk(data.reshape(1)))
            return
        grid = [range((s + c - 1) // c) for s, c in zip(self.shape, self.chunks)]
        for idx in np.ndindex(*[len(r) for r in grid]):
            sel = tuple(
                slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, self.chunks, self.shape)
            )
            block = data[sel]
            if block.shape != self.chunks:  # pad edge chunks to full chunk shape
                full = np.full(self.chunks, self.fill_value, dtype=self.dtype)
                full[tuple(slice(0, b) for b in block.shape)] = block
                block = full
            f = self._chunk_file(idx)
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_bytes(self._encode_chunk(block))

    def __getitem__(self, key) -> np.ndarray:
        return self.read()[key]

    def __array__(self, dtype=None) -> np.ndarray:
        out = self.read()
        return out.astype(dtype) if dtype is not None else out


class ZarrGroup(_Node):
    """A zarr v3 group node with nested arrays/groups."""

    def create_array(
        self,
        name: str,
        data: np.ndarray | None = None,
        *,
        shape: tuple[int, ...] | None = None,
        dtype: Any = None,
        chunks: tuple[int, ...] | None = None,
        compress: bool = True,
        fill_value: Any = 0,
        attributes: dict | None = None,
    ) -> ZarrArray:
        if data is not None:
            data = np.asarray(data)
            shape = data.shape
            dtype = data.dtype if dtype is None else np.dtype(dtype)
        if shape is None or dtype is None:
            raise ValueError("either data or (shape, dtype) is required")
        dtype = np.dtype(dtype)
        if chunks is None:
            # One chunk per dim up to ~16M elements, else split the leading dim.
            # Chunk dims must be >= 1 even for zero-length arrays (zarr v3 spec).
            chunks = tuple(max(1, s) for s in shape) if shape else ()
            if shape and int(np.prod(shape)) > 1 << 24:
                lead = max(1, (1 << 24) // max(1, int(np.prod(shape[1:]))))
                chunks = (min(lead, max(1, shape[0])),) + tuple(max(1, s) for s in shape[1:])
        codecs: list[dict] = [{"name": "bytes", "configuration": {"endian": "little"}}]
        if compress:
            codecs.append({"name": "gzip", "configuration": {"level": 5}})
        meta = {
            "zarr_format": 3,
            "node_type": "array",
            "shape": list(shape),
            "data_type": _dtype_to_name(dtype),
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": list(chunks)}},
            "chunk_key_encoding": {"name": "default", "configuration": {"separator": "/"}},
            "fill_value": _encode_fill(fill_value, dtype),
            "codecs": codecs,
            "attributes": attributes or {},
        }
        apath = self.path / name
        apath.mkdir(parents=True, exist_ok=True)
        (apath / "zarr.json").write_text(json.dumps(meta, indent=2))
        arr = ZarrArray(apath, meta)
        if data is not None:
            arr.write(data)
        return arr

    def create_group(self, name: str, attributes: dict | None = None) -> "ZarrGroup":
        return create_group(self.path / name, attributes=attributes)

    def require_group(self, name: str) -> "ZarrGroup":
        sub = self.path / name
        if (sub / "zarr.json").exists():
            node = _open_node(sub)
            assert isinstance(node, ZarrGroup), f"{sub} is not a group"
            return node
        return self.create_group(name)

    def __getitem__(self, name: str) -> "ZarrArray | ZarrGroup":
        node = _open_node(self.path / name)
        if node is None:
            raise KeyError(name)
        return node

    def get(self, name: str, default: Any = None) -> Any:
        try:
            return self[name]
        except KeyError:
            return default

    def __contains__(self, name: str) -> bool:
        return (self.path / name / "zarr.json").exists()

    def keys(self) -> Iterator[str]:
        for child in sorted(self.path.iterdir()):
            if child.is_dir() and (child / "zarr.json").exists():
                yield child.name

    def arrays(self) -> Iterator[tuple[str, ZarrArray]]:
        for k in self.keys():
            node = self[k]
            if isinstance(node, ZarrArray):
                yield k, node

    def groups(self) -> Iterator[tuple[str, "ZarrGroup"]]:
        for k in self.keys():
            node = self[k]
            if isinstance(node, ZarrGroup):
                yield k, node


def _open_node(path: Path) -> "ZarrArray | ZarrGroup | None":
    meta_path = Path(path) / "zarr.json"
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    if meta.get("node_type") == "array":
        return ZarrArray(path, meta)
    return ZarrGroup(path, meta)


def create_group(path: str | Path, attributes: dict | None = None) -> ZarrGroup:
    """Create a FRESH group at ``path``.

    If a zarr node already exists there, its children are removed first — rebuilding a
    store in place must not leave stale arrays/subgroups resolvable (e.g. a dropped
    gauge subset surviving a preprocessing re-run). A non-empty directory that is
    *not* a zarr node is refused rather than wiped.
    """
    path = Path(path)
    if path.exists():
        if (path / "zarr.json").exists():
            for child in path.iterdir():
                if child == path / "zarr.json":
                    continue
                if child.is_dir():
                    shutil.rmtree(child)
                else:
                    child.unlink()
        elif any(path.iterdir()):
            raise FileExistsError(
                f"{path} exists, is non-empty, and is not a zarr store; refusing to overwrite"
            )
    path.mkdir(parents=True, exist_ok=True)
    meta = {"zarr_format": 3, "node_type": "group", "attributes": attributes or {}}
    (path / "zarr.json").write_text(json.dumps(meta, indent=2))
    return ZarrGroup(path, meta)


def open_group(path: str | Path) -> ZarrGroup:
    node = _open_node(Path(path))
    if node is None:
        raise FileNotFoundError(f"no zarr group at {path}")
    if not isinstance(node, ZarrGroup):
        raise TypeError(f"{path} is an array, not a group")
    return node


def open_array(path: str | Path) -> ZarrArray:
    node = _open_node(Path(path))
    if not isinstance(node, ZarrArray):
        raise TypeError(f"{path} is not a zarr array")
    return node
