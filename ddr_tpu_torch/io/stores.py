"""Hydrologic time-series and attribute stores on zarrlite: the port's copy
of ``ddr_tpu/io/stores.py``, with ``numpy.datetime64`` in place of pandas
timestamps.

Group layout
------------
- attrs: ``start_date`` ("YYYY/MM/DD"), ``freq`` ("D" daily | "h" hourly),
  ``ids`` (JSON list of divide/gage ids), optional ``id_dim`` name
  ("divide_id" / "gage_id") and per-variable ``units``;
- one array per data variable, shaped ``(n_ids, n_time)``: ``Qr`` for
  lateral inflow, ``streamflow`` for USGS observations (m^3/s).

An attribute store holds ``ids`` in its attrs and one ``(n_ids,)`` array per
attribute.

Paths open as local zarr v3 groups, or through an opener registered for a
``scheme://`` URI with :func:`register_store_backend`. The JAX package's
icechunk/S3 backend (``io/remote.py``) and its zarr v2 reader
(``io/zarr2.py``) are not in the port (ROADMAP A.8): an ``s3://`` URI with
no opener registered raises ``RuntimeError``, another unregistered scheme
``ValueError``, and a v2 group ``NotImplementedError``.
"""

from __future__ import annotations

from datetime import date, datetime
from pathlib import Path
from typing import Any, Callable, Iterator, Protocol, runtime_checkable

import numpy as np

from ddr_tpu_torch.io import zarrlite

__all__ = [
    "GroupLike",
    "read_array",
    "parse_timestamp",
    "HydroStore",
    "open_hydro_store",
    "write_hydro_store",
    "AttributeStore",
    "open_attribute_store",
    "write_attribute_store",
    "register_store_backend",
    "unregister_store_backend",
]

ORIGIN = np.datetime64("1980-01-01T00:00:00", "s")  # day 0 of the stores

#: The spellings of a timestamp :func:`parse_timestamp` reads.
_TIMESTAMP_FORMATS = (
    "%Y/%m/%d", "%Y-%m-%d", "%Y%m%d", "%Y/%m/%d %H:%M:%S", "%Y-%m-%d %H:%M:%S",
    "%Y-%m-%dT%H:%M:%S", "%Y/%m/%d %H:%M", "%Y-%m-%d %H:%M", "%Y-%m-%dT%H:%M",
)


def parse_timestamp(value: Any) -> np.datetime64:
    """A date or date-time as ``datetime64[s]``: the text forms the stores
    and configs spell (``1981/09/25``, ``1981-09-25``, ``19810925``, with an
    optional ``HH:MM[:SS]`` time), a ``datetime``/``date`` or a
    ``datetime64``."""
    if isinstance(value, np.datetime64):
        return value.astype("datetime64[s]")
    if isinstance(value, (datetime, date)):
        return np.datetime64(value, "s")
    text = str(value).strip()
    for fmt in _TIMESTAMP_FORMATS:
        try:
            return np.datetime64(datetime.strptime(text, fmt), "s")
        except ValueError:
            continue
    raise ValueError(f"cannot read {value!r} as a date (formats: {', '.join(_TIMESTAMP_FORMATS)})")


@runtime_checkable
class GroupLike(Protocol):
    """What the store facades require of a zarr-ish group: ``attrs`` (a
    mapping), ``__getitem__`` giving a sub-group or an array-like with
    ``.shape`` and ``.read()`` or ``__array__``, ``__contains__`` and
    ``keys``."""

    attrs: Any

    def __getitem__(self, name: str) -> Any: ...

    def __contains__(self, name: str) -> bool: ...

    def keys(self) -> Iterator[str]: ...


def _is_array(node: Any) -> bool:
    """Arrays have a shape; groups don't."""
    return hasattr(node, "shape")


def read_array(node: Any) -> np.ndarray:
    """Materialize an array-like: zarrlite's ``.read()`` or numpy's ``__array__``."""
    if hasattr(node, "read"):
        return node.read()
    return np.asarray(node)


_STORE_BACKENDS: dict[str, Callable[[str], GroupLike]] = {}


def register_store_backend(scheme: str, opener: Callable[[str], GroupLike]) -> None:
    """Register an opener for ``scheme://...`` URIs; it receives the full URI
    and returns a :class:`GroupLike`."""
    _STORE_BACKENDS[scheme.lower()] = opener


def unregister_store_backend(scheme: str) -> None:
    _STORE_BACKENDS.pop(scheme.lower(), None)


def _resolve_group(store: str | Path, kind: str) -> GroupLike:
    """Dispatch a path or URI to its backend; the local filesystem is the default."""
    uri = str(store)
    if "://" in uri:
        scheme = uri.split("://", 1)[0].lower()
        opener = _STORE_BACKENDS.get(scheme)
        if opener is not None:
            return opener(uri)
        if scheme == "s3":
            raise RuntimeError(
                f"{kind} {uri!r}: s3:// stores open through the JAX package's icechunk/S3 backend "
                "(io/remote.py), which is not ported yet (ROADMAP A.8); materialize the store "
                "locally, or register_store_backend('s3', opener)"
            )
        if scheme == "file":
            from urllib.parse import unquote, urlparse

            parsed = urlparse(uri)
            if parsed.netloc not in ("", "localhost"):
                raise ValueError(
                    f"file:// URIs with a remote host are not supported: {uri!r}"
                )
            return _open_local_group(unquote(parsed.path))
        raise ValueError(
            f"No backend registered for {scheme}:// {kind} {uri!r}. This environment "
            "has no egress; either materialize the store locally and point the "
            "config at the path, or register_store_backend"
            f"({scheme!r}, opener) with an icechunk/zarr opener."
        )
    return _open_local_group(uri)


def _open_local_group(path: str) -> GroupLike:
    """A local zarr v3 group; a zarr v2 group (``.zgroup``) is refused."""
    if (Path(path) / ".zgroup").exists():
        raise NotImplementedError(
            f"{path} is a zarr v2 store; the JAX package's v2 reader (io/zarr2.py) is not ported "
            "yet (ROADMAP A.8)"
        )
    return zarrlite.open_group(path)


class HydroStore:
    """Read facade over one time-series group: id lookup and time alignment."""

    def __init__(self, group: GroupLike) -> None:
        self.group = group
        self.start_date = parse_timestamp(group.attrs["start_date"])
        self.freq = group.attrs.get("freq", "D")
        self.ids: list = list(group.attrs["ids"])
        self.id_to_index = {i: k for k, i in enumerate(self.ids)}

    @property
    def is_hourly(self) -> bool:
        return self.freq in ("h", "H")

    @property
    def time_offset_days(self) -> int:
        """Whole days from the 1980/01/01 origin to the store's first record."""
        return int((self.start_date - ORIGIN) // np.timedelta64(1, "D"))

    def n_time(self, var: str = "Qr") -> int:
        return self[var].shape[1]

    def __getitem__(self, var: str):
        arr = self.group[var]
        if not _is_array(arr):
            raise KeyError(f"{var} is not an array variable")
        return arr

    def __contains__(self, var: str) -> bool:
        return var in self.group

    def select(self, var: str, id_rows: np.ndarray, time_cols: np.ndarray) -> np.ndarray:
        """Fancy-select ``(rows, cols)`` out of a variable. Reads the whole
        variable, then slices."""
        data = read_array(self[var])
        return data[np.asarray(id_rows)[:, None], np.asarray(time_cols)[None, :]]


def open_hydro_store(store: str | Path) -> HydroStore:
    """Open a hydro store from a local path or a registered ``scheme://`` URI."""
    return HydroStore(_resolve_group(store, "hydro store"))


def write_hydro_store(
    path: str | Path,
    ids: list,
    start_date: Any,
    freq: str,
    variables: dict[str, np.ndarray],
    id_dim: str = "divide_id",
    units: dict[str, str] | None = None,
) -> HydroStore:
    """Create a hydro store; each variable is ``(len(ids), n_time)`` and is
    stored as float32. ``start_date`` is written as ``YYYY/MM/DD``."""
    group = zarrlite.create_group(path)
    group.attrs.update(
        {
            "start_date": parse_timestamp(start_date).item().strftime("%Y/%m/%d"),
            "freq": freq,
            "ids": list(ids),
            "id_dim": id_dim,
            "units": units or {},
        }
    )
    for name, data in variables.items():
        data = np.asarray(data)
        if data.ndim != 2 or data.shape[0] != len(ids):
            raise ValueError(f"{name}: expected ({len(ids)}, T), got {data.shape}")
        group.create_array(name, data.astype(np.float32))
    return HydroStore(group)


class AttributeStore:
    """Static per-catchment attributes: ``ids`` in the group's attrs, one
    ``(n_ids,)`` array per attribute."""

    def __init__(self, group: GroupLike) -> None:
        self.group = group
        self.ids: list = list(group.attrs["ids"])
        self.id_to_index = {i: k for k, i in enumerate(self.ids)}

    @property
    def attribute_names(self) -> list[str]:
        return [k for k in self.group.keys() if _is_array(self.group[k])]

    def matrix(self, names: list[str]) -> np.ndarray:
        """The named attributes stacked into ``(len(names), n_ids)`` float32."""
        return np.stack(
            [np.asarray(read_array(self.group[n]), dtype=np.float32) for n in names], axis=0
        )

    def as_mapping(self) -> dict[str, np.ndarray]:
        """``{name: (n_ids,)}``, what the statistics read."""
        return {n: read_array(self.group[n]) for n in self.attribute_names}


def open_attribute_store(path: str | Path) -> AttributeStore:
    return AttributeStore(_resolve_group(path, "attribute store"))


def write_attribute_store(
    path: str | Path, ids: list, attributes: dict[str, np.ndarray]
) -> AttributeStore:
    """Create an attribute store; each attribute is ``(len(ids),)`` float32."""
    group = zarrlite.create_group(path)
    group.attrs.update({"ids": list(ids)})
    for name, data in attributes.items():
        data = np.asarray(data, dtype=np.float32)
        if data.shape != (len(ids),):
            raise ValueError(f"{name}: expected ({len(ids)},), got {data.shape}")
        group.create_array(name, data)
    return AttributeStore(group)
