"""The configuration tree and its loader: the port's copy of
``ddr_tpu/validation/configs.py``, on dataclasses and the standard library.

Section and field names, defaults, coercions and errors follow the JAX
package's pydantic models, so one YAML file validates to the same values in
both (``tests/test_torch_config.py`` holds the two side by side). Each
section is a dataclass; :meth:`_Section.from_dict` validates a mapping the
way pydantic's lax mode does: unknown keys raise, numbers and numeric
strings coerce to ``int``/``float`` (``int`` only without a fractional part),
the usual words to ``bool``, strings to ``Path``, and a ``str`` field takes
only a string. Every error is a ``ValueError``.

:func:`load_config` reads YAML with the port's own reader
(:mod:`ddr_tpu_torch.validation.yaml_subset`), resolves ``include:`` lists,
applies ``a.b=c`` overrides and ``${...}`` interpolation, validates, seeds
numpy and ``random``, and saves the validated config as
``pydantic_config.yaml`` in JSON, which is a YAML document the JAX package
reads back.

The port's deltas: ``device`` is ``"cuda"`` (the default, any ``cuda:i``)
or ``"cpu"``; ``"tpu"`` raises. Options of the JAX package that the port
does not have yet raise ``NotImplementedError`` naming their ROADMAP item:
``kan.adaptive_grid`` (A.5) and ``experiment.parallel`` other than
``"none"`` (A.13).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import math
import os
import random
import re
import types
import typing
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np

from ddr_tpu_torch.validation import yaml_subset
from ddr_tpu_torch.validation.enums import GeoDataset, Mode

log = logging.getLogger(__name__)

__all__ = [
    "BENCHMARK_SECTION_KEYS",
    "Config",
    "DataSources",
    "ExperimentConfig",
    "Kan",
    "KanConfig",
    "Params",
    "load_config",
    "load_raw_config",
    "validate_config",
]

#: YAML sections owned by the benchmark harness, which the core config ignores.
BENCHMARK_SECTION_KEYS = ("lti", "diffroute", "summed_q_prime")
#: The JAX package's ``experiment.parallel`` modes; only ``"none"`` is ported.
PARALLEL_MODES = ("none", "auto", "gspmd", "sharded-wavefront", "stacked-sharded")

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _required(**kw: Any) -> Any:
    """A field the mapping must name (pydantic's field without a default). It
    still defaults to None for direct construction in code."""
    return dataclasses.field(default=None, metadata={"required": True}, **kw)


def _coerce(value: Any, tp: Any, where: str, strip: bool = False) -> Any:
    """``value`` as type ``tp``, coerced as pydantic's lax mode does."""
    origin = typing.get_origin(tp)
    if tp is Any:
        return value
    if origin in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0], where, strip)
    if value is None:
        raise ValueError(f"{where}: a value is required, got None")
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.strip().lower() in _TRUE | _FALSE:
            return value.strip().lower() in _TRUE
        raise ValueError(f"{where}: input should be a valid boolean, got {value!r}")
    if tp is int:
        if isinstance(value, bool):
            return int(value)
        num = value
        if isinstance(value, str):
            try:
                num = float(value.strip()) if not re.fullmatch(r"\s*[-+]?\d+\s*", value) else int(value)
            except ValueError:
                raise ValueError(f"{where}: input should be a valid integer, got {value!r}") from None
        if isinstance(num, int):
            return num
        if isinstance(num, float) and math.isfinite(num) and num == int(num):
            return int(num)
        raise ValueError(f"{where}: input should be a valid integer, got {value!r}")
    if tp is float:
        if isinstance(value, (bool, int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value.strip())
            except ValueError:
                pass
        raise ValueError(f"{where}: input should be a valid number, got {value!r}")
    if tp is str:
        if not isinstance(value, str):
            raise ValueError(f"{where}: input should be a valid string, got {value!r}")
        return value.strip() if strip else value
    if tp is Path:
        if isinstance(value, (str, Path)):
            return Path(value)
        raise ValueError(f"{where}: input is not a valid path, got {value!r}")
    if origin is list:
        if not isinstance(value, (list, tuple)):
            raise ValueError(f"{where}: input should be a valid list, got {value!r}")
        (item,) = typing.get_args(tp)
        return [_coerce(v, item, f"{where}.{i}") for i, v in enumerate(value)]
    if origin is dict:
        if not isinstance(value, dict):
            raise ValueError(f"{where}: input should be a valid dictionary, got {value!r}")
        kt, vt = typing.get_args(tp)
        return {_coerce(k, kt, f"{where}.{k}.[key]"): _coerce(v, vt, f"{where}.{k}") for k, v in value.items()}
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        try:
            return tp(value)
        except ValueError:
            allowed = ", ".join(repr(m.value) for m in tp)
            raise ValueError(f"{where}: input should be one of {allowed}, got {value!r}") from None
    if isinstance(tp, type) and issubclass(tp, _Section):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise ValueError(f"{where}: input should be a valid dictionary, got {value!r}")
        return tp.from_dict(value, where)
    raise TypeError(f"{where}: no coercion for {tp!r}")


def _plain(value: Any) -> Any:
    """JSON-plain form of a validated value (pydantic's ``model_dump(mode="json")``)."""
    if isinstance(value, _Section):
        return value.model_dump()
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


class _Section:
    """Validation shared by every config section (a dataclass)."""

    _strip_strings = False

    @classmethod
    def from_dict(cls, raw: dict, where: str = "") -> Any:
        """Validate a mapping: unknown keys and missing required fields raise,
        every value is coerced to its field's type, then :meth:`_check` runs."""
        hints = typing.get_type_hints(cls)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - set(fields), key=str)
        if unknown:
            raise ValueError(f"{where or cls.__name__}: extra inputs are not permitted: {unknown}")
        kwargs = {}
        for name, f in fields.items():
            loc = f"{where}.{name}" if where else name
            if name in raw:
                value = cls._before(name, raw[name])
                kwargs[name] = _coerce(value, hints[name], loc, cls._strip_strings)
            elif f.metadata.get("required"):
                raise ValueError(f"{loc}: field required")
        obj = cls(**kwargs)
        obj._check(where or cls.__name__)
        return obj

    @classmethod
    def _before(cls, name: str, value: Any) -> Any:
        return value

    def _check(self, where: str) -> None:
        pass

    def model_dump(self) -> dict:
        return {f.name: _plain(getattr(self, f.name)) for f in dataclasses.fields(self)}

    def model_dump_json(self, indent: int | None = None) -> str:
        return json.dumps(self.model_dump(), indent=indent)


@dataclasses.dataclass
class DataSources(_Section):
    """Data source paths, read by the store-backed datasets (``merit``)."""

    attributes: str | None = None
    geospatial_fabric_gpkg: Path | None = None
    conus_adjacency: Path | None = None
    statistics: Path = Path("./data/")
    streamflow: str | None = None
    is_hourly: bool = False
    observations: str | None = None
    gages: str | None = None
    gages_adjacency: str | None = None
    target_catchments: list[str] | None = None


@dataclasses.dataclass
class Params(_Section):
    """Physical parameter config."""

    attribute_minimums: dict[str, float] = dataclasses.field(
        default_factory=lambda: {
            "discharge": 0.0001,
            "slope": 0.001,
            "velocity": 0.01,
            "depth": 0.01,
            "bottom_width": 0.01,
        }
    )
    parameter_ranges: dict[str, list[float]] = dataclasses.field(
        default_factory=lambda: {
            "n": [0.015, 0.25],
            "q_spatial": [0.0, 1.0],
            "p_spatial": [1.0, 200.0],
        }
    )
    log_space_parameters: list[str] = dataclasses.field(default_factory=lambda: ["p_spatial"])
    defaults: dict[str, float] = dataclasses.field(default_factory=lambda: {"p_spatial": 21.0})
    tau: int = 3  # routing timestep offset of the daily trim
    save_path: Path = Path("./")


@dataclasses.dataclass
class Kan(_Section):
    """KAN architecture config."""

    hidden_size: int = 11
    input_var_names: list[str] = _required()
    num_hidden_layers: int = 1
    learnable_parameters: list[str] = dataclasses.field(default_factory=lambda: ["n", "q_spatial"])
    grid: int = 3
    k: int = 3
    grid_range: list[float] = dataclasses.field(default_factory=lambda: [-2.0, 2.0])
    adaptive_grid: bool = False
    grid_update_epochs: list[int] = dataclasses.field(default_factory=list)

    def _check(self, where: str) -> None:
        v = self.grid_range
        if len(v) != 2 or not all(math.isfinite(b) for b in v) or not v[0] < v[1]:
            raise ValueError(f"{where}.grid_range: must be finite [lo, hi] with lo < hi, got {v}")
        if self.grid_update_epochs and not self.adaptive_grid:
            raise ValueError(
                "kan.grid_update_epochs requires kan.adaptive_grid=true "
                "(static grids have no refittable knots)"
            )
        if self.adaptive_grid:
            raise NotImplementedError(
                "kan.adaptive_grid=true (refittable per-feature knots) is not ported yet "
                "(ROADMAP A.5); the port's KAN has static grids"
            )


#: The name the serving and train-step slices used for :class:`Kan`.
KanConfig = Kan


@dataclasses.dataclass
class ExperimentConfig(_Section):
    """Training and testing experiment config."""

    batch_size: int = 1
    start_time: str = "1981/10/01"
    end_time: str = "1995/09/30"
    checkpoint: Path | None = None
    epochs: int = 1
    learning_rate: dict[int, float] = dataclasses.field(
        default_factory=lambda: {1: 0.005, 3: 0.001}
    )  # epoch -> learning rate, the latest at or before an epoch applies
    rho: int | None = None  # days per random training window
    shuffle: bool = True
    warmup: int = 3  # days excluded from the loss while routing spins up
    max_area_diff_sqkm: float | None = 50.0
    parallel: str = "none"
    remat_bands: bool = False
    adjoint: str = "auto"
    prefetch_ahead: int = 1  # batches the host-side prefetch pool prepares ahead
    test_start_time: str | None = None
    test_end_time: str | None = None

    @classmethod
    def _before(cls, name: str, value: Any) -> Any:
        if name == "learning_rate" and isinstance(value, dict):
            return {int(k): float(v) for k, v in value.items()}
        return value

    def _check(self, where: str) -> None:
        if self.parallel not in PARALLEL_MODES:
            raise ValueError(f"experiment.parallel must be one of {PARALLEL_MODES}, got {self.parallel!r}")
        if self.adjoint not in ("auto", "analytic", "ad"):
            raise ValueError(
                f"experiment.adjoint must be 'auto', 'analytic' or 'ad', got {self.adjoint!r}"
            )
        if self.prefetch_ahead < 1:
            raise ValueError(f"{where}.prefetch_ahead: input should be >= 1, got {self.prefetch_ahead}")
        if self.parallel != "none":
            raise NotImplementedError(
                f"experiment.parallel={self.parallel!r} (multi-device training) is not ported yet "
                "(ROADMAP A.13); use experiment.parallel=none"
            )


@dataclasses.dataclass
class Config(_Section):
    """Top-level config. ``name``, ``geodataset``, ``mode`` and ``kan`` must be
    named in a mapping; in code, :class:`Config` can be built from a ``kan``
    section alone (the serving and train-step paths read no other)."""

    _strip_strings = True

    name: str | None = _required()
    data_sources: DataSources = dataclasses.field(default_factory=DataSources)
    experiment: ExperimentConfig = dataclasses.field(default_factory=ExperimentConfig)
    geodataset: GeoDataset | None = _required()
    mode: Mode | None = _required()
    params: Params = dataclasses.field(default_factory=Params)
    kan: Kan = _required()
    np_seed: int = 1
    seed: int = 0
    device: str = "cuda"  # "cuda" (any "cuda:i") or "cpu"
    s3_region: str = "us-east-2"
    synthetic_segments: int | None = None  # synthetic geodataset: reaches (default 64)
    synthetic_depth: int | None = None  # synthetic geodataset: exact longest-path depth
    run_dir: str | None = None  # run-directory root: <run_dir>/<name>/<timestamp>/

    def _check(self, where: str) -> None:
        for name in ("synthetic_segments", "synthetic_depth"):
            value = getattr(self, name)
            if value is not None and value < 1:
                raise ValueError(f"{name}: input should be >= 1, got {value}")
        dev = self.device.split(":")
        if dev[0] == "tpu":
            raise ValueError(
                "device='tpu' is the JAX package's; the port runs on 'cuda' (the default) or 'cpu'"
            )
        if dev[0] == "cpu" and len(dev) > 1:
            raise NotImplementedError(
                f"device={self.device!r} asks for a virtual multi-device mesh, which the port does "
                "not have yet (ROADMAP A.13); use 'cpu' or 'cuda'"
            )
        if dev[0] not in ("cuda", "cpu") or (len(dev) > 1 and not dev[1].isdigit()) or len(dev) > 2:
            raise ValueError(f"device must be 'cuda', 'cuda:<i>' or 'cpu', got {self.device!r}")


def _set_seed(cfg: Config) -> None:
    """Seed numpy's and Python's global generators, as the JAX package does
    (the port's KAN and loader draw from explicit generators)."""
    np.random.seed(cfg.np_seed)
    random.seed(cfg.seed)


def _apply_override(d: dict, dotted: str, value: str) -> None:
    keys = dotted.split(".")
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = yaml_subset.safe_load(value)


_INTERP = re.compile(r"\$\{([^${}]+)\}")


def _resolve_expr(expr: str, raw: dict, stack: tuple) -> Any:
    """Resolve one ``${...}`` expression: ``${oc.env:VAR,default}`` /
    ``${oc.env:VAR}``, ``${now:%fmt}``, or a dotted config reference."""
    if expr.startswith("oc.env:"):
        var, sep, default = expr[len("oc.env:"):].partition(",")
        val = os.environ.get(var.strip())
        if val is not None:
            return val
        if not sep:
            raise ValueError(f"environment variable {var!r} is not set and ${{{expr}}} has no default")
        return default
    if expr.startswith("now:"):
        return datetime.now().strftime(expr[len("now:"):])
    if expr in stack:
        raise ValueError(f"circular config interpolation through ${{{expr}}}")
    cur: Any = raw
    for part in expr.split("."):
        if not isinstance(cur, dict) or part not in cur:
            raise ValueError(f"config interpolation ${{{expr}}} does not resolve")
        cur = cur[part]
    return _interpolate(cur, raw, stack + (expr,))


def _interpolate(node: Any, raw: dict, stack: tuple = ()) -> Any:
    """Resolve ``${...}`` in the strings of a config tree. A string that IS
    one expression keeps the resolved value's type; mixed strings concatenate
    the resolved pieces as text."""
    if isinstance(node, dict):
        return {k: _interpolate(v, raw, stack) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, raw, stack) for v in node]
    if not isinstance(node, str) or "${" not in node:
        return node
    full = _INTERP.fullmatch(node)
    if full:
        return _resolve_expr(full.group(1), raw, stack)
    return _INTERP.sub(lambda m: str(_resolve_expr(m.group(1), raw, stack)), node)


def _deep_merge(base: dict, over: dict) -> dict:
    """Nested-dict merge, ``over`` winning."""
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml_with_includes(path: Path, _stack: tuple = ()) -> dict:
    """Read one YAML file after its ``include:`` list: includes merge in
    order, later winning, and the file's own keys win over all of them. Paths
    are relative to the including file; cycles raise."""
    path = Path(path).resolve()
    if path in _stack:
        chain = " -> ".join(str(p) for p in (*_stack, path))
        raise ValueError(f"circular config include: {chain}")
    raw = yaml_subset.safe_load(path.read_text()) or {}
    includes = raw.pop("include", None) or []
    if isinstance(includes, (str, Path)):
        includes = [includes]
    merged: dict = {}
    for inc in includes:
        inc_path = Path(inc)
        if not inc_path.is_absolute():
            inc_path = path.parent / inc_path
        merged = _deep_merge(merged, _load_yaml_with_includes(inc_path, _stack + (path,)))
    return _deep_merge(merged, raw)


def load_raw_config(
    path: str | Path | None = None,
    overrides: list[str] | None = None,
    base: dict | None = None,
) -> dict:
    """``path`` + ``overrides`` -> the interpolated mapping :func:`load_config`
    validates. Benchmark-only sections are dropped before the overrides (so an
    override into one still fails validation), a file holding only a
    ``ddr:`` section is unwrapped, and interpolation runs last."""
    raw: dict = dict(base or {})
    if path is not None:
        raw = _deep_merge(raw, _load_yaml_with_includes(Path(path)))
    for benchmark_key in BENCHMARK_SECTION_KEYS:
        raw.pop(benchmark_key, None)
    if isinstance(raw.get("ddr"), dict) and set(raw) == {"ddr"}:
        raw = raw["ddr"]
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like key.subkey=value")
        k, v = ov.split("=", 1)
        _apply_override(raw, k, v)
    return _interpolate(raw, raw)


def load_config(
    path: str | Path | None = None,
    overrides: list[str] | None = None,
    base: dict | None = None,
    save_config: bool = True,
) -> Config:
    """Load and validate a config from YAML with ``a.b=c`` overrides.

    A top-level ``include: [base.yaml, ...]`` list composes files: includes
    merge first, the file's own keys override them, overrides override
    everything. With ``run_dir`` set, ``params.save_path`` becomes a fresh
    ``<run_dir>/<name>/<YYYY-MM-DD_HH-MM-SS>/``. With ``save_config`` and an
    existing ``params.save_path``, the validated config is written there as
    ``pydantic_config.yaml`` (JSON, which YAML readers read)."""
    cfg = validate_config(load_raw_config(path, overrides, base))
    if cfg.run_dir is not None:
        run_path = Path(cfg.run_dir) / cfg.name / datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        run_path.mkdir(parents=True, exist_ok=True)
        cfg.params.save_path = run_path
    if save_config:
        save_dir = Path(cfg.params.save_path)
        if save_dir.is_dir():
            (save_dir / "pydantic_config.yaml").write_text(cfg.model_dump_json(indent=2) + "\n")
    return cfg


def validate_config(cfg: dict | Config) -> Config:
    """Validate an already-parsed mapping (a :class:`Config` passes as it is)
    and seed the global generators."""
    config = cfg if isinstance(cfg, Config) else Config.from_dict(cfg)
    _set_seed(config)
    return config
