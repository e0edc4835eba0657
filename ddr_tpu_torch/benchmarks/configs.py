"""Benchmark configuration: the port of ``ddr_tpu/benchmarks/configs.py`` on
the port's standard-library validation (:mod:`ddr_tpu_torch.validation.configs`).

:class:`BenchmarkConfig` wraps the core :class:`Config` under ``ddr`` and
adds the LTI comparator's section (``lti``, or its older name
``diffroute``) and the optional ΣQ' store path. Reading that store is not
ported yet (ROADMAP A.8), so a config that names one raises.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

from ddr_tpu_torch.benchmarks.irf import IRF_FAMILIES
from ddr_tpu_torch.validation.configs import (
    BENCHMARK_SECTION_KEYS,
    Config,
    _required,
    _Section,
    _set_seed,
)

__all__ = ["BenchmarkConfig", "LTIRouteConfig", "validate_benchmark_config"]


@dataclasses.dataclass
class LTIRouteConfig(_Section):
    """The linear-IRF comparator: ``irf_fn`` one of :data:`IRF_FAMILIES`,
    kernels ``max_delay`` steps long at ``dt`` days, travel time ``k`` days
    (None: 0.1042, RAPID's 9000 s), weighting ``x`` in [0, 0.5), ``nash_n``
    reservoirs for ``nash_cascade``, and the FFT's zero-pad ``pad_steps``
    (None: scaled with network depth)."""

    enabled: bool = True
    irf_fn: str = "muskingum"
    max_delay: int = 100
    dt: float = 1.0 / 24.0
    k: float | None = None
    x: float = 0.3
    nash_n: int = 3
    pad_steps: int | None = None

    def _check(self, where: str) -> None:
        if self.irf_fn not in IRF_FAMILIES:
            raise ValueError(f"{where}.irf_fn: {self.irf_fn!r} not in {IRF_FAMILIES}")
        if not 0.0 <= self.x < 0.5:
            raise ValueError(f"{where}.x: input should be >= 0 and < 0.5, got {self.x}")
        if self.nash_n < 1:
            raise ValueError(f"{where}.nash_n: input should be >= 1, got {self.nash_n}")


@dataclasses.dataclass
class BenchmarkConfig(_Section):
    """The core config and the comparator's sections."""

    ddr: Config = _required()
    lti: LTIRouteConfig = dataclasses.field(default_factory=LTIRouteConfig)
    summed_q_prime: Path | None = None

    def _check(self, where: str) -> None:
        if self.summed_q_prime is not None:
            raise NotImplementedError(
                f"summed_q_prime={str(self.summed_q_prime)!r}: reading a ΣQ' store is not ported "
                "yet (ROADMAP A.8); leave summed_q_prime unset"
            )


def validate_benchmark_config(raw: dict[str, Any]) -> BenchmarkConfig:
    """A flat mapping (or one holding only ``ddr``) -> :class:`BenchmarkConfig`:
    the ``lti`` (or ``diffroute``) and ``summed_q_prime`` keys, the sections
    the core loader ignores, are split out, everything else is the core
    config. Seeds the global generators as :func:`load_config` does."""
    raw = dict(raw)
    lti = raw.pop("lti", raw.pop("diffroute", {}))
    summed_q_prime = raw.pop("summed_q_prime", None)
    assert not set(raw) & set(BENCHMARK_SECTION_KEYS), "unsplit benchmark section"
    ddr = raw["ddr"] if set(raw) == {"ddr"} else raw
    cfg = BenchmarkConfig.from_dict({"ddr": ddr, "lti": lti or {}, "summed_q_prime": summed_q_prime})
    _set_seed(cfg.ddr)
    return cfg
