"""Fleet-tier configuration: the ensemble knobs.

The port's copy of the ensemble half of ``ddr_tpu/fleet/config.py``: one
frozen dataclass, every knob overridable by a ``DDR_FLEET_*`` variable,
built in the order defaults < environment < explicit keywords, as
:class:`~ddr_tpu_torch.serving.config.ServeConfig`. The replica, router and
canary knobs come with ``ddr fleet`` (ROADMAP A.9).
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["FleetConfig"]

_ENV_PREFIX = "DDR_FLEET_"


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Ensemble knobs (env var in parentheses)."""

    #: Ceiling on an ensemble request's ``members``
    #: (DDR_FLEET_ENSEMBLE_MAX_MEMBERS).
    ensemble_max_members: int = 64
    #: Lognormal spread of the per-member forcing perturbation
    #: (DDR_FLEET_ENSEMBLE_SIGMA): member forcing = forcing *
    #: exp(sigma * N(0,1)), deterministic per (request id, seed, member).
    ensemble_sigma: float = 0.1

    def __post_init__(self) -> None:
        if self.ensemble_max_members < 1:
            raise ValueError(
                f"ensemble_max_members must be >= 1, got {self.ensemble_max_members}"
            )
        if self.ensemble_sigma < 0:
            raise ValueError(
                f"ensemble_sigma must be >= 0, got {self.ensemble_sigma}"
            )

    @classmethod
    def from_env(cls, environ: dict | None = None, **overrides) -> "FleetConfig":
        """Defaults < ``DDR_FLEET_*`` environment < explicit ``overrides``."""
        env = os.environ if environ is None else environ
        from_env: dict = {}
        for key, var, cast in (
            ("ensemble_max_members", "ENSEMBLE_MAX_MEMBERS", int),
            ("ensemble_sigma", "ENSEMBLE_SIGMA", float),
        ):
            raw = env.get(_ENV_PREFIX + var)
            if raw is None or raw == "":
                continue
            try:
                from_env[key] = cast(raw)
            except ValueError as e:
                raise ValueError(f"bad {_ENV_PREFIX}{var}={raw!r}: {e}") from e
        from_env.update(overrides)
        return cls(**from_env)
