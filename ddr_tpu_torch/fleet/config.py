"""Fleet-tier configuration: replica groups, ensemble and canary knobs.

The port's copy of ``ddr_tpu/fleet/config.py``: one frozen dataclass, every
knob overridable by a ``DDR_FLEET_*`` variable, built in the order defaults
< environment < explicit keywords, as
:class:`~ddr_tpu_torch.serving.config.ServeConfig`.

Three ``DDR_FLEET_*`` variables are identity, not knobs: ``DDR_FLEET_GROUP``
(the group label), ``DDR_FLEET_REPLICA`` (this replica's index) and
``DDR_FLEET_ROUTER`` (the front door's address). A subprocess
:class:`~ddr_tpu_torch.fleet.group.ReplicaGroup` stamps them into each
worker's environment, so the worker's boot log and ``/v1/stats`` name its
place in the group (:func:`fleet_identity`).
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["FLEET_MODES", "FleetConfig", "fleet_identity"]

#: How a replica group runs its members: ``inprocess`` builds N
#: :class:`~ddr_tpu_torch.serving.service.ForecastService` instances in this
#: process; ``subprocess`` launches N ``serve`` workers on distinct ports,
#: each killable on its own.
FLEET_MODES = ("inprocess", "subprocess")

_ENV_PREFIX = "DDR_FLEET_"


def fleet_identity(environ: dict | None = None) -> dict | None:
    """This process's place in a replica group, or None outside one:
    ``{"group", "replica", "router"}`` from the ``DDR_FLEET_GROUP`` /
    ``DDR_FLEET_REPLICA`` / ``DDR_FLEET_ROUTER`` variables. It rides the
    ``serve`` boot log and the ``fleet`` slice of ``/v1/stats``."""
    env = os.environ if environ is None else environ
    group = env.get("DDR_FLEET_GROUP")
    if not group:
        return None
    out: dict = {"group": group}
    replica = env.get("DDR_FLEET_REPLICA")
    if replica is not None:
        try:
            out["replica"] = int(replica)
        except ValueError:
            out["replica"] = replica
    router = env.get("DDR_FLEET_ROUTER")
    if router:
        out["router"] = router
    return out


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Replica-group, ensemble and canary knobs (env var in parentheses)."""

    #: Replica count of a booted group (DDR_FLEET_REPLICAS).
    replicas: int = 2
    #: Group label stamped on every replica's identity (DDR_FLEET_GROUP).
    group: str = "fleet"
    #: One of :data:`FLEET_MODES` (DDR_FLEET_MODE).
    mode: str = "inprocess"
    #: First subprocess replica port; replica ``i`` binds ``base_port + i``.
    #: 0 = a free ephemeral port per replica (DDR_FLEET_BASE_PORT).
    base_port: int = 0
    #: The router's health-probe cadence, seconds (DDR_FLEET_PROBE_MS, ms).
    probe_s: float = 1.0
    #: Consecutive failed probes or dispatch transport errors before a
    #: replica leaves rotation (DDR_FLEET_EJECT_AFTER). An ejected replica is
    #: still probed and rejoins on its first good probe.
    eject_after: int = 2
    #: Ceiling on an ensemble request's ``members``
    #: (DDR_FLEET_ENSEMBLE_MAX_MEMBERS).
    ensemble_max_members: int = 64
    #: Lognormal spread of the per-member forcing perturbation
    #: (DDR_FLEET_ENSEMBLE_SIGMA): member forcing = forcing *
    #: exp(sigma * N(0,1)), deterministic per (request id, seed, member).
    ensemble_sigma: float = 0.1
    #: The fraction of requests the candidate arm answers in the ``canary``
    #: state (DDR_FLEET_CANARY_WEIGHT).
    canary_weight: float = 0.1
    #: Per-arm skill observations before a promotion or rollback may fire
    #: (DDR_FLEET_CANARY_MIN_OBS).
    canary_min_obs: int = 4
    #: Median-NSE margin: the candidate advances while within it of the
    #: stable arm and rolls back when it falls further below
    #: (DDR_FLEET_CANARY_MARGIN).
    canary_margin: float = 0.05
    #: Per-arm scored (pred, obs) pairs before a forward canary transition
    #: (shadow -> canary, canary -> promoted) may fire; rollbacks are not
    #: gated (DDR_CANARY_MIN_SAMPLES, without the DDR_FLEET_ prefix: the
    #: floor belongs to verification, not to the group's topology).
    canary_min_samples: int = 8

    def __post_init__(self) -> None:
        if self.mode not in FLEET_MODES:
            raise ValueError(
                f"mode must be one of {FLEET_MODES}, got {self.mode!r}"
            )
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.eject_after < 1:
            raise ValueError(f"eject_after must be >= 1, got {self.eject_after}")
        if self.probe_s <= 0:
            raise ValueError(f"probe_s must be > 0, got {self.probe_s}")
        if self.ensemble_max_members < 1:
            raise ValueError(
                f"ensemble_max_members must be >= 1, got {self.ensemble_max_members}"
            )
        if self.ensemble_sigma < 0:
            raise ValueError(
                f"ensemble_sigma must be >= 0, got {self.ensemble_sigma}"
            )
        if not 0.0 < self.canary_weight <= 1.0:
            raise ValueError(
                f"canary_weight must be in (0, 1], got {self.canary_weight}"
            )
        if self.canary_min_obs < 1:
            raise ValueError(
                f"canary_min_obs must be >= 1, got {self.canary_min_obs}"
            )
        if self.canary_min_samples < 0:
            raise ValueError(
                f"canary_min_samples must be >= 0, got {self.canary_min_samples}"
            )

    @classmethod
    def from_env(cls, environ: dict | None = None, **overrides) -> "FleetConfig":
        """Defaults < ``DDR_FLEET_*`` environment < explicit ``overrides``."""
        env = os.environ if environ is None else environ
        from_env: dict = {}
        for key, var, cast, scale in (
            ("replicas", "REPLICAS", int, 1.0),
            ("group", "GROUP", str, 1.0),
            ("mode", "MODE", str, 1.0),
            ("base_port", "BASE_PORT", int, 1.0),
            ("probe_s", "PROBE_MS", float, 1e-3),
            ("eject_after", "EJECT_AFTER", int, 1.0),
            ("ensemble_max_members", "ENSEMBLE_MAX_MEMBERS", int, 1.0),
            ("ensemble_sigma", "ENSEMBLE_SIGMA", float, 1.0),
            ("canary_weight", "CANARY_WEIGHT", float, 1.0),
            ("canary_min_obs", "CANARY_MIN_OBS", int, 1.0),
            ("canary_margin", "CANARY_MARGIN", float, 1.0),
        ):
            raw = env.get(_ENV_PREFIX + var)
            if raw is None or raw == "":
                continue
            try:
                v = cast(raw)
            except ValueError as e:
                raise ValueError(f"bad {_ENV_PREFIX}{var}={raw!r}: {e}") from e
            from_env[key] = v * scale if scale != 1.0 else v
        raw = env.get("DDR_CANARY_MIN_SAMPLES")
        if raw not in (None, ""):
            try:
                from_env["canary_min_samples"] = int(raw)
            except ValueError as e:
                raise ValueError(f"bad DDR_CANARY_MIN_SAMPLES={raw!r}: {e}") from e
        from_env.update(overrides)
        return cls(**from_env)
