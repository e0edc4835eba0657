"""Serving-layer configuration: one frozen knob set, overridable from the
environment.

The port's copy of ``ddr_tpu/serving/config.py``. Every knob has a
``DDR_SERVE_*`` environment variable, so a deployment tunes backpressure
without touching the run config. Construction order: dataclass defaults <
environment < explicit keyword overrides (:meth:`ServeConfig.from_env`).
"""

from __future__ import annotations

import dataclasses
import os

__all__ = [
    "BACKPRESSURE_POLICIES",
    "DEFAULT_PRIORITY",
    "PRIORITIES",
    "ServeConfig",
    "priority_rank",
]

#: Request priority classes, highest first. ``interactive`` is the
#: user-facing tier (a person waits on the hydrograph), ``batch`` the default
#: work tier, ``bulk`` the best-effort backfill tier. Extraction is strict
#: priority, and shed victims are chosen lowest class first.
PRIORITIES = ("interactive", "batch", "bulk")

#: The class of requests that name none.
DEFAULT_PRIORITY = "batch"


def priority_rank(priority: str) -> int:
    """0 for the highest class; raises ``ValueError`` on an unknown name, so a
    caller's typo fails at admission and never inside the scheduler."""
    try:
        return PRIORITIES.index(priority)
    except ValueError:
        raise ValueError(f"unknown priority {priority!r}; expected one of {PRIORITIES}") from None


#: Accepted ``backpressure`` values: what happens when the queue is at
#: ``queue_cap`` and another request arrives.
#:
#: - ``reject-new``: the arrival fails at once (the default: the caller sees
#:   the rejection and backs off);
#: - ``shed-oldest``: the oldest queued request is failed and the arrival
#:   admitted (freshness wins);
#: - ``shed-by-deadline``: the queued request with the earliest deadline is
#:   failed (ties by oldest admission; requests without a deadline are never
#:   preferred victims). An arrival whose own deadline is the earliest is
#:   rejected instead.
BACKPRESSURE_POLICIES = ("reject-new", "shed-oldest", "shed-by-deadline")

_ENV_PREFIX = "DDR_SERVE_"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Forecast-service knobs (environment variable in parentheses).

    ``max_batch`` is also the batch slot: every executed batch is padded to
    exactly this many requests, so one (network, model) pair always runs the
    same shapes.
    """

    #: Coalesced requests per executed batch (DDR_SERVE_MAX_BATCH).
    max_batch: int = 8
    #: Bounded queue capacity; beyond it the backpressure policy applies
    #: (DDR_SERVE_QUEUE_CAP).
    queue_cap: int = 128
    #: How long the batcher holds the queue head open for co-batchable
    #: requests, seconds (DDR_SERVE_BATCH_WAIT_MS, milliseconds).
    batch_wait_s: float = 0.005
    #: Default per-request deadline from admission, seconds; expired requests
    #: are shed, never executed (DDR_SERVE_DEADLINE_MS, milliseconds).
    deadline_s: float = 30.0
    #: Queue-full policy, one of :data:`BACKPRESSURE_POLICIES`
    #: (DDR_SERVE_BACKPRESSURE).
    backpressure: str = "reject-new"
    #: Checkpoint-watch poll cadence, seconds (DDR_SERVE_RELOAD_POLL_MS,
    #: milliseconds). 0 disables watching.
    reload_poll_s: float = 2.0
    #: HTTP bind address (DDR_SERVE_HOST).
    host: str = "127.0.0.1"
    #: HTTP port; 0 = ephemeral, the bound port is logged (DDR_SERVE_PORT).
    port: int = 8080
    #: Forecast horizon in hourly steps for networks registered without one
    #: (DDR_SERVE_HORIZON_HOURS).
    horizon_hours: int = 72
    #: Ceiling on a ``POST /v1/profile?seconds=N`` capture, seconds
    #: (DDR_SERVE_PROFILE_MAX_SECONDS). A profiler holds what it records in
    #: memory until it stops, so the API answers 400 past this.
    profile_max_seconds: float = 60.0

    def __post_init__(self) -> None:
        if self.backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"backpressure must be one of {BACKPRESSURE_POLICIES}, got {self.backpressure!r}"
            )
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {self.queue_cap}")
        if self.horizon_hours < 1:
            raise ValueError(f"horizon_hours must be >= 1, got {self.horizon_hours}")
        if self.profile_max_seconds <= 0:
            raise ValueError(f"profile_max_seconds must be > 0, got {self.profile_max_seconds}")

    @classmethod
    def from_env(cls, environ: dict | None = None, **overrides) -> "ServeConfig":
        """Defaults < ``DDR_SERVE_*`` environment < explicit ``overrides``."""
        env = os.environ if environ is None else environ

        def _get(name: str, cast, scale: float = 1.0):
            raw = env.get(_ENV_PREFIX + name)
            if raw is None or raw == "":
                return None
            try:
                v = cast(raw)
            except ValueError as e:
                raise ValueError(f"bad {_ENV_PREFIX}{name}={raw!r}: {e}") from e
            return v * scale if scale != 1.0 else v

        from_env: dict = {}
        for key, var, cast, scale in (
            ("max_batch", "MAX_BATCH", int, 1.0),
            ("queue_cap", "QUEUE_CAP", int, 1.0),
            ("batch_wait_s", "BATCH_WAIT_MS", float, 1e-3),
            ("deadline_s", "DEADLINE_MS", float, 1e-3),
            ("backpressure", "BACKPRESSURE", str, 1.0),
            ("reload_poll_s", "RELOAD_POLL_MS", float, 1e-3),
            ("host", "HOST", str, 1.0),
            ("port", "PORT", int, 1.0),
            ("horizon_hours", "HORIZON_HOURS", int, 1.0),
            ("profile_max_seconds", "PROFILE_MAX_SECONDS", float, 1.0),
        ):
            v = _get(var, cast, scale)
            if v is not None:
                from_env[key] = v
        from_env.update(overrides)
        return cls(**from_env)
