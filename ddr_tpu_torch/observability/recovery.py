"""Self-healing training: the recovery supervisor's escalation ladder.

The port of ``ddr_tpu/observability/recovery.py`` (without its
``ForcingValidator``, which waits for the ``ddr train`` data path). The
health watchdog (:mod:`ddr_tpu_torch.observability.health`) detects a NaN
solve, a bf16 overflow or drift, an exploding gradient; this module turns
each violation into one bounded, deterministic action from a ladder walked
downwards:

1. ``fp32-reroute``: re-run the batch from the pre-step snapshot with the
   ``dtype="fp32"`` twin step, when every reason is bf16-specific
   (``bf16-overflow``, ``ulp-drift``) and the loop has the twin;
2. ``skip``: restore the pre-step snapshot and move on, remembering the
   batch's identity;
3. ``rollback``: restore the last pinned-good checkpoint;
4. ``give-up``: an emergency save and :class:`RecoveryGiveUp`, once every
   ``DDR_RECOVERY_MAX_*`` budget is spent.

The supervisor is host-side bookkeeping only: every decision is a function
of the reasons and the remaining budgets, so a run replays the same
recoveries. Its decisions are logged; the JAX package's ``recovery`` event of
the run recorder is not ported yet.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from typing import Any

log = logging.getLogger(__name__)

__all__ = [
    "RECOVERY_STAGES",
    "REROUTE_REASONS",
    "RecoveryConfig",
    "RecoveryGiveUp",
    "RecoverySupervisor",
]

_FALSEY = ("", "0", "false", "no", "off")

#: The escalation ladder, in order. ``decide`` only ever walks DOWN this list.
RECOVERY_STAGES = ("fp32-reroute", "skip", "rollback", "give-up")

#: Violation reasons that are artifacts of the bf16 history ring rather than
#: of the state itself: the only class that an fp32 re-run can clear.
REROUTE_REASONS = ("bf16-overflow", "ulp-drift")


class RecoveryGiveUp(RuntimeError):
    """Raised by a train loop once the supervisor's budgets are exhausted,
    after its emergency save: a deliberate, state-preserving stop, told
    apart from a crash by its type."""


@dataclass(frozen=True)
class RecoveryConfig:
    """Budgets for the escalation ladder. Defaults < ``DDR_RECOVERY_*``
    environment < explicit overrides."""

    #: Master switch (DDR_RECOVERY_ENABLED; default off: the loop then
    #: snapshots the parameters and optimizer state before every step).
    enabled: bool = False
    #: Per-run quarantined-batch budget (DDR_RECOVERY_MAX_SKIPS).
    max_skips: int = 4
    #: Per-run fp32 re-execution budget (DDR_RECOVERY_MAX_REROUTES).
    max_reroutes: int = 2
    #: Per-run pinned-good rollback budget (DDR_RECOVERY_MAX_ROLLBACKS).
    max_rollbacks: int = 1
    #: Learning-rate multiplier on each rollback (DDR_RECOVERY_LR_BACKOFF).
    lr_backoff: float = 0.5

    def __post_init__(self) -> None:
        for name in ("max_skips", "max_reroutes", "max_rollbacks"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError(f"lr_backoff must be in (0, 1], got {self.lr_backoff}")

    @classmethod
    def from_env(cls, environ: dict | None = None, **overrides) -> "RecoveryConfig":
        env = os.environ if environ is None else environ

        def get(name: str, cast):
            raw = env.get(name)
            if raw is None or raw == "":
                return None
            try:
                return cast(raw)
            except ValueError as e:
                raise ValueError(f"bad {name}={raw!r}: {e}") from e

        from_env: dict = {}
        for key, var, cast in (
            ("enabled", "DDR_RECOVERY_ENABLED", lambda s: s.strip().lower() not in _FALSEY),
            ("max_skips", "DDR_RECOVERY_MAX_SKIPS", int),
            ("max_reroutes", "DDR_RECOVERY_MAX_REROUTES", int),
            ("max_rollbacks", "DDR_RECOVERY_MAX_ROLLBACKS", int),
            ("lr_backoff", "DDR_RECOVERY_LR_BACKOFF", float),
        ):
            v = get(var, cast)
            if v is not None:
                from_env[key] = v
        from_env.update(overrides)
        return cls(**from_env)


class RecoverySupervisor:
    """The escalation-ladder state machine a train loop consults.

    Two phases, so that the loop can escalate when a stage fails:
    :meth:`decide` is a pure read of (reasons, budgets) -> stage;
    :meth:`record` commits the stage the loop executed: spends its budget,
    remembers a skipped batch's identity, logs. A failed fp32 re-run
    therefore calls ``decide`` again with ``fp32_available=False``."""

    #: Quarantined-batch identities kept for the summary (bounded).
    MAX_QUARANTINE = 64

    def __init__(self, config: RecoveryConfig | None = None) -> None:
        self.config = config or RecoveryConfig.from_env()
        self._lock = threading.Lock()
        self._counts = {stage: 0 for stage in RECOVERY_STAGES}
        self._quarantined: list[dict[str, Any]] = []

    def decide(self, reasons: list[str], *, fp32_available: bool = False,
               rollback_available: bool = False) -> str:
        """The next ladder stage for one violating batch (spends nothing)."""
        with self._lock:
            counts = dict(self._counts)
        cfg = self.config
        bf16_only = bool(reasons) and all(r in REROUTE_REASONS for r in reasons)
        if bf16_only and fp32_available and counts["fp32-reroute"] < cfg.max_reroutes:
            return "fp32-reroute"
        if counts["skip"] < cfg.max_skips:
            return "skip"
        if rollback_available and counts["rollback"] < cfg.max_rollbacks:
            return "rollback"
        return "give-up"

    def record(self, stage: str, reasons: list[str], **context: Any) -> None:
        """Commit one executed stage: spend its budget, quarantine the batch
        identity (``epoch``/``batch`` of a skip), log."""
        if stage not in RECOVERY_STAGES:
            raise ValueError(f"unknown recovery stage {stage!r}")
        with self._lock:
            self._counts[stage] += 1
            if stage == "skip" and len(self._quarantined) < self.MAX_QUARANTINE:
                self._quarantined.append({k: context[k] for k in ("epoch", "batch") if k in context})
        log.warning(
            "recovery: %s (%s) %s", stage, ", ".join(reasons) or "-",
            " ".join(f"{k}={v}" for k, v in context.items()
                     if isinstance(v, (bool, int, float, str)) or v is None),
        )

    def count(self, stage: str) -> int:
        with self._lock:
            return self._counts[stage]

    @property
    def recoveries(self) -> int:
        """Total committed stages."""
        with self._lock:
            return sum(self._counts.values())

    def summary(self) -> dict[str, Any]:
        """Rollup of the run's recoveries."""
        with self._lock:
            return {
                "enabled": self.config.enabled,
                "counts": dict(self._counts),
                "quarantined": [dict(q) for q in self._quarantined],
            }
