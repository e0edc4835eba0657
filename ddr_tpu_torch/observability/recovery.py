"""Self-healing training: the recovery supervisor's escalation ladder and
the forcing validator.

The port of ``ddr_tpu/observability/recovery.py``. The health watchdog (:mod:`ddr_tpu_torch.observability.health`) detects a NaN
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
recoveries. Each committed stage is logged and is one ``recovery`` event of
the active run recorder.

:class:`ForcingValidator` (``DDR_DATA_VALIDATE=off|warn|quarantine``) scans
each assembled forcing batch on the host for non-finite and out-of-range
inflow before the card sees it; ``ddr train`` drops a quarantined batch as a
ladder ``skip``.
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
    "ForcingValidator",
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
        identity (``epoch``/``batch`` of a skip), log, and emit the
        ``recovery`` event."""
        if stage not in RECOVERY_STAGES:
            raise ValueError(f"unknown recovery stage {stage!r}")
        with self._lock:
            self._counts[stage] += 1
            if stage == "skip" and len(self._quarantined) < self.MAX_QUARANTINE:
                self._quarantined.append({k: context[k] for k in ("epoch", "batch") if k in context})
        payload = {
            "stage": stage,
            "reasons": list(reasons),
            **{k: v for k, v in context.items() if isinstance(v, (bool, int, float, str)) or v is None},
        }
        log.warning(
            "recovery: %s (%s) %s", stage, ", ".join(reasons) or "-",
            " ".join(f"{k}={v}" for k, v in payload.items() if k not in ("stage", "reasons")),
        )
        try:
            from ddr_tpu_torch.observability.events import get_recorder

            rec = get_recorder()
            if rec is not None:
                rec.emit("recovery", **payload)
        except Exception:  # telemetry must never mask the recovery itself
            log.exception("could not record recovery event")

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


# ---------------------------------------------------------------------------
# Forcing validation (the data_load-phase scan).
# ---------------------------------------------------------------------------

_POLICIES = ("off", "warn", "quarantine")


class ForcingValidator:
    """Host-side sanity scan over each assembled forcing batch.

    Runs inside the existing ``data_load`` step phase (prefetch thread) so a
    bad tile is caught before the device ever sees it. :meth:`scan` is pure
    (safe off the main thread); :meth:`note` — called from the train loop —
    emits the bounded ``data_anomaly`` event and answers what the policy says
    to do with the batch (``"warn"``: train on it anyway, ``"quarantine"``:
    drop it).
    """

    #: Physical ceiling for a lateral-inflow value (m^3/s). The largest
    #: observed river discharge on Earth is O(1e5); anything past this is a
    #: corrupt tile, not hydrology.
    MAX_RUNOFF = 1.0e7
    #: Small negative tolerance: spectral/NN runoff generators can undershoot
    #: zero by numerical noise; genuinely negative inflow is an anomaly.
    MIN_RUNOFF = -1.0
    #: ``data_anomaly`` events emitted per run before suppression kicks in
    #: (suppressed findings still count into the run_end rollup).
    MAX_EVENTS = 32

    def __init__(self, policy: str | None = None) -> None:
        if policy is None:
            policy = os.environ.get("DDR_DATA_VALIDATE", "off")
        policy = (policy or "off").strip().lower() or "off"
        if policy not in _POLICIES:
            raise ValueError(
                f"bad DDR_DATA_VALIDATE={policy!r} (want one of {', '.join(_POLICIES)})"
            )
        self.policy = policy
        self.enabled = policy != "off"
        self._lock = threading.Lock()
        self._batches = 0
        self._anomalies = 0
        self._quarantined = 0
        self._emitted = 0
        self._suppressed = 0

    def scan(self, q_prime: Any, **identity: Any) -> dict[str, Any] | None:
        """Scan one forcing batch -> anomaly descriptor, or None when clean
        (or validation is off). Duck-typed over the ndarray API so this module
        needs no numpy import; the comparisons below are vectorized C loops
        either way."""
        if not self.enabled:
            return None
        with self._lock:
            self._batches += 1
        finite = _isfinite(q_prime)
        n_nonfinite = int(q_prime.size - finite.sum())
        # range check only over the finite entries (NaN comparisons are False
        # anyway, but inf > MAX would double-count the non-finites)
        in_range = (q_prime >= self.MIN_RUNOFF) & (q_prime <= self.MAX_RUNOFF)
        n_out = int((finite & ~in_range).sum())
        if not n_nonfinite and not n_out:
            return None
        with self._lock:
            self._anomalies += 1
        return {
            "nonfinite": n_nonfinite,
            "out_of_range": n_out,
            "size": int(q_prime.size),
            "policy": self.policy,
            **{k: v for k, v in identity.items() if _plain(v)},
        }

    def note(self, anomaly: dict[str, Any]) -> str:
        """Record one scan finding from the train loop: emit the bounded
        ``data_anomaly`` event and return the policy's verdict for the batch
        (``"warn"`` or ``"quarantine"``)."""
        with self._lock:
            if self._emitted < self.MAX_EVENTS:
                self._emitted += 1
                emit = True
            else:
                self._suppressed += 1
                emit = False
            if self.policy == "quarantine":
                self._quarantined += 1
        log.warning(
            "forcing anomaly (%s): %s", self.policy,
            " ".join(f"{k}={v}" for k, v in anomaly.items() if k != "policy"),
        )
        if emit:
            try:
                from ddr_tpu_torch.observability.events import get_recorder

                rec = get_recorder()
                if rec is not None:
                    rec.emit("data_anomaly", **anomaly)
            except Exception:
                log.exception("could not record data_anomaly event")
        return "quarantine" if self.policy == "quarantine" else "warn"

    def summary(self) -> dict[str, Any]:
        """Rollup for ``merge_summary("data_validate", ...)`` on run_end."""
        with self._lock:
            return {
                "policy": self.policy,
                "batches": self._batches,
                "anomalies": self._anomalies,
                "quarantined": self._quarantined,
                "events_suppressed": self._suppressed,
            }


def _isfinite(arr: Any) -> Any:
    """Elementwise finiteness without importing numpy: finite <=> the value
    minus itself is 0 (NaN/inf propagate). Works on any ndarray duck type.
    ``inf - inf`` legitimately hits the invalid-value path, so the expected
    RuntimeWarning is silenced (stdlib ``warnings``, keeping the module
    numpy-free)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        diff = arr - arr
    return diff == diff


def _plain(v: Any) -> bool:
    return isinstance(v, (bool, int, float, str)) or v is None
