"""Parameter-field drift: per-epoch distribution summaries of the KAN's
spatially distributed physical parameters.

The port's copy of ``ddr_tpu/observability/drift.py`` (numpy and the
standard library). The KAN predicts a physical field per reach (Manning's
n, the Leopold ``q_spatial``/``p_spatial`` exponents), and training can keep
lowering the loss while that field drifts somewhere unphysical: every reach
pinned at a bound, a bimodal collapse, an epoch-over-epoch random walk.

- :meth:`DriftTracker.observe` takes the denormalized fields once an epoch
  (host numpy: the train loop runs one extra KAN forward outside its timed
  step) and reduces each to a bounded summary: a fixed quantile profile,
  mean and std, out-of-bounds and non-finite counts;
- the first observation is the reference snapshot (or an explicit
  :meth:`DriftTracker.set_reference`); every later epoch reports a drift
  index per field, the mean absolute displacement of the quantile profile
  over the reference profile's span (0: the distribution did not move; 1:
  it moved by its own width);
- each observation emits one ``drift`` event and sets the
  ``ddr_param_drift{param}`` and ``ddr_param_oob{param}`` gauges;
- a drift index past ``DDR_HEALTH_MAX_PARAM_DRIFT``, an out-of-bounds count
  past ``DDR_HEALTH_MAX_PARAM_OOB`` or any non-finite parameter is flagged
  to the health watchdog (:meth:`HealthWatchdog.flag`), so drifting epochs
  degrade a run as solve NaNs do.
"""

from __future__ import annotations

import logging
import threading
from typing import Any

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["DRIFT_QUANTILES", "DriftTracker", "drift_index"]

#: The fixed quantile profile every field reduces to (bounded summary; the
#: tails catch pin-at-bound collapse, the quartiles catch bulk drift).
DRIFT_QUANTILES = (0.0, 0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99, 1.0)

#: Relative tolerance when counting out-of-physical-bounds entries: the
#: sigmoid denormalization maps INTO [lo, hi] by construction, so only float
#: round-off should ever sit outside — anything past lo/hi by more than this
#: fraction of the range is genuinely wrong (imported weights, a broken
#: denormalize, numerical blow-up).
_OOB_RTOL = 1e-4


def drift_index(q_now: np.ndarray, q_ref: np.ndarray) -> float:
    """Mean |quantile displacement| / reference-profile span — a scale-free
    "how far did the distribution move" index (see module docstring)."""
    q_now = np.asarray(q_now, dtype=np.float64)
    q_ref = np.asarray(q_ref, dtype=np.float64)
    span = float(q_ref[-1] - q_ref[0])
    if not np.isfinite(span) or span <= 0:
        span = max(abs(float(q_ref[-1])), 1e-12)
    d = np.abs(q_now - q_ref)
    return float(d[np.isfinite(d)].mean() / span) if np.isfinite(d).any() else float("inf")


class DriftTracker:
    """Per-epoch parameter-field drift watchdog. One instance per run.

    ``parameter_ranges`` maps field name -> (lo, hi) physical bounds (the
    config's ``params.parameter_ranges``); fields without an entry skip the
    OOB count. ``watchdog`` (a
    :class:`~ddr_tpu_torch.observability.health.HealthWatchdog`) receives
    violations via :meth:`~ddr_tpu_torch.observability.health.HealthWatchdog.flag`.
    """

    def __init__(
        self,
        parameter_ranges: dict[str, Any] | None = None,
        config: Any = None,
        registry: Any = None,
        watchdog: Any = None,
    ) -> None:
        if config is None:
            from ddr_tpu_torch.observability.health import HealthConfig

            config = HealthConfig.from_env()
        self.config = config
        self.parameter_ranges = {
            str(k): (float(v[0]), float(v[1]))
            for k, v in (parameter_ranges or {}).items()
        }
        self.watchdog = watchdog
        self._lock = threading.Lock()
        self._reference: dict[str, np.ndarray] = {}
        self._last: dict[str, dict[str, Any]] = {}
        self._observations = 0
        self._violations = 0
        if registry is None:
            from ddr_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self._drift_gauge = registry.gauge(
            "ddr_param_drift",
            "Parameter-field drift index vs the reference snapshot "
            "(quantile-profile displacement / reference span)",
            labels=("param",),
        )
        self._oob_gauge = registry.gauge(
            "ddr_param_oob",
            "Parameter-field entries outside their physical bounds at the "
            "last drift observation",
            labels=("param",),
        )

    # ---- reference ----

    def set_reference(self, fields: dict[str, Any]) -> None:
        """Pin the drift reference explicitly (a blessed checkpoint's fields);
        otherwise the first :meth:`observe` becomes the reference."""
        with self._lock:
            self._reference = {
                str(k): self._quantiles(np.asarray(v, dtype=np.float64))
                for k, v in fields.items()
            }

    @staticmethod
    def _quantiles(values: np.ndarray) -> np.ndarray:
        finite = values[np.isfinite(values)]
        if finite.size == 0:
            return np.full(len(DRIFT_QUANTILES), np.nan)
        return np.quantile(finite, DRIFT_QUANTILES)

    # ---- observation ----

    def _field_summary(
        self, name: str, values: np.ndarray
    ) -> tuple[dict[str, Any], np.ndarray]:
        q = self._quantiles(values)
        finite = values[np.isfinite(values)]
        out: dict[str, Any] = {
            "quantiles": [round(float(v), 6) for v in q],
            "mean": round(float(finite.mean()), 6) if finite.size else None,
            "std": round(float(finite.std()), 6) if finite.size else None,
            "nonfinite": int(values.size - finite.size),
            "n": int(values.size),
        }
        bounds = self.parameter_ranges.get(name)
        if bounds is not None:
            lo, hi = bounds
            tol = _OOB_RTOL * max(hi - lo, 1e-12)
            out["oob"] = int(((finite < lo - tol) | (finite > hi + tol)).sum())
            out["bounds"] = [lo, hi]
        with self._lock:
            ref = self._reference.get(name)
        if ref is not None:
            out["drift"] = round(drift_index(q, ref), 6)
        return out, q

    def observe(self, fields: dict[str, Any], **context: Any) -> list[str]:
        """Reduce one epoch's parameter fields, emit the ``drift`` event,
        mirror gauges, and threshold: returns the violation reasons (empty =
        healthy), which were also flagged to the watchdog when one is
        attached. ``context`` (epoch/...) rides the event."""
        summaries: dict[str, dict[str, Any]] = {}
        new_ref: dict[str, np.ndarray] = {}
        reasons: list[str] = []
        import math as _math

        for name, values in fields.items():
            name = str(name)
            values = np.asarray(values, dtype=np.float64)
            summary, q = self._field_summary(name, values)
            summaries[name] = summary
            new_ref[name] = q
            if summary["nonfinite"] > 0 and "param-nonfinite" not in reasons:
                reasons.append("param-nonfinite")
            if (
                summary.get("oob", 0) > self.config.max_param_oob
                and "param-oob" not in reasons
            ):
                reasons.append("param-oob")
            drift = summary.get("drift")
            if drift is not None and (
                not _math.isfinite(drift) or drift > self.config.max_param_drift
            ):
                if "param-drift" not in reasons:
                    reasons.append("param-drift")
        with self._lock:
            if not self._reference:
                self._reference = new_ref  # first observation = reference
            self._last = summaries
            self._observations += 1
            if reasons:
                self._violations += 1
        try:
            for name, summary in summaries.items():
                if summary.get("drift") is not None:
                    self._drift_gauge.set(summary["drift"], param=name)
                if summary.get("oob") is not None:
                    self._oob_gauge.set(float(summary["oob"]), param=name)
        except Exception:
            log.exception("drift metrics mirroring failed")
        from ddr_tpu_torch.observability.events import get_recorder

        rec = get_recorder()
        if rec is not None:
            rec.emit("drift", fields=summaries, reasons=reasons, **context)
        if reasons:
            log.warning(
                f"parameter drift violation ({', '.join(reasons)}): "
                + ", ".join(
                    f"{k} drift={v.get('drift')} oob={v.get('oob')}"
                    for k, v in summaries.items()
                )
            )
        if self.watchdog is not None:
            # every snapshot, violating or not: an empty flag CLEARS the
            # watchdog's flagged streak (recovered parameters re-arm /readyz)
            self.watchdog.flag(reasons, source="drift", **context)
        return reasons

    # ---- rollups ----

    def status(self) -> dict[str, Any]:
        """run_end rollup: counters + the last per-field summaries."""
        with self._lock:
            return {
                "observations": self._observations,
                "violations": self._violations,
                "fields": {
                    k: dict(v) for k, v in self._last.items()
                },
            }
