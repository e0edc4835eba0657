"""Per-gauge hydrologic skill: streaming NSE, KGE and percent-bias.

The port's copy of ``ddr_tpu/observability/skill.py`` (numpy and the
standard library). A :class:`SkillTracker` folds each batch's predictions
and observations into bounded per-gauge running sums (seven a gauge: enough
to rebuild NSE, KGE and percent-bias exactly over everything seen, with no
series kept), emits one ``skill`` event per observation with a bounded
payload (distribution percentiles and the worst-K gauges) to the active run
recorder, and mirrors the distribution into the ``ddr_skill_nse`` /
``ddr_skill_kge`` histograms and the per-gauge ``ddr_skill_worst_nse``
gauges, capped at the worst K (a gauge leaving the set is removed).

Definitions, reconstructed from the sums over each gauge's ``n`` valid pairs
``(p_i, o_i)``: NSE = ``1 - sum (p-o)^2 / sum (o-mean(o))^2``; KGE = ``1 -
sqrt((r-1)^2 + (alpha-1)^2 + (beta-1)^2)`` with Pearson ``r``, ``alpha =
sigma_p/sigma_o``, ``beta = mean(p)/mean(o)``; percent-bias = ``100 (sum p -
sum o)/sum o``. Gauges with fewer than ``min_samples`` pairs, constant
observations or zero observed mass report NaN.

``ddr train`` feeds a tracker once a batch and ``ddr test`` once with its
evaluation battery (each a ``skill`` event and a ``skill`` rollup on
``run_end``); each arm of the canary controller
(:mod:`ddr_tpu_torch.fleet.canary`) holds a private tracker, and a tracker
attached to the service (``ForecastService.attach_skill_tracker``) is its
``skill`` slice of ``/v1/stats``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
from typing import Any, Sequence

import numpy as np

log = logging.getLogger(__name__)

__all__ = [
    "SKILL_BUCKETS",
    "SkillConfig",
    "SkillTracker",
    "gauge_skill_from_sums",
]

#: Histogram buckets for the per-gauge NSE/KGE distributions (upper bounds;
#: +Inf implied). Skill metrics live in (-inf, 1]; the interesting structure
#: is the 0..1 shoulder — negative skill ("worse than predicting the mean")
#: pools in the low buckets.
SKILL_BUCKETS = (-1.0, -0.5, 0.0, 0.25, 0.5, 0.7, 0.8, 0.9, 0.95, 1.0)

_FALSEY = ("0", "false", "no", "off")

#: Accumulator layout per gauge: [n, Σp, Σo, Σp², Σo², Σpo, Σ(p-o)²].
_N_SUMS = 7


@dataclasses.dataclass(frozen=True)
class SkillConfig:
    """Skill-tracking knobs (env var in parentheses)."""

    #: Master switch (DDR_SKILL_ENABLED; 0/false/no/off disables).
    enabled: bool = True
    #: Worst-gauge set size for events + per-gauge Prometheus series
    #: (DDR_SKILL_TOPK). This CAPS the ``ddr_skill_worst_nse`` cardinality.
    top_k: int = 8
    #: Valid (pred, obs) pairs a gauge needs before its metrics count
    #: (DDR_SKILL_MIN_SAMPLES; < 2 makes variance terms meaningless).
    min_samples: int = 2

    def __post_init__(self) -> None:
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.min_samples < 2:
            raise ValueError(f"min_samples must be >= 2, got {self.min_samples}")

    @classmethod
    def from_env(cls, environ: dict | None = None, **overrides) -> "SkillConfig":
        env = os.environ if environ is None else environ
        from_env: dict = {}
        raw = env.get("DDR_SKILL_ENABLED")
        if raw not in (None, ""):
            from_env["enabled"] = raw.strip().lower() not in _FALSEY
        for key, var in (("top_k", "DDR_SKILL_TOPK"),
                         ("min_samples", "DDR_SKILL_MIN_SAMPLES")):
            raw = env.get(var)
            if raw not in (None, ""):
                try:
                    from_env[key] = int(raw)
                except ValueError as e:
                    raise ValueError(f"bad {var}={raw!r}: {e}") from e
        from_env.update(overrides)
        return cls(**from_env)


def gauge_skill_from_sums(
    sums: np.ndarray, min_samples: int = 2
) -> dict[str, np.ndarray]:
    """NSE/KGE/percent-bias per gauge from the ``(G, 7)`` streaming-sum array
    (see module docstring for the layout and formulas). Vectorized over
    gauges; degenerate gauges yield NaN. Exposed for an offline
    replay and the unit tests' hand-computed checks."""
    sums = np.asarray(sums, dtype=np.float64)
    n = sums[:, 0]
    sp, so, spp, soo, spo, sse = (sums[:, i] for i in range(1, 7))
    with np.errstate(invalid="ignore", divide="ignore"):
        ok = n >= max(2, int(min_samples))
        n1 = np.maximum(n, 1.0)
        pmean = sp / n1
        omean = so / n1
        pvar = spp - n * pmean**2  # Σ(p - p̄)²
        ovar = soo - n * omean**2
        # float cancellation can push a tiny true variance below zero
        pvar = np.maximum(pvar, 0.0)
        ovar = np.maximum(ovar, 0.0)
        nan = np.full(n.shape, np.nan)

        nse_ok = ok & (ovar > 0)
        nse = np.where(nse_ok, 1.0 - sse / np.where(nse_ok, ovar, 1.0), nan)

        cov = spo - n * pmean * omean
        denom = np.sqrt(pvar * ovar)
        corr_ok = ok & (denom > 0)
        r = np.where(corr_ok, cov / np.where(corr_ok, denom, 1.0), nan)
        kge_ok = corr_ok & (ovar > 0) & (omean != 0)
        alpha = np.sqrt(pvar / np.where(ovar > 0, ovar, 1.0))
        beta = pmean / np.where(omean != 0, omean, 1.0)
        kge = np.where(
            kge_ok,
            1.0 - np.sqrt((r - 1.0) ** 2 + (alpha - 1.0) ** 2 + (beta - 1.0) ** 2),
            nan,
        )
        pbias_ok = ok & (so != 0)
        pbias = np.where(pbias_ok, 100.0 * (sp - so) / np.where(pbias_ok, so, 1.0), nan)
    return {"nse": nse, "kge": kge, "pbias": pbias, "n": n}


def _percentile(vals: np.ndarray, q: float) -> float | None:
    finite = vals[np.isfinite(vals)]
    if finite.size == 0:
        return None
    return float(np.percentile(finite, q))


class SkillTracker:
    """Streaming per-gauge skill over a run. One instance per run/service;
    :meth:`observe` is called once per batch AFTER the loop's existing host
    sync (everything it touches is already a numpy array). Thread-safe."""

    def __init__(
        self, config: SkillConfig | None = None, registry: Any = None
    ) -> None:
        self.config = config or SkillConfig.from_env()
        self._lock = threading.Lock()
        self._gauges: dict[str, int] = {}  # gauge id -> row in self._sums
        self._sums = np.zeros((0, _N_SUMS), dtype=np.float64)
        self._observations = 0
        self._last_summary: dict[str, Any] | None = None
        self._exported_worst: set[str] = set()  # live ddr_skill_worst_nse series
        if registry is None:
            from ddr_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self._registry = registry
        self._nse_hist = registry.histogram(
            "ddr_skill_nse",
            "Per-gauge Nash-Sutcliffe efficiency (one observation per gauge "
            "per skill update)",
            buckets=SKILL_BUCKETS,
        )
        self._kge_hist = registry.histogram(
            "ddr_skill_kge",
            "Per-gauge Kling-Gupta efficiency (one observation per gauge per "
            "skill update)",
            buckets=SKILL_BUCKETS,
        )
        self._worst_gauge = registry.gauge(
            "ddr_skill_worst_nse",
            "NSE of the current worst-K gauges (series capped at K; gauges "
            "leaving the worst set are removed)",
            labels=("gauge",),
        )

    # ---- accumulation ----

    def _rows_for(self, gauge_ids: Sequence[Any]) -> np.ndarray:
        """Row index per gauge id, growing the sum table for new gauges."""
        rows = np.empty(len(gauge_ids), dtype=np.int64)
        new: list[str] = []
        for i, gid in enumerate(gauge_ids):
            key = str(gid)
            row = self._gauges.get(key)
            if row is None:
                row = len(self._gauges)
                self._gauges[key] = row
                new.append(key)
            rows[i] = row
        if new:
            self._sums = np.vstack(
                [self._sums, np.zeros((len(new), _N_SUMS), dtype=np.float64)]
            )
        return rows

    def observe(
        self,
        pred: np.ndarray,
        obs: np.ndarray,
        gauge_ids: Sequence[Any],
        **context: Any,
    ) -> dict[str, Any] | None:
        """Fold one batch's ``(T, G)`` daily predictions and observations
        (NaN = missing; masked entries should arrive as NaN) into the
        streaming sums, emit one ``skill`` event, and mirror the updated
        distribution into the registry. Returns the bounded summary dict the
        event carried (None when disabled or nothing was valid). ``context``
        (epoch/batch/network/...) rides the event."""
        if not self.config.enabled:
            return None
        pred = np.atleast_2d(np.asarray(pred, dtype=np.float64))
        obs = np.atleast_2d(np.asarray(obs, dtype=np.float64))
        if pred.shape != obs.shape or pred.shape[1] != len(gauge_ids):
            raise ValueError(
                f"shape mismatch: pred {pred.shape}, obs {obs.shape}, "
                f"{len(gauge_ids)} gauge ids"
            )
        valid = np.isfinite(pred) & np.isfinite(obs)
        p = np.where(valid, pred, 0.0)
        o = np.where(valid, obs, 0.0)
        batch = np.stack(
            [
                valid.sum(axis=0).astype(np.float64),
                p.sum(axis=0),
                o.sum(axis=0),
                (p * p).sum(axis=0),
                (o * o).sum(axis=0),
                (p * o).sum(axis=0),
                (np.where(valid, pred - obs, 0.0) ** 2).sum(axis=0),
            ],
            axis=1,
        )  # (G, 7)
        with self._lock:
            rows = self._rows_for(gauge_ids)
            np.add.at(self._sums, rows, batch)
            self._observations += 1
            sums = self._sums.copy()
            index = dict(self._gauges)
        # ONE skill reconstruction per observe: summary and registry
        # mirroring both consume it (O(G) host work, paid once per batch)
        skill = gauge_skill_from_sums(sums, self.config.min_samples)
        summary = self._summarize(skill, index, context)
        self._mirror(summary, skill)
        self._emit(summary, context)
        return summary

    def merge(self, other: "SkillTracker") -> None:
        """Fold another tracker's running sums into this one, exactly: the
        merged state equals a single tracker that had seen both streams
        (the sums are plain per-gauge additions, so the fold is lossless).
        Used by canary gating and ``ddr verify`` replay to combine per-arm /
        per-replica trackers. The merged distribution is NOT re-mirrored into
        the registry here — folding is a read-side aggregation; call sites
        that want fresh metrics keep feeding :meth:`observe`."""
        if other is self:
            raise ValueError("cannot merge a tracker into itself")
        with other._lock:
            other_sums = other._sums.copy()
            other_index = dict(other._gauges)
            other_obs = other._observations
        ids = [None] * len(other_index)
        for name, row in other_index.items():
            ids[row] = name
        with self._lock:
            if ids:
                rows = self._rows_for(ids)
                np.add.at(self._sums, rows, other_sums)
            self._observations += other_obs

    # ---- reporting ----

    def _summarize(
        self, skill: dict[str, np.ndarray], index: dict[str, int], context: dict
    ) -> dict[str, Any]:
        """The bounded event payload: distribution percentiles + worst-K."""
        nse, kge, pbias = skill["nse"], skill["kge"], skill["pbias"]
        gauge_names = [None] * len(index)
        for name, row in index.items():
            gauge_names[row] = name
        finite = np.isfinite(nse)
        worst: list[dict[str, Any]] = []
        if self.config.top_k > 0 and finite.any():
            order = np.argsort(np.where(finite, nse, np.inf))
            for row in order[: self.config.top_k]:
                if not finite[row]:
                    break
                worst.append({
                    "gauge": gauge_names[row],
                    "nse": round(float(nse[row]), 4),
                    "kge": round(float(kge[row]), 4)
                    if np.isfinite(kge[row]) else None,
                    "pbias": round(float(pbias[row]), 2)
                    if np.isfinite(pbias[row]) else None,
                })
        summary = {
            "gauges": int(len(index)),
            "scored": int(finite.sum()),
            "nse": {
                "median": _percentile(nse, 50),
                "p10": _percentile(nse, 10),
                "p90": _percentile(nse, 90),
                "frac_positive": (
                    round(float((nse[finite] > 0).mean()), 4) if finite.any() else None
                ),
            },
            "kge": {"median": _percentile(kge, 50), "p10": _percentile(kge, 10)},
            "pbias": {
                "median_abs": _percentile(np.abs(pbias), 50),
                "p90_abs": _percentile(np.abs(pbias), 90),
            },
            "worst": worst,
        }
        for sect in ("nse", "kge", "pbias"):
            summary[sect] = {
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in summary[sect].items()
            }
        with self._lock:
            self._last_summary = summary
        return summary

    def _mirror(
        self, summary: dict[str, Any], skill: dict[str, np.ndarray]
    ) -> None:
        """Registry mirroring: distribution histograms + the capped worst-K
        per-gauge series (with removal on churn). Never raises."""
        try:
            nse, kge = skill["nse"], skill["kge"]
            for v in nse[np.isfinite(nse)]:
                self._nse_hist.observe(float(v))
            for v in kge[np.isfinite(kge)]:
                self._kge_hist.observe(float(v))
            current = {w["gauge"]: w["nse"] for w in summary["worst"]}
            with self._lock:
                stale = self._exported_worst - set(current)
                self._exported_worst = set(current)
            for gauge in stale:
                self._worst_gauge.remove(gauge=gauge)
            for gauge, v in current.items():
                self._worst_gauge.set(v, gauge=gauge)
        except Exception:
            log.exception("skill metrics mirroring failed")

    def _emit(self, summary: dict[str, Any], context: dict) -> None:
        from ddr_tpu_torch.observability.events import get_recorder

        rec = get_recorder()
        if rec is not None:
            rec.emit("skill", **summary, **context)

    # ---- rollups ----

    def status(self) -> dict[str, Any]:
        """The run_end / ``/v1/stats`` rollup: last computed summary +
        observation counters."""
        with self._lock:
            return {
                "enabled": self.config.enabled,
                "observations": self._observations,
                "samples": int(self._sums[:, 0].sum()),
                "gauges": len(self._gauges),
                **({} if self._last_summary is None else dict(self._last_summary)),
            }

    def results(self) -> dict[str, dict[str, float | None]]:
        """Full per-gauge metrics (a replay or report path — NOT
        for per-batch telemetry; at continental gauge counts this is the big
        vector the event payload deliberately omits)."""
        with self._lock:
            sums = self._sums.copy()
            index = dict(self._gauges)
        skill = gauge_skill_from_sums(sums, self.config.min_samples)

        def _f(v: float) -> float | None:
            return float(v) if np.isfinite(v) else None

        return {
            name: {
                "nse": _f(skill["nse"][row]),
                "kge": _f(skill["kge"][row]),
                "pbias": _f(skill["pbias"][row]),
                "n": int(skill["n"][row]),
            }
            for name, row in sorted(index.items(), key=lambda kv: kv[1])
        }
