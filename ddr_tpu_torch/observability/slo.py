"""Service-level objectives: sliding-window attainment and multi-window burn rates.

The port's copy of ``ddr_tpu/observability/slo.py`` (standard library only).
An objective such as "99% of requests complete within their deadline"
defines an error budget (1 - target); the burn rate of a window is how many
times faster than budget-neutral the service spends it (1.0 spends exactly
the budget over the SLO period; 14 over a short window is a fast burn worth
an alert). The longest window says whether the objective is met, the
shortest catches incidents early.

- :class:`SloConfig` — the objective: defaults < ``DDR_SLO_*`` environment <
  explicit keywords, as :class:`~ddr_tpu_torch.serving.config.ServeConfig`;
- :class:`SloTracker` — thread-safe good/bad counts in coarse time buckets
  (memory O(longest window / bucket) whatever the traffic), per-window
  attainment and burn-rate reads, and the fast-burn alert's edge detector
  (``check_alert``), which the service turns into one ``slo`` event per
  change of state.

- :func:`attainment_from_events` — the same rollup offline, over a run
  log's ``serve_request`` events (``ddr metrics summarize``'s SLO section).

The service sets the ``ddr_slo_attainment`` and ``ddr_slo_burn_rate{window}``
gauges (:mod:`~ddr_tpu_torch.observability.prometheus`) from the tracker.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Iterable

__all__ = [
    "SloConfig",
    "SloTracker",
    "attainment_from_events",
    "parse_window_label",
    "window_label",
]

_ENV_PREFIX = "DDR_SLO_"
_FALSE = {"0", "false", "no", "off"}


def window_label(window_s: float) -> str:
    """The Prometheus ``window`` label value for a window length (``"300s"``)."""
    return f"{window_s:g}s"


def parse_window_label(label: str) -> float | None:
    """Inverse of :func:`window_label` (``"300s"`` -> 300.0); None when the
    label isn't a window length."""
    try:
        return float(str(label).rstrip("s"))
    except ValueError:
        return None


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """One serving objective (env var in parentheses).

    The objective reads: ``target`` of requests must terminate *good* — served
    ``ok`` within their deadline, and (when ``latency_s`` is set) within that
    latency ceiling. Sheds, rejections, executor errors, and late replies are
    budget spend.
    """

    #: Master switch (DDR_SLO_ENABLED; 0/false/no/off disables).
    enabled: bool = True
    #: Fraction of requests that must be good, in (0, 1) (DDR_SLO_TARGET).
    target: float = 0.99
    #: Optional latency ceiling for a request to count good, seconds
    #: (DDR_SLO_LATENCY_MS, milliseconds). None = the request's own deadline
    #: is the objective.
    latency_s: float | None = None
    #: Sliding windows, seconds, ascending; the longest is the SLO window
    #: proper, the shortest drives fast-burn alerting (DDR_SLO_WINDOWS,
    #: comma-separated seconds).
    windows: tuple[float, ...] = (60.0, 300.0, 3600.0)
    #: Burn rate over the shortest window at/above which the tracker alerts
    #: (DDR_SLO_ALERT_BURN). The classic fast-burn page threshold is ~14 —
    #: one hour at that rate spends half a 30-day budget.
    alert_burn_rate: float = 14.0
    #: Minimum samples in the shortest window before alerting — a single bad
    #: request on an idle service is not an incident (DDR_SLO_ALERT_MIN_SAMPLES).
    alert_min_samples: int = 10

    def __post_init__(self) -> None:
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.latency_s is not None and self.latency_s <= 0:
            raise ValueError(f"latency_s must be > 0, got {self.latency_s}")
        wins = tuple(sorted({float(w) for w in self.windows}))
        if not wins or any(w <= 0 for w in wins):
            raise ValueError(f"windows must be positive seconds, got {self.windows}")
        object.__setattr__(self, "windows", wins)
        if self.alert_burn_rate <= 0:
            raise ValueError(
                f"alert_burn_rate must be > 0, got {self.alert_burn_rate}"
            )
        if self.alert_min_samples < 1:
            raise ValueError(
                f"alert_min_samples must be >= 1, got {self.alert_min_samples}"
            )

    @property
    def slo_window(self) -> float:
        """The longest window — the objective's own accounting period."""
        return self.windows[-1]

    @property
    def fast_window(self) -> float:
        """The shortest window — the fast-burn alert signal."""
        return self.windows[0]

    @classmethod
    def from_env(cls, environ: dict | None = None, **overrides) -> "SloConfig":
        """Defaults < ``DDR_SLO_*`` environment < explicit ``overrides``."""
        env = os.environ if environ is None else environ

        def _raw(name: str) -> str | None:
            v = env.get(_ENV_PREFIX + name)
            return None if v is None or v == "" else v

        from_env: dict[str, Any] = {}
        raw = _raw("ENABLED")
        if raw is not None:
            from_env["enabled"] = raw.strip().lower() not in _FALSE
        for key, var, cast, scale in (
            ("target", "TARGET", float, 1.0),
            ("latency_s", "LATENCY_MS", float, 1e-3),
            ("alert_burn_rate", "ALERT_BURN", float, 1.0),
            ("alert_min_samples", "ALERT_MIN_SAMPLES", int, 1),
        ):
            raw = _raw(var)
            if raw is None:
                continue
            try:
                v = cast(raw)
            except ValueError as e:
                raise ValueError(f"bad {_ENV_PREFIX}{var}={raw!r}: {e}") from e
            from_env[key] = v * scale if scale != 1 else v
        raw = _raw("WINDOWS")
        if raw is not None:
            try:
                from_env["windows"] = tuple(
                    float(p) for p in raw.split(",") if p.strip()
                )
            except ValueError as e:
                raise ValueError(f"bad {_ENV_PREFIX}WINDOWS={raw!r}: {e}") from e
        from_env.update(overrides)
        return cls(**from_env)


class SloTracker:
    """Bounded-memory sliding-window good/bad accounting.

    Observations land in coarse time buckets (width ``min(1s, fast_window/20)``,
    floored at 50 ms) keyed by the monotonic clock, so memory is bounded by
    ``slo_window / bucket`` regardless of request rate — the structure a
    serving replica can keep forever. ``observe`` is one dict update under a
    lock; reads scan at most the bucket count.
    """

    def __init__(self, cfg: SloConfig | None = None) -> None:
        self.cfg = cfg or SloConfig.from_env()
        self._lock = threading.Lock()
        self._bucket_s = max(0.05, min(1.0, self.cfg.fast_window / 20.0))
        # bucket index -> [good, total]
        self._buckets: dict[int, list[int]] = {}
        self._good_lifetime = 0
        self._total_lifetime = 0
        self._alerting = False

    # ---- writes ----

    def observe(self, good: bool, now: float | None = None) -> bool:
        """Record one terminal request decision. Returns True when the
        observation opened a NEW time bucket — the natural cadence for
        callers to recompute window reads (which scan every bucket under the
        lock): once per ``bucket_s``, not once per request."""
        now = time.monotonic() if now is None else now
        idx = int(now / self._bucket_s)
        rolled = False
        with self._lock:
            b = self._buckets.get(idx)
            if b is None:
                rolled = True
                b = self._buckets[idx] = [0, 0]
                # prune on bucket rollover only: O(buckets) once per bucket_s,
                # O(1) on the per-request path
                horizon = idx - int(self.cfg.slo_window / self._bucket_s) - 1
                for k in [k for k in self._buckets if k < horizon]:
                    del self._buckets[k]
            if good:
                b[0] += 1
                self._good_lifetime += 1
            b[1] += 1
            self._total_lifetime += 1
        return rolled

    # ---- reads ----

    def _counts(self, window_s: float, now: float) -> tuple[int, int]:
        lo = int((now - window_s) / self._bucket_s)
        good = total = 0
        with self._lock:
            for k, (g, t) in self._buckets.items():
                if k >= lo:
                    good += g
                    total += t
        return good, total

    def attainment(self, window_s: float | None = None, now: float | None = None) -> float | None:
        """Good fraction over the window (default: the SLO window proper);
        None with no samples — an idle service neither meets nor misses."""
        now = time.monotonic() if now is None else now
        window_s = self.cfg.slo_window if window_s is None else window_s
        good, total = self._counts(window_s, now)
        return None if total == 0 else good / total

    def burn_rate(self, window_s: float, now: float | None = None) -> float | None:
        """Error-budget burn over the window: ``error_rate / (1 - target)``.
        1.0 spends exactly the budget; >1 is over-spend; None with no samples."""
        att = self.attainment(window_s, now=now)
        if att is None:
            return None
        return (1.0 - att) / (1.0 - self.cfg.target)

    def burn_rates(self, now: float | None = None) -> dict[str, float | None]:
        """``{window_label: burn_rate}`` for every configured window."""
        now = time.monotonic() if now is None else now
        return {
            window_label(w): self.burn_rate(w, now=now) for w in self.cfg.windows
        }

    def check_alert(self, now: float | None = None) -> dict[str, Any] | None:
        """Edge-detect the fast-burn alert: returns ``{"state": "firing" |
        "resolved", ...}`` exactly when the state changes, else None. Firing
        needs ``alert_min_samples`` in the fast window (one bad request on an
        idle replica is not an incident); an empty window resolves."""
        now = time.monotonic() if now is None else now
        good, total = self._counts(self.cfg.fast_window, now)
        burn = None
        if total:
            burn = (1.0 - good / total) / (1.0 - self.cfg.target)
        firing = (
            burn is not None
            and total >= self.cfg.alert_min_samples
            and burn >= self.cfg.alert_burn_rate
        )
        with self._lock:
            if firing == self._alerting:
                return None
            self._alerting = firing
        return {
            "state": "firing" if firing else "resolved",
            "window": window_label(self.cfg.fast_window),
            "burn_rate": None if burn is None else round(burn, 3),
            "attainment": None if not total else round(good / total, 6),
            "target": self.cfg.target,
        }

    @property
    def alerting(self) -> bool:
        with self._lock:
            return self._alerting

    def status(self, now: float | None = None) -> dict[str, Any]:
        """The ``/v1/stats`` slice: objective, lifetime counters, per-window
        attainment/burn, alert state."""
        now = time.monotonic() if now is None else now
        windows: dict[str, Any] = {}
        for w in self.cfg.windows:
            good, total = self._counts(w, now)
            att = None if total == 0 else good / total
            windows[window_label(w)] = {
                "attainment": None if att is None else round(att, 6),
                "burn_rate": (
                    None if att is None
                    else round((1.0 - att) / (1.0 - self.cfg.target), 3)
                ),
                "total": total,
            }
        with self._lock:
            good_l, total_l = self._good_lifetime, self._total_lifetime
        return {
            "target": self.cfg.target,
            "objective_latency_s": self.cfg.latency_s,
            "lifetime": {
                "good": good_l,
                "total": total_l,
                "attainment": None if total_l == 0 else round(good_l / total_l, 6),
            },
            "windows": windows,
            "alerting": self.alerting,
        }


def attainment_from_events(
    events: Iterable[dict],
    windows: Iterable[float] = (60.0, 300.0, 3600.0),
    target: float | None = None,
) -> dict[str, Any] | None:
    """Offline SLO rollup over logged ``serve_request`` events (the archive
    half of the live gauges — ``ddr metrics summarize``'s SLO section).

    Goodness comes from each event's ``slo_ok`` field when the serving layer
    stamped one, else ``status == "ok"`` (pre-tracing logs). Windows trail the
    LAST event's wall clock. ``target`` (when known — the run_end rollup
    carries it) adds burn rates. Returns None with no usable events.
    """
    samples: list[tuple[float, bool]] = []
    for e in events:
        if e.get("event") != "serve_request":
            continue
        wall = e.get("wall")
        if wall is None:
            continue
        ok = e.get("slo_ok")
        good = bool(ok) if ok is not None else (e.get("status") == "ok")
        samples.append((float(wall), good))
    if not samples:
        return None
    end = max(w for w, _ in samples)
    total = len(samples)
    good_n = sum(1 for _, g in samples if g)
    have_target = target is not None and 0.0 < float(target) < 1.0
    out: dict[str, Any] = {
        "good": good_n,
        "total": total,
        "attainment": good_n / total,
        "windows": {},
    }
    if have_target:
        out["target"] = float(target)
        out["burn_rate"] = (1.0 - out["attainment"]) / (1.0 - float(target))
    for w in sorted({float(w) for w in windows}):
        sel = [g for t, g in samples if t > end - w]
        if not sel:
            continue
        att = sum(sel) / len(sel)
        entry: dict[str, Any] = {"attainment": att, "total": len(sel)}
        if have_target:
            entry["burn_rate"] = (1.0 - att) / (1.0 - float(target))
        out["windows"][window_label(w)] = entry
    return out
