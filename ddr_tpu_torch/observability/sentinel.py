"""Runtime performance sentinel: streaming anomaly detection and bottleneck
attribution.

The port's copy of ``ddr_tpu/observability/sentinel.py`` (host-side
arithmetic over scalars the caller already holds; standard library only):

- **Streaming change-point detection** (:class:`EwmaCusumDetector`,
  :class:`Sentinel`): self-calibrating EWMA + two-sided CUSUM detectors over
  a run's own signals (step phases, cadence, throughput, queue depth, shed
  rate, p99 latency, heartbeat gaps). The first ``warmup`` samples of a
  signal fix its baseline (Welford mean and variance, with a noise floor so
  a near-constant warmup cannot give a hair-trigger sigma); after that the
  EWMA-smoothed residual feeds a two-sided CUSUM, and a crossing of the
  decision threshold fires one bounded ``anomaly`` event per episode;
  ``hysteresis`` consecutive in-band samples resolve it, so a noisy signal
  cannot flap. Transitions update the ``ddr_anomaly_active{signal}`` gauge
  and the ``ddr_anomalies_total{signal}`` counter through the event tee.
- **Overlap-aware bottleneck attribution** (:func:`classify_step`,
  :class:`BottleneckAttributor`, :func:`attribute_steps`): from a step's
  phases and its loop wall ``loop_s``, device idle time is ``loop_s -
  device_step``; a critical-path model classifies each step data-bound,
  host-bound, device-bound or checkpoint-bound and the rollup names the
  stage that owns the run's wall and the knob that moves it.

The train loop feeds a ``train``-scoped :class:`Sentinel` once a step
(:meth:`Sentinel.observe_step`) and once a heartbeat, and puts its
``pipeline`` verdict and ``sentinel`` status on ``run_end``; the service
sweeps a ``serve``-scoped one (``stats()["sentinel"]``); the fleet router
builds a fleet-scoped one over its replicas' probed queue depths
(:mod:`ddr_tpu_torch.fleet.router`); ``ddr obs bottleneck`` replays a run
log through :func:`attribute_steps`. Knobs are the ``DDR_SENTINEL_*``
family (:class:`SentinelConfig`).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
import time
from typing import Any, Callable

log = logging.getLogger(__name__)

__all__ = [
    "BOTTLENECK_CLASSES",
    "SENTINEL_SIGNALS",
    "SentinelConfig",
    "EwmaCusumDetector",
    "Sentinel",
    "BottleneckAttributor",
    "classify_step",
    "attribute_steps",
    "recommendations",
    "render_attribution",
]

_ENV_PREFIX = "DDR_SENTINEL_"
_FALSEY = ("0", "false", "no", "off")

#: z-score clamp: a 200 ms stall on a 2 ms baseline is thousands of σ; the
#: CUSUM only needs "way past the threshold", and an unclamped accumulator
#: would take as many steps to drain as the excursion was tall.
_Z_CAP = 50.0

#: Directionality of the stock signals: for everything timed/queued, *up* is
#: degradation; throughput degrades *down*. Unknown signals default to "high"
#: (callers can override per :meth:`Sentinel.observe` call).
SENTINEL_SIGNALS = {
    "data_load": "high",
    "host_prep": "high",
    "device_step": "high",
    "checkpoint": "high",
    "step_seconds": "high",
    "throughput": "low",
    "compile_rate": "high",
    "heartbeat_gap_s": "high",
    "queue_depth": "high",
    "shed_rate": "high",
    "serve_p99_s": "high",
}


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Detector + attribution knobs (env var in parentheses; defaults are
    calibrated for "fire on a sustained multi-σ shift, never on one noisy
    sample")."""

    #: Master switch (DDR_SENTINEL_ENABLED; 0/false/no/off disables).
    enabled: bool = True
    #: Baseline-calibration samples per signal before a detector may fire
    #: (DDR_SENTINEL_WARMUP). The warmup window IS the self-calibration: it
    #: freezes the signal's mean/σ, so the first compile-heavy steps should
    #: be inside it.
    warmup: int = 20
    #: EWMA smoothing factor for the observed value (DDR_SENTINEL_EWMA_ALPHA,
    #: in (0, 1]; 1 = no smoothing). Smoothing is what keeps one scheduler
    #: hiccup from counting as a level shift.
    ewma_alpha: float = 0.4
    #: CUSUM per-sample slack in σ units (DDR_SENTINEL_CUSUM_K): residuals
    #: inside ±k·σ of baseline accumulate nothing.
    cusum_k: float = 0.5
    #: CUSUM decision threshold in σ units (DDR_SENTINEL_CUSUM_H): the
    #: accumulated excess that fires an anomaly episode.
    cusum_h: float = 10.0
    #: Consecutive in-band samples required to resolve a firing episode
    #: (DDR_SENTINEL_HYSTERESIS) — the anti-flap gate.
    hysteresis: int = 5
    #: σ noise floor as a fraction of |baseline mean|
    #: (DDR_SENTINEL_MIN_SIGMA_FRAC): a warmup of near-identical samples
    #: would otherwise calibrate σ≈0 and fire on scheduler jitter.
    min_sigma_frac: float = 0.15
    #: Bounded ``anomaly`` event budget per sentinel instance
    #: (DDR_SENTINEL_MAX_EVENTS); transitions past it still update gauges but
    #: write no events (the cap is what keeps a pathological run's log
    #: bounded).
    max_events: int = 64
    #: Bottleneck classifier: device idle share of ``loop_s`` above which a
    #: step is NOT device-bound (DDR_SENTINEL_IDLE_FRAC).
    idle_frac: float = 0.25
    #: Serving sweep cadence in seconds (DDR_SENTINEL_SWEEP_S): queue depth /
    #: shed rate / p99 are sampled per sweep, not per request.
    sweep_s: float = 5.0
    #: Whether sustained serving anomalies flag the
    #: :class:`~ddr_tpu_torch.observability.health.HealthWatchdog` — and thereby
    #: degrade ``/readyz`` (DDR_SENTINEL_FLAG_WATCHDOG; off by default:
    #: a perf regression is an alert, not automatically an outage).
    flag_watchdog: bool = False
    #: Consecutive sweeps with an active anomaly before the watchdog is
    #: flagged (DDR_SENTINEL_FLAG_AFTER).
    flag_after: int = 3

    def __post_init__(self) -> None:
        if self.warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {self.warmup}")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError(f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        if self.cusum_k < 0:
            raise ValueError(f"cusum_k must be >= 0, got {self.cusum_k}")
        if self.cusum_h <= 0:
            raise ValueError(f"cusum_h must be > 0, got {self.cusum_h}")
        if self.hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {self.hysteresis}")
        if self.min_sigma_frac < 0:
            raise ValueError(
                f"min_sigma_frac must be >= 0, got {self.min_sigma_frac}"
            )
        if self.max_events < 0:
            raise ValueError(f"max_events must be >= 0, got {self.max_events}")
        if not (0.0 <= self.idle_frac < 1.0):
            raise ValueError(f"idle_frac must be in [0, 1), got {self.idle_frac}")
        if self.sweep_s < 0:
            raise ValueError(f"sweep_s must be >= 0, got {self.sweep_s}")
        if self.flag_after < 1:
            raise ValueError(f"flag_after must be >= 1, got {self.flag_after}")

    @classmethod
    def from_env(cls, environ: dict | None = None, **overrides) -> "SentinelConfig":
        """Defaults < ``DDR_SENTINEL_*`` environment < explicit overrides
        (the HealthConfig convention)."""
        env = os.environ if environ is None else environ

        def _get(name: str, cast):
            raw = env.get(_ENV_PREFIX + name)
            if raw is None or raw == "":
                return None
            try:
                return cast(raw)
            except ValueError as e:
                raise ValueError(f"bad {_ENV_PREFIX}{name}={raw!r}: {e}") from e

        from_env: dict = {}
        for key, var, cast in (
            ("enabled", "ENABLED", lambda s: s.strip().lower() not in _FALSEY),
            ("warmup", "WARMUP", int),
            ("ewma_alpha", "EWMA_ALPHA", float),
            ("cusum_k", "CUSUM_K", float),
            ("cusum_h", "CUSUM_H", float),
            ("hysteresis", "HYSTERESIS", int),
            ("min_sigma_frac", "MIN_SIGMA_FRAC", float),
            ("max_events", "MAX_EVENTS", int),
            ("idle_frac", "IDLE_FRAC", float),
            ("sweep_s", "SWEEP_S", float),
            ("flag_watchdog", "FLAG_WATCHDOG",
             lambda s: s.strip().lower() not in _FALSEY),
            ("flag_after", "FLAG_AFTER", int),
        ):
            v = _get(var, cast)
            if v is not None:
                from_env[key] = v
        from_env.update(overrides)
        return cls(**from_env)


class EwmaCusumDetector:
    """One signal's streaming change-point detector.

    Lifecycle per sample (:meth:`observe`): during the first ``warmup``
    samples the baseline mean/variance accumulates (Welford) and nothing can
    fire. At warmup's end μ₀/σ freeze (σ floored at
    ``min_sigma_frac · |μ₀|``). After that each sample updates an EWMA of the
    observed value; its residual in σ units (clamped to ±50) drives the
    classic two-sided CUSUM recursion ``S⁺ = max(0, S⁺ + z − k)`` /
    ``S⁻ = max(0, S⁻ − z − k)``. Crossing ``h`` fires ONE ``firing``
    transition for the whole episode (``onset_step`` is the first sample of
    the excursion that crossed, not the crossing itself); while firing,
    ``hysteresis`` consecutive in-band samples (|z| ≤ k) produce the one
    ``resolved`` transition and re-arm the detector.

    ``direction`` restricts which side may fire: ``"high"`` (degradation is
    up: latencies, queue depth), ``"low"`` (degradation is down: throughput),
    or ``"both"``. Not thread-safe — :class:`Sentinel` serializes access.
    """

    def __init__(
        self,
        signal: str,
        config: SentinelConfig | None = None,
        direction: str = "high",
    ) -> None:
        if direction not in ("high", "low", "both"):
            raise ValueError(f"direction must be high|low|both, got {direction!r}")
        self.signal = signal
        self.config = config or SentinelConfig()
        self.direction = direction
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._mu0: float | None = None
        self._sigma: float | None = None
        self._ewma: float | None = None
        self._s_hi = 0.0
        self._s_lo = 0.0
        self.firing = False
        self._side: str | None = None
        self._onset_step: Any = None
        self._in_band = 0
        self.episodes = 0

    def observe(self, value: float, step: Any = None) -> dict | None:
        """Fold one sample; return the transition dict (``state`` ∈
        ``firing``/``resolved``) when this sample changes the episode state,
        else None. Non-finite samples are dropped."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            return None
        if not math.isfinite(v):
            return None
        cfg = self.config
        self._n += 1
        if self._mu0 is None:
            # self-calibration window: Welford mean/variance, nothing fires
            delta = v - self._mean
            self._mean += delta / self._n
            self._m2 += delta * (v - self._mean)
            if self._n >= cfg.warmup:
                self._mu0 = self._mean
                var = self._m2 / max(1, self._n - 1)
                floor = cfg.min_sigma_frac * abs(self._mu0)
                self._sigma = max(math.sqrt(max(0.0, var)), floor, 1e-12)
                self._ewma = self._mean
            return None
        alpha = cfg.ewma_alpha
        self._ewma = alpha * v + (1.0 - alpha) * self._ewma  # type: ignore[operator]
        z = (self._ewma - self._mu0) / self._sigma  # type: ignore[operator]
        z = max(-_Z_CAP, min(_Z_CAP, z))
        if self.firing:
            # hysteresis: only a sustained return to band resolves the episode
            self._in_band = self._in_band + 1 if abs(z) <= cfg.cusum_k else 0
            if self._in_band < cfg.hysteresis:
                return None
            self.firing = False
            side, self._side = self._side, None
            self._s_hi = self._s_lo = 0.0
            self._in_band = 0
            return self._transition("resolved", side, step)
        was_idle = self._s_hi == 0.0 and self._s_lo == 0.0
        if self.direction in ("high", "both"):
            self._s_hi = max(0.0, self._s_hi + z - cfg.cusum_k)
        if self.direction in ("low", "both"):
            self._s_lo = max(0.0, self._s_lo - z - cfg.cusum_k)
        if was_idle and (self._s_hi > 0.0 or self._s_lo > 0.0):
            self._onset_step = step  # first sample of the current excursion
        if self._s_hi == 0.0 and self._s_lo == 0.0:
            self._onset_step = None
        if self._s_hi <= cfg.cusum_h and self._s_lo <= cfg.cusum_h:
            return None
        self.firing = True
        self.episodes += 1
        self._side = "high" if self._s_hi > cfg.cusum_h else "low"
        self._in_band = 0
        return self._transition("firing", self._side, step)

    def _transition(self, state: str, side: str | None, step: Any) -> dict:
        return {
            "signal": self.signal,
            "state": state,
            "side": side,
            "baseline": round(float(self._mu0), 6),  # type: ignore[arg-type]
            "observed": round(float(self._ewma), 6),  # type: ignore[arg-type]
            "sigma": round(float(self._sigma), 6),  # type: ignore[arg-type]
            "onset_step": self._onset_step if self._onset_step is not None else step,
            "step": step,
            "episodes": self.episodes,
        }

    def snapshot(self) -> dict:
        """The detector's current state for status rollups."""
        out: dict[str, Any] = {
            "samples": self._n,
            "firing": self.firing,
            "episodes": self.episodes,
            "direction": self.direction,
        }
        if self._mu0 is not None:
            out["baseline"] = round(self._mu0, 6)
            out["sigma"] = round(self._sigma, 6)  # type: ignore[arg-type]
            out["observed"] = round(self._ewma, 6)  # type: ignore[arg-type]
        else:
            out["warming_up"] = True
        return out


# ---------------------------------------------------------------------------
# Bottleneck attribution: the overlap-aware critical-path model.
# ---------------------------------------------------------------------------

#: The classifier's vocabulary, in verdict tie-break order (an actionable
#: input-pipeline diagnosis beats "the device is busy", which is the healthy
#: state, not a finding).
BOTTLENECK_CLASSES = ("data_bound", "host_bound", "checkpoint_bound", "device_bound")

_CLASS_OF_PHASE = {
    "data_load": "data_bound",
    "host_prep": "host_bound",
    "eval": "host_bound",
    "checkpoint": "checkpoint_bound",
}

#: verdict -> concrete knob moves, most actionable first (the JAX package's
#: text, word for word).
_RECOMMENDATIONS = {
    "data_bound": [
        "raise experiment.prefetch_ahead — deepen the prefetch pool so "
        "data_load overlaps the device step (watch ddr_prefetch_depth: "
        "a pool pinned at 0 is starved)",
        "check forcing-read throughput (remote zarr/NetCDF latency, "
        "DDR_IO_RETRIES churn) — data_load wall is dominated by the reads",
    ],
    "host_bound": [
        "raise experiment.prefetch_ahead so host_prep runs further ahead of "
        "the device step (it is thread-parallel past ahead=1)",
        "profile host_prep: graph-schedule builds and collate work dominate; "
        "shrink batch topology churn so the step cache hits",
    ],
    "checkpoint_bound": [
        "turn on the async checkpoint writer (DDR_CKPT_ASYNC=1) so saves "
        "leave the step path",
        "save less often or prune more aggressively (DDR_CKPT_KEEP)",
    ],
    "device_bound": [
        "healthy: the device is the critical path — raise batch size or let "
        "`ddr tune` pick a faster engine to spend that time better",
    ],
    "unknown": [
        "idle loop time is unattributed — bracket remaining host work with "
        "PhaseTimer phases so the critical-path model can see it",
    ],
}


def recommendations(verdict: str | None) -> list[str]:
    """Concrete knob moves for a pipeline verdict (empty for None)."""
    if verdict is None:
        return []
    return list(_RECOMMENDATIONS.get(verdict, []))


def _num(v: Any) -> float | None:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def classify_step(
    phases: dict | None, loop_s: float | None = None, idle_frac: float = 0.25
) -> str:
    """Classify one step's critical path from its ``phases`` dict (and, when
    recorded, its full loop wall ``loop_s``).

    With ``loop_s`` the model is overlap-aware: device idle =
    ``loop_s − device_step``. Idle at or below ``idle_frac`` of the loop means
    the prefetch pipeline kept the device fed — device-bound regardless of how
    large the (overlapped) host buckets were. Larger idle is attributed to the
    largest host-side bucket (data_load → data-bound, host_prep/eval →
    host-bound, checkpoint → checkpoint-bound). Without ``loop_s`` (older
    logs) the largest bucket wins outright, device winning ties.
    """
    p = {k: f for k, v in (phases or {}).items() if (f := _num(v)) is not None}
    device = p.get("device_step", 0.0)
    buckets = {
        cls: sum(p.get(ph, 0.0) for ph, c in _CLASS_OF_PHASE.items() if c == cls)
        for cls in ("data_bound", "host_bound", "checkpoint_bound")
    }
    host_total = sum(buckets.values())
    loop = _num(loop_s)
    if loop is not None and loop > 0:
        idle = max(0.0, loop - device)
        if idle <= idle_frac * loop:
            return "device_bound"
        if host_total <= 0.0:
            return "unknown"
    else:
        if host_total <= 0.0 and device <= 0.0:
            return "unknown"
        if device >= max(buckets.values(), default=0.0):
            return "device_bound"
    return max(buckets, key=lambda c: (buckets[c], -BOTTLENECK_CLASSES.index(c)))


class BottleneckAttributor:
    """Streaming per-step classification -> per-run pipeline verdict.

    Fed once per step (:meth:`add`); :meth:`summary` is the ``run_end``
    ``pipeline`` rollup — class counts, stage seconds, overlap efficiency
    (Σ device_step / Σ loop wall, when ``loop_s`` was recorded), the modal
    verdict, and its knob recommendations. Thread-safe (serving and the train
    loop both feed from worker threads in principle).
    """

    def __init__(self, idle_frac: float = 0.25) -> None:
        self.idle_frac = float(idle_frac)
        self._lock = threading.Lock()
        self._classes: dict[str, int] = {}
        self._stage_s: dict[str, float] = {}
        self._loop_s = 0.0
        self._device_s = 0.0
        self._loop_steps = 0
        self._steps = 0

    def add(self, phases: dict | None, loop_s: float | None = None) -> str:
        cls = classify_step(phases, loop_s, idle_frac=self.idle_frac)
        loop = _num(loop_s)
        with self._lock:
            self._steps += 1
            self._classes[cls] = self._classes.get(cls, 0) + 1
            for ph, v in (phases or {}).items():
                f = _num(v)
                if f is not None:
                    self._stage_s[str(ph)] = self._stage_s.get(str(ph), 0.0) + f
            if loop is not None and loop > 0:
                self._loop_steps += 1
                self._loop_s += loop
                self._device_s += _num((phases or {}).get("device_step")) or 0.0
        return cls

    def summary(self) -> dict:
        with self._lock:
            classes = dict(self._classes)
            stage_s = {k: round(v, 6) for k, v in sorted(self._stage_s.items())}
            loop_s, device_s = self._loop_s, self._device_s
            loop_steps, steps = self._loop_steps, self._steps
        verdict = None
        scored = {c: n for c, n in classes.items() if c != "unknown"}
        if scored:
            verdict = max(
                scored, key=lambda c: (scored[c], -BOTTLENECK_CLASSES.index(c))
            )
        elif classes:
            verdict = "unknown"
        overlap = None
        if loop_steps:
            overlap = {
                "steps": loop_steps,
                "loop_s": round(loop_s, 6),
                "device_s": round(device_s, 6),
                "busy_frac": round(device_s / loop_s, 4) if loop_s > 0 else 0.0,
                "idle_s": round(max(0.0, loop_s - device_s), 6),
            }
        return {
            "steps": steps,
            "classes": classes,
            "verdict": verdict,
            "stage_seconds": stage_s,
            "overlap": overlap,
            "recommendations": recommendations(verdict),
        }


def attribute_steps(step_events: list[dict], idle_frac: float = 0.25) -> dict:
    """Replay recorded ``step`` events through the critical-path model — the
    entry point of a run-log replay (any run log, any age: events without
    ``phases`` are skipped, events without ``loop_s`` fall back to the
    non-overlap classifier)."""
    attr = BottleneckAttributor(idle_frac=idle_frac)
    for e in step_events:
        phases = e.get("phases")
        if isinstance(phases, dict):
            attr.add(phases, e.get("loop_s"))
    return attr.summary()


def render_attribution(result: dict) -> str:
    """The per-stage attribution table + verdict + knob recommendations as
    plain text."""
    lines: list[str] = []
    steps = result.get("steps", 0)
    lines.append(f"steps classified : {steps}")
    classes = result.get("classes") or {}
    if classes:
        width = max(len(c) for c in classes)
        for cls in (*BOTTLENECK_CLASSES, "unknown"):
            if cls in classes:
                n = classes[cls]
                share = 100.0 * n / steps if steps else 0.0
                lines.append(f"  {cls:<{width}}  {n:>6}  {share:5.1f}%")
    stage_s = result.get("stage_seconds") or {}
    if stage_s:
        width = max(len(s) for s in stage_s)
        lines.append("stage seconds    :")
        for ph, s in sorted(stage_s.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {ph:<{width}}  {s:10.3f}s")
    overlap = result.get("overlap")
    if overlap:
        lines.append(
            f"overlap          : device busy {100.0 * overlap['busy_frac']:.1f}% "
            f"of loop wall (idle {overlap['idle_s']:.3f}s of "
            f"{overlap['loop_s']:.3f}s over {overlap['steps']} steps)"
        )
    verdict = result.get("verdict")
    lines.append(f"pipeline verdict : {verdict or '(no classified steps)'}")
    recs = result.get("recommendations") or []
    if recs:
        lines.append("recommendations  :")
        lines.extend(f"  - {r}" for r in recs)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The sentinel: named detectors + bounded anomaly emission + attribution.
# ---------------------------------------------------------------------------


class Sentinel:
    """Per-run (or per-service / per-router) detector set.

    :meth:`observe` feeds one named signal sample; episode transitions emit
    one bounded ``anomaly`` event each — through ``emit`` when given (the
    serving layer passes its recorder-or-tee ``_emit``), else through the
    active recorder (whose hook tees the registry), else directly through
    :func:`~ddr_tpu_torch.observability.prometheus.event_tee` — exactly one path,
    so gauges never double-count. Thread-safe.
    """

    def __init__(
        self,
        config: SentinelConfig | None = None,
        scope: str = "train",
        registry: Any = None,
        emit: Callable[..., None] | None = None,
    ) -> None:
        self.config = config or SentinelConfig.from_env()
        self.scope = scope
        self._emit_fn = emit
        self._lock = threading.Lock()
        self._detectors: dict[str, EwmaCusumDetector] = {}
        self._events = 0
        self._suppressed = 0
        self._last_beat: float | None = None
        self._last_compiles: float | None = None
        self.attribution = BottleneckAttributor(idle_frac=self.config.idle_frac)
        if registry is None:
            from ddr_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self._registry = registry

    # ---- signal ingestion ----

    def observe(
        self, signal: str, value: Any, step: Any = None, direction: str | None = None
    ) -> dict | None:
        """Feed one sample of ``signal``; returns (and reports) the episode
        transition when this sample causes one."""
        if not self.config.enabled:
            return None
        with self._lock:
            det = self._detectors.get(signal)
            if det is None:
                det = EwmaCusumDetector(
                    signal,
                    self.config,
                    direction or SENTINEL_SIGNALS.get(signal, "high"),
                )
                self._detectors[signal] = det
            transition = det.observe(value, step=step)
        if transition is not None:
            self._report(transition)
        return transition

    def observe_step(
        self,
        step: Any,
        phases: dict | None = None,
        loop_s: float | None = None,
        seconds: float | None = None,
        rate: float | None = None,
        compiles: float | None = None,
    ) -> list[dict]:
        """The train loop's one call per step: feeds the per-phase detectors,
        step cadence, throughput, the compile-event rate (``compiles`` is the
        cumulative miss count; the detector sees per-step deltas), and the
        bottleneck attributor. Returns any transitions this step caused."""
        if not self.config.enabled:
            return []
        out: list[dict] = []
        for name in ("data_load", "host_prep", "device_step", "checkpoint"):
            v = _num((phases or {}).get(name))
            if v is not None:
                tr = self.observe(name, v, step=step)
                if tr:
                    out.append(tr)
        for name, v in (("step_seconds", seconds), ("throughput", rate)):
            f = _num(v)
            if f is not None and f > 0:
                tr = self.observe(name, f, step=step)
                if tr:
                    out.append(tr)
        c = _num(compiles)
        if c is not None:
            with self._lock:
                prev, self._last_compiles = self._last_compiles, c
            if prev is not None:
                tr = self.observe("compile_rate", max(0.0, c - prev), step=step)
                if tr:
                    out.append(tr)
        if phases is not None or loop_s is not None:
            self.attribution.add(phases, loop_s)
        return out

    def observe_heartbeat(self, now: float | None = None, step: Any = None) -> dict | None:
        """Feed the inter-heartbeat gap (monotonic seconds); a growing gap is
        the straggler/wedged-pipeline signature even when steps stop."""
        if not self.config.enabled:
            return None
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            prev, self._last_beat = self._last_beat, t
        if prev is None:
            return None
        return self.observe("heartbeat_gap_s", max(0.0, t - prev), step=step)

    # ---- reporting / rollups ----

    def _report(self, transition: dict) -> None:
        record = {**transition, "scope": self.scope}
        with self._lock:
            if self._events >= self.config.max_events:
                self._suppressed += 1
                over = True
            else:
                self._events += 1
                over = False
        try:
            if over:
                # event budget spent: keep the live gauges honest anyway
                # (direct tee only — nothing is written to the log)
                from ddr_tpu_torch.observability.prometheus import event_tee

                event_tee({"event": "anomaly", **record}, self._registry)
                return
            if self._emit_fn is not None:
                self._emit_fn("anomaly", **record)
                return
            from ddr_tpu_torch.observability.events import get_recorder

            rec = get_recorder()
            if rec is not None:
                rec.emit("anomaly", **record)
            else:
                from ddr_tpu_torch.observability.prometheus import event_tee

                event_tee({"event": "anomaly", **record}, self._registry)
        except Exception:
            log.exception("sentinel anomaly report failed")  # never the loop

    def active(self) -> list[str]:
        """Names of currently-firing signals (sorted)."""
        with self._lock:
            return sorted(s for s, d in self._detectors.items() if d.firing)

    def status(self) -> dict:
        """The rollup riding ``/v1/stats`` (serving) and ``run_end``."""
        with self._lock:
            signals = {s: d.snapshot() for s, d in sorted(self._detectors.items())}
            events, suppressed = self._events, self._suppressed
        return {
            "scope": self.scope,
            "active": [s for s, d in signals.items() if d.get("firing")],
            "episodes": sum(d.get("episodes", 0) for d in signals.values()),
            "signals": signals,
            "events": events,
            "suppressed": suppressed,
        }

    def pipeline_summary(self) -> dict:
        """The bottleneck attributor's rollup (the ``run_end`` ``pipeline``
        key — the per-run "pipeline verdict")."""
        return self.attribution.summary()
