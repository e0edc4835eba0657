"""Forecast verification: streaming CRPS, flood-threshold skill, and the
forecast-observation ledger.

The port's copy of ``ddr_tpu/observability/verification.py`` (numpy and the
standard library). It joins issued forecasts to observations that arrive
hours later and scores them as they come, with proper scoring rules
(Gneiting & Raftery 2007) and rank histograms (Hamill 2001). Both layers keep
running sums, never series, and run on the host:

- :class:`VerificationScorer` — the fair ensemble CRPS (the sorted-member
  estimator, O(E log E) a sample, with the member-pair term over ``E(E-1)``;
  the absolute error for E = 1), the Brier score with Murphy's reliability
  decomposition at per-gauge flood thresholds (``DDR_VERIFY_THRESHOLDS``:
  absolute discharges, or ``pNN`` climatological percentiles frozen from each
  gauge's first ``clim_samples`` observations), rank histograms with a
  chi-square flatness, and the spread-skill ratio, all by lead-time bin
  (``DDR_VERIFY_LEAD_BINS``). :func:`crps_ensemble`, :func:`brier_score` and
  :func:`rank_of_obs` are the offline references the sums must match to 1e-9.
- :class:`ForecastLedger` — issued forecasts in a bounded ring per (network,
  gauge) keyed by integer valid hour (oldest-first eviction), joined when
  observations arrive (``POST /v1/observe`` or :meth:`ForecastLedger.observe`)
  and fed to the scorer. Its rollup is the service's ``stats()["verification"]``.

The scorer writes the ``ddr_verify_crps``, ``ddr_verify_brier`` and
``ddr_verify_spread_skill`` histograms and the worst-K
``ddr_verify_worst_crps{gauge}`` gauges into the metrics registry directly.
Each join is also one ``verify`` event of the active run recorder (the join
counters, the caller's context and the scorer's bounded summary), which
``ddr verify <logdir>`` folds.

Valid times are integer hours: step ``i`` of a ``t0``-window forecast is
valid at hour ``t0 + 1 + i`` of the network's forcing, a ``q_prime``
forecast's at ``floor(unix / 3600) + 1 + i``. Gauge ids are the forecast's
output column indices as strings.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import re
import threading
from typing import Any, Sequence

import numpy as np

log = logging.getLogger(__name__)

__all__ = [
    "VERIFY_BRIER_BUCKETS",
    "VERIFY_CRPS_BUCKETS",
    "VERIFY_SPREAD_BUCKETS",
    "VerificationScorer",
    "VerifyConfig",
    "ForecastLedger",
    "brier_score",
    "crps_ensemble",
    "lead_bin_index",
    "lead_bin_labels",
    "parse_thresholds",
    "rank_of_obs",
]

_FALSEY = ("0", "false", "no", "off")

#: CRPS is in discharge units (m³/s) and non-negative; the interesting
#: structure spans decades, so the buckets are log-spaced (upper bounds;
#: +Inf implied).
VERIFY_CRPS_BUCKETS = (0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0)

#: Brier scores live in [0, 1]; 0.25 is the no-skill coin-flip mark.
VERIFY_BRIER_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.15, 0.25, 0.5, 0.75, 1.0)

#: Spread–skill ratios cluster around 1 (perfectly dispersed); the buckets
#: resolve under- (< 1) and over-dispersion (> 1) symmetrically in log space.
VERIFY_SPREAD_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 1.1, 1.25, 1.5, 2.0, 4.0)

#: Reliability-diagram probability bins (fixed — p ∈ [0, 1] in tenths). A
#: structural constant, not a knob: the decomposition sums are only
#: mergeable/comparable across runs when every run bins identically.
N_PROB_BINS = 10

#: ``pNN``/``pNN.N`` climatological-percentile threshold token.
_PCT_RE = re.compile(r"^p(\d+(?:\.\d+)?)$")


# ---------------------------------------------------------------------------
# Offline reference scorers (pure functions — the unit tests' ground truth,
# and the exact math the streaming sums accumulate).
# ---------------------------------------------------------------------------


def crps_ensemble(members: np.ndarray, obs: np.ndarray, fair: bool = True) -> np.ndarray:
    """Exact ensemble CRPS per sample, vectorized over trailing axes.

    ``members`` is ``(E, ...)``, ``obs`` broadcasts against ``members[0]``.
    The sorted-member form computes the member-pair term in O(E log E):
    with ascending ``x_(0..E-1)``, ``Σ_{i<j}(x_(j) - x_(i)) =
    Σ_k x_(k)(2k - E + 1)``, so

    ``CRPS = mean_i |x_i - y| - pairsum / D``

    with ``D = E²`` (the plain empirical-CDF estimator) or ``D = E(E-1)``
    (``fair=True`` — Ferro's unbiased-against-ensemble-size correction).
    E=1 degenerates to ``|x - y|`` (MAE) under both conventions."""
    m = np.sort(np.asarray(members, dtype=np.float64), axis=0)
    obs = np.asarray(obs, dtype=np.float64)
    E = m.shape[0]
    term1 = np.mean(np.abs(m - obs[None, ...]), axis=0)
    if E == 1:
        return term1
    coef = (2.0 * np.arange(E) - E + 1.0).reshape((E,) + (1,) * (m.ndim - 1))
    pairsum = np.sum(coef * m, axis=0)  # Σ_{i<j} (x_(j) - x_(i))
    denom = float(E * (E - 1)) if fair else float(E * E)
    return term1 - pairsum / denom


def brier_score(p: np.ndarray, o: np.ndarray) -> float:
    """Mean squared probability error ``mean((p - o)²)`` — the reference the
    streaming ``Σ(p-o)²`` sum reproduces exactly."""
    p = np.asarray(p, dtype=np.float64).ravel()
    o = np.asarray(o, dtype=np.float64).ravel()
    return float(np.mean((p - o) ** 2))


def rank_of_obs(members: np.ndarray, obs: np.ndarray) -> np.ndarray:
    """The observation's rank among the E members: the count of members
    strictly below it, in ``[0, E]``. Ties count LOW (deterministic — no
    random tie-breaking), which biases rank-0 under heavily tied degenerate
    ensembles; real discharge members are continuous, so ties are measure
    zero there."""
    members = np.asarray(members, dtype=np.float64)
    obs = np.asarray(obs, dtype=np.float64)
    return (members < obs[None, ...]).sum(axis=0).astype(np.int64)


def lead_bin_labels(edges: Sequence[float]) -> tuple[str, ...]:
    """Human labels for the lead bins ``[0, e0), [e0, e1), ..., [e_last, ∞)``."""
    edges = [float(e) for e in edges]
    labels = []
    prev = 0.0
    for e in edges:
        labels.append(f"{prev:g}-{e:g}h")
        prev = e
    labels.append(f"{prev:g}h+")
    return tuple(labels)


def lead_bin_index(lead_h: np.ndarray, edges: Sequence[float]) -> np.ndarray:
    """Bin index per lead hour: ``searchsorted`` over the upper-bound edges,
    so a lead exactly AT an edge lands in the bin the edge opens (edges are
    half-open upper bounds — lead 6 with edges (6, 24) is in "6-24h")."""
    return np.searchsorted(np.asarray(edges, dtype=np.float64),
                           np.asarray(lead_h, dtype=np.float64), side="right")


def parse_thresholds(spec: str | Sequence[str]) -> tuple[tuple[str, str, float], ...]:
    """``DDR_VERIFY_THRESHOLDS`` tokens -> ``(label, kind, value)`` triples:
    a float literal is an absolute discharge threshold (``("5.0", "abs",
    5.0)``), ``pNN`` a climatological percentile (``("p90", "pct", 90.0)``).
    Malformed tokens raise — a silently dropped flood threshold is exactly
    the quiet failure this plane exists to prevent."""
    tokens = (
        [t.strip() for t in spec.split(",")] if isinstance(spec, str) else
        [str(t).strip() for t in spec]
    )
    out: list[tuple[str, str, float]] = []
    for tok in tokens:
        if not tok:
            continue
        m = _PCT_RE.match(tok)
        if m:
            q = float(m.group(1))
            if not 0.0 < q < 100.0:
                raise ValueError(f"percentile threshold {tok!r} must be in (0, 100)")
            out.append((tok, "pct", q))
            continue
        try:
            v = float(tok)
        except ValueError:
            raise ValueError(
                f"bad threshold token {tok!r} (want a discharge value or pNN)"
            ) from None
        if not math.isfinite(v) or v < 0:
            raise ValueError(f"absolute threshold {tok!r} must be finite and >= 0")
        out.append((tok, "abs", v))
    if len({t[0] for t in out}) != len(out):
        raise ValueError(f"duplicate threshold tokens in {spec!r}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class VerifyConfig:
    """Verification knobs (env var in parentheses)."""

    #: Master switch (DDR_VERIFY_ENABLED; 0/false/no/off disables).
    enabled: bool = True
    #: Flood-threshold tokens for the Brier scorers (DDR_VERIFY_THRESHOLDS,
    #: comma list): absolute discharge values and/or ``pNN`` climatological
    #: percentiles (resolved per gauge; see :class:`VerificationScorer`).
    thresholds: tuple[str, ...] = ("p90",)
    #: Lead-time bin edges in hours, strictly increasing (DDR_VERIFY_LEAD_BINS,
    #: comma list). Bins are ``[0, e0), [e0, e1), ..., [e_last, ∞)``.
    lead_bins_h: tuple[float, ...] = (6.0, 24.0, 72.0)
    #: Pending (unmatched) valid times retained per (network, gauge) before
    #: deterministic oldest-first eviction (DDR_VERIFY_LEDGER_CAP).
    ledger_cap: int = 256
    #: Worst-gauge set size for events + the per-gauge
    #: ``ddr_verify_worst_crps`` series cap (DDR_VERIFY_TOPK).
    top_k: int = 8
    #: Matched samples a gauge needs before its CRPS enters summaries and the
    #: worst set (DDR_VERIFY_MIN_SAMPLES).
    min_samples: int = 2
    #: Per-gauge climatology buffer: the first N observations define the
    #: ``pNN`` percentile thresholds, frozen once full
    #: (DDR_VERIFY_CLIM_SAMPLES). Percentile Brier scoring for a gauge starts
    #: once it holds ``min_clim`` values.
    clim_samples: int = 256
    #: Minimum climatology values before a percentile threshold resolves
    #: (DDR_VERIFY_MIN_CLIM).
    min_clim: int = 8

    def __post_init__(self) -> None:
        parse_thresholds(self.thresholds)  # raises on malformed tokens
        edges = tuple(float(e) for e in self.lead_bins_h)
        if any(e <= 0 for e in edges) or any(
            b <= a for a, b in zip(edges, edges[1:])
        ):
            raise ValueError(
                f"lead_bins_h must be positive and strictly increasing, got {edges}"
            )
        object.__setattr__(self, "lead_bins_h", edges)
        object.__setattr__(
            self, "thresholds", tuple(str(t) for t in self.thresholds)
        )
        if self.ledger_cap < 1:
            raise ValueError(f"ledger_cap must be >= 1, got {self.ledger_cap}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {self.min_samples}")
        if self.min_clim < 2:
            raise ValueError(f"min_clim must be >= 2, got {self.min_clim}")
        if self.clim_samples < self.min_clim:
            raise ValueError(
                f"clim_samples ({self.clim_samples}) must be >= min_clim "
                f"({self.min_clim})"
            )

    @classmethod
    def from_env(cls, environ: dict | None = None, **overrides) -> "VerifyConfig":
        """Defaults < ``DDR_VERIFY_*`` environment < explicit ``overrides``."""
        env = os.environ if environ is None else environ
        from_env: dict = {}
        raw = env.get("DDR_VERIFY_ENABLED")
        if raw not in (None, ""):
            from_env["enabled"] = raw.strip().lower() not in _FALSEY
        raw = env.get("DDR_VERIFY_THRESHOLDS")
        if raw not in (None, ""):
            from_env["thresholds"] = tuple(
                t.strip() for t in raw.split(",") if t.strip()
            )
        raw = env.get("DDR_VERIFY_LEAD_BINS")
        if raw not in (None, ""):
            try:
                from_env["lead_bins_h"] = tuple(
                    float(t) for t in raw.split(",") if t.strip()
                )
            except ValueError as e:
                raise ValueError(f"bad DDR_VERIFY_LEAD_BINS={raw!r}: {e}") from e
        for key, var in (
            ("ledger_cap", "DDR_VERIFY_LEDGER_CAP"),
            ("top_k", "DDR_VERIFY_TOPK"),
            ("min_samples", "DDR_VERIFY_MIN_SAMPLES"),
            ("clim_samples", "DDR_VERIFY_CLIM_SAMPLES"),
            ("min_clim", "DDR_VERIFY_MIN_CLIM"),
        ):
            raw = env.get(var)
            if raw not in (None, ""):
                try:
                    from_env[key] = int(raw)
                except ValueError as e:
                    raise ValueError(f"bad {var}={raw!r}: {e}") from e
        from_env.update(overrides)
        return cls(**from_env)


# ---------------------------------------------------------------------------
# The streaming scorer.
# ---------------------------------------------------------------------------

#: Per-lead-bin accumulator layout:
#: [n, Σcrps, Σcrps², Σ(ens_mean-obs)², n_spread, Σ ens_var].
_N_BIN_SUMS = 6

#: Per-gauge accumulator layout: [n, Σcrps].
_N_GAUGE_SUMS = 2


class VerificationScorer:
    """Streaming probabilistic verification over matched (forecast, obs)
    samples. One sample = one (gauge, valid time) pair with its E-member
    forecast vector and the observed value. Thread-safe; numpy-only.

    Everything accumulates into fixed-size running sums — per lead bin, per
    threshold × lead bin × probability bin, per ensemble size (rank
    histograms), plus a per-gauge ``[n, Σcrps]`` table for the worst-K set.
    No sample is ever retained; memory is O(gauges + bins + thresholds)."""

    def __init__(
        self, config: VerifyConfig | None = None, registry: Any = None
    ) -> None:
        self.config = config or VerifyConfig.from_env()
        self._thresholds = parse_thresholds(self.config.thresholds)
        self._edges = tuple(self.config.lead_bins_h)
        self._labels = lead_bin_labels(self._edges)
        n_bins = len(self._labels)
        self._lock = threading.Lock()
        # per-lead-bin streaming sums
        self._bin_sums = np.zeros((n_bins, _N_BIN_SUMS), dtype=np.float64)
        # rank histograms: ensemble size E -> (n_bins, E + 1) counts
        self._ranks: dict[int, np.ndarray] = {}
        # Brier sums per threshold: label -> dict of
        #   n (n_bins,), sse (n_bins,), so (n_bins,),
        #   bins (n_bins, N_PROB_BINS, 3) = [count, Σp, Σo] per prob bin
        self._brier: dict[str, dict[str, np.ndarray]] = {
            label: {
                "n": np.zeros(n_bins),
                "sse": np.zeros(n_bins),
                "so": np.zeros(n_bins),
                "bins": np.zeros((n_bins, N_PROB_BINS, 3)),
            }
            for label, _, _ in self._thresholds
        }
        # per-gauge [n, Σcrps] + climatology buffers for pct thresholds
        self._gauges: dict[str, int] = {}
        self._gauge_sums = np.zeros((0, _N_GAUGE_SUMS), dtype=np.float64)
        self._clim: dict[str, list[float]] = {}
        self._updates = 0
        self._samples = 0
        self._nonfinite = 0  # samples skipped for non-finite members/obs
        self._last_summary: dict[str, Any] | None = None
        self._exported_worst: set[str] = set()
        if registry is None:
            from ddr_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self._registry = registry
        self._crps_hist = registry.histogram(
            "ddr_verify_crps",
            "Fair ensemble CRPS per matched (gauge, valid-time) sample "
            "(discharge units)",
            buckets=VERIFY_CRPS_BUCKETS,
        )
        self._brier_hist = registry.histogram(
            "ddr_verify_brier",
            "Per-sample squared probability error at one flood threshold "
            "(the threshold label is the DDR_VERIFY_THRESHOLDS token)",
            labels=("threshold",),
            buckets=VERIFY_BRIER_BUCKETS,
        )
        self._spread_hist = registry.histogram(
            "ddr_verify_spread_skill",
            "Spread-skill ratio (fair mean ensemble spread / ensemble-mean "
            "RMSE) per verification update",
            buckets=VERIFY_SPREAD_BUCKETS,
        )
        self._worst_gauge = registry.gauge(
            "ddr_verify_worst_crps",
            "Mean CRPS of the current worst-K gauges (series capped at K; "
            "gauges leaving the worst set are removed)",
            labels=("gauge",),
        )

    # ---- accumulation ----

    @property
    def lead_labels(self) -> tuple[str, ...]:
        return self._labels

    def _gauge_rows(self, gauge_ids: Sequence[str]) -> np.ndarray:
        rows = np.empty(len(gauge_ids), dtype=np.int64)
        new = 0
        for i, gid in enumerate(gauge_ids):
            key = str(gid)
            row = self._gauges.get(key)
            if row is None:
                row = len(self._gauges)
                self._gauges[key] = row
                new += 1
            rows[i] = row
        if new:
            self._gauge_sums = np.vstack(
                [self._gauge_sums, np.zeros((new, _N_GAUGE_SUMS))]
            )
        return rows

    def _resolve_thresholds(
        self, kind: str, value: float, gauge_ids: Sequence[str]
    ) -> np.ndarray:
        """Per-sample threshold values (NaN = not yet resolvable). Absolute
        tokens apply one value everywhere; percentile tokens resolve from
        each gauge's climatology buffer (NaN until it holds ``min_clim``
        observations — those samples are excluded from that threshold's
        Brier sums, never scored against a placeholder)."""
        if kind == "abs":
            return np.full(len(gauge_ids), value)
        out = np.full(len(gauge_ids), np.nan)
        for i, gid in enumerate(gauge_ids):
            clim = self._clim.get(str(gid))
            if clim is not None and len(clim) >= self.config.min_clim:
                out[i] = np.percentile(np.asarray(clim), value)
        return out

    def update_samples(
        self,
        members: np.ndarray,
        obs: np.ndarray,
        lead_h: np.ndarray,
        gauge_ids: Sequence[Any],
    ) -> int:
        """Fold S matched samples into the streaming sums and mirror the
        registry. ``members`` is ``(E, S)`` (uniform E — the ledger groups by
        ensemble size), ``obs``/``lead_h`` are ``(S,)``, ``gauge_ids`` has S
        entries (repeats fine). Samples with any non-finite member or obs are
        counted and skipped. Returns the number of samples scored."""
        if not self.config.enabled:
            return 0
        members = np.atleast_2d(np.asarray(members, dtype=np.float64))
        obs = np.asarray(obs, dtype=np.float64).ravel()
        lead_h = np.asarray(lead_h, dtype=np.float64).ravel()
        S = obs.shape[0]
        if members.shape[1] != S or lead_h.shape[0] != S or len(gauge_ids) != S:
            raise ValueError(
                f"shape mismatch: members {members.shape}, obs {obs.shape}, "
                f"lead {lead_h.shape}, {len(gauge_ids)} gauge ids"
            )
        E = members.shape[0]
        gauge_ids = [str(g) for g in gauge_ids]
        valid = np.isfinite(obs) & np.isfinite(members).all(axis=0)
        n_bad = int(S - valid.sum())
        with self._lock:
            self._nonfinite += n_bad
            if not valid.any():
                self._updates += 1
                return 0
            m = members[:, valid]
            o = obs[valid]
            lh = lead_h[valid]
            gids = [g for g, ok in zip(gauge_ids, valid) if ok]
            nv = o.shape[0]

            # thresholds resolve from PRIOR climatology (strictly before this
            # update's observations fold in) — a forecast must be judged
            # against a flood definition that predates it
            thr_vals = {
                label: self._resolve_thresholds(kind, value, gids)
                for label, kind, value in self._thresholds
            }

            bins = lead_bin_index(lh, self._edges)  # (nv,)
            crps = crps_ensemble(m, o, fair=True)  # (nv,)
            ranks = rank_of_obs(m, o)  # (nv,)
            ens_mean = m.mean(axis=0)
            err2 = (ens_mean - o) ** 2
            if E >= 2:
                # fair spread: unbiased member variance scaled by (E+1)/E —
                # the dispersion a perfectly reliable ensemble would need for
                # spread/RMSE = 1 at finite E
                ens_var = m.var(axis=0, ddof=1) * (E + 1.0) / E
            else:
                ens_var = None

            # per-lead-bin sums
            batch = np.zeros_like(self._bin_sums)
            np.add.at(batch[:, 0], bins, 1.0)
            np.add.at(batch[:, 1], bins, crps)
            np.add.at(batch[:, 2], bins, crps**2)
            np.add.at(batch[:, 3], bins, err2)
            if ens_var is not None:
                np.add.at(batch[:, 4], bins, 1.0)
                np.add.at(batch[:, 5], bins, ens_var)
            self._bin_sums += batch

            # rank histogram for this ensemble size
            hist = self._ranks.get(E)
            if hist is None:
                hist = self._ranks[E] = np.zeros(
                    (len(self._labels), E + 1), dtype=np.int64
                )
            np.add.at(hist, (bins, ranks), 1)

            # Brier + reliability sums per threshold
            brier_samples: dict[str, np.ndarray] = {}
            for label, _, _ in self._thresholds:
                thr = thr_vals[label]
                ok = np.isfinite(thr)
                if not ok.any():
                    continue
                p = (m[:, ok] > thr[ok]).mean(axis=0)
                ob = (o[ok] > thr[ok]).astype(np.float64)
                sq = (p - ob) ** 2
                b = bins[ok]
                acc = self._brier[label]
                np.add.at(acc["n"], b, 1.0)
                np.add.at(acc["sse"], b, sq)
                np.add.at(acc["so"], b, ob)
                pk = np.minimum((p * N_PROB_BINS).astype(np.int64), N_PROB_BINS - 1)
                np.add.at(acc["bins"], (b, pk, 0), 1.0)
                np.add.at(acc["bins"], (b, pk, 1), p)
                np.add.at(acc["bins"], (b, pk, 2), ob)
                brier_samples[label] = sq

            # per-gauge CRPS sums (repeated ids accumulate via add.at)
            rows = self._gauge_rows(gids)
            np.add.at(self._gauge_sums[:, 0], rows, 1.0)
            np.add.at(self._gauge_sums[:, 1], rows, crps)

            # climatology folds in AFTER scoring (priors-only thresholds)
            for g, val in zip(gids, o):
                clim = self._clim.setdefault(g, [])
                if len(clim) < self.config.clim_samples:
                    clim.append(float(val))

            self._updates += 1
            self._samples += nv
            spread_ratio = None
            if ens_var is not None:
                rmse = math.sqrt(float(err2.mean()))
                if rmse > 0:
                    spread_ratio = math.sqrt(float(ens_var.mean())) / rmse
        self._mirror(crps, brier_samples, spread_ratio)
        return nv

    def update(
        self,
        members: np.ndarray,
        obs: np.ndarray,
        lead_h: np.ndarray,
        gauge_ids: Sequence[Any],
    ) -> int:
        """Grid convenience: ``members (E, T, G)``, ``obs (T, G)``,
        ``lead_h (T,)``, ``gauge_ids (G,)`` — flattened to T·G samples."""
        members = np.asarray(members, dtype=np.float64)
        if members.ndim == 2:
            members = members[None, :, :]
        obs = np.atleast_2d(np.asarray(obs, dtype=np.float64))
        E, T, G = members.shape
        if obs.shape != (T, G) or len(gauge_ids) != G:
            raise ValueError(
                f"shape mismatch: members {members.shape}, obs {obs.shape}, "
                f"{len(gauge_ids)} gauge ids"
            )
        lead = np.repeat(np.asarray(lead_h, dtype=np.float64).ravel(), G)
        gids = [str(g) for _ in range(T) for g in gauge_ids]
        return self.update_samples(
            members.reshape(E, T * G), obs.reshape(T * G), lead, gids
        )

    # ---- registry mirroring ----

    def _mirror(
        self,
        crps: np.ndarray,
        brier_samples: dict[str, np.ndarray],
        spread_ratio: float | None,
    ) -> None:
        """Direct registry updates (never through the event tee — worst-K
        removal is stateful). Never raises."""
        try:
            for v in crps:
                self._crps_hist.observe(float(v))
            for label, sq in brier_samples.items():
                for v in sq:
                    self._brier_hist.observe(float(v), threshold=label)
            if spread_ratio is not None and math.isfinite(spread_ratio):
                self._spread_hist.observe(float(spread_ratio))
            worst = self.worst_gauges()
            current = {w["gauge"]: w["crps"] for w in worst}
            with self._lock:
                stale = self._exported_worst - set(current)
                self._exported_worst = set(current)
            for gauge in stale:
                self._worst_gauge.remove(gauge=gauge)
            for gauge, v in current.items():
                self._worst_gauge.set(v, gauge=gauge)
        except Exception:
            log.exception("verification metrics mirroring failed")

    # ---- reporting ----

    def worst_gauges(self) -> list[dict[str, Any]]:
        """The worst-K gauges by mean CRPS (bounded — the event/series set),
        among gauges with at least ``min_samples`` matched samples."""
        with self._lock:
            sums = self._gauge_sums.copy()
            index = dict(self._gauges)
        if self.config.top_k <= 0 or not index:
            return []
        names = [None] * len(index)
        for name, row in index.items():
            names[row] = name
        n = sums[:, 0]
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.where(n > 0, sums[:, 1] / np.maximum(n, 1.0), np.nan)
        ok = (n >= self.config.min_samples) & np.isfinite(mean)
        if not ok.any():
            return []
        # below-floor gauges sort LAST (+inf) so the break below never cuts
        # off eligible rows behind them
        order = np.argsort(np.where(ok, -mean, np.inf))
        out = []
        for row in order[: self.config.top_k]:
            if not ok[row]:
                break
            out.append({
                "gauge": names[row],
                "crps": round(float(mean[row]), 6),
                "n": int(n[row]),
            })
        return out

    @staticmethod
    def _flatness(counts: np.ndarray) -> float | None:
        """Chi-square flatness of one rank histogram (0 = perfectly flat;
        larger = more U/L-shaped). None below 2 total counts."""
        total = counts.sum()
        if total < 2:
            return None
        expected = total / counts.shape[0]
        return float(np.sum((counts - expected) ** 2) / expected)

    def summary(self) -> dict[str, Any]:
        """The bounded rollup the ``verify`` event carries: overall + per-bin
        CRPS / spread-skill, per-threshold Brier with Murphy's reliability
        decomposition, rank-histogram flatness. Size is O(bins + thresholds
        + top_k) — never per-gauge vectors."""
        with self._lock:
            bin_sums = self._bin_sums.copy()
            ranks = {e: h.copy() for e, h in self._ranks.items()}
            brier = {
                label: {k: v.copy() for k, v in acc.items()}
                for label, acc in self._brier.items()
            }
            samples = self._samples
            nonfinite = self._nonfinite
        tot = bin_sums.sum(axis=0)
        out: dict[str, Any] = {
            "samples": int(samples),
            "nonfinite_samples": int(nonfinite),
            "crps": round(float(tot[1] / tot[0]), 6) if tot[0] else None,
            "spread_skill": None,
            "by_lead": {},
            "thresholds": {},
        }
        if tot[4] and tot[3]:
            rmse = math.sqrt(float(tot[3] / tot[0]))
            spread = math.sqrt(float(tot[5] / tot[4]))
            out["spread_skill"] = round(spread / rmse, 4) if rmse > 0 else None
        # rank flatness aggregates over lead bins per ensemble size; report
        # the sample-weighted dominant E's histogram shape
        agg_ranks = {e: h.sum(axis=0) for e, h in ranks.items()}
        if agg_ranks:
            e_top = max(agg_ranks, key=lambda e: agg_ranks[e].sum())
            flat = self._flatness(agg_ranks[e_top])
            out["rank_histogram"] = {
                "members": int(e_top),
                "counts": [int(c) for c in agg_ranks[e_top]],
                "flatness": None if flat is None else round(flat, 4),
            }
        for b, label in enumerate(self._labels):
            n = bin_sums[b, 0]
            if not n:
                continue
            entry: dict[str, Any] = {
                "n": int(n),
                "crps": round(float(bin_sums[b, 1] / n), 6),
            }
            if bin_sums[b, 4]:
                rmse = math.sqrt(float(bin_sums[b, 3] / n))
                spread = math.sqrt(float(bin_sums[b, 5] / bin_sums[b, 4]))
                entry["spread_skill"] = (
                    round(spread / rmse, 4) if rmse > 0 else None
                )
            out["by_lead"][label] = entry
        for label, acc in brier.items():
            n = float(acc["n"].sum())
            if not n:
                out["thresholds"][label] = {"n": 0}
                continue
            bs = float(acc["sse"].sum()) / n
            obar = float(acc["so"].sum()) / n
            # Murphy decomposition from the probability-bin sums:
            # BS = REL - RES + UNC over the binned forecast distribution
            pb = acc["bins"].sum(axis=0)  # (N_PROB_BINS, 3)
            nk = pb[:, 0]
            with np.errstate(invalid="ignore", divide="ignore"):
                pbar_k = np.where(nk > 0, pb[:, 1] / np.maximum(nk, 1), 0.0)
                obar_k = np.where(nk > 0, pb[:, 2] / np.maximum(nk, 1), 0.0)
            rel = float(np.sum(nk * (pbar_k - obar_k) ** 2) / n)
            res = float(np.sum(nk * (obar_k - obar) ** 2) / n)
            unc = obar * (1.0 - obar)
            out["thresholds"][label] = {
                "n": int(n),
                "brier": round(bs, 6),
                "reliability": round(rel, 6),
                "resolution": round(res, 6),
                "uncertainty": round(unc, 6),
                "base_rate": round(obar, 6),
            }
        out["worst"] = self.worst_gauges()
        with self._lock:
            self._last_summary = out
        return out

    def status(self) -> dict[str, Any]:
        """Counters + the last computed summary (the ``/v1/stats`` /
        ``run_end`` shape)."""
        with self._lock:
            last = self._last_summary
            base = {
                "enabled": self.config.enabled,
                "updates": self._updates,
                "samples": self._samples,
                "gauges": len(self._gauges),
                "thresholds": list(self.config.thresholds),
                "lead_bins": list(self._labels),
            }
        if last is None and base["samples"]:
            last = self.summary()
        if last is not None:
            base["scores"] = last
        return base


# ---------------------------------------------------------------------------
# The forecast–observation ledger.
# ---------------------------------------------------------------------------


class ForecastLedger:
    """Bounded store of issued forecasts + the delayed observation join.

    ``record_forecast`` decomposes an issued ``(E, T, G)`` member stack into
    per-(gauge, valid-hour) member vectors under a per-(network, gauge) ring
    keyed by integer valid hour (cap ``ledger_cap`` distinct valid times;
    deterministic oldest-valid-time eviction). ``observe`` pops every pending
    vector at the observed (gauge, hour), feeds the scorer grouped by
    ensemble size, and emits ONE bounded ``verify`` event per call. Member
    vectors live only until matched or evicted; duplicate observations (a
    recently-matched key seen again) and unmatched ones are counted, never
    scored. Thread-safe; host-side only."""

    def __init__(
        self,
        config: VerifyConfig | None = None,
        registry: Any = None,
        scorer: VerificationScorer | None = None,
    ) -> None:
        self.config = config or VerifyConfig.from_env()
        self.scorer = scorer or VerificationScorer(self.config, registry=registry)
        self._lock = threading.Lock()
        # (network, gauge) -> {valid_hour: [(issue_hour, model, (E,) vector)]}
        self._pending: dict[tuple[str, str], dict[int, list[tuple]]] = {}
        # (network, gauge) -> recently matched valid hours (duplicate watch,
        # bounded at ledger_cap)
        self._matched_keys: dict[tuple[str, str], dict[int, None]] = {}
        self._forecasts = 0
        self._cells = 0
        self._matched = 0
        self._unmatched_obs = 0
        self._duplicate_obs = 0
        self._evicted = 0

    # ---- recording ----

    def record_forecast(
        self,
        network: str,
        model: str,
        request_id: str,
        issue_hour: int,
        valid_hours: Sequence[int],
        gauge_ids: Sequence[Any],
        members: np.ndarray,
    ) -> None:
        """Store one issued forecast. ``members`` is ``(E, T, G)`` (``(T, G)``
        accepted for deterministic forecasts); ``valid_hours`` has T entries,
        ``gauge_ids`` G. Silent no-op when disabled."""
        if not self.config.enabled:
            return
        members = np.asarray(members, dtype=np.float32)
        if members.ndim == 2:
            members = members[None, :, :]
        E, T, G = members.shape
        valid_hours = [int(v) for v in valid_hours]
        if len(valid_hours) != T or len(gauge_ids) != G:
            raise ValueError(
                f"shape mismatch: members {members.shape}, {len(valid_hours)} "
                f"valid hours, {len(gauge_ids)} gauge ids"
            )
        issue_hour = int(issue_hour)
        net = str(network)
        with self._lock:
            self._forecasts += 1
            for g in range(G):
                ring = self._pending.setdefault((net, str(gauge_ids[g])), {})
                col = members[:, :, g]
                for t, vh in enumerate(valid_hours):
                    ring.setdefault(vh, []).append(
                        (issue_hour, str(model), col[:, t].copy())
                    )
                    self._cells += 1
                # deterministic eviction: drop oldest valid hours past the cap
                while len(ring) > self.config.ledger_cap:
                    oldest = min(ring)
                    dropped = ring.pop(oldest)
                    self._cells -= len(dropped)
                    self._evicted += len(dropped)

    # ---- the delayed join ----

    def observe(
        self,
        network: str,
        observations: dict[str, Sequence[tuple[int, float]]] | list[dict],
        **context: Any,
    ) -> dict[str, Any]:
        """Join one batch of observations against pending forecasts.

        ``observations`` is either ``{gauge_id: [(valid_hour, value), ...]}``
        or the HTTP-body list form ``[{"gauge": ..., "times": [...],
        "values": [...]}, ...]``. Every matched (forecast, obs) pair is
        scored. Returns the join stats dict (the ``/v1/observe`` response
        body). ``context`` (e.g. ``source="http"``) rides the run log's
        ``verify`` event."""
        net = str(network)
        pairs: list[tuple[str, int, float]] = []
        if isinstance(observations, dict):
            for gid, series in observations.items():
                for vh, val in series:
                    pairs.append((str(gid), int(vh), float(val)))
        else:
            for entry in observations:
                gid = str(entry["gauge"])
                times = entry["times"]
                values = entry["values"]
                if len(times) != len(values):
                    raise ValueError(
                        f"gauge {gid!r}: {len(times)} times vs "
                        f"{len(values)} values"
                    )
                for vh, val in zip(times, values):
                    pairs.append((gid, int(vh), float(val)))

        matched = 0
        unmatched = 0
        duplicates = 0
        # matched cells grouped by ensemble size for uniform-E scorer updates
        by_e: dict[int, list[tuple[np.ndarray, float, float, str]]] = {}
        with self._lock:
            for gid, vh, val in pairs:
                key = (net, gid)
                ring = self._pending.get(key)
                entries = ring.pop(vh, None) if ring else None
                if not entries:
                    seen = self._matched_keys.get(key)
                    if seen is not None and vh in seen:
                        duplicates += 1
                        self._duplicate_obs += 1
                    else:
                        unmatched += 1
                        self._unmatched_obs += 1
                    continue
                self._cells -= len(entries)
                seen = self._matched_keys.setdefault(key, {})
                seen[vh] = None
                while len(seen) > self.config.ledger_cap:
                    del seen[next(iter(seen))]
                for issue_hour, _model, vec in entries:
                    lead = float(vh - issue_hour)
                    by_e.setdefault(len(vec), []).append((vec, val, lead, gid))
                    matched += 1
                    self._matched += 1
        for E, cells in sorted(by_e.items()):
            members = np.stack([c[0] for c in cells], axis=1)  # (E, S)
            obs = np.array([c[1] for c in cells])
            lead = np.array([c[2] for c in cells])
            gids = [c[3] for c in cells]
            self.scorer.update_samples(members, obs, lead, gids)
        stats = {
            "network": net,
            "observations": len(pairs),
            "matched": matched,
            "unmatched": unmatched,
            "duplicates": duplicates,
        }
        self._emit_verify(stats, context)
        return stats

    def _emit_verify(self, stats: dict[str, Any], context: dict) -> None:
        """One ``verify`` event a join, to the active recorder only."""
        from ddr_tpu_torch.observability.events import get_recorder

        rec = get_recorder()
        if rec is None:
            return
        try:
            rec.emit("verify", **stats, **context, **self.scorer.summary())
        except Exception:
            log.exception("verify event emission failed")

    # ---- rollups ----

    def status(self) -> dict[str, Any]:
        """The ``/v1/stats`` ``verification`` slice / ``run_end`` rollup."""
        with self._lock:
            out = {
                "enabled": self.config.enabled,
                "forecasts": self._forecasts,
                "cells_pending": self._cells,
                "matched": self._matched,
                "unmatched_obs": self._unmatched_obs,
                "duplicate_obs": self._duplicate_obs,
                "evicted": self._evicted,
                "ledger_cap": self.config.ledger_cap,
            }
        out["scorer"] = self.scorer.status()
        return out
