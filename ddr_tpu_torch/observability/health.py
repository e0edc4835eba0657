"""Numerical-health watchdog: device-side health stats, host-side thresholds.

The port of ``ddr_tpu/observability/health.py``. The Muskingum-Cunge solve
makes "the numbers went wrong" checkable: discharge must stay finite, the
domain's total discharge must stay in proportion to its lateral inflow (a
scale-free explosion indicator), training gradients must stay bounded, and a
bf16 ring must neither overflow nor drift. The split keeps monitoring out of
the hot path's way:

- :func:`compute_health` (and the spatial :func:`compute_reach_stats` /
  :func:`compute_band_health`, :func:`compute_output_worst`) run on the
  device, on the tensors the route or the step already holds: a handful of
  reductions that return 0-d or ``(B,)``/``(K,)`` tensors, no host sync;
- :class:`HealthWatchdog` runs on the HOST after the step's own
  synchronisation: it thresholds the stats against :class:`HealthConfig`
  (``DDR_HEALTH_*`` knobs), logs one warning per violating batch, and counts
  consecutive violations so the service can report itself degraded after K
  bad batches.

``mass_residual`` is ``(sum(outputs) - sum(inflow)) / (|sum(inflow)| +
1e-6)`` over the live, finite entries: not a conservation law (routed
discharge accumulates downstream, gauges cover a subset of reaches), but
stable across healthy windows for a fixed network and gauge set, and it
explodes with the solve.

Translations from JAX: ``jax.ops.segment_min``/``segment_max`` are
``scatter_reduce(..., "amin"/"amax", include_self=False)`` over a tensor
filled with ``+inf``/``-inf``, so empty bands read the JAX identities;
``jax.lax.top_k`` is ``torch.topk``, which orders tied scores differently
(JAX puts the lower index first); ``jnp.finfo(bfloat16)`` is
``torch.finfo(torch.bfloat16)`` (eps ``2**-7``, the same max). Not ported
yet: the ``ddr_health_status`` Prometheus gauge and the ``health`` event of
the run recorder; a violation is logged instead.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
import time
from typing import Any

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = [
    "HealthConfig",
    "HealthStats",
    "HealthWatchdog",
    "ReachStats",
    "assemble_reach_stats",
    "compute_band_health",
    "compute_health",
    "compute_health_host",
    "compute_output_worst",
    "compute_reach_stats",
]

_BF16 = torch.finfo(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class HealthStats:
    """Numerical-health scalars for one routed batch or train step: 0-d
    tensors (or numbers, from :func:`compute_health_host`), ``None`` where
    not computed. Fields and meanings as in the JAX package."""

    nonfinite: Any  # int32 count of non-finite entries (outputs + inflow)
    q_min: Any  # min over finite output discharge
    q_max: Any  # max over finite output discharge
    mass_residual: Any  # scale-free outflow/inflow imbalance (module docstring)
    grad_norm: Any = None  # pre-clip global gradient norm; train steps only
    # bf16 batches only: entries past the bf16 finite max, and |mass_residual|
    # in bf16-epsilon units
    overflow: Any = None
    ulp_drift: Any = None
    # spatial attribution (compute_band_health), (B,) per level band
    band_nonfinite: Any = None
    band_q_min: Any = None
    band_q_max: Any = None
    band_residual: Any = None
    band_overflow: Any = None
    band_ulp_drift: Any = None
    # top-K worst reaches (original order) or, in serving, output columns
    worst_idx: Any = None  # (K,) int32
    worst_score: Any = None  # (K,) float32


@dataclasses.dataclass(frozen=True)
class ReachStats:
    """Per-reach time-reduced route statistics, ORIGINAL node order, ``(N,)``
    each: the intermediate :func:`compute_band_health` collapses to the
    bounded band fields before the route returns."""

    nonfinite: Any  # (N,) int32, discharge and lateral inflow
    q_min: Any  # (N,) min finite discharge over the window
    q_max: Any  # (N,) max finite discharge over the window
    out_mass: Any  # (N,) finite discharge sum over the window
    in_mass: Any  # (N,) finite lateral-inflow sum over the window
    overflow: Any = None  # (N,) int32 bf16-overflow entries (bf16 batches)


def _live(arr: torch.Tensor, row_mask) -> torch.Tensor | None:
    """``row_mask`` (boolean over ``arr``'s leading axis) broadcast to
    ``arr``'s shape, or None for every entry."""
    if row_mask is None:
        return None
    m = torch.as_tensor(row_mask, device=arr.device).bool()
    return m.reshape(m.shape + (1,) * (arr.dim() - m.dim())).expand(arr.shape)


def _masked(a: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    return a if mask is None else a & mask


def compute_health(runoff: torch.Tensor, q_prime: torch.Tensor | None = None,
                   final_discharge: torch.Tensor | None = None,
                   row_mask: Any | None = None,
                   compute_dtype: str = "fp32") -> HealthStats:
    """Health scalars from routed outputs, on their device.

    ``runoff`` is the route output (``(T, G)``, ``(T, N)``, or batched with a
    leading axis); ``q_prime`` the lateral inflow the window consumed;
    ``final_discharge`` the carry state when available. ``row_mask``
    (boolean over the LEADING axis) restricts everything to the live rows of
    a padded batch slot, so the residual and ``q_min`` do not depend on batch
    occupancy. ``compute_dtype="bf16"`` also fills ``overflow`` and
    ``ulp_drift``; fp32 leaves them None."""
    with torch.no_grad():
        runoff = runoff.detach()
        finite = torch.isfinite(runoff)
        valid = _live(runoff, row_mask)
        live_finite = _masked(finite, valid)
        nonfinite = _masked(~finite, valid).sum(dtype=torch.int32)
        big = torch.finfo(runoff.dtype).max
        q_min = torch.where(live_finite, runoff, big).amin()
        q_max = torch.where(live_finite, runoff, -big).amax()
        out_mass = torch.where(live_finite, runoff, 0.0).sum()
        if q_prime is not None:
            qp = q_prime.detach()
            qp_valid = _live(qp, row_mask)
            qp_finite = torch.isfinite(qp)
            nonfinite = nonfinite + _masked(~qp_finite, qp_valid).sum(dtype=torch.int32)
            in_mass = torch.where(_masked(qp_finite, qp_valid), qp, 0.0).sum()
        else:
            in_mass = runoff.new_zeros(())
        if final_discharge is not None:
            nonfinite = nonfinite + (~torch.isfinite(final_discharge.detach())).sum(dtype=torch.int32)
        residual = (out_mass - in_mass) / (in_mass.abs() + 1e-6)
        overflow = ulp_drift = None
        if compute_dtype == "bf16":
            overflow = _masked(runoff.abs() > _BF16.max, valid).sum(dtype=torch.int32)
            if q_prime is not None:
                overflow = overflow + _masked(qp.abs() > _BF16.max, qp_valid).sum(dtype=torch.int32)
            ulp_drift = residual.abs() / _BF16.eps
    return HealthStats(nonfinite=nonfinite, q_min=q_min, q_max=q_max, mass_residual=residual,
                       overflow=overflow, ulp_drift=ulp_drift)


def compute_health_host(runoff: Any, q_prime: Any | None = None) -> HealthStats:
    """Numpy twin of :func:`compute_health` for results that already live on
    the host: same fields, same semantics, plain numbers."""
    runoff = np.asarray(runoff)
    finite = np.isfinite(runoff)
    nonfinite = int((~finite).sum())
    big = np.finfo(runoff.dtype).max if runoff.dtype.kind == "f" else np.inf
    q_min = float(np.where(finite, runoff, big).min()) if runoff.size else float("inf")
    q_max = float(np.where(finite, runoff, -big).max()) if runoff.size else float("-inf")
    out_mass = float(np.where(finite, runoff, 0.0).sum())
    in_mass = 0.0
    if q_prime is not None:
        qp = np.asarray(q_prime)
        qp_finite = np.isfinite(qp)
        nonfinite += int((~qp_finite).sum())
        in_mass = float(np.where(qp_finite, qp, 0.0).sum())
    residual = (out_mass - in_mass) / (abs(in_mass) + 1e-6)
    return HealthStats(nonfinite=nonfinite, q_min=q_min, q_max=q_max, mass_residual=residual)


def compute_reach_stats(runoff: torch.Tensor, q_prime: torch.Tensor, compute_dtype: str = "fp32",
                        runoff_inv: torch.Tensor | None = None,
                        q_prime_inv: torch.Tensor | None = None) -> ReachStats:
    """Reduce a ``(..., T, N)`` per-reach discharge field and its lateral
    inflow over every leading axis (time, and a batch where there is one)
    into :class:`ReachStats`. ``runoff_inv``/``q_prime_inv`` map each
    field's column order back to original node order (one gather each), so
    every engine's stats land on the same axis."""
    with torch.no_grad():
        runoff, qp = runoff.detach(), q_prime.detach()
        dims = tuple(range(runoff.dim() - 1))
        qp_dims = tuple(range(qp.dim() - 1))
        big = torch.finfo(runoff.dtype).max
        finite = torch.isfinite(runoff)
        nf = (~finite).sum(dim=dims, dtype=torch.int32)
        q_min = torch.where(finite, runoff, big).amin(dim=dims)
        q_max = torch.where(finite, runoff, -big).amax(dim=dims)
        out_mass = torch.where(finite, runoff, 0.0).sum(dim=dims)
        del finite
        qp_finite = torch.isfinite(qp)
        nf_qp = (~qp_finite).sum(dim=qp_dims, dtype=torch.int32)
        in_mass = torch.where(qp_finite, qp, 0.0).sum(dim=qp_dims)
        overflow = None
        if compute_dtype == "bf16":
            overflow = (runoff.abs() > _BF16.max).sum(dim=dims, dtype=torch.int32)

    def inv(a, index):
        return a if index is None else a[index.long()]

    return ReachStats(
        nonfinite=inv(nf, runoff_inv) + inv(nf_qp, q_prime_inv),
        q_min=inv(q_min, runoff_inv),
        q_max=inv(q_max, runoff_inv),
        out_mass=inv(out_mass, runoff_inv),
        in_mass=inv(in_mass, q_prime_inv),
        overflow=None if overflow is None else inv(overflow, runoff_inv),
    )


def assemble_reach_stats(nonfinite: torch.Tensor, q_min: torch.Tensor, q_max: torch.Tensor,
                         out_mass: torch.Tensor, q_prime: torch.Tensor, inv: torch.Tensor | None = None,
                         q_prime_inv: torch.Tensor | None = None) -> ReachStats:
    """:class:`ReachStats` from per-reach reductions already accumulated
    (the step engine's carried accumulators, where the full ``(T, N)``
    field never exists); the lateral-inflow half is reduced here over every
    leading axis of ``q_prime``. ``inv``/``q_prime_inv`` re-align the column
    orders as in :func:`compute_reach_stats`. The step engine has no bf16
    ring, so ``overflow`` is ``None``."""
    with torch.no_grad():
        qp = q_prime.detach()
        qp_dims = tuple(range(qp.dim() - 1))
        qp_finite = torch.isfinite(qp)
        nf_qp = (~qp_finite).sum(dim=qp_dims, dtype=torch.int32)
        in_mass = torch.where(qp_finite, qp, 0.0).sum(dim=qp_dims)

    def align(a, index):
        return a if index is None else a[index.long()]

    return ReachStats(
        nonfinite=align(nonfinite.to(torch.int32), inv) + align(nf_qp, q_prime_inv),
        q_min=align(q_min, inv),
        q_max=align(q_max, inv),
        out_mass=align(out_mass, inv),
        in_mass=align(in_mass, q_prime_inv),
        overflow=None,
    )


#: Worst-reach score offset for non-finite entries: any reach with a NaN/Inf
#: outranks every finite-but-extreme one.
_WORST_NONFINITE_WEIGHT = 1e30


def _worst_score(nonfinite: torch.Tensor, q_max: torch.Tensor) -> torch.Tensor:
    """Non-finite count first, ``|max discharge|`` as the tiebreak."""
    mag = torch.where(torch.isfinite(q_max), q_max.abs(),
                      torch.full_like(q_max, _WORST_NONFINITE_WEIGHT)).float()
    return nonfinite.float() * _WORST_NONFINITE_WEIGHT + mag


def compute_band_health(reach: ReachStats, band_ids: torch.Tensor, n_bands: int, top_k: int = 8,
                        compute_dtype: str = "fp32") -> dict[str, Any]:
    """Collapse :class:`ReachStats` to the bounded :class:`HealthStats` band
    fields: per-band (``band_ids`` ``(N,)`` in ``[0, n_bands)``) sums,
    extrema and mass residual, and the top-K worst reaches. Returns the
    field dict for ``dataclasses.replace`` on a :class:`HealthStats`."""
    with torch.no_grad():
        ids = band_ids.long()

        def seg_sum(x):
            return x.new_zeros(n_bands).index_add_(0, ids, x)

        def seg_extreme(x, reduce, fill):
            return x.new_full((n_bands,), fill).scatter_reduce_(0, ids, x, reduce, include_self=False)

        out_b = seg_sum(reach.out_mass)
        in_b = seg_sum(reach.in_mass)
        band_residual = (out_b - in_b) / (in_b.abs() + 1e-6)
        out: dict[str, Any] = {
            "band_nonfinite": seg_sum(reach.nonfinite),
            "band_q_min": seg_extreme(reach.q_min, "amin", math.inf),
            "band_q_max": seg_extreme(reach.q_max, "amax", -math.inf),
            "band_residual": band_residual,
        }
        if compute_dtype == "bf16" and reach.overflow is not None:
            out["band_overflow"] = seg_sum(reach.overflow)
            out["band_ulp_drift"] = band_residual.abs() / _BF16.eps
        if top_k > 0:
            k = min(int(top_k), int(reach.q_max.shape[0]))
            score, idx = torch.topk(_worst_score(reach.nonfinite, reach.q_max), k)
            out["worst_idx"] = idx.int()
            out["worst_score"] = score
    return out


def compute_output_worst(values: torch.Tensor, top_k: int,
                         row_mask: Any | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K worst OUTPUT columns of a ``(..., G)`` field (the serving
    layer's worst-gauge selection): reduces every leading axis, ``row_mask``
    dropping padded batch rows first, scores columns like the worst-reach
    selection. Returns ``(worst_idx, worst_score)``, each ``(K,)``."""
    with torch.no_grad():
        v = values.detach()
        valid = _live(v, row_mask)
        axes = tuple(range(v.dim() - 1))
        finite = torch.isfinite(v)
        nf = _masked(~finite, valid).sum(dim=axes, dtype=torch.int32)
        big = torch.finfo(v.dtype).max
        q_max = torch.where(_masked(finite, valid), v, -big).amax(dim=axes)
        k = min(int(top_k), int(v.shape[-1]))
        score, idx = torch.topk(_worst_score(nf, q_max), k)
    return idx.int(), score


_ENV_PREFIX = "DDR_HEALTH_"
_FALSEY = ("0", "false", "no", "off")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Watchdog thresholds (env var in parentheses). The defaults are
    permissive: only non-finite values violate out of the box."""

    #: Master switch (DDR_HEALTH_ENABLED; 0/false/no/off disables).
    enabled: bool = True
    #: Non-finite entries tolerated per batch (DDR_HEALTH_MAX_NONFINITE).
    max_nonfinite: int = 0
    #: Discharge ceiling, m^3/s (DDR_HEALTH_MAX_DISCHARGE; inf = off).
    max_discharge: float = math.inf
    #: |mass_residual| ceiling (DDR_HEALTH_MAX_RESIDUAL; inf = off).
    max_residual: float = math.inf
    #: Gradient global-norm ceiling (DDR_HEALTH_MAX_GRAD_NORM; inf = off;
    #: a non-finite norm always violates).
    max_grad_norm: float = math.inf
    #: bf16 overflow entries tolerated per batch (DDR_HEALTH_MAX_OVERFLOW;
    #: evaluated on bf16 batches only).
    max_overflow: int = 0
    #: bf16 ulp-drift ceiling (DDR_HEALTH_MAX_ULP_DRIFT; inf = off; a
    #: non-finite drift always violates on bf16 batches).
    max_ulp_drift: float = math.inf
    #: Consecutive violating batches before the watchdog reports degraded
    #: (DDR_HEALTH_BAD_BATCHES).
    bad_batches: int = 3
    #: Seconds without an observed batch before the watchdog reports stale,
    #: and so degraded (DDR_HEALTH_MAX_STALL_S; inf = off).
    max_stall_s: float = math.inf
    #: Level bands of the spatial attribution (DDR_HEALTH_BANDS; 0 = off).
    bands: int = 0
    #: Worst-reach (serving: worst-gauge) selection size (DDR_HEALTH_TOPK;
    #: 0 = off).
    top_k: int = 8
    #: Parameter-field drift-index ceiling per epoch (DDR_HEALTH_MAX_PARAM_DRIFT).
    max_param_drift: float = math.inf
    #: Out-of-bounds parameter entries per field per epoch (DDR_HEALTH_MAX_PARAM_OOB).
    max_param_oob: float = math.inf

    def __post_init__(self) -> None:
        if self.bad_batches < 1:
            raise ValueError(f"bad_batches must be >= 1, got {self.bad_batches}")
        if self.max_nonfinite < 0:
            raise ValueError(f"max_nonfinite must be >= 0, got {self.max_nonfinite}")
        if self.max_overflow < 0:
            raise ValueError(f"max_overflow must be >= 0, got {self.max_overflow}")
        if self.max_stall_s <= 0:
            raise ValueError(f"max_stall_s must be > 0, got {self.max_stall_s}")
        if self.bands < 0:
            raise ValueError(f"bands must be >= 0, got {self.bands}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @classmethod
    def from_env(cls, environ: dict | None = None, **overrides) -> "HealthConfig":
        """Defaults < ``DDR_HEALTH_*`` environment < explicit overrides."""
        env = os.environ if environ is None else environ

        def get(name: str, cast):
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
            ("max_nonfinite", "MAX_NONFINITE", int),
            ("max_discharge", "MAX_DISCHARGE", float),
            ("max_residual", "MAX_RESIDUAL", float),
            ("max_grad_norm", "MAX_GRAD_NORM", float),
            ("max_overflow", "MAX_OVERFLOW", int),
            ("max_ulp_drift", "MAX_ULP_DRIFT", float),
            ("bad_batches", "BAD_BATCHES", int),
            ("max_stall_s", "MAX_STALL_S", float),
            ("bands", "BANDS", int),
            ("top_k", "TOPK", int),
            ("max_param_drift", "MAX_PARAM_DRIFT", float),
            ("max_param_oob", "MAX_PARAM_OOB", float),
        ):
            v = get(var, cast)
            if v is not None:
                from_env[key] = v
        from_env.update(overrides)
        return cls(**from_env)


def _host(a: Any) -> np.ndarray:
    """A stats field as a host array (a CUDA tensor is copied back)."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class HealthWatchdog:
    """Host-side thresholder over :class:`HealthStats`.

    One instance per run or service. :meth:`observe` is called once per
    batch after the step's own synchronisation, so reading the stats moves a
    few scalars. Thread-safe: a service observes from its batcher's worker
    while other threads read :attr:`degraded`."""

    def __init__(self, config: HealthConfig | None = None) -> None:
        self.config = config or HealthConfig.from_env()
        self._lock = threading.Lock()
        self._consecutive = 0
        self._batches = 0
        self._violations = 0
        # externally flagged violations (flag) keep their own streak: healthy
        # batches between epoch-end checks must not clear it
        self._consecutive_flagged = 0
        self._last_reasons: list[str] = []
        self._last_spatial: dict[str, Any] | None = None
        # the staleness clock starts at construction, so a first batch that
        # hangs also trips the stall ceiling
        self._last_observe = time.monotonic()

    # ---- observation ----

    def check(self, stats: HealthStats) -> list[str]:
        """Pure threshold evaluation -> violation reasons (no state, no I/O)."""
        cfg = self.config
        reasons: list[str] = []
        if int(stats.nonfinite) > cfg.max_nonfinite:
            reasons.append("non-finite")
        if float(stats.q_max) > cfg.max_discharge:
            reasons.append("discharge-max")
        residual = float(stats.mass_residual)
        if not math.isfinite(residual) or abs(residual) > cfg.max_residual:
            reasons.append("mass-residual")
        if stats.grad_norm is not None:
            gn = float(stats.grad_norm)
            if not math.isfinite(gn) or gn > cfg.max_grad_norm:
                reasons.append("grad-norm")
        if stats.overflow is not None and int(stats.overflow) > cfg.max_overflow:
            reasons.append("bf16-overflow")
        if stats.ulp_drift is not None:
            drift = float(stats.ulp_drift)
            if not math.isfinite(drift) or drift > cfg.max_ulp_drift:
                reasons.append("ulp-drift")
        if stats.band_nonfinite is not None:
            # the per-reach view catches non-finites an ungauged reach hides
            # from gauge-aggregated global stats
            if int(_host(stats.band_nonfinite).sum()) > cfg.max_nonfinite:
                if "non-finite" not in reasons:
                    reasons.append("non-finite")
        return reasons

    @staticmethod
    def spatial_summary(stats: HealthStats) -> dict[str, Any] | None:
        """The bounded host-side slice of a batch's spatial attribution; None
        when the stats carry no band or worst fields."""
        out: dict[str, Any] = {}
        if stats.band_residual is not None:
            band_res = _host(stats.band_residual).astype(np.float64)
            band_nf = _host(stats.band_nonfinite).astype(np.int64)
            finite = np.where(np.isfinite(band_res), np.abs(band_res), np.inf)
            out["worst_band"] = int(np.argmax(band_nf * 1e30 + finite))
            out["band_nonfinite"] = [int(v) for v in band_nf]
            out["band_residual"] = [round(float(v), 6) for v in band_res]
            out["band_q_max"] = [round(float(v), 4) for v in _host(stats.band_q_max)]
            if stats.band_ulp_drift is not None:
                out["band_ulp_drift"] = [round(float(v), 3) for v in _host(stats.band_ulp_drift)]
        if stats.worst_idx is not None:
            out["worst_idx"] = [int(v) for v in _host(stats.worst_idx)]
            out["worst_score"] = [round(float(v), 4) for v in _host(stats.worst_score)]
        return out or None

    def observe(self, stats: HealthStats, **context: Any) -> list[str]:
        """Threshold one batch's stats; returns the violation reasons (empty
        = healthy). A violating batch logs one warning (reasons, values,
        spatial attribution, ``context``) and bumps the violation counters; a
        healthy one clears the consecutive count. The spatial fields are
        remembered on every batch, healthy or not."""
        if not self.config.enabled:
            return []
        reasons = self.check(stats)
        spatial = self.spatial_summary(stats)
        with self._lock:
            if spatial is not None:
                self._last_spatial = spatial
        consecutive = self._note(reasons)
        if not reasons:
            return reasons
        payload = {
            "nonfinite": int(stats.nonfinite),
            "q_min": float(stats.q_min),
            "q_max": float(stats.q_max),
            "mass_residual": float(stats.mass_residual),
            "consecutive": consecutive,
            **context,
        }
        if stats.grad_norm is not None:
            payload["grad_norm"] = float(stats.grad_norm)
        if stats.overflow is not None:
            payload["overflow"] = int(stats.overflow)
        if stats.ulp_drift is not None:
            payload["ulp_drift"] = float(stats.ulp_drift)
        if spatial is not None:
            payload.update(spatial)
        self._report(reasons, payload)
        return reasons

    def flag(self, reasons: list[str], **context: Any) -> list[str]:
        """Fold an externally detected violation into the same counters as
        an in-batch one. Flags keep their own consecutive streak, which
        :meth:`observe` does not reset, and do not count as batches; an empty
        ``reasons`` clears the flagged streak."""
        if not self.config.enabled:
            return []
        reasons = list(reasons)
        with self._lock:
            if reasons:
                self._consecutive_flagged += 1
                self._violations += 1
                self._last_reasons = reasons
            else:
                self._consecutive_flagged = 0
            consecutive = self._consecutive_flagged
        if not reasons:
            return []
        self._report(reasons, {"consecutive": consecutive, **context})
        return reasons

    def _note(self, reasons: list[str]) -> int:
        """Counter bookkeeping for one observation."""
        with self._lock:
            self._last_observe = time.monotonic()
            self._batches += 1
            if reasons:
                self._consecutive += 1
                self._violations += 1
            else:
                self._consecutive = 0
            self._last_reasons = reasons
            return self._consecutive

    def _report(self, reasons: list[str], payload: dict[str, Any]) -> None:
        """The one warning of a violating observation."""
        log.warning(
            f"numerical health violation ({', '.join(reasons)}): "
            + " ".join(f"{k}={v}" for k, v in payload.items())
        )

    def reset_streaks(self) -> None:
        """Clear both consecutive-violation streaks, the last reasons and
        spatial slice, and the staleness clock, keeping the lifetime
        ``batches``/``violations`` totals: a restored or re-run state is
        another trajectory and must not inherit a degraded streak."""
        with self._lock:
            self._consecutive = 0
            self._consecutive_flagged = 0
            self._last_reasons = []
            self._last_spatial = None
            self._last_observe = time.monotonic()

    # ---- state ----

    @property
    def consecutive_bad(self) -> int:
        with self._lock:
            return self._consecutive

    @property
    def staleness_s(self) -> float:
        """Seconds since the last observed batch (or construction)."""
        with self._lock:
            return max(0.0, time.monotonic() - self._last_observe)

    @property
    def stale(self) -> bool:
        """True when no batch has been observed for ``max_stall_s`` (off at
        the default ``inf``)."""
        return (
            self.config.enabled
            and math.isfinite(self.config.max_stall_s)
            and self.staleness_s > self.config.max_stall_s
        )

    @property
    def degraded(self) -> bool:
        """True after ``bad_batches`` consecutive violations (in-batch or
        flagged) or a stall."""
        if self.stale:
            return True
        with self._lock:
            return max(self._consecutive, self._consecutive_flagged) >= self.config.bad_batches

    def status(self) -> dict[str, Any]:
        """Rollup of the counters, the last reasons and the last spatial
        slice."""
        stale = self.stale
        with self._lock:
            return {
                "enabled": self.config.enabled,
                "batches": self._batches,
                "violations": self._violations,
                "consecutive_bad": self._consecutive,
                "consecutive_flagged": self._consecutive_flagged,
                "degraded": stale
                or max(self._consecutive, self._consecutive_flagged) >= self.config.bad_batches,
                "stale": stale,
                "staleness_s": round(max(0.0, time.monotonic() - self._last_observe), 3),
                "last_reasons": list(self._last_reasons),
                "spatial": self._last_spatial,
            }
