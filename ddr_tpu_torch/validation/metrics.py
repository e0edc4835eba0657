"""Evaluation metrics battery: the port's copy of ``ddr_tpu/validation/metrics.py``
(numpy and scipy, on host arrays).

Bias, MAE, RMSE, ubRMSE, FDC-RMSE, Pearson and Spearman correlation, R^2,
NSE, FLV/FHV (% bias over the sorted bottom-30% / top-2% flows), PBias
(+mid), KGE and KGE', and low/mid/high RMSE splits, per gauge over the time
axis with NaN-aware masking; NaN predictions raise.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
from scipy import stats

__all__ = ["Metrics"]


def _nanmean(x, axis=1, keepdims=False):
    """NaN-masked mean with an EXPLICIT empty-slice contract: slices with zero
    valid entries yield NaN silently (np.nanmean emits 'Mean of empty slice'
    RuntimeWarnings on all-NaN gauges, which the battery hits routinely on
    sparse observation records)."""
    valid = ~np.isnan(x)
    cnt = valid.sum(axis=axis, keepdims=keepdims)
    total = np.where(valid, x, 0.0).sum(axis=axis, keepdims=keepdims)
    return np.where(cnt > 0, total / np.maximum(cnt, 1), np.nan)


def _rmse(pred, target, axis=1):
    return np.sqrt(_nanmean((pred - target) ** 2, axis=axis))


@dataclasses.dataclass
class Metrics:
    """Per-gauge metrics over (n_gauges, n_time) prediction/target arrays."""

    pred: np.ndarray
    target: np.ndarray

    def __post_init__(self) -> None:
        self.pred = np.atleast_2d(np.asarray(self.pred, dtype=np.float64))
        self.target = np.atleast_2d(np.asarray(self.target, dtype=np.float64))
        if np.isnan(self.pred).any():
            raise ValueError("pred contains NaN, check your gradient chain")
        if self.pred.shape != self.target.shape:
            raise ValueError(f"shape mismatch {self.pred.shape} vs {self.target.shape}")
        self._compute()

    @property
    def ngrid(self) -> int:
        return self.pred.shape[0]

    @property
    def nt(self) -> int:
        return self.pred.shape[1]

    def _fdc(self, data: np.ndarray) -> np.ndarray:
        """100-point flow duration curve per gauge (exceedance-sorted);
        all-NaN gauges yield the reference's all-zero curve."""
        valid = ~np.isnan(data)
        kv = valid.sum(axis=1)
        srt = np.sort(np.where(valid, data, -np.inf), axis=1)[:, ::-1]
        idx = (np.arange(100)[None, :] / 100 * kv[:, None]).astype(np.int64)
        out = np.take_along_axis(srt, idx, axis=1)
        return np.where((kv == 0)[:, None], 0.0, out)

    def _compute(self) -> None:
        """Whole-battery computation, vectorized over the gauge axis. Variable
        per-gauge valid counts are handled by sorting invalid entries to the
        end (inf fill) and taking per-gauge cumulative-sum differences at the
        30%/98% split indices; Spearman ranks come from one `rankdata` call per
        array (inf fill keeps valid entries' ranks equal to their ranks among
        the valid subset alone). NaN contracts are identical to the loop:
        constant series yield NaN correlations explicitly (no scipy
        ConstantInputWarning), empty segments yield NaN, k<=1 gauges yield NaN
        for the moment-based metrics.
        """
        g, t = self.ngrid, self.nt
        if t == 0:
            # zero-length series: every metric NaN (matching the k==0 gauge
            # contract); reductions below have no identity on a 0 axis
            for nm in (
                "bias rmse mae ub_rmse fdc_rmse corr corr_spearman r2 nse flv "
                "fhv pbias pbias_mid kge kge_12 rmse_low rmse_high rmse_mid"
            ).split():
                setattr(self, nm, np.full(g, np.nan))
            return
        self.bias = _nanmean(self.pred - self.target, axis=1)
        self.rmse = _rmse(self.pred, self.target)
        self.mae = _nanmean(np.abs(self.pred - self.target), axis=1)

        pred_anom = self.pred - _nanmean(self.pred, axis=1, keepdims=True)
        target_anom = self.target - _nanmean(self.target, axis=1, keepdims=True)
        self.ub_rmse = _rmse(pred_anom, target_anom)
        self.fdc_rmse = _rmse(self._fdc(self.pred), self._fdc(self.target))

        m = ~np.isnan(self.pred) & ~np.isnan(self.target)
        k = m.sum(axis=1)
        k1 = np.maximum(k, 1)
        rows = np.arange(g)
        nan = np.full(g, np.nan)

        # --- sorted-segment family: pbias/flv/fhv + low/mid/high RMSE ---
        # (pred and target sorted INDEPENDENTLY within each gauge's valid
        # subset, as in the reference's FDC-style low/high-flow splits)
        ps = np.sort(np.where(m, self.pred, np.inf), axis=1)
        ts = np.sort(np.where(m, self.target, np.inf), axis=1)
        in_valid = np.arange(t)[None, :] < k[:, None]
        ps = np.where(in_valid, ps, 0.0)
        ts = np.where(in_valid, ts, 0.0)
        zcol = np.zeros((g, 1))
        cp = np.concatenate([zcol, np.cumsum(ps, axis=1)], axis=1)
        ct = np.concatenate([zcol, np.cumsum(ts, axis=1)], axis=1)
        cd2 = np.concatenate([zcol, np.cumsum((ps - ts) ** 2, axis=1)], axis=1)
        # round-half-even, matching the loop's Python round()
        i_lo = np.rint(0.3 * k).astype(np.int64)
        i_hi = np.rint(0.98 * k).astype(np.int64)
        zero = np.zeros(g, dtype=np.int64)

        def _seg_pbias(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
            num = (cp[rows, hi] - cp[rows, lo]) - (ct[rows, hi] - ct[rows, lo])
            den = ct[rows, hi] - ct[rows, lo]
            return np.divide(num, den, out=nan.copy(), where=den != 0) * 100.0

        def _seg_rmse(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
            cnt = hi - lo
            msq = np.divide(
                cd2[rows, hi] - cd2[rows, lo], cnt, out=nan.copy(), where=cnt > 0
            )
            return np.sqrt(msq)

        self.pbias = _seg_pbias(zero, k)
        self.flv = _seg_pbias(zero, i_lo)
        self.fhv = _seg_pbias(i_hi, k)
        self.pbias_mid = _seg_pbias(i_lo, i_hi)
        self.rmse_low = _seg_rmse(zero, i_lo)
        self.rmse_high = _seg_rmse(i_hi, k)
        self.rmse_mid = _seg_rmse(i_lo, i_hi)

        # --- moment family: Pearson/Spearman/NSE/KGE (k > 1 gauges only) ---
        pz = np.where(m, self.pred, 0.0)
        tz = np.where(m, self.target, 0.0)
        pmean = pz.sum(axis=1) / k1
        tmean = tz.sum(axis=1) / k1
        pa = np.where(m, self.pred - pmean[:, None], 0.0)
        ta = np.where(m, self.target - tmean[:, None], 0.0)
        cov = (pa * ta).sum(axis=1)
        pvar = (pa**2).sum(axis=1)
        tvar = (ta**2).sum(axis=1)

        # Constant series make correlation undefined (the loop's np.ptp check:
        # exact range, immune to the float residue a var==0 test would carry).
        pconst = np.where(m, self.pred, -np.inf).max(axis=1) == np.where(
            m, self.pred, np.inf
        ).min(axis=1)
        tconst = np.where(m, self.target, -np.inf).max(axis=1) == np.where(
            m, self.target, np.inf
        ).min(axis=1)
        corr_ok = (k > 1) & ~pconst & ~tconst
        denom = np.sqrt(pvar * tvar)
        self.corr = np.divide(cov, denom, out=nan.copy(), where=corr_ok & (denom > 0))

        def _masked_rank_corr() -> np.ndarray:
            pr = stats.rankdata(np.where(m, self.pred, np.inf), axis=1, method="average")
            tr = stats.rankdata(np.where(m, self.target, np.inf), axis=1, method="average")
            pra = np.where(m, pr - (np.where(m, pr, 0.0).sum(axis=1) / k1)[:, None], 0.0)
            tra = np.where(m, tr - (np.where(m, tr, 0.0).sum(axis=1) / k1)[:, None], 0.0)
            rden = np.sqrt((pra**2).sum(axis=1) * (tra**2).sum(axis=1))
            return np.divide(
                (pra * tra).sum(axis=1), rden, out=nan.copy(), where=corr_ok & (rden > 0)
            )

        self.corr_spearman = _masked_rank_corr()

        psd = np.sqrt(pvar / k1)
        tsd = np.sqrt(tvar / k1)
        kge_ok = (k > 1) & (tsd > 0) & (tmean != 0)
        safe_tsd = np.where(kge_ok, tsd, 1.0)
        safe_tmean = np.where(kge_ok, tmean, 1.0)
        self.kge = np.where(
            kge_ok,
            1
            - np.sqrt(
                (self.corr - 1) ** 2
                + (psd / safe_tsd - 1) ** 2
                + (pmean / safe_tmean - 1) ** 2
            ),
            np.nan,
        )
        kge12_ok = kge_ok & (pmean != 0)
        safe_pmean = np.where(kge12_ok, pmean, 1.0)
        self.kge_12 = np.where(
            kge12_ok,
            1
            - np.sqrt(
                (self.corr - 1) ** 2
                + ((psd * safe_tmean) / (safe_tsd * safe_pmean) - 1) ** 2
                + (pmean / safe_tmean - 1) ** 2
            ),
            np.nan,
        )

        ssres = np.where(m, (self.pred - self.target) ** 2, 0.0).sum(axis=1)
        nse_ok = (k > 1) & (tvar > 0)
        self.nse = np.where(
            nse_ok, 1 - ssres / np.where(nse_ok, tvar, 1.0), np.nan
        )
        self.r2 = self.nse.copy()  # the reference's r2==NSE quirk, kept deliberately

    def model_dump_json(self, indent: int | None = None) -> str:
        """Serialize all metric arrays (not pred/target) to JSON."""
        skip = {"pred", "target"}
        payload = {
            k: np.asarray(v).tolist()
            for k, v in vars(self).items()
            if k not in skip and isinstance(v, np.ndarray)
        }
        return json.dumps(payload, indent=indent)
