"""Ensemble forecasts: E perturbed members routed in one batched launch.

The port of ``ddr_tpu/fleet/ensemble.py``. An E-member forecast runs the
KAN and the denormalization once, perturbs the ``(T, N)`` forcing window
into ``(E, T, N)`` on the device with per-member lognormal noise
(``exp(sigma * N(0, 1))``, drawn from the request id with the JAX package's
threefry bits, :mod:`~ddr_tpu_torch.fleet.prng`, so the same request id gives
the same members in both packages), and routes all members as one batch:
on a single-ring network that is one ``wave_scan_tm`` launch with B = E. The
worst gauges come from
:func:`~ddr_tpu_torch.observability.health.compute_output_worst` over every
member; the percentile hydrographs are taken on the host, so any list of
percentiles is free.

The JAX package compiles one program per (network, model, E) ahead of time
and caches it; the port's kernels take any batch, so there is nothing to
cache.
"""

from __future__ import annotations

import hashlib
import time
import warnings
from typing import Any

import numpy as np
import torch

from ddr_tpu_torch.fleet.config import FleetConfig
from ddr_tpu_torch.fleet.prng import fold_in, normal, prng_key
from ddr_tpu_torch.observability.health import compute_output_worst
from ddr_tpu_torch.observability.trace import adopt_trace_id, new_span_id, trace_enabled
from ddr_tpu_torch.routing.mc import route
from ddr_tpu_torch.routing.model import denormalize_spatial_parameters
from ddr_tpu_torch.serving.service import make_request_id, request_window

__all__ = [
    "DEFAULT_PERCENTILES",
    "EnsembleRunner",
    "member_forcing",
    "member_windows",
    "percentile_bands",
    "perturbation_seed",
]

#: Percentiles returned when a request names none.
DEFAULT_PERCENTILES = (10.0, 50.0, 90.0)


def percentile_bands(runoff_e: np.ndarray, qs: tuple[float, ...]) -> tuple[np.ndarray, int]:
    """Percentile hydrographs over the member axis: ``(E, T, G)`` ->
    ``((P, T, G) bands, non-finite member count)``. A member with any
    non-finite cell counts as non-finite; its non-finite cells are left out
    of the bands (``np.nanpercentile``) instead of poisoning them, and a cell
    with no finite member gives a NaN band value."""
    runoff_e = np.asarray(runoff_e)
    finite = np.isfinite(runoff_e)
    n_bad = int(runoff_e.shape[0] - finite.all(axis=(1, 2)).sum())
    if n_bad == 0:
        return np.percentile(runoff_e, qs, axis=0), 0
    masked = np.where(finite, runoff_e, np.nan)
    with warnings.catch_warnings():
        # a cell where every member broke is a NaN band, not a warning
        warnings.simplefilter("ignore", category=RuntimeWarning)
        bands = np.nanpercentile(masked, qs, axis=0)
    return bands, n_bad


def perturbation_seed(request_id: str, seed: int = 0) -> int:
    """The 31-bit seed every member key folds from: the first four bytes of
    the SHA-1 of ``"<request_id>|<seed>"``, so a replayed request id
    reproduces its ensemble in any process."""
    digest = hashlib.sha1(f"{request_id}|{int(seed)}".encode()).digest()
    return int.from_bytes(digest[:4], "big") & 0x7FFFFFFF


def member_windows(q_prime: torch.Tensor, base_seed: int, members: int, sigma: float) -> torch.Tensor:
    """The ``(E, T, N)`` perturbed windows of an ensemble, on ``q_prime``'s
    device: member ``m`` is ``q_prime * exp(sigma * normal(fold_in(key, m)))``
    in float32, ``key = PRNGKey(base_seed)``; ``sigma = 0`` repeats the
    window. A new contiguous tensor, as the kernels require."""
    q = q_prime.to(torch.float32)
    if sigma == 0.0:
        return q.expand((int(members), *q.shape)).contiguous()
    key = prng_key(base_seed)
    noise = torch.empty((int(members), *q.shape), dtype=torch.float32, device=q.device)
    for m in range(int(members)):
        normal(fold_in(key, m), tuple(q.shape), device=q.device, out=noise[m])
    # in place: at E = 64 and 65,536 reaches x 72 h each (E, T, N) array is 1.2 GB
    return noise.mul_(float(np.float32(sigma))).exp_().mul_(q)


def member_forcing(q_prime: np.ndarray, request_id: str, seed: int, member: int,
                   sigma: float) -> np.ndarray:
    """Member ``member``'s perturbed window on the host, in the JAX
    package's numpy form (``qp * np.exp(np.float32(sigma) * normal)``): the
    offline twin that routes one member at a time through the plain serve
    path."""
    qp = np.asarray(q_prime, dtype=np.float32)
    if sigma == 0.0:
        return qp
    key = fold_in(prng_key(perturbation_seed(request_id, seed)), int(member))
    noise = np.exp(np.float32(sigma) * normal(key, qp.shape).numpy())
    return qp * noise


class EnsembleRunner:
    """The ensemble path of one
    :class:`~ddr_tpu_torch.serving.service.ForecastService`, held by it
    (``service.ensemble_forecast``). Thread-safe: it keeps no state between
    requests."""

    def __init__(self, service: Any, fleet_cfg: FleetConfig | None = None) -> None:
        self._svc = service
        self.fleet_cfg = fleet_cfg or FleetConfig.from_env()

    # ---- request path ----

    def forecast(
        self,
        network: str,
        model: str = "default",
        q_prime: Any | None = None,
        t0: int | None = None,
        gauges: Any | None = None,
        members: int = 8,
        percentiles: Any | None = None,
        seed: int = 0,
        request_id: str | None = None,
        trace_id: str | None = None,
        return_members: bool = False,
    ) -> dict:
        """One ensemble forecast, on the caller's thread; ``submit``'s request
        fields plus ``members``, ``percentiles`` and ``seed``. Answers the JAX
        package's keys: ``runoff`` is the ``(P, T, G)`` band stack, ``mean``
        the member mean, ``worst`` the worst gauges over all members;
        ``return_members`` adds the ``(E, T, G)`` ``member_runoff``."""
        svc = self._svc
        net = svc.networks().get(network)
        if net is None:
            raise ValueError(f"unknown network {network!r}")
        entry = svc.registry.get(model)  # one snapshot for all members
        E = int(members)
        if not 1 <= E <= self.fleet_cfg.ensemble_max_members:
            raise ValueError(
                f"members must be in [1, {self.fleet_cfg.ensemble_max_members}], got {members}"
            )
        qs = tuple(float(p) for p in (DEFAULT_PERCENTILES if percentiles is None else percentiles))
        if not qs or any(not 0.0 <= p <= 100.0 for p in qs):
            raise ValueError(f"percentiles must be in [0, 100], got {qs!r}")
        qp, start, gauge_sel = request_window(net, network, q_prime, t0, gauges,
                                              gauge_error="gauge index out of range")
        rid = make_request_id(request_id)
        trace: dict = {}
        if trace_enabled():
            trace = {"trace_id": adopt_trace_id(trace_id), "span_id": new_span_id()}

        t_start = time.perf_counter()
        runoff_e, widx, wscore = self._route(net, entry, qp, E, perturbation_seed(rid, seed))
        seconds = time.perf_counter() - t_start

        if gauge_sel is not None:
            runoff_e = runoff_e[:, :, gauge_sel]
        bands, n_nonfinite = percentile_bands(runoff_e, qs)  # (P, T, G)
        svc._emit(
            "serve_request", status="ok", network=network, model=model, request_id=rid,
            latency_s=round(seconds, 6), execute_s=round(seconds, 6), version=entry.version,
            ensemble_members=E, n_gauges=int(runoff_e.shape[2]), slo_ok=True,
            **({"ensemble_nonfinite_members": n_nonfinite} if n_nonfinite else {}),
            **trace,
        )
        valid_times = svc._feed_verifier(network, model, rid, start, gauge_sel, runoff_e)
        out = {
            "network": network,
            "model": model,
            "version": entry.version,
            "engine": f"{svc._engine_label(net)}:ensemble{E}",
            "request_id": rid,
            "members": E,
            "seed": int(seed),
            "percentiles": list(qs),
            "runoff": bands,
            "mean": runoff_e.mean(axis=0),
            "worst": {
                "gauges": np.asarray(widx).astype(int).tolist(),
                "scores": [round(float(s), 6) for s in np.asarray(wscore)],
            },
            "execute_s": round(seconds, 6),
            "ensemble_nonfinite_members": n_nonfinite,
            **({"valid_times": valid_times} if valid_times is not None else {}),
            **trace,
        }
        if return_members:
            out["member_runoff"] = runoff_e
        return out

    def _route(self, net: Any, entry: Any, qp: np.ndarray, E: int,
               base_seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """KAN -> denormalize once, the E perturbed windows, one batched
        ``route`` -> host ``((E, T, G) runoff, worst_idx, worst_score)``."""
        svc = self._svc
        p = svc.cfg.params
        top_k = min(max(1, svc.health_cfg.top_k or 8), net.n_outputs)
        # grad mode is per thread, and an HTTP or load-generator thread calls this
        with torch.no_grad():
            raw = entry.kan(net.attrs)
            phys = denormalize_spatial_parameters(
                raw, p.parameter_ranges, p.log_space_parameters, p.defaults, net.n_segments
            )
            q = torch.from_numpy(np.ascontiguousarray(qp, dtype=np.float32)).to(svc.device)
            qe = member_windows(q, base_seed, E, self.fleet_cfg.ensemble_sigma)
            if net.flow_scale is not None:
                qe.mul_(net.flow_scale)
            runoff = route(net.network, net.channels, phys, qe, gauges=net.gauge_index,
                           bounds=svc.bounds, device=svc.device).runoff
            widx, wscore = compute_output_worst(runoff, top_k)
        return runoff.cpu().numpy(), widx.cpu().numpy(), wscore.cpu().numpy()
