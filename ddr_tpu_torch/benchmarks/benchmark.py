"""``ddr benchmark`` on the port: Muskingum-Cunge routing against the LTI
comparator and the un-routed ΣQ' baseline; the port of
``ddr_tpu/benchmarks/benchmark.py``.

Phase 1 is the sequential evaluation loop of ``ddr test``
(:func:`~ddr_tpu_torch.scripts.common.evaluate_hourly`). Phase 2 routes the
same lateral inflows over the whole window through the frequency-domain LTI
router (:func:`~ddr_tpu_torch.benchmarks.irf.route_lti`) and aggregates
them at the gauges. Headwater gauges are masked and daily metrics are logged
for each model. When the config names a ΣQ' store (``summed_q_prime``, the
output of ``ddr summed-q-prime``), its gauges join the battery and the
routed volumes are mass-balanced against it. ``benchmark_results.zarr``
gets the JAX package's arrays and attributes. The comparison plots need
matplotlib, which the card machine lacks, and are skipped.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ddr_tpu_torch.benchmarks.configs import BenchmarkConfig, validate_benchmark_config
from ddr_tpu_torch.benchmarks.irf import irf_kernels, route_lti
from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.routing.mc import GaugeIndex
from ddr_tpu_torch.routing.model import prepare_batch
from ddr_tpu_torch.scripts.common import (
    evaluate_hourly,
    get_flow_fn,
    load_kan,
    setup_run,
    split_config_argv,
    timed,
)
from ddr_tpu_torch.scripts_utils import compute_daily_runoff
from ddr_tpu_torch.validation import yaml_subset
from ddr_tpu_torch.validation.configs import _apply_override
from ddr_tpu_torch.validation.metrics import Metrics
from ddr_tpu_torch.validation.utils import log_metrics

log = logging.getLogger(__name__)

__all__ = [
    "benchmark",
    "build_headwater_mask",
    "load_summed_q_prime",
    "main",
    "mass_balance",
    "run_lti_benchmark",
]

#: Logged once by every ``ddr benchmark`` run.
BENCHMARK_PARTS_ABSENT = (
    "not in this port yet, so off in this run: the benchmark comparison plots (they need "
    "matplotlib)"
)


def build_headwater_mask(rd: Any) -> np.ndarray:
    """True = non-headwater (keep). A gauge is headwater when none of its
    upstream-inflow segments has an incoming edge."""
    has_upstream = np.zeros(rd.n_segments, dtype=bool)
    has_upstream[np.unique(np.asarray(rd.adjacency_rows))] = True
    mask = np.array([bool(has_upstream[np.asarray(ix)].any()) for ix in rd.outflow_idx])
    log.info(f"Headwater filter: {int(mask.sum())}/{len(mask)} gauges kept")
    return mask


def load_summed_q_prime(
    path: str | Path, gage_ids: np.ndarray, daily_obs: np.ndarray, warmup: int
) -> tuple[Metrics, np.ndarray, np.ndarray] | None:
    """Align a ΣQ' store (``ddr summed-q-prime``'s ``summed_q_prime.zarr``)
    with the benchmark gauges: ``(metrics, daily predictions of the matched
    gauges, boolean mask into gage_ids)``, or None with a warning when the
    store cannot be opened or shares no gauge."""
    try:
        root = zarrlite.open_group(path)
        sqp_gages = np.asarray(root.attrs["gage_ids"], dtype=str)
        sqp_preds = root["predictions"][:]
    except (FileNotFoundError, KeyError, ValueError):
        log.warning(f"Failed to open summed Q' store at {path}")
        return None

    gage_ids = np.asarray(gage_ids, dtype=str)
    common = np.isin(gage_ids, sqp_gages)
    if not common.any():
        log.warning("No common gauges between benchmark and summed Q' store")
        return None
    sqp_idx = [int(np.where(sqp_gages == g)[0][0]) for g in gage_ids[common]]
    num_days = min(sqp_preds.shape[1], daily_obs.shape[1])
    sqp_aligned = sqp_preds[sqp_idx, :num_days]
    obs_aligned = daily_obs[common, :num_days]
    log.info(f"Summed Q': {int(common.sum())}/{len(gage_ids)} gauges matched, {num_days} days")
    metrics = Metrics(pred=sqp_aligned[:, warmup:], target=obs_aligned[:, warmup:])
    return metrics, sqp_aligned, common


def run_lti_benchmark(bench_cfg: BenchmarkConfig, dataset: Any, flow: Any) -> np.ndarray:
    """Phase 2: route the whole window's lateral inflows through the LTI
    comparator on ``cfg.device`` and aggregate at the gauges. Returns
    ``(G, T_hourly)``; logs the route's time and, on the card, its peak
    device memory."""
    cfg, lti = bench_cfg.ddr, bench_cfg.lti
    dev = resolve_device(cfg.device)
    rd = dataset.routing_data
    dataset.dates.set_date_range(np.arange(len(dataset.dates.daily_time_range)))
    q_prime = torch.as_tensor(np.asarray(flow(routing_dataclass=rd), dtype=np.float32), device=dev)
    # a plain RiverNetwork: route_lti reads its solve schedule
    network, _, gauges = prepare_batch(rd, cfg.params.attribute_minimums["slope"], device=dev,
                                       chunked=False)
    if gauges is None:
        gauges = GaugeIndex.from_ragged(rd.outflow_idx, device=dev)
    n = rd.n_segments
    k_val = lti.k if lti.k is not None else 0.1042
    kernels = irf_kernels(lti.irf_fn, np.full(n, k_val), np.full(n, lti.x), lti.dt, lti.max_delay,
                          lti.nash_n)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    q_all = route_lti(network, kernels, q_prime, pad_steps=lti.pad_steps)  # (T, N)
    out = gauges.aggregate(q_all).T.cpu().numpy()  # (G, T), synchronises
    seconds = time.perf_counter() - t0
    peak = ""
    if dev.type == "cuda":
        peak = (f", peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB "
                f"({(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.3f} GB above its inputs)")
    log.info(f"LTI route: {seconds * 1e3:.3f} ms for T={q_prime.shape[0]} h x {n} reaches{peak}")
    return out


def mass_balance(daily: np.ndarray, sqp_daily: np.ndarray, warmup: int) -> np.ndarray:
    """Per-gauge relative error of the total routed volume after ``warmup``
    days against ΣQ''s, over the days both cover; ``daily`` holds the
    gauges the ΣQ' store matched, in its order."""
    num_days = sqp_daily.shape[1]
    sqp_total = np.nansum(sqp_daily[:, warmup:], axis=1)
    denom = np.where(sqp_total != 0, sqp_total, 1.0)
    return np.abs(np.nansum(daily[:, warmup:num_days], axis=1) - sqp_total) / denom


def benchmark(bench_cfg: BenchmarkConfig) -> dict[str, Metrics]:
    """Run the whole comparison on ``cfg.device``; returns each model's
    metric battery (``mc``, ``lti`` when enabled, ``summed_q_prime`` when the
    config names a ΣQ' store that shares gauges with the run)."""
    log.info(BENCHMARK_PARTS_ABSENT)
    cfg = bench_cfg.ddr
    dev = resolve_device(cfg.device)
    dataset = cfg.geodataset.get_dataset_class(cfg, device=dev)
    flow = get_flow_fn(cfg, dataset)
    kan = load_kan(cfg, purpose="benchmarking")

    rd0 = dataset.routing_data
    assert rd0 is not None and rd0.observations is not None, "dataset must carry obs"
    observations = np.array(rd0.observations.streamflow, copy=True)
    gage_ids = np.asarray(rd0.observations.gage_ids, dtype=str)

    log.info("Phase 1: Muskingum-Cunge evaluation...")
    mc_hourly = evaluate_hourly(cfg, dataset, flow, kan)

    lti_hourly = np.full_like(mc_hourly, np.nan)
    if bench_cfg.lti.enabled:
        log.info(f"Phase 2: LTI routing ({bench_cfg.lti.irf_fn})...")
        lti_hourly = run_lti_benchmark(bench_cfg, dataset, flow)

    keep = build_headwater_mask(rd0)
    gage_ids, observations = gage_ids[keep], observations[keep]
    mc_hourly, lti_hourly = mc_hourly[keep], lti_hourly[keep]

    mc_daily = compute_daily_runoff(mc_hourly, cfg.params.tau)  # (G, D-1)
    lti_daily = compute_daily_runoff(lti_hourly, cfg.params.tau)
    daily_obs = observations[:, 1 : 1 + mc_daily.shape[1]]
    warmup = cfg.experiment.warmup

    results: dict[str, Metrics] = {}
    results["mc"] = Metrics(pred=mc_daily[:, warmup:], target=daily_obs[:, warmup:])
    log_metrics(results["mc"], header="=== Muskingum-Cunge (MC) metrics ===")
    if bench_cfg.lti.enabled:
        results["lti"] = Metrics(pred=lti_daily[:, warmup:], target=daily_obs[:, warmup:])
        log_metrics(results["lti"], header=f"=== LTI ({bench_cfg.lti.irf_fn}) metrics ===")

    sqp = None
    if bench_cfg.summed_q_prime is not None:
        sqp = load_summed_q_prime(bench_cfg.summed_q_prime, gage_ids, daily_obs, warmup)
    if sqp is not None:
        sqp_metrics, sqp_daily, common = sqp
        results["summed_q_prime"] = sqp_metrics
        log_metrics(sqp_metrics, header="=== ΣQ' baseline metrics ===")
        for name, daily in (("MC", mc_daily), ("LTI", lti_daily)):
            if name == "LTI" and not bench_cfg.lti.enabled:
                continue
            err = mass_balance(daily[common], sqp_daily, warmup)
            log.info(f"Mass balance {name} vs ΣQ': mean rel err {err.mean():.4f}, "
                     f"median {np.median(err):.4f}")

    save_dir = Path(cfg.params.save_path)
    root = zarrlite.create_group(save_dir / "benchmark_results.zarr")
    root.create_array("mc_predictions", mc_daily)
    root.create_array("lti_predictions", lti_daily)
    root.create_array("observations", daily_obs.astype(np.float32))
    root.attrs.update(
        {
            "description": "Benchmark comparison: MC routing vs LTI IRF routing",
            "irf_fn": bench_cfg.lti.irf_fn,
            "gage_ids": [str(g) for g in gage_ids],
            "version": os.environ.get("DDR_VERSION", "dev"),
            "model_checkpoint": str(cfg.experiment.checkpoint or "None"),
        }
    )
    log.info(f"Benchmark complete; results in {save_dir / 'benchmark_results.zarr'}")
    return results


def main(argv: list[str] | None = None) -> int:
    """``[config.yaml] [a.b=c ...]``: validate the benchmark config (testing
    mode unless it says otherwise) and run the comparison."""
    path, overrides = split_config_argv(argv)
    raw: dict = {}
    if path is not None:
        raw = yaml_subset.safe_load(Path(path).read_text()) or {}
    for ov in overrides:
        k, v = ov.split("=", 1)
        _apply_override(raw, k, v)
    # default the mode inside whichever layout (flat or nested under "ddr") is in use
    (raw["ddr"] if isinstance(raw.get("ddr"), dict) else raw).setdefault("mode", "testing")
    bench_cfg = validate_benchmark_config(raw)
    setup_run(bench_cfg.ddr)
    with timed("benchmark"):
        benchmark(bench_cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
