"""``ddr summed-q-prime`` on the port: the un-routed baseline, the port of
``ddr_tpu/scripts/summed_q_prime.py``.

A gauge's predicted flow is the plain sum of the lateral inflow over its
upstream divide set (the ``order`` of its subset in the gauge adjacency
store), with no routing physics. The sum over each gauge's divides is one
``torch.nansum`` on ``cfg.device``, as the JAX command's is one
``jnp.nansum`` outside any kernel. The command prints a summary table and
writes ``summed_q_prime_summary.json``, ``summed_q_prime_metrics.csv`` (the
``csv`` module, in pandas' column order) and ``summed_q_prime.zarr``, which
``ddr benchmark`` reads through its ``summed_q_prime`` key.

    python -m ddr_tpu_torch.cli summed-q-prime config.yaml device=cpu
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geodatazoo.dataclasses import Dates
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.io.readers import USGSObservationReader, read_zarr
from ddr_tpu_torch.io.stores import open_hydro_store
from ddr_tpu_torch.scripts.common import parse_cli, timed
from ddr_tpu_torch.scripts_utils import safe_mean, safe_percentile
from ddr_tpu_torch.validation.configs import Config
from ddr_tpu_torch.validation.metrics import Metrics
from ddr_tpu_torch.validation.utils import log_metrics

log = logging.getLogger(__name__)

__all__ = ["eval_q_prime", "main", "print_metrics_summary"]

#: The metric columns of the summary and the per-gauge CSV, in order.
SUMMARY_METRICS = ("nse", "kge", "rmse", "corr", "pbias")


def _csv_cell(value) -> str:
    """One float as pandas' ``to_csv`` writes it: the shortest repr, NaN empty."""
    value = np.float64(value)
    return "" if np.isnan(value) else str(value)


def print_metrics_summary(metrics: Metrics, gage_ids: list[str], save_dir: Path) -> dict:
    """Print the summary table (median and mean of each metric), write it as
    ``summed_q_prime_summary.json`` and the per-gauge metrics as
    ``summed_q_prime_metrics.csv``; returns the summary."""
    summary = {
        name: {
            "median": safe_percentile(getattr(metrics, name), 50),
            "mean": safe_mean(getattr(metrics, name)),
        }
        for name in SUMMARY_METRICS
    }
    print("=" * 56)
    print("Summed Q' baseline (no routing)")
    print("=" * 56)
    for name, row in summary.items():
        print(f"  {name:>6}: median {row['median']:8.3f}  mean {row['mean']:8.3f}")
    print("=" * 56)

    save_dir.mkdir(parents=True, exist_ok=True)
    (save_dir / "summed_q_prime_summary.json").write_text(json.dumps(summary, indent=2))
    columns = [np.asarray(getattr(metrics, name)) for name in SUMMARY_METRICS]
    with open(save_dir / "summed_q_prime_metrics.csv", "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["gage_id", *SUMMARY_METRICS])
        for i, gid in enumerate(gage_ids):
            writer.writerow([gid, *(_csv_cell(col[i]) for col in columns)])
    return summary


def eval_q_prime(cfg: Config) -> Metrics:
    """The ΣQ' baseline of every gauge that has both observations and a
    subset in the gauge adjacency store: daily predictions, the metric
    battery against the observations, and the three output files under
    ``cfg.params.save_path``."""
    dev = resolve_device(cfg.device)
    store = open_hydro_store(cfg.data_sources.streamflow)
    obs_reader = USGSObservationReader(cfg)
    dates = Dates(start_time=cfg.experiment.start_time, end_time=cfg.experiment.end_time)
    observations = obs_reader.read_data(dates=dates)
    gages_adjacency = read_zarr(Path(cfg.data_sources.gages_adjacency))

    available = [g for g in observations.gage_ids if g in gages_adjacency]
    if not available:
        raise ValueError("no gauges overlap between observations and gages_adjacency")

    n_days = len(dates.daily_time_range)
    preds = np.zeros((len(available), n_days), dtype=np.float32)
    for i, gid in enumerate(available):
        sub = gages_adjacency[gid]
        assert isinstance(sub, zarrlite.ZarrGroup)
        # the subset group's ``order`` is the gauge's upstream divide set
        divide_ids = sub["order"].read()

        store_rows = []
        for divide in divide_ids:
            for key in (divide, int(divide), str(divide), f"cat-{divide}"):
                row = store.id_to_index.get(key)
                if row is not None:
                    store_rows.append(row)
                    break
        if not store_rows:
            log.warning(f"gage {gid}: no upstream divides found in the streamflow store")
            continue

        if store.is_hourly:
            hours = np.asarray(dates.batch_hourly_time_range).astype("datetime64[s]") - store.start_date
            q = store.select("Qr", np.asarray(store_rows), np.asarray(hours // np.timedelta64(3600, "s"),
                                                                     dtype=np.int64))
            q_daily = q.reshape(len(store_rows), n_days, 24).mean(axis=2)
        else:
            time_idx = dates.numerical_time_range - store.time_offset_days
            q_daily = store.select("Qr", np.asarray(store_rows), time_idx)
        preds[i] = torch.nansum(torch.as_tensor(q_daily, device=dev), dim=0).cpu().numpy()

    obs = observations.sel_gages(available).streamflow[:, :n_days]
    metrics = Metrics(pred=preds, target=obs)
    log_metrics(metrics, header="Summed Q' baseline")
    save_dir = Path(cfg.params.save_path)
    print_metrics_summary(metrics, available, save_dir)

    root = zarrlite.create_group(save_dir / "summed_q_prime.zarr")
    root.create_array("predictions", preds)
    root.create_array("observations", obs.astype(np.float32))
    root.attrs.update(
        {
            "gage_ids": list(available),
            "start_time": cfg.experiment.start_time,
            "end_time": cfg.experiment.end_time,
            "description": "Summed lateral inflow baseline (no routing)",
        }
    )
    return metrics


def main(argv: list[str] | None = None) -> int:
    """``[config.yaml] [a.b=c ...]``: validate the config in testing mode and
    compute the baseline."""
    cfg = parse_cli(argv, mode="testing")
    with timed("summed-q-prime"):
        try:
            eval_q_prime(cfg)
        except KeyboardInterrupt:
            log.info("Keyboard interrupt received")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
