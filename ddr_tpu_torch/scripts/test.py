"""``ddr test`` on the port: sequential evaluation over time chunks with
carried discharge state, the port of ``ddr_tpu/scripts/test.py``. Writes
the daily predictions and observations to ``model_test.zarr`` with the JAX
package's arrays and attributes, and logs the metric battery.

The JAX command's skill telemetry (ROADMAP A.10) and its evaluation plots
(matplotlib, which the card machine lacks) are skipped, and the log says so.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.scripts.common import evaluate_hourly, get_flow_fn, load_kan, parse_cli, timed
from ddr_tpu_torch.scripts_utils import compute_daily_runoff
from ddr_tpu_torch.validation.configs import Config
from ddr_tpu_torch.validation.metrics import Metrics
from ddr_tpu_torch.validation.utils import log_metrics

log = logging.getLogger(__name__)

__all__ = ["main", "test", "timestamp_strings"]

#: Logged once by every ``ddr test`` run.
TEST_PARTS_ABSENT = (
    "not in this port yet, so off in this run: the skill telemetry of the evaluation "
    "(ROADMAP A.10) and the evaluation plots (they need matplotlib)"
)


def timestamp_strings(times: np.ndarray) -> list[str]:
    """``datetime64`` values as the JAX package's stores spell them
    (pandas' ``str(Timestamp)``: ``1981-10-02 00:00:00``)."""
    return [t.item().strftime("%Y-%m-%d %H:%M:%S") for t in np.asarray(times).astype("datetime64[s]")]


def test(cfg: Config, dataset=None, params=None) -> Metrics:
    """Sequential chunked inference on ``cfg.device``; returns the metric
    battery. ``params`` (a KAN state dict) wins over
    ``cfg.experiment.checkpoint``; with neither the KAN is fresh."""
    log.info(TEST_PARTS_ABSENT)
    dev = resolve_device(cfg.device)
    dataset = dataset or cfg.geodataset.get_dataset_class(cfg, device=dev)
    flow = get_flow_fn(cfg, dataset)
    kan = load_kan(cfg, params, purpose="evaluation")

    rd0 = dataset.routing_data
    assert rd0 is not None, "Routing dataclass not defined in dataset"
    assert rd0.observations is not None, "Observations not defined in dataset"
    # snapshot before iterating: a dataset may re-window its live object per chunk
    observations = np.array(rd0.observations.streamflow, copy=True)
    gage_ids = list(rd0.observations.gage_ids)

    predictions = evaluate_hourly(cfg, dataset, flow, kan)

    daily_runoff = compute_daily_runoff(predictions, cfg.params.tau)  # (G, D-1)
    daily_obs = observations[:, 1 : 1 + daily_runoff.shape[1]]
    time_range = dataset.dates.daily_time_range[1 : 1 + daily_runoff.shape[1]]

    out_path = Path(cfg.params.save_path) / "model_test.zarr"
    root = zarrlite.create_group(out_path)
    root.create_array("predictions", daily_runoff)
    root.create_array("observations", daily_obs.astype(np.float32))
    root.attrs.update(
        {
            "description": "Predictions and obs for time period",
            "start_time": cfg.experiment.start_time,
            "end_time": cfg.experiment.end_time,
            "version": os.environ.get("DDR_VERSION", "dev"),
            "gage_ids": gage_ids,
            "time": timestamp_strings(time_range),
            "units": "m3/s",
            "evaluation_basins_file": str(cfg.data_sources.gages),
            "model": str(cfg.experiment.checkpoint or "No Trained Model"),
        }
    )
    warmup = cfg.experiment.warmup
    metrics = Metrics(pred=daily_runoff[:, warmup:], target=daily_obs[:, warmup:])
    log_metrics(metrics, header="Test evaluation")
    log.info(f"Test run complete; results in {out_path}")
    return metrics


def main(argv: list[str] | None = None) -> int:
    """``[config.yaml] [a.b=c ...]``: validate the config in testing mode and evaluate."""
    cfg = parse_cli(argv, mode="testing")
    try:
        with timed("testing"):
            test(cfg)
    except KeyboardInterrupt:
        log.info("Keyboard interrupt received")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
