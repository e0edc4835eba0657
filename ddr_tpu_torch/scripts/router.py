"""``ddr route`` on the port: forward-only routing over the gauges (or every
segment), the port of ``ddr_tpu/scripts/router.py``. Writes the routed
hourly discharge to ``chrout.zarr`` with the JAX package's array and
attributes and prints a terminal summary. Each chunk is a ``route-batch``
span and one ``eval`` event of ``run_log.route.jsonl``.

The JAX command's hydrograph plot (matplotlib, which the card machine lacks)
is skipped, and the log says so.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geodatazoo.loader import DataLoader
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.observability.events import get_recorder, run_telemetry
from ddr_tpu_torch.observability.spans import span
from ddr_tpu_torch.routing.model import dmc
from ddr_tpu_torch.scripts.common import get_flow_fn, load_kan, parse_cli, timed
from ddr_tpu_torch.scripts_utils import safe_mean, safe_percentile
from ddr_tpu_torch.validation.configs import Config

log = logging.getLogger(__name__)

__all__ = ["main", "print_routing_summary", "route_domain"]

#: Logged once by every ``ddr route`` run.
ROUTE_PARTS_ABSENT = (
    "not in this port yet, so off in this run: the routing hydrograph plot (it needs "
    "matplotlib)"
)


def print_routing_summary(discharge: np.ndarray, ids: list, runtime_s: float, out_path: Path) -> None:
    """Print the terminal summary of a routing run."""
    peak = np.nanmax(discharge, axis=1)
    lines = [
        "=" * 60,
        "DDR routing summary",
        "=" * 60,
        f"  segments routed     : {discharge.shape[0]}",
        f"  timesteps (hours)   : {discharge.shape[1]}",
        f"  runtime             : {runtime_s:.2f} s",
        f"  mean discharge      : {safe_mean(discharge):.3f} m³/s",
        f"  median peak         : {safe_percentile(peak, 50):.3f} m³/s",
        f"  max peak            : {np.nanmax(peak):.3f} m³/s",
        f"  output              : {out_path}",
        "=" * 60,
    ]
    print("\n".join(lines))


def route_domain(cfg: Config, dataset=None, params=None) -> np.ndarray:
    """Route the whole window chunk by chunk with carried discharge state on
    ``cfg.device``; returns the ``(S, T)`` routed discharge at the outputs
    (the gauges, or every segment)."""
    log.info(ROUTE_PARTS_ABSENT)
    dev = resolve_device(cfg.device)
    dataset = dataset or cfg.geodataset.get_dataset_class(cfg, device=dev)
    flow = get_flow_fn(cfg, dataset)
    kan = load_kan(cfg, params, purpose="routing")

    routing_model = dmc(cfg, device=dev)
    loader = DataLoader(dataset, batch_size=cfg.experiment.batch_size, shuffle=False)
    rd0 = dataset.routing_data
    assert rd0 is not None, "Routing dataclass not defined in dataset"
    n_outputs = len(rd0.outflow_idx) if rd0.outflow_idx is not None else rd0.n_segments
    output_ids = (
        list(rd0.gage_catchment)
        if rd0.gage_catchment is not None
        else [str(d) for d in np.asarray(rd0.divide_ids)[:n_outputs]]
    )

    rec = get_recorder()
    t0 = time.perf_counter()
    discharge = np.zeros((n_outputs, len(dataset.dates.hourly_time_range)), dtype=np.float32)
    for i, rd in enumerate(loader):
        t_b = time.perf_counter()
        q_prime = np.asarray(flow(routing_dataclass=rd), dtype=np.float32)
        t_r = time.perf_counter()
        with span("route-batch"), torch.no_grad():
            raw = kan(torch.as_tensor(rd.normalized_spatial_attributes, device=dev))
            out = routing_model.forward(rd, q_prime, raw, carry_state=i > 0)
            discharge[:, rd.dates.hourly_indices] = out["runoff"].cpu().numpy()  # synchronises
        t_e = time.perf_counter()
        dr = max(t_e - t_r, 1e-12)
        log.info(f"route batch {i}: {rd.n_segments * q_prime.shape[0] / dr:,.0f} "
                 f"reach-timesteps/s ({dr * 1e3:.3f} ms, {q_prime.shape[0]} h)")
        if rec is not None:  # the event's time includes the inflow read, as JAX's does
            dt = max(t_e - t_b, 1e-6)
            rec.emit(
                "eval",
                batch=i,
                n_reaches=int(rd.n_segments),
                n_timesteps=int(q_prime.shape[0]),
                seconds=round(dt, 6),
                reach_timesteps_per_sec=round(rd.n_segments * q_prime.shape[0] / dt, 1),
            )
    runtime = time.perf_counter() - t0

    out_path = Path(cfg.params.save_path) / "chrout.zarr"
    root = zarrlite.create_group(out_path)
    root.create_array("discharge", discharge)
    root.attrs.update(
        {
            "description": "DDR routed discharge",
            "start_time": cfg.experiment.start_time,
            "end_time": cfg.experiment.end_time,
            "version": os.environ.get("DDR_VERSION", "dev"),
            "ids": [str(i) for i in output_ids],
            "units": "m3/s",
            "model": str(cfg.experiment.checkpoint or "No Trained Model"),
        }
    )
    print_routing_summary(discharge, output_ids, runtime, out_path)
    return discharge


def main(argv: list[str] | None = None) -> int:
    """``[config.yaml] [a.b=c ...]``: validate the config in routing mode and route."""
    cfg = parse_cli(argv, mode="routing")
    # the interrupt is caught outside run_telemetry, so the run log says "interrupted"
    try:
        with timed("routing"), run_telemetry(cfg, "route"):
            route_domain(cfg)
    except KeyboardInterrupt:
        log.info("Keyboard interrupt received")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
