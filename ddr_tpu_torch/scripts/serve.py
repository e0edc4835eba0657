"""``ddr serve`` on the port: the batched, hot-reloadable forecast service
behind its HTTP front, the port of ``ddr_tpu/scripts/serve.py``.

Builds a :class:`~ddr_tpu_torch.serving.service.ForecastService` from the run
config on ``cfg.device`` (the card unless ``device=cpu``): the configured
dataset supplies the routing domain and its hourly forcing (network
``"default"``), ``experiment.checkpoint`` (or a fresh KAN, with a warning)
supplies model ``"default"``, and ``<save_path>/saved_models``, where ``ddr
train`` writes its checkpoints, is watched for hot-reload, so a trainer and
a server pointed at the same run directory form a live train-to-serve loop.
Warmup runs every (network, model) pair before ``/readyz`` answers 200.

    python -m ddr_tpu_torch.cli serve examples/synthetic/config.yaml device=cpu
    curl -s localhost:8080/readyz

``DDR_SERVE_*`` variables set the serving knobs (:class:`ServeConfig`), among
them ``DDR_SERVE_HOST``/``DDR_SERVE_PORT``. Ctrl-C stops the server, drains
the queue and stops the watcher. Every admission, batch and shed is an event
of ``run_log.serve.jsonl`` (``DDR_METRICS_DIR``, else the save path).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.fleet.config import fleet_identity
from ddr_tpu_torch.observability.federate import replicas_from_env
from ddr_tpu_torch.observability.events import run_telemetry
from ddr_tpu_torch.observability.trace import trace_enabled
from ddr_tpu_torch.scripts.common import get_flow_fn, kan_arch, load_kan, parse_cli
from ddr_tpu_torch.serving.config import ServeConfig
from ddr_tpu_torch.serving.http_api import serve_http
from ddr_tpu_torch.serving.service import ForecastService
from ddr_tpu_torch.validation.configs import Config

log = logging.getLogger(__name__)

__all__ = ["build_service", "main", "serve"]

def build_service(
    cfg: Config, serve_cfg: ServeConfig | None = None, warmup: bool = True, watch: bool = True,
) -> ForecastService:
    """Config -> (warmed) service with the run's dataset registered as network
    ``"default"`` and its KAN as model ``"default"``: the testable core of
    the ``serve`` command, which adds the HTTP front."""
    dev = resolve_device(cfg.device)
    service = ForecastService(cfg, serve_cfg, device=dev)
    try:
        dataset = cfg.geodataset.get_dataset_class(cfg, device=dev)
        rd = dataset.routing_data
        if rd is None:
            raise ValueError("dataset carries no routing data; cannot serve")
        # the dataset's dates open on the full experiment window, so this is the
        # whole period's hourly forcing, which requests window into by t0
        forcing = np.asarray(get_flow_fn(cfg, dataset)(routing_dataclass=rd), dtype=np.float32)
        service.register_network("default", rd, forcing=forcing)
        kan = load_kan(cfg, purpose="serving")
        source = str(cfg.experiment.checkpoint) if cfg.experiment.checkpoint else None
        service.register_model("default", kan, arch=kan_arch(cfg), source=source)
        if watch:
            service.watch_checkpoints("default", Path(cfg.params.save_path) / "saved_models")
        if warmup:
            service.warmup()
    except BaseException:
        service.close(drain=False)
        raise
    return service


def serve(cfg: Config, serve_cfg: ServeConfig | None = None) -> int:
    """Build the service and answer HTTP on this thread until interrupted.
    The boot log states what this replica answers for: trace propagation,
    the targets ``/metrics?federated=1`` scrapes, and its fleet identity."""
    service = build_service(cfg, serve_cfg)
    dev = service.device
    if dev.type == "cuda":  # the card and what this process holds on it, for a replica's boot log
        log.info(f"serving on {dev} ({torch.cuda.get_device_name(dev)}), "
                 f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB of device memory reserved after warmup")
    else:
        log.info(f"serving on {dev}")
    if trace_enabled():
        log.info("trace propagation on: X-DDR-Trace-Id adopted/minted per request")
    else:
        log.info("trace propagation OFF (DDR_TRACE=0): responses carry no trace ids")
    replicas = replicas_from_env()
    if replicas:
        log.info(f"/metrics?federated=1 federates {len(replicas)} replica(s): "
                 + ", ".join(label for label, _ in replicas))
    identity = fleet_identity()
    if identity is not None:
        log.info(f"fleet identity: group {identity['group']!r} replica {identity.get('replica', '?')} "
                 f"(router {identity.get('router', 'unknown')}) — /v1/stats carries this under \"fleet\"")
    try:
        serve_http(service, block=True)
    except KeyboardInterrupt:
        log.info("shutting down forecast service")
    finally:
        service.close()
    log.info("forecast service stopped")
    return 0


def main(argv: list[str] | None = None) -> int:
    """``[config.yaml] [a.b=c ...]``: validate the config in testing mode and serve.
    The JAX command first points XLA's persistent compile cache at its
    directory; the port builds its kernels once into ``build/kernels`` and
    has nothing of the kind to set."""
    cfg = parse_cli(argv, mode="testing")
    try:
        with run_telemetry(cfg, "serve"):
            return serve(cfg, ServeConfig.from_env())
    except KeyboardInterrupt:
        log.info("Keyboard interrupt received")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
