"""``ddr fleet`` on the port: boot and inspect a forecast replica group, the
port of ``ddr_tpu/scripts/fleet.py``.

``fleet up`` launches ``DDR_FLEET_REPLICAS`` (or ``--replicas``) ``serve``
workers of the port on distinct ports behind the least-queue-depth router,
publishes the federation targets (so ``GET /metrics?federated=1`` on any
member answers for the group), prints the replica table, and blocks until
Ctrl-C, which stops every worker. Each worker runs on the card unless the
config or an override says ``device=cpu``.

``fleet status`` asks a running replica (``--url``) for its ``/v1/stats``
and prints its fleet slice (group, slot, router) and a queue and health line.

    python -m ddr_tpu_torch.cli fleet up examples/synthetic/config.yaml device=cpu --replicas 2
    python -m ddr_tpu_torch.cli fleet up --synthetic --segments 64 device=cpu
    python -m ddr_tpu_torch.cli fleet status --url http://127.0.0.1:8080

With ``--synthetic`` the positional arguments are ``a.b=c`` overrides of the
written synthetic config (the JAX command takes none there, and so cannot
ask for the CPU).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import time
from pathlib import Path

log = logging.getLogger(__name__)

__all__ = ["main", "synthetic_cfg_path"]


def synthetic_cfg_path(workdir: Path, segments: int) -> Path:
    """Write the zero-data synthetic serve config (the JAX command's) and
    return its path. The card machine has no ``yaml``, so the file is block
    YAML written as text, which the port's ``yaml_subset`` reader reads back
    as PyYAML reads the JAX command's file."""
    names = "".join(f"  - a{i}\n" for i in range(10))
    text = (
        "experiment:\n"
        "  end_time: 1981/10/10\n"
        "  rho: 8\n"
        "  start_time: 1981/10/01\n"
        "geodataset: synthetic\n"
        "kan:\n"
        "  input_var_names:\n"
        f"{names}"
        "mode: testing\n"
        "name: fleet_synthetic\n"
        "params:\n"
        f"  save_path: {json.dumps(str(workdir / 'run'))}\n"
        f"synthetic_segments: {int(segments)}\n"
    )
    path = workdir / "fleet_serve.yaml"
    path.write_text(text)
    return path


def _render_describe(desc: dict) -> str:
    lines = [f"fleet group {desc['group']!r}: {desc['replicas']} {desc['mode']} replica(s)  "
             f"(workdir {desc['workdir']})"]
    router = desc.get("router") or {}
    for r in router.get("replicas", []):
        state = "EJECTED" if r["ejected"] else "up"
        lines.append(f"  {r['name']:>12}  {state:>7}  depth {r['last_probed_depth']}"
                     f"  dispatched {r['dispatched']}  {r.get('url') or '(in-process)'}")
    fed = desc.get("federation")
    if fed:
        lines.append(f"  federation: DDR_FEDERATE_REPLICAS={fed}")
    return "\n".join(lines)


def run_up(args) -> int:
    from ddr_tpu_torch.fleet.config import FleetConfig
    from ddr_tpu_torch.fleet.group import ReplicaGroup

    workdir = Path(args.out or os.environ.get("DDR_METRICS_DIR") or ".")
    workdir = workdir / f"fleet_{args.group or 'group'}"
    workdir.mkdir(parents=True, exist_ok=True)
    if args.synthetic:
        serve_args = [str(synthetic_cfg_path(workdir, args.segments)), *args.config]
    elif args.config:
        serve_args = list(args.config)
    else:
        raise SystemExit("ddr fleet up needs a config.yaml or --synthetic")

    overrides: dict = {"mode": "subprocess"}
    if args.replicas is not None:
        overrides["replicas"] = args.replicas
    if args.group is not None:
        overrides["group"] = args.group
    if args.base_port is not None:
        overrides["base_port"] = args.base_port
    cfg = FleetConfig.from_env(**overrides)
    group = ReplicaGroup(cfg, serve_args=serve_args, workdir=workdir, boot_timeout=args.boot_timeout)
    log.info(f"booting {cfg.replicas} replica(s); each builds its service and warms up")
    try:
        group.boot()
        print(_render_describe(group.describe()), flush=True)
        while True:
            time.sleep(30.0)
            # the table in the log, so an operator tailing it sees ejections
            log.info("\n" + _render_describe(group.describe()))
    except KeyboardInterrupt:
        log.info("shutting down fleet group")
    finally:
        # a second Ctrl-C must not cut the shutdown short and strand workers
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        group.close()
    return 0


def run_status(args) -> int:
    from ddr_tpu_torch.serving.client import HttpForecastClient

    client = HttpForecastClient(args.url, timeout=args.timeout)
    stats = client.stats()
    fleet = stats.get("fleet")
    if fleet is None:
        print(f"{args.url}: not part of a fleet (no DDR_FLEET_GROUP identity)")
    else:
        print(f"{args.url}: group {fleet.get('group')!r} replica {fleet.get('replica', '?')} "
              f"(router {fleet.get('router', '?')})")
    queue = stats.get("queue") or {}
    health = stats.get("health") or {}
    print(f"  ready {stats.get('ready')}  depth {queue.get('depth')}  served {queue.get('served')}  "
          f"shed {queue.get('shed')}  degraded {health.get('degraded')}")
    if args.json:
        print(json.dumps(stats))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="ddr fleet",
        description="Boot/inspect a replica group: N `serve` workers behind a least-queue-depth "
        "router with health-aware ejection.",
    )
    sub = parser.add_subparsers(dest="mode")

    p_up = sub.add_parser("up", help="boot a subprocess replica group")
    p_up.add_argument("config", nargs="*",
                      help="config.yaml (+ a.b=c overrides) each replica serves; with --synthetic, "
                      "overrides of the synthetic config")
    p_up.add_argument("--synthetic", action="store_true", help="serve a synthetic basin instead of a config")
    p_up.add_argument("--segments", type=int, default=64, help="synthetic reach count (default 64)")
    p_up.add_argument("--replicas", type=int, default=None,
                      help="replica count (default DDR_FLEET_REPLICAS or 2)")
    p_up.add_argument("--group", default=None, help="group label (default DDR_FLEET_GROUP or 'fleet')")
    p_up.add_argument("--base-port", type=int, default=None, dest="base_port",
                      help="replica i binds base+i (default: ephemeral ports)")
    p_up.add_argument("--boot-timeout", type=float, default=300.0,
                      help="readiness ceiling per boot, seconds (default 300)")
    p_up.add_argument("--out", default=None, help="workdir root (default: DDR_METRICS_DIR or .)")

    p_status = sub.add_parser("status", help="query a replica's fleet identity")
    p_status.add_argument("--url", required=True, help="any replica's base URL")
    p_status.add_argument("--timeout", type=float, default=5.0)
    p_status.add_argument("--json", action="store_true", help="also print the full /v1/stats payload")

    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    if not args.mode:
        parser.print_help()
        return 2
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.mode == "up":
        return run_up(args)
    return run_status(args)


if __name__ == "__main__":
    raise SystemExit(main())
