"""``ddr obs`` — fleet observability operations: the port's copy of
``ddr_tpu/observability/obs_cli.py`` (standard library only).

``ddr obs federate --replicas a=host:9100,b=host:9101`` scrapes every
replica's ``/metrics`` and re-exposes the union with ``replica`` labels
(:mod:`ddr_tpu_torch.observability.federate`):

- ``--once`` prints one federated exposition to stdout;
- ``--port N`` runs a standing aggregator whose every ``GET /metrics``
  scrapes the fleet afresh (``--port 0`` binds an ephemeral port and prints
  its url).

Targets default to ``DDR_FEDERATE_REPLICAS`` without ``--replicas``; the
series cap is ``DDR_FEDERATE_MAX_SERIES``.

``ddr obs bottleneck <run_log-or-dir>`` replays a run log's ``step`` events
through the performance sentinel's critical-path model
(:func:`~ddr_tpu_torch.observability.sentinel.attribute_steps`): each step
is classified data-, host-, checkpoint- or device-bound, the counts and
stage seconds are tabulated, and the modal class is the pipeline verdict
with the knobs that move it. Steps without ``loop_s`` fall back to
largest-bucket attribution.
"""

from __future__ import annotations

import argparse
import logging
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Sequence

from ddr_tpu_torch.observability.federate import (
    federate_text,
    parse_replicas,
    replicas_from_env,
)

log = logging.getLogger(__name__)

__all__ = ["main", "serve_federation", "FederationHTTPServer"]


class _FederationHandler(BaseHTTPRequestHandler):
    server: "FederationHTTPServer"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        log.debug("federate %s", format % args)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        from ddr_tpu_torch.observability.prometheus import CONTENT_TYPE

        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_response(404)
            self.end_headers()
            return
        # scrape-on-demand: the aggregator holds no state, so its page is
        # always as fresh as the replicas answer (and a dead replica shows as
        # ddr_federate_up 0 on this very scrape)
        body = federate_text(
            self.server.replicas, timeout=self.server.scrape_timeout
        ).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass


class FederationHTTPServer(ThreadingHTTPServer):
    """The standing aggregator: ``GET /metrics`` federates the configured
    replica set on demand."""

    daemon_threads = True

    def __init__(
        self,
        replicas: list[tuple[str, str]],
        host: str,
        port: int,
        scrape_timeout: float = 2.0,
    ) -> None:
        self.replicas = replicas
        self.scrape_timeout = scrape_timeout
        super().__init__((host, port), _FederationHandler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}/metrics"


def serve_federation(
    replicas: list[tuple[str, str]],
    host: str = "0.0.0.0",
    port: int = 9200,
    scrape_timeout: float = 2.0,
) -> FederationHTTPServer:
    """Start the aggregator on a daemon thread; returns the server (its
    ``url`` reports the bound port — ``port=0`` binds ephemeral)."""
    import threading

    server = FederationHTTPServer(replicas, host, port, scrape_timeout)
    thread = threading.Thread(
        target=server.serve_forever, name="ddr-obs-federate", daemon=True
    )
    thread.start()
    log.info(f"federation aggregator listening on {server.url}")
    return server


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="ddr obs", description="fleet observability operations"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    fed = sub.add_parser(
        "federate", help="scrape replica /metrics endpoints into one exposition"
    )
    fed.add_argument(
        "--replicas",
        default=None,
        help="comma-separated label=url targets (default: DDR_FEDERATE_REPLICAS)",
    )
    fed.add_argument(
        "--once",
        action="store_true",
        help="scrape once, print the federated exposition, exit",
    )
    fed.add_argument(
        "--port",
        type=int,
        default=None,
        help="serve a standing aggregator /metrics on this port (0 = ephemeral)",
    )
    fed.add_argument(
        "--timeout",
        type=float,
        default=2.0,
        help="per-replica scrape timeout in seconds (default 2)",
    )
    bot = sub.add_parser(
        "bottleneck",
        help="replay a run log into a pipeline bottleneck attribution table",
    )
    bot.add_argument(
        "path", help="run_log.*.jsonl file (or a directory containing one)"
    )
    bot.add_argument(
        "--idle-frac",
        type=float,
        default=0.25,
        help="device idle share of loop wall below which a step counts as "
        "device-bound (default 0.25)",
    )
    args = parser.parse_args(argv)

    if args.command == "bottleneck":
        from ddr_tpu_torch.observability.metrics_cli import load_events
        from ddr_tpu_torch.observability.sentinel import (
            attribute_steps,
            render_attribution,
        )

        try:
            events, bad = load_events(args.path)
        except (OSError, ValueError) as e:
            print(f"cannot read {args.path}: {e}", file=sys.stderr)
            return 2
        if bad:
            print(f"skipped {bad} malformed line(s)", file=sys.stderr)
        steps = [e for e in events if e.get("event") == "step"]
        if not steps:
            print(
                f"no step events in {args.path}; nothing to attribute",
                file=sys.stderr,
            )
            return 1
        sys.stdout.write(
            render_attribution(attribute_steps(steps, idle_frac=args.idle_frac))
        )
        return 0

    if args.command == "federate":
        replicas = (
            parse_replicas(args.replicas)
            if args.replicas is not None
            else replicas_from_env()
        )
        if not replicas:
            print(
                "no federation targets: pass --replicas or set "
                "DDR_FEDERATE_REPLICAS",
                file=sys.stderr,
            )
            return 2
        if args.port is None or args.once:
            sys.stdout.write(federate_text(replicas, timeout=args.timeout))
            return 0
        server = FederationHTTPServer(
            replicas, "0.0.0.0", args.port, scrape_timeout=args.timeout
        )
        print(f"federation aggregator listening on {server.url}", file=sys.stderr)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
