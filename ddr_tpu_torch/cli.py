"""The port's command-line dispatcher: ``python -m ddr_tpu_torch.cli
{train,test,route,train-and-test,benchmark,summed-q-prime,serve,fleet,loadtest,verify,
metrics,obs,profile,chaos} [config.yaml] [a.b=c ...]``.

The subcommands are the JAX package's ``ddr`` CLI's. ``train``, ``test``,
``route``, ``train-and-test``, ``benchmark``, ``summed-q-prime``, ``serve``,
``fleet``, ``loadtest``, ``verify``, ``profile`` and ``chaos`` are ported; each
runs on the card unless the config or an override says ``device=cpu``. ``metrics`` and ``obs``
read run logs and scrape ``/metrics`` endpoints (standard library only). Every
other subcommand exits with a message naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import importlib
import sys

__all__ = ["main"]

_COMMANDS = {
    "train": "ddr_tpu_torch.scripts.train",
    "test": "ddr_tpu_torch.scripts.test",
    "route": "ddr_tpu_torch.scripts.router",
    "train-and-test": "ddr_tpu_torch.scripts.train_and_test",
    "benchmark": "ddr_tpu_torch.benchmarks.benchmark",
    "summed-q-prime": "ddr_tpu_torch.scripts.summed_q_prime",
    "serve": "ddr_tpu_torch.scripts.serve",
    "fleet": "ddr_tpu_torch.scripts.fleet",
    "loadtest": "ddr_tpu_torch.scripts.loadtest",
    "verify": "ddr_tpu_torch.scripts.verify",
    "metrics": "ddr_tpu_torch.observability.metrics_cli",
    "obs": "ddr_tpu_torch.observability.obs_cli",
    "profile": "ddr_tpu_torch.scripts.profile",
    "chaos": "ddr_tpu_torch.scripts.chaos",
}
#: Subcommands of the JAX package's CLI that are not ported yet, by ROADMAP item.
_NOT_PORTED = {
    "geometry-predictor": "A.11",
    "tune": "A.13",
    "sweep": "A.12",
    "audit": "A.12",
    "gen-config-docs": "A.12",
    "lint": "A.12",
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in {"-h", "--help"}:
        print("usage: python -m ddr_tpu_torch.cli {" + ",".join(_COMMANDS) + "} [config.yaml] [a.b=c ...]")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in _NOT_PORTED:
        print(f"ddr_tpu_torch: command {cmd!r} is not ported yet (ROADMAP {_NOT_PORTED[cmd]})",
              file=sys.stderr)
        return 2
    if cmd not in _COMMANDS:
        print(f"ddr_tpu_torch: unknown command {cmd!r}; choose from {sorted(_COMMANDS)}", file=sys.stderr)
        return 2
    return importlib.import_module(_COMMANDS[cmd]).main(rest) or 0


if __name__ == "__main__":
    raise SystemExit(main())
