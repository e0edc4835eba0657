"""The port's command-line dispatcher: ``python -m ddr_tpu_torch.cli
{train,test,route,train-and-test,benchmark} config.yaml [a.b=c ...]``.

The subcommands are the JAX package's ``ddr`` CLI's. ``train``, ``test``,
``route``, ``train-and-test`` and ``benchmark`` are ported; each runs on the
card unless the config or an override says ``device=cpu``. Every other
subcommand exits with a message naming the ROADMAP item that ports it.
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
}
#: Subcommands of the JAX package's CLI that are not ported yet, by ROADMAP item.
_NOT_PORTED = {
    "summed-q-prime": "A.8",
    "serve": "A.9",
    "fleet": "A.9",
    "loadtest": "A.9",
    "verify": "A.9",
    "chaos": "A.6",
    "metrics": "A.10",
    "obs": "A.10",
    "profile": "A.10",
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
