"""``ddr train-and-test`` on the port: training, then evaluation of the
newest checkpoint over a held-out period; the port of
``ddr_tpu/scripts/train_and_test.py``.
"""

from __future__ import annotations

import copy
import logging
from pathlib import Path

from ddr_tpu_torch.scripts.common import parse_cli, timed
from ddr_tpu_torch.scripts.test import test as _test
from ddr_tpu_torch.scripts.train import train as _train
from ddr_tpu_torch.training import latest_checkpoint
from ddr_tpu_torch.validation.configs import Config
from ddr_tpu_torch.validation.enums import Mode
from ddr_tpu_torch.validation.metrics import Metrics

log = logging.getLogger(__name__)

__all__ = ["DEFAULT_TEST_PERIOD", "main", "train_and_test"]

#: The test period when ``experiment.test_start_time``/``test_end_time`` are unset.
DEFAULT_TEST_PERIOD = ("1995/10/01", "2010/09/30")


def train_and_test(cfg: Config) -> Metrics:
    """Train on ``cfg``, then test its newest checkpoint over
    ``experiment.test_start_time``..``test_end_time`` (default
    :data:`DEFAULT_TEST_PERIOD`); returns the test's metric battery."""
    _train(cfg)

    ckpt = latest_checkpoint(Path(cfg.params.save_path) / "saved_models")
    if ckpt is None:
        raise FileNotFoundError("training produced no checkpoint to evaluate")
    log.info(f"Evaluating checkpoint {ckpt}")

    test_cfg = copy.deepcopy(cfg)
    test_cfg.mode = Mode.testing
    test_cfg.experiment.checkpoint = ckpt
    test_cfg.experiment.start_time = cfg.experiment.test_start_time or DEFAULT_TEST_PERIOD[0]
    test_cfg.experiment.end_time = cfg.experiment.test_end_time or DEFAULT_TEST_PERIOD[1]
    return _test(test_cfg)


def main(argv: list[str] | None = None) -> int:
    """``[config.yaml] [a.b=c ...]``: validate the config in training mode, train, then test."""
    cfg = parse_cli(argv, mode="training")
    try:
        with timed("train-and-test"):
            train_and_test(cfg)
    except KeyboardInterrupt:
        log.info("Keyboard interrupt received")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
