"""Reach-timesteps per second: the port's copy of
``ddr_tpu/observability/throughput.py``.

One reach-timestep is one reach advanced one routing step, a unit that does
not depend on the batch's shape. Callers time the synchronised step (after
the loss or the result reached the host), and the loops forward each
recorded batch as a ``step`` or ``eval`` event.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from contextlib import contextmanager
from typing import Iterator

log = logging.getLogger(__name__)

__all__ = ["Throughput", "MIN_BATCH_SECONDS"]

#: Zero-or-negative batch durations (clock granularity, mocked timers) clamp to
#: this floor so no rate is ever non-finite — JSONL aggregation and the metrics
#: CLI divide by and average these numbers.
MIN_BATCH_SECONDS = 1e-6


@dataclasses.dataclass
class Throughput:
    """Running reach-timesteps/sec counter."""

    label: str = "routing"
    total_reach_timesteps: float = 0.0
    total_seconds: float = 0.0
    batches: int = 0
    last_rate: float = 0.0
    last_seconds: float = 0.0

    def record(self, n_reaches: int, n_timesteps: int, seconds: float) -> float:
        """Record one synchronized batch; returns its reach-timesteps/sec.

        Durations below :data:`MIN_BATCH_SECONDS` (including 0, negatives, and
        NaN) are clamped with a warning — rates must stay finite for the JSONL
        consumers downstream.
        """
        work = float(n_reaches) * float(n_timesteps)
        if not (seconds >= MIN_BATCH_SECONDS):
            log.warning(
                f"{self.label}: batch duration {seconds!r}s is below the "
                f"{MIN_BATCH_SECONDS}s floor (timer resolution?); clamping so "
                "the recorded rate stays finite"
            )
            seconds = MIN_BATCH_SECONDS
        self.total_reach_timesteps += work
        self.total_seconds += seconds
        self.batches += 1
        self.last_seconds = seconds
        self.last_rate = work / seconds
        return self.last_rate

    @contextmanager
    def batch(self, n_reaches: int, n_timesteps: int) -> Iterator[None]:
        """Time a batch body. The body must synchronize on its device results
        (``.cpu()`` / ``float(loss)``) before exiting."""
        start = time.perf_counter()
        yield
        self.record(n_reaches, n_timesteps, time.perf_counter() - start)

    @property
    def rate(self) -> float:
        """Aggregate reach-timesteps/sec over all recorded batches."""
        return self.total_reach_timesteps / self.total_seconds if self.total_seconds else 0.0

    def format(self) -> str:
        return (
            f"{self.label}: {self.rate:,.0f} reach-timesteps/s "
            f"(last batch {self.last_rate:,.0f}, {self.batches} batches)"
        )

    def log_summary(self) -> None:
        if self.batches:
            log.info(self.format())
