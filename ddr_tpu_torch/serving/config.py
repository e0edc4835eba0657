"""Forecast-service knobs for the serving slice."""

from __future__ import annotations

import dataclasses

__all__ = ["ServeConfig"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """``max_batch`` is also the batch slot: every executed batch is padded
    to exactly this many requests, so one (network, model) pair always runs
    the same shapes."""

    #: Coalesced requests per executed batch.
    max_batch: int = 8
    #: Bounded queue capacity; a full queue rejects new requests.
    queue_cap: int = 128
    #: How long the batcher holds the queue head open for co-batchable requests, seconds.
    batch_wait_s: float = 0.005
    #: Default per-request deadline from admission, seconds; expired requests are shed.
    deadline_s: float = 30.0
    #: Forecast horizon in hourly steps for networks registered without one.
    horizon_hours: int = 72

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {self.queue_cap}")
        if self.horizon_hours < 1:
            raise ValueError(f"horizon_hours must be >= 1, got {self.horizon_hours}")
