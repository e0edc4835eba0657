"""Request queue + micro-batcher: coalesce concurrent forecasts into batch slots.

The port's own copy of ``ddr_tpu/serving/batcher.py``'s mechanism, standard
library only, without priority classes and shed policies (a full queue
rejects the arrival):

- one bounded FIFO queue (``queue_cap``);
- the worker takes the queue head, holds its batch open up to
  ``batch_wait_s`` for more requests with the SAME key (network, model),
  caps it at ``max_batch``, and keeps FIFO order across keys;
- requests whose deadline passed while queued are shed at extraction, never
  executed;
- ``execute`` failures fail that batch's requests; the worker keeps draining.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Hashable

log = logging.getLogger(__name__)

__all__ = ["ForecastRequest", "MicroBatcher", "QueueFullError", "RequestShedError"]


class QueueFullError(RuntimeError):
    """The bounded queue is at capacity; the arriving request is rejected."""


class RequestShedError(RuntimeError):
    """Set on a request's future when it is shed (``reason``: ``deadline`` or
    ``shutdown``)."""

    def __init__(self, reason: str, message: str) -> None:
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass
class ForecastRequest:
    """One queued unit of work; ``key`` groups co-batchable requests and
    ``payload`` is opaque to the batcher."""

    key: Hashable
    payload: Any
    future: Future = dataclasses.field(default_factory=Future)
    admitted: float = 0.0  # monotonic seconds, stamped at admission
    deadline: float | None = None  # monotonic seconds, None = no deadline


class MicroBatcher:
    """Bounded FIFO queue + coalescing worker thread. ``execute(key,
    requests)`` runs on the worker and must resolve every request's future."""

    def __init__(
        self,
        execute: Callable[[Hashable, list[ForecastRequest]], None],
        max_batch: int = 8,
        queue_cap: int = 128,
        batch_wait_s: float = 0.005,
    ) -> None:
        self._execute = execute
        self.max_batch = int(max_batch)
        self.queue_cap = int(queue_cap)
        self.batch_wait_s = float(batch_wait_s)
        self._q: list[ForecastRequest] = []
        self._cond = threading.Condition()
        self._stopping = False
        self._stats = {"admitted": 0, "served": 0, "shed": 0, "rejected": 0, "batches": 0}
        self._worker = threading.Thread(target=self._loop, name="ddr-torch-batcher", daemon=True)
        self._worker.start()

    def submit(self, req: ForecastRequest) -> ForecastRequest:
        """Admit one request; raises :class:`QueueFullError` at capacity."""
        with self._cond:
            if self._stopping:
                raise RuntimeError("batcher is shut down")
            if len(self._q) >= self.queue_cap:
                self._stats["rejected"] += 1
                raise QueueFullError(f"queue at capacity ({self.queue_cap}); request rejected")
            req.admitted = time.monotonic()
            self._q.append(req)
            self._stats["admitted"] += 1
            self._cond.notify_all()
        return req

    def _shed(self, req: ForecastRequest, reason: str) -> None:
        with self._cond:
            self._stats["shed"] += 1
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(RequestShedError(reason, f"request shed ({reason})"))

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stopping:
                    self._cond.wait()
                if self._stopping and not self._q:
                    return
                key = self._q[0].key
                hold_until = time.monotonic() + self.batch_wait_s
                while (
                    not self._stopping
                    and sum(1 for r in self._q if r.key == key) < self.max_batch
                    and time.monotonic() < hold_until
                ):
                    self._cond.wait(timeout=max(0.0, hold_until - time.monotonic()))
                batch: list[ForecastRequest] = []
                rest: list[ForecastRequest] = []
                for r in self._q:
                    (batch if r.key == key and len(batch) < self.max_batch else rest).append(r)
                self._q = rest
                self._cond.notify_all()

            now = time.monotonic()
            live = []
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    self._shed(r, "deadline")
                else:
                    live.append(r)
            if not live:
                continue
            try:
                self._execute(key, live)
                with self._cond:
                    self._stats["served"] += len(live)
                    self._stats["batches"] += 1
            except Exception as e:  # the worker must survive a failed batch
                log.exception(f"batch executor failed for key {key!r}")
                for r in live:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(e)

    def stats(self) -> dict:
        with self._cond:
            return {**self._stats, "depth": len(self._q)}

    def close(self, drain: bool = True) -> None:
        """Stop the worker; ``drain=True`` serves what is queued first,
        ``drain=False`` sheds it."""
        with self._cond:
            self._stopping = True
            backlog = [] if drain else list(self._q)
            if not drain:
                self._q = []
            self._cond.notify_all()
        for r in backlog:
            self._shed(r, "shutdown")
        self._worker.join(timeout=60.0)
