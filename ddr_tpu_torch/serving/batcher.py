"""Request queue + micro-batcher: coalesce concurrent forecasts into batch slots.

The port's copy of ``ddr_tpu/serving/batcher.py``, standard library only.
Mechanism only: the service supplies ``execute`` and observes decisions
through ``on_shed``.

- one bounded queue (``queue_cap``); a full queue applies the configured
  backpressure: ``reject-new`` fails the arrival, ``shed-oldest`` fails the
  oldest queued request and admits the arrival, ``shed-by-deadline`` fails
  the queued request with the earliest deadline (ties by oldest admission;
  requests without a deadline are never preferred victims; an arrival whose
  own deadline is the earliest is rejected instead). Victims come from the
  lowest priority class present (``bulk`` before ``batch`` before
  ``interactive``), the arrival's included: an arrival below every queued
  class is rejected rather than admitted by shedding higher-class work;
- the worker takes the highest-priority queued request as the batch head
  (FIFO within a class), holds its batch open up to ``batch_wait_s`` for
  more requests with the same key (network, model), and fills it strict
  priority first up to ``max_batch``;
- requests whose deadline passed while queued are shed at extraction,
  never executed;
- ``execute`` failures fail that batch's requests; the worker keeps draining.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Hashable

from ddr_tpu_torch.serving.config import BACKPRESSURE_POLICIES, priority_rank

log = logging.getLogger(__name__)

__all__ = ["ForecastRequest", "MicroBatcher", "QueueFullError", "RequestShedError"]


class QueueFullError(RuntimeError):
    """Raised to the submitter when the queue is full and the policy rejects
    the arrival. The service stamps ``request_id`` so an HTTP 429 body can
    echo it."""

    request_id: str | None = None


class RequestShedError(RuntimeError):
    """Set on a request's future when it is shed, with the machine-readable
    ``reason`` (``queue-full``, ``deadline``, ``model-unloaded``) and the
    victim's request and trace ids from its ``meta``."""

    def __init__(
        self, reason: str, message: str, request_id: str | None = None, trace_id: str | None = None,
    ) -> None:
        super().__init__(message)
        self.reason = reason
        self.request_id = request_id
        self.trace_id = trace_id


@dataclasses.dataclass
class ForecastRequest:
    """One queued unit of work; ``key`` groups co-batchable requests and
    ``payload`` is opaque to the batcher."""

    key: Hashable
    payload: Any
    future: Future = dataclasses.field(default_factory=Future)
    meta: dict = dataclasses.field(default_factory=dict)
    admitted: float = 0.0  # monotonic seconds, stamped at admission
    extracted: float = 0.0  # monotonic seconds, stamped at batch extraction
    deadline: float | None = None  # monotonic seconds, None = no deadline
    priority: str = "batch"  # one of config.PRIORITIES; validated by submit()

    def age(self, now: float | None = None) -> float:
        return (time.monotonic() if now is None else now) - self.admitted


class MicroBatcher:
    """Bounded queue + coalescing worker thread. ``execute(key, requests)``
    runs on the worker and must resolve every request's future;
    ``on_shed(request, reason)`` fires after a future is failed with
    :class:`RequestShedError`."""

    def __init__(
        self,
        execute: Callable[[Hashable, list[ForecastRequest]], None],
        max_batch: int = 8,
        queue_cap: int = 128,
        batch_wait_s: float = 0.005,
        backpressure: str = "reject-new",
        on_shed: Callable[[ForecastRequest, str], None] | None = None,
    ) -> None:
        if backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(f"unknown backpressure policy {backpressure!r}")
        self._execute = execute
        self.max_batch = int(max_batch)
        self.queue_cap = int(queue_cap)
        self.batch_wait_s = float(batch_wait_s)
        self.backpressure = backpressure
        self._on_shed = on_shed
        self._q: list[ForecastRequest] = []
        self._cond = threading.Condition()
        self._stopping = False
        self._stats = {"admitted": 0, "served": 0, "shed": 0, "rejected": 0, "batches": 0}
        #: per-(reason, priority) shed counts (``ddr_serve_shed_total``)
        self._shed_by: dict[tuple[str, str], int] = {}
        self._worker = threading.Thread(target=self._loop, name="ddr-torch-batcher", daemon=True)
        self._worker.start()

    # ---- admission ----

    def _reject(self, message: str) -> QueueFullError:
        self._stats["rejected"] += 1
        return QueueFullError(message)

    def submit(self, req: ForecastRequest) -> ForecastRequest:
        """Admit one request under the backpressure policy; returns ``req``
        with its admission time set, or raises :class:`QueueFullError`."""
        rank = priority_rank(req.priority)  # validates the class name too
        victim: ForecastRequest | None = None
        with self._cond:
            if self._stopping:
                raise RuntimeError("batcher is shut down")
            if len(self._q) >= self.queue_cap:
                if self.backpressure == "reject-new":
                    raise self._reject(f"queue at capacity ({self.queue_cap}); request rejected")
                if self.backpressure == "shed-oldest":
                    # the oldest within the lowest class present
                    worst = max(priority_rank(r.priority) for r in self._q)
                    if rank > worst:
                        raise self._reject(
                            f"queue at capacity ({self.queue_cap}) and the arriving request is "
                            "below every queued class; request rejected")
                    victim = self._q.pop(next(
                        i for i, r in enumerate(self._q) if priority_rank(r.priority) == worst))
                else:  # shed-by-deadline: lowest class first, then earliest deadline in it
                    idx = min(
                        range(len(self._q)),
                        key=lambda i: (
                            -priority_rank(self._q[i].priority),
                            self._q[i].deadline is None,  # no deadline sorts last
                            self._q[i].deadline or 0.0,
                            self._q[i].admitted,
                        ),
                    )
                    cand = self._q[idx]
                    cand_rank = priority_rank(cand.priority)
                    doomed = rank > cand_rank or (
                        rank == cand_rank
                        and req.deadline is not None
                        and (cand.deadline is None or req.deadline < cand.deadline)
                    )
                    if doomed:
                        # the arrival is the preferred victim: reject it at the
                        # edge, where the caller can back off
                        raise self._reject(
                            f"queue at capacity ({self.queue_cap}) and the arriving request is "
                            "the preferred shed victim (lowest class, earliest deadline); "
                            "request rejected")
                    victim = self._q.pop(idx)
            req.admitted = time.monotonic()
            self._q.append(req)
            self._stats["admitted"] += 1
            self._cond.notify_all()
        if victim is not None:
            self._fail_shed(victim, "queue-full")
        return req

    def purge(self, predicate: Callable[[ForecastRequest], bool], reason: str) -> int:
        """Shed every queued request matching ``predicate`` with ``reason``;
        returns the count. Batches in flight keep their snapshots and finish."""
        with self._cond:
            # one predicate pass, never request equality (numpy payloads)
            victims: list[ForecastRequest] = []
            survivors: list[ForecastRequest] = []
            for r in self._q:
                (victims if predicate(r) else survivors).append(r)
            if victims:
                self._q = survivors
                self._cond.notify_all()
        for r in victims:
            self._fail_shed(r, reason)
        return len(victims)

    def _fail_shed(self, req: ForecastRequest, reason: str) -> None:
        # every shed path counts here; callers must not hold the lock
        with self._cond:
            self._stats["shed"] += 1
            by = (reason, req.priority)
            self._shed_by[by] = self._shed_by.get(by, 0) + 1
        err = RequestShedError(reason, f"request shed ({reason})",
                               request_id=req.meta.get("request_id"), trace_id=req.meta.get("trace_id"))
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(err)
        if self._on_shed is not None:
            try:
                self._on_shed(req, reason)
            except Exception:  # observability must never break the data path
                log.exception("on_shed callback failed")

    # ---- worker ----

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stopping:
                    self._cond.wait()
                if self._stopping and not self._q:
                    return
                # strict-priority head, FIFO within a class
                head = min(range(len(self._q)), key=lambda i: (priority_rank(self._q[i].priority), i))
                key = self._q[head].key
                # hold for co-batchable arrivals, never past batch_wait_s from now
                hold_until = time.monotonic() + self.batch_wait_s
                while (
                    not self._stopping
                    and sum(1 for r in self._q if r.key == key) < self.max_batch
                    and time.monotonic() < hold_until
                ):
                    self._cond.wait(timeout=max(0.0, hold_until - time.monotonic()))
                # same-key requests board highest class first, FIFO within one
                matching = sorted((i for i, r in enumerate(self._q) if r.key == key),
                                  key=lambda i: (priority_rank(self._q[i].priority), i))
                chosen = set(matching[: self.max_batch])
                batch = [self._q[i] for i in sorted(chosen)]
                self._q = [r for i, r in enumerate(self._q) if i not in chosen]
                depth = len(self._q)
                self._cond.notify_all()

            now = time.monotonic()
            live: list[ForecastRequest] = []
            for r in batch:
                r.extracted = now  # closes the queue wait, of a shed request too
                if r.deadline is not None and now > r.deadline:
                    self._fail_shed(r, "deadline")
                else:
                    live.append(r)
            if not live:
                continue
            for r in live:
                r.meta["queue_depth"] = depth
            try:
                self._execute(key, live)
                with self._cond:
                    self._stats["served"] += len(live)
                    self._stats["batches"] += 1
            except BaseException as e:  # noqa: BLE001 - the worker must survive anything
                log.exception(f"batch executor failed for key {key!r}")
                for r in live:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(e)

    # ---- lifecycle / inspection ----

    def stats(self) -> dict:
        with self._cond:
            out: dict = dict(self._stats)
            out["depth"] = len(self._q)
            out["shed_by_class"] = {
                f"{reason}/{priority}": n for (reason, priority), n in sorted(self._shed_by.items())
            }
            return out

    def close(self, drain: bool = True) -> None:
        """Stop the worker; ``drain=True`` serves what is queued first,
        ``drain=False`` sheds it (reason ``queue-full``)."""
        with self._cond:
            self._stopping = True
            backlog = [] if drain else list(self._q)
            if not drain:
                self._q = []
            self._cond.notify_all()
        for r in backlog:
            self._fail_shed(r, "queue-full")
        self._worker.join(timeout=60.0)
