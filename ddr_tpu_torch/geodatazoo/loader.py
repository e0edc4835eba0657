"""Batching loader and the prefetch pool: the port's copy of
``ddr_tpu/geodatazoo/loader.py`` (host-side numpy and threads).

Sampling is deterministic and checkpointable: the loader's RNG is an
explicit ``np.random.Generator`` whose state is saved and restored for a
mid-epoch resume. :func:`prefetch` prepares batches ahead of the train loop
in a small thread pool and hands them over in iteration order.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator

import numpy as np

__all__ = ["DataLoader", "PrefetchStats", "prefetch"]


class PrefetchStats:
    """Live occupancy of one :func:`prefetch` pool: ``depth()`` counts
    prepared batches waiting for the consumer (a sustained 0 means each
    ``next()`` waits on host preparation), ``in_flight()`` everything
    submitted and not yet consumed. Both are None while no pool is attached.
    Reads copy the pool's pending list and are safe from any thread."""

    def __init__(self) -> None:
        self._pending: list | None = None

    def depth(self) -> int | None:
        pending = self._pending
        if pending is None:
            return None
        return sum(1 for f in list(pending) if f.done())

    def in_flight(self) -> int | None:
        pending = self._pending
        return None if pending is None else len(pending)


def prefetch(
    iterable: Iterable[Any],
    prepare: Callable[[Any], Any],
    ahead: int = 1,
    stats: PrefetchStats | None = None,
) -> Iterator[Any]:
    """Map ``prepare`` over ``iterable`` in a pool of ``ahead`` threads,
    keeping up to ``ahead + 1`` items prepared or in preparation beyond the
    one being consumed. Items are yielded in iteration order whatever the
    threads' interleaving, the source is pulled only from the consumer's
    thread, and an exception in ``prepare`` is raised at the ``next()`` of
    the item that failed. Items must share no mutable state (the datasets
    hand each batch its own ``Dates.snapshot()``), and ``prepare`` must be
    reentrant when ``ahead > 1``. ``stats`` attaches a
    :class:`PrefetchStats` while the generator runs. An early exit of the
    consumer drops the queued work without waiting for it."""
    ahead = max(1, int(ahead))
    pool = ThreadPoolExecutor(max_workers=ahead)
    try:
        pending: list = []
        if stats is not None:
            stats._pending = pending
        it = iter(iterable)
        try:
            while len(pending) <= ahead:
                pending.append(pool.submit(prepare, next(it)))
        except StopIteration:
            it = None
        while pending:
            item = pending.pop(0).result()
            if it is not None:
                try:
                    pending.append(pool.submit(prepare, next(it)))
                except StopIteration:
                    it = None
            yield item
    finally:
        if stats is not None:
            stats._pending = None
        pool.shutdown(wait=False, cancel_futures=True)


class DataLoader:
    """Iterate ``dataset.collate_fn`` over index batches of ``batch_size``;
    ``shuffle`` draws each epoch's order from ``rng`` (pass a seeded one for
    reproducible epochs), ``drop_last`` drops a short final batch."""

    def __init__(
        self,
        dataset: Any,
        batch_size: int = 1,
        shuffle: bool = False,
        rng: np.random.Generator | None = None,
        drop_last: bool = False,
    ) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.rng = rng or np.random.default_rng()
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            idxs = order[start : start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield self.dataset.collate_fn([self.dataset[int(i)] for i in idxs])

    def state(self) -> dict:
        """The RNG state, for mid-epoch resumable checkpoints."""
        return {"bit_generator": self.rng.bit_generator.state}

    def set_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["bit_generator"]
