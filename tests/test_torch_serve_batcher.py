"""The port's ``MicroBatcher`` against the JAX package's, decision for decision.

Both batchers get the same seeded sequence of submissions (keys, priority
classes, deadlines with ties and without) while their executor is blocked
on a first request, under each backpressure policy. They must reject the
same arrivals, shed the same victims for the same reasons, count the same
per-(reason, priority) sheds and, once the executor is released, extract the
same batches in the same order. ``purge`` and ``close(drain=False)`` shed
alike too. All deadlines lie far in the future, so no shed depends on the
clock.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from ddr_tpu.serving import batcher as jb
from ddr_tpu_torch.serving import batcher as tb
from ddr_tpu_torch.serving.config import BACKPRESSURE_POLICIES

KEYS = ("k0", "k1", "k2")
CLASSES = ("interactive", "batch", "bulk")


def _ops(seed: int, n: int = 30) -> list[tuple]:
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        deadline = None if rng.random() < 0.2 else float(rng.integers(0, 8))  # ties on purpose
        ops.append((f"r{i}", KEYS[int(rng.integers(len(KEYS)))], CLASSES[int(rng.integers(3))], deadline))
    return ops


def _drive(mod, policy: str, ops: list[tuple], after=None) -> dict:
    """Run ``ops`` through ``mod``'s batcher with a blocked executor; returns
    every decision it made."""
    extracted: list[list[str]] = []
    shed_seen: list[tuple[str, str]] = []
    entered, gate = threading.Event(), threading.Event()

    def execute(key, reqs):
        if not entered.is_set():
            entered.set()
            gate.wait(timeout=30)
        extracted.append([r.meta["request_id"] for r in reqs])
        for r in reqs:
            r.future.set_result(key)

    mb = mod.MicroBatcher(execute, max_batch=3, queue_cap=6, batch_wait_s=0.0, backpressure=policy,
                          on_shed=lambda r, reason: shed_seen.append((r.meta["request_id"], reason)))
    mb.submit(mod.ForecastRequest(key="k0", payload=None, meta={"request_id": "first"}))
    assert entered.wait(timeout=30)
    base = time.monotonic() + 1000.0
    rejected, reqs = [], []
    for rid, key, prio, offset in ops:
        req = mod.ForecastRequest(key=key, payload=None, meta={"request_id": rid}, priority=prio,
                                  deadline=None if offset is None else base + offset)
        try:
            mb.submit(req)
        except mod.QueueFullError:
            rejected.append(rid)
            continue
        reqs.append(req)
    if after is not None:
        after(mb, gate)
    gate.set()
    outcomes = {}
    for r in reqs:
        try:
            r.future.result(timeout=30)
            outcomes[r.meta["request_id"]] = "served"
        except mod.RequestShedError as e:
            assert e.request_id == r.meta["request_id"]
            outcomes[r.meta["request_id"]] = f"shed:{e.reason}"
    mb.close()
    stats = mb.stats()
    return {"extracted": extracted, "rejected": rejected, "outcomes": outcomes, "shed_seen": shed_seen,
            "shed_by_class": stats["shed_by_class"],
            "counts": {k: stats[k] for k in ("admitted", "served", "shed", "rejected", "batches", "depth")}}


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("policy", BACKPRESSURE_POLICIES)
def test_batcher_decides_as_jax(policy, seed):
    ops = _ops(seed)
    ours, ref = _drive(tb, policy, ops), _drive(jb, policy, ops)
    assert ours == ref
    # every policy met a full queue; the shedding ones shed
    assert ours["rejected"] or ours["shed_seen"]
    if policy != "reject-new":
        assert any(v.startswith("shed:queue-full") for v in ours["outcomes"].values())


@pytest.mark.parametrize("policy", BACKPRESSURE_POLICIES)
def test_purge_and_close_shed_as_jax(policy):
    ops = _ops(11, n=5)

    def purge(mb, gate):
        assert mb.purge(lambda r: r.key == "k1", "model-unloaded") >= 0

    assert _drive(tb, policy, ops, after=purge) == _drive(jb, policy, ops, after=purge)

    def close_now(mb, gate):
        # the worker finishes its blocked batch while close sheds the backlog
        threading.Timer(0.2, gate.set).start()
        mb.close(drain=False)

    ours, ref = _drive(tb, policy, ops, after=close_now), _drive(jb, policy, ops, after=close_now)
    assert ours == ref and "shed:queue-full" in ours["outcomes"].values()


def test_unknown_priority_and_policy_are_refused_alike():
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="backpressure"):
            mod.MicroBatcher(lambda k, r: None, backpressure="drop")
        mb = mod.MicroBatcher(lambda k, r: None)
        try:
            with pytest.raises(ValueError, match="unknown priority"):
                mb.submit(mod.ForecastRequest(key="k", payload=None, priority="urgent"))
        finally:
            mb.close()
