"""Step-phase wall-clock split of the training loop: the port's copy of
``ddr_tpu/observability/phases.py``, standard library only.

The loop brackets each region of an iteration with
``timer.phase("data_load", into=step_phases)`` and attaches the step's
``phases`` dict to its ``step`` event; the timer also keeps run totals for
the ``run_end`` rollup. Phases timed on the prefetch thread (``data_load``,
``host_prep``) overlap the device step, so the split says where wall time
went per bucket, not a timeline; ``loop_s`` on the step event gives the
loop's own wall, and :func:`summarize_phases` folds the two into the device's
busy share.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

__all__ = ["STEP_PHASES", "PhaseTimer", "summarize_phases"]

#: The canonical loop buckets (a timer accepts any name; these are the ones
#: the train loop emits and the docs table explains).
STEP_PHASES = ("data_load", "host_prep", "device_step", "eval", "checkpoint")


class PhaseTimer:
    """Accumulates per-phase wall time, per step and per run.

    Thread-safe: the prefetch thread times data-load/host-prep while the main
    thread times the device step. Per-step dicts are plain caller-owned dicts
    (each batch carries its own), so concurrent steps never race on them.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._totals: dict[str, list[float]] = {}  # name -> [count, seconds]

    @contextmanager
    def phase(
        self,
        name: str,
        into: dict[str, float] | None = None,
        ctx: Any = None,
    ) -> Iterator[None]:
        """Time a region; add its seconds to the run totals and (when given)
        to the caller's per-step ``into`` dict. Exception-safe.

        ``ctx`` (a :class:`~ddr_tpu_torch.observability.trace.SpanContext`,
        normally the step's root) also emits one ``span`` event named
        ``phase/<name>`` as a child of that context, so a phase timed on the
        prefetch thread keeps its step as parent. Without ``ctx`` (or without
        an active recorder) nothing more is emitted."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                agg = self._totals.setdefault(name, [0, 0.0])
                agg[0] += 1
                agg[1] += dt
            if into is not None:
                into[name] = round(into.get(name, 0.0) + dt, 6)
            if ctx is not None:
                from ddr_tpu_torch.observability.events import get_recorder

                rec = get_recorder()
                if rec is not None:
                    child = ctx.child()
                    rec.emit(
                        "span",
                        name=f"phase/{name}",
                        seconds=round(dt, 6),
                        thread=threading.current_thread().name,
                        **child.ids(),
                    )

    def totals(self) -> dict[str, dict[str, float]]:
        """``{phase: {count, seconds}}`` run totals so far."""
        with self._lock:
            return {
                k: {"count": int(c), "seconds": round(s, 6)}
                for k, (c, s) in sorted(self._totals.items())
            }

    def summary(self) -> dict[str, Any]:
        """The ``run_end`` rollup: totals plus each phase's share of the summed
        phase time (not of wall time — prefetch phases overlap the step)."""
        totals = self.totals()
        denom = sum(v["seconds"] for v in totals.values())
        return {
            "phases": totals,
            "shares": {
                k: round(v["seconds"] / denom, 4) if denom > 0 else 0.0
                for k, v in totals.items()
            },
        }


def summarize_phases(step_events: list[dict]) -> dict[str, dict[str, float]]:
    """Aggregate the ``phases`` dicts attached to ``step`` events into
    ``{phase: {count, seconds, share}}`` — the "Where time went" table's data
    (shared by ``ddr metrics summarize`` and its tests).

    When steps additionally carry ``loop_s`` (the full loop-iteration wall the
    train loop records since schema v5), the result gains one reserved
    ``"_overlap"`` entry reporting overlap efficiency — device busy fraction
    of the loop wall and total device idle — which phase shares alone cannot
    express (prefetch phases overlap the device step). Renderers iterating
    phases should skip keys starting with ``_``.
    """
    agg: dict[str, list[float]] = {}
    loop_steps = 0
    loop_s = 0.0
    device_s = 0.0
    for e in step_events:
        phases = e.get("phases")
        if not isinstance(phases, dict):
            continue
        for name, seconds in phases.items():
            try:
                s = float(seconds)
            except (TypeError, ValueError):
                continue
            a = agg.setdefault(str(name), [0, 0.0])
            a[0] += 1
            a[1] += s
        try:
            loop = float(e["loop_s"])
        except (KeyError, TypeError, ValueError):
            continue
        if loop > 0:
            loop_steps += 1
            loop_s += loop
            try:
                device_s += float(phases.get("device_step", 0.0))
            except (TypeError, ValueError):
                pass
    denom = sum(s for _, s in agg.values())
    out: dict[str, dict[str, float]] = {
        name: {
            "count": int(c),
            "seconds": round(s, 6),
            "share": round(s / denom, 4) if denom > 0 else 0.0,
        }
        for name, (c, s) in sorted(agg.items(), key=lambda kv: -kv[1][1])
    }
    if loop_steps:
        out["_overlap"] = {
            "count": loop_steps,
            "loop_s": round(loop_s, 6),
            "device_s": round(device_s, 6),
            "busy_frac": round(device_s / loop_s, 4) if loop_s > 0 else 0.0,
            "idle_s": round(max(0.0, loop_s - device_s), 6),
        }
    return out
