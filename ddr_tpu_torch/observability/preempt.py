"""Preemption handling: turn SIGTERM/SIGINT into one graceful drain + save.

The port of ``ddr_tpu/observability/preempt.py``.

Preemptible machines (spot GPU instances, k8s evictions) announce shutdown with
SIGTERM and a grace window. Python's default disposition kills the process on
the spot — everything since the last checkpoint is lost. The handler here
converts the signal into a *flag* the training loop polls at its batch
boundary (the only place the host owns all of params / opt_state / loader
RNG), so the loop can drain in-flight checkpoint writes, perform ONE emergency
save, emit a ``preempt`` telemetry event, and exit cleanly inside the grace
window.

Signal discipline:

- SIGTERM: always graceful. A second SIGTERM during the drain is ignored
  (orchestrators commonly re-signal; the save is already underway).
- SIGINT: the FIRST Ctrl-C requests the same graceful stop; a SECOND restores
  the default ``KeyboardInterrupt`` path — an operator hammering Ctrl-C wants
  out now, not a checkpoint.

Handlers can only be installed from the main thread (CPython restriction);
:class:`PreemptionHandler` degrades to an inert no-op elsewhere (worker-thread
test harnesses), because a training loop that cannot arm preemption handling
must still train.

Standard library only.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Any

log = logging.getLogger(__name__)

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """Context manager arming SIGTERM/SIGINT -> :attr:`requested`.

    Usage::

        with PreemptionHandler() as preempt:
            for batch in loader:
                step(batch)
                if preempt.requested:
                    emergency_save(); break

    The previous handlers are restored on exit, so nesting (tests) and the
    surrounding CLI's own KeyboardInterrupt handling keep working.
    """

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)) -> None:
        self._signals = signals
        self._event = threading.Event()
        self._previous: dict[int, Any] = {}
        self.reason: str | None = None  #: signal name that requested the stop
        self.installed = False

    # ---- signal plumbing ----

    def _handle(self, signum: int, frame: Any) -> None:
        name = signal.Signals(signum).name
        if signum == signal.SIGINT and self._event.is_set():
            # second Ctrl-C: the operator wants out NOW — restore the default
            # disposition and raise through it
            signal.signal(signal.SIGINT, self._previous.get(signal.SIGINT, signal.SIG_DFL))
            raise KeyboardInterrupt
        if not self._event.is_set():
            self.reason = name
            log.warning(
                f"{name} received: draining and writing an emergency checkpoint "
                "at the next batch boundary"
            )
        self._event.set()

    def __enter__(self) -> "PreemptionHandler":
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handle)
            self.installed = True
        except ValueError:
            # not the main thread: stay inert (requested is simply never set)
            self._previous.clear()
            self.installed = False
        return self

    def __exit__(self, *exc: Any) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # interpreter shutdown / wrong thread
                pass
        self._previous.clear()
        return None

    # ---- the loop-facing surface ----

    @property
    def requested(self) -> bool:
        """True once a shutdown signal arrived; the loop should save and exit."""
        return self._event.is_set()

    def request(self, reason: str = "test") -> None:
        """Set the flag programmatically (tests / cooperative shutdown)."""
        if not self._event.is_set():
            self.reason = reason
        self._event.set()
