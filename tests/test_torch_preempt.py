"""The port's preemption handler against the JAX package's: ``requested``
and ``reason`` after ``request()`` and after a real SIGTERM to this process
inside the context, the first SIGINT's graceful stop and the second's
``KeyboardInterrupt``, the previous handlers restored on exit, and the inert
handler off the main thread."""

from __future__ import annotations

import os
import signal
import threading
import time

import pytest

from ddr_tpu.observability.preempt import PreemptionHandler as JaxHandler
from ddr_tpu_torch.observability.preempt import PreemptionHandler as PortHandler

HANDLERS = pytest.mark.parametrize("handler_cls", [JaxHandler, PortHandler], ids=["jax", "port"])


def _signal_self(signum: int) -> None:
    os.kill(os.getpid(), signum)
    time.sleep(0.01)  # the handler runs on the main thread between bytecodes


def _state(h) -> tuple:
    return h.requested, h.reason, h.installed


def test_request_equals_jax():
    states = []
    for cls in (JaxHandler, PortHandler):
        with cls() as h:
            before = _state(h)
            h.request("drill")
            h.request("second")  # the first reason stays
            states.append((before, _state(h)))
    assert states[0] == states[1] == ((False, None, True), (True, "drill", True))


@HANDLERS
def test_sigterm_sets_the_flag_and_handlers_come_back(handler_cls):
    prev_term, prev_int = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    with handler_cls() as h:
        assert signal.getsignal(signal.SIGTERM) == h._handle
        _signal_self(signal.SIGTERM)
        assert _state(h) == (True, "SIGTERM", True)
        _signal_self(signal.SIGTERM)  # a second SIGTERM is ignored
        assert _state(h) == (True, "SIGTERM", True)
    assert signal.getsignal(signal.SIGTERM) == prev_term
    assert signal.getsignal(signal.SIGINT) == prev_int


def test_sigterm_states_equal_jax():
    states = []
    for cls in (JaxHandler, PortHandler):
        with cls() as h:
            _signal_self(signal.SIGTERM)
            states.append(_state(h))
    assert states[0] == states[1]


@HANDLERS
def test_second_sigint_raises_keyboard_interrupt(handler_cls):
    prev_int = signal.getsignal(signal.SIGINT)
    with handler_cls() as h:
        _signal_self(signal.SIGINT)
        assert _state(h) == (True, "SIGINT", True)
        with pytest.raises(KeyboardInterrupt):
            _signal_self(signal.SIGINT)
        # the second Ctrl-C put the previous disposition back
        assert signal.getsignal(signal.SIGINT) == prev_int
    assert signal.getsignal(signal.SIGINT) == prev_int


def test_off_the_main_thread_both_stay_inert():
    states = []

    def run():
        for cls in (JaxHandler, PortHandler):
            with cls() as h:
                states.append(_state(h))
                h.request("cooperative")
                states.append(_state(h))

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=30)
    assert states == [(False, None, False), (True, "cooperative", False)] * 2
