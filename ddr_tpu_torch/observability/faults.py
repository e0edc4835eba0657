"""Deterministic fault injection for the hot paths (``DDR_FAULTS``).

The port of ``ddr_tpu/observability/faults.py``: the same sites, actions,
grammar, seeded draws and ``fault`` events. Chaos engineering needs
*reproducible* failures: "the run died once" is not a test, "the run dies at
step 37 every time and resumes" is. Each named **fault site** sits on a path
whose failure matters at production scale:

==================  =========================================================
site                where it fires (host side only, never inside a kernel)
==================  =========================================================
``checkpoint.write``  :func:`ddr_tpu_torch.training.save_state`, between the
                      temp write and the rename (a crash leaves a ``.tmp``, a
                      corrupt flips bits under an already-computed manifest)
``data.load``         the train loop's prefetch-thread forcing read
``data.forcings``     the prefetch thread's assembled forcing batch, BEFORE
                      the ``data_load`` validation scan (a ``nan`` here is the
                      bad tile the quarantine policy must catch on the host)
``data.remote_read``  the remote store reader's array reads (the port has no
                      remote reader yet, so nothing fires it; a plan naming it
                      still parses, as in the JAX package)
``device.step``       the train loop, immediately before the step (a ``nan``
                      poisons the uploaded forcing AFTER validation passed:
                      the storm only the watchdog sees)
``device.grads``      the train loop, on the host-synchronised gradient norm
                      right before the watchdog thresholds it (a ``nan``
                      simulates a non-finite backward pass)
``serve.execute``     :class:`~ddr_tpu_torch.serving.service.ForecastService`'s
                      batch worker, before the batch is routed
``registry.reload``   :class:`~ddr_tpu_torch.serving.registry.CheckpointWatcher`,
                      before a hot-reload load
==================  =========================================================

A seeded plan parsed out of the environment drives them::

    DDR_FAULTS="crash@step=37;slow@data.load:p=0.1,ms=500;corrupt@checkpoint.write:n=1"

Grammar: ``;``-separated clauses of ``action@site[=AT][:k=v,...]``.

- ``action``: ``crash`` (raise :class:`InjectedFault`), ``slow`` (sleep
  ``ms``), ``corrupt`` (bit-flip the byte payload the site is writing),
  ``nan`` (overwrite the float-array payload the site is carrying with
  non-finites: the nan-storm drill's primitive).
- ``site``: a registered name or any unambiguous suffix (``step`` resolves to
  ``device.step``, ``write`` to ``checkpoint.write``).
- ``=AT`` (or ``at=AT``): fire only when the site's context ``step`` (else
  its 0-based invocation counter) equals ``AT``.
- ``p=<float>``: fire with this probability per invocation (seeded RNG:
  ``DDR_FAULTS_SEED``, default 0: the same plan replays the same faults).
- ``n=<int>``: stop after this many firings.
- ``ms=<float>``: the ``slow`` action's delay.

Every firing emits one ``fault`` event on the active recorder and a log
warning, so a chaos run's log shows which injected failure each recovery
answered.

**Zero cost when off.** Call sites resolve their site handle once, at build
time (:func:`fault_site` returns ``None`` when the plan has no action for
that site, the unset-``DDR_FAULTS`` case), so the per-step cost is one ``if
None`` check on the host. Nothing here runs on the card.

Standard library only.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Any

log = logging.getLogger(__name__)

__all__ = [
    "FAULT_SITES",
    "FAULT_ACTIONS",
    "PAYLOAD_SITES",
    "NAN_SITES",
    "InjectedFault",
    "FaultAction",
    "FaultPlan",
    "FaultPoint",
    "parse_faults",
    "fault_site",
    "maybe_inject",
    "configure",
    "active_plan",
]

#: The closed vocabulary of injectable sites. A plan naming anything else fails at parse time —
#: a typo'd chaos plan silently injecting nothing is worse than a crash.
FAULT_SITES = (
    "checkpoint.write",
    "data.load",
    "data.forcings",
    "data.remote_read",
    "device.step",
    "device.grads",
    "serve.execute",
    "registry.reload",
)

#: Supported actions: raise / delay / bit-flip / nan-storm.
FAULT_ACTIONS = ("crash", "slow", "corrupt", "nan")

#: Sites whose invocation carries a byte payload a ``corrupt`` action can
#: flip. A corrupt clause anywhere else would fire, log, emit a ``fault``
#: event — and change nothing: exactly the silently-inert plan the parse-time
#: strictness exists to prevent, so it is rejected up front.
PAYLOAD_SITES = ("checkpoint.write",)

#: Sites whose invocation carries a float ndarray payload a ``nan`` action can
#: overwrite with non-finites. Same parse-time strictness as PAYLOAD_SITES: a
#: ``nan`` clause at a byte/no-payload site would be silently inert.
NAN_SITES = ("data.forcings", "device.step", "device.grads")


class InjectedFault(RuntimeError):
    """The exception a ``crash`` action raises — a distinct type, so recovery
    tests can assert *their* fault (and only theirs) took the path down."""

    def __init__(self, site: str, message: str) -> None:
        super().__init__(message)
        self.site = site


def _resolve_site(token: str) -> str:
    """Exact or unambiguous-suffix site resolution (``step`` -> ``device.step``)."""
    if token in FAULT_SITES:
        return token
    matches = [s for s in FAULT_SITES if s.endswith("." + token) or s.split(".")[-1] == token]
    if len(matches) == 1:
        return matches[0]
    raise ValueError(
        f"unknown fault site {token!r} (sites: {', '.join(FAULT_SITES)})"
        + (f"; ambiguous between {matches}" if matches else "")
    )


class FaultAction:
    """One parsed clause, owning its own match/firing state (thread-safe:
    sites fire from prefetch, batcher, and writer threads)."""

    def __init__(
        self,
        action: str,
        site: str,
        at: int | None = None,
        p: float | None = None,
        n: int | None = None,
        ms: float = 0.0,
        seed: int = 0,
    ) -> None:
        if action not in FAULT_ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} (actions: {', '.join(FAULT_ACTIONS)})"
            )
        if action == "corrupt" and site not in PAYLOAD_SITES:
            raise ValueError(
                f"corrupt@{site} would inject nothing: only "
                f"{', '.join(PAYLOAD_SITES)} write a byte payload to flip"
            )
        if action == "nan" and site not in NAN_SITES:
            raise ValueError(
                f"nan@{site} would inject nothing: only "
                f"{', '.join(NAN_SITES)} carry a float-array payload to poison"
            )
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], got {p}")
        self.action = action
        self.site = site
        self.at = at
        self.p = p
        self.n = n
        self.ms = float(ms)
        # per-action RNG: adding a clause to the plan must not reshuffle the
        # firing pattern of the clauses before it. Seeded from a stable digest
        # — NOT a tuple: random.seed(tuple) is rejected on modern Pythons, and
        # on older ones it falls back to the PYTHONHASHSEED-salted hash(),
        # which would break the replay-the-same-faults contract across
        # processes.
        import hashlib

        digest = hashlib.sha256(
            f"{seed}|{action}|{site}|{at}|{n}".encode()
        ).digest()
        self._rng = random.Random(int.from_bytes(digest[:8], "big"))
        self._lock = threading.Lock()
        self._invocations = 0
        self._fired = 0

    def should_fire(self, ctx: dict[str, Any]) -> bool:
        """Evaluate the match for one site invocation (advances counters)."""
        with self._lock:
            idx = self._invocations
            self._invocations += 1
            if self.n is not None and self._fired >= self.n:
                return False
            step = ctx.get("step")
            position = int(step) if step is not None else idx
            if self.at is not None and position != self.at:
                return False
            if self.p is not None and self._rng.random() >= self.p:
                return False
            self._fired += 1
            return True

    def describe(self) -> dict[str, Any]:
        params: dict[str, Any] = {}
        if self.at is not None:
            params["at"] = self.at
        if self.p is not None:
            params["p"] = self.p
        if self.n is not None:
            params["n"] = self.n
        if self.ms:
            params["ms"] = self.ms
        return {"action": self.action, "site": self.site, **params}


def parse_faults(spec: str, seed: int = 0) -> list[FaultAction]:
    """``DDR_FAULTS`` grammar -> actions. Raises ``ValueError`` on any typo —
    a chaos plan that silently injects nothing proves nothing."""
    actions: list[FaultAction] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "@" not in clause:
            raise ValueError(
                f"bad fault clause {clause!r}: want action@site[:k=v,...]"
            )
        action, _, rest = clause.partition("@")
        site_token, _, param_str = rest.partition(":")
        at: int | None = None
        if "=" in site_token:  # the crash@step=37 shorthand
            site_token, _, at_raw = site_token.partition("=")
            at = int(at_raw)
        params: dict[str, float] = {}
        for kv in param_str.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(f"bad fault parameter {kv!r} in {clause!r} (want k=v)")
            k, _, v = kv.partition("=")
            params[k.strip()] = float(v)
        unknown = set(params) - {"p", "n", "ms", "at"}
        if unknown:
            raise ValueError(f"unknown fault parameters {sorted(unknown)} in {clause!r}")
        if "at" in params:
            at = int(params["at"])
        actions.append(
            FaultAction(
                action.strip(),
                _resolve_site(site_token.strip()),
                at=at,
                p=params.get("p"),
                n=None if "n" not in params else int(params["n"]),
                ms=params.get("ms", 0.0),
                seed=seed,
            )
        )
    return actions


class FaultPlan:
    """The parsed plan, indexed by site; :meth:`point` hands out per-site
    callables (or None) so armed hot paths pay one attribute call and idle
    ones pay nothing."""

    def __init__(self, actions: list[FaultAction]) -> None:
        self._by_site: dict[str, list[FaultAction]] = {}
        for a in actions:
            self._by_site.setdefault(a.site, []).append(a)

    def point(self, site: str) -> "FaultPoint | None":
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}")
        actions = self._by_site.get(site)
        return FaultPoint(site, actions) if actions else None

    def describe(self) -> list[dict[str, Any]]:
        return [a.describe() for acts in self._by_site.values() for a in acts]


class FaultPoint:
    """One armed site. Calling it evaluates every matching action:

    - ``slow`` sleeps, then execution continues;
    - ``corrupt`` bit-flips the ``data`` bytes (returned; sites that write
      payloads pass them through);
    - ``nan`` overwrites a float ndarray ``data`` with non-finites (returned
      as a poisoned copy — the caller's array is never mutated in place);
    - ``crash`` raises :class:`InjectedFault` (evaluated last, so a clause
      list like ``slow;crash`` behaves as written).

    Returns the (possibly mutated) ``data`` — ``None`` when none was given.
    """

    def __init__(self, site: str, actions: list[FaultAction]) -> None:
        self.site = site
        self._actions = actions
        #: True when any clause needs an ndarray payload — call sites that
        #: must materialize a host copy to offer one check this first so an
        #: armed-but-nan-free plan stays payload-free on the hot path.
        self.wants_array = any(a.action == "nan" for a in actions)

    def __call__(self, data: Any = None, **ctx: Any) -> Any:
        crash: FaultAction | None = None
        for a in self._actions:
            if not a.should_fire(ctx):
                continue
            self._emit(a, ctx)
            if a.action == "slow":
                time.sleep(a.ms / 1e3)
            elif a.action == "corrupt" and data is not None:
                data = _flip_bits(data)
            elif a.action == "nan" and data is not None:
                data = _poison_array(data)
            elif a.action == "crash":
                crash = a
        if crash is not None:
            raise InjectedFault(
                self.site,
                f"injected fault: crash@{self.site}"
                + (f" step={ctx['step']}" if "step" in ctx else ""),
            )
        return data

    def _emit(self, action: FaultAction, ctx: dict[str, Any]) -> None:
        payload = {**action.describe(), **{k: v for k, v in ctx.items() if _plain(v)}}
        log.warning(
            "fault injected: %s@%s %s", action.action, self.site,
            " ".join(f"{k}={v}" for k, v in payload.items() if k not in ("action", "site")),
        )
        try:
            from ddr_tpu_torch.observability.events import get_recorder

            rec = get_recorder()
            if rec is not None:
                rec.emit("fault", **payload)
        except Exception:  # telemetry must never mask the injected failure
            log.exception("could not record fault event")


def _plain(v: Any) -> bool:
    return isinstance(v, (bool, int, float, str)) or v is None


def _poison_array(arr: Any, every: int = 3) -> Any:
    """Overwrite every ``every``-th element of a float ndarray with NaN (plus
    one +inf, so downstream scans see both non-finite kinds) — a deterministic
    "storm", dense enough that any reduction over the payload goes non-finite.
    Duck-typed over the ndarray API (``dtype``/``copy``/``flat``) so this
    module stays import-free of numpy; non-float payloads pass through
    untouched (there is nothing representable to poison)."""
    dtype = getattr(arr, "dtype", None)
    if dtype is None or getattr(dtype, "kind", "") not in ("f", "c"):
        return arr
    out = arr.copy()
    # .flat (not .reshape(-1)) — a reshape of a non-contiguous copy would
    # detach from ``out`` and the poison would vanish
    out.flat[:: max(1, int(every))] = float("nan")
    if out.size:
        out.flat[0] = float("inf")
    return out


def _flip_bits(data: bytes, every: int = 97) -> bytes:
    """Deterministically flip one bit every ``every`` bytes (at least one) —
    the shape of real bit-rot/torn-write corruption, reproducible in tests."""
    buf = bytearray(data)
    if not buf:
        return bytes(buf)
    for i in range(0, len(buf), every):
        buf[i] ^= 0x40
    return bytes(buf)


# ---------------------------------------------------------------------------
# The process-wide plan (parsed from the environment once, on first use).
# ---------------------------------------------------------------------------

_PLAN: FaultPlan | None = None
_PLAN_LOCK = threading.Lock()


def active_plan() -> FaultPlan:
    """The process plan: parsed from ``DDR_FAULTS`` (+ ``DDR_FAULTS_SEED``)
    exactly once. An empty/unset spec yields an empty plan — every
    :func:`fault_site` then returns None and armed paths cost nothing."""
    global _PLAN
    if _PLAN is None:
        with _PLAN_LOCK:
            if _PLAN is None:
                spec = os.environ.get("DDR_FAULTS", "")
                seed = int(os.environ.get("DDR_FAULTS_SEED", "0") or 0)
                plan = FaultPlan(parse_faults(spec, seed=seed) if spec else [])
                if spec:
                    log.warning(f"fault injection armed: {plan.describe()}")
                _PLAN = plan
    return _PLAN


def configure(spec: str | None, seed: int = 0) -> FaultPlan:
    """Install a plan programmatically (tests; ``None``/empty disarms).
    Replaces the env-derived plan for the whole process."""
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = FaultPlan(parse_faults(spec, seed=seed) if spec else [])
    return _PLAN


def fault_site(site: str) -> FaultPoint | None:
    """The build-time resolution call sites use: grab the handle once, keep
    it for the loop's lifetime. None = site unarmed (the common case)."""
    return active_plan().point(site)


def maybe_inject(site: str, data: Any = None, **ctx: Any) -> Any:
    """One-shot convenience for cold sites (checkpoint writes, reloads) where
    re-resolving per call is fine."""
    point = fault_site(site)
    if point is None:
        return data
    return point(data=data, **ctx)
