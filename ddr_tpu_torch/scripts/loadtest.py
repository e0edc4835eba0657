"""``ddr loadtest`` on the port: load generation with latency and SLO reports.

The port of ``ddr_tpu/scripts/loadtest.py``. It drives a forecast service
hard enough to see its real p50/p95/p99, where the time goes (queue wait
against execution, as the service reports them per request), what it sheds
under pressure and why, and whether the SLO held. Two generators:

- **open loop** (``--mode open``, the default): Poisson arrivals at
  ``--rps``, independent of completions, so queueing delay is measured, not
  hidden. In-flight requests are capped at ``--max-inflight``; an arrival
  past the cap waits on the client, and that wait counts into its latency
  (the clock starts at the scheduled arrival);
- **closed loop** (``--mode closed``): ``--clients`` synchronous clients,
  each sending its next request when the last returns.

Targets: a running server (``--url http://host:port``), an in-process
service built from a run config (``ddr loadtest config.yaml [a.b=c ...]``),
``--synthetic``, an in-process service over a synthetic basin (``a.b=c``
overrides such as ``device=cpu`` apply to its config), or ``--fleet N``, an
in-process group of N such synthetic services behind the fleet router
(:class:`FleetDriver`). In-process services run on the card unless
``device=cpu``. The report is one flat JSON record,
written to ``LOADTEST_<label>.json`` and printed as the last line of
standard output after a short summary.

    python -m ddr_tpu_torch.cli loadtest --synthetic --rps 50 --duration 10 device=cpu
    python -m ddr_tpu_torch.cli loadtest --url http://127.0.0.1:8080 --mode closed --clients 16
    python -m ddr_tpu_torch.cli loadtest examples/synthetic/config.yaml --rps 20 --t0-span 240
    python -m ddr_tpu_torch.cli loadtest --synthetic --fleet 2 --rps 80 --duration 10 device=cpu

An in-process run records the service's decisions in
``run_log.loadtest.jsonl`` (``DDR_METRICS_DIR``, else the report directory);
so does a ``--url`` run when ``DDR_METRICS_DIR`` is set, with the client's
side only.

Departures from the JAX command: :func:`priority_for` seeds its draw with a
string, because Python 3.12 refuses the tuple seed of the JAX function; and
the report's ``device`` names the card (or ``cpu``) of the in-process
service, or of the group's first replica, where JAX's names the platform.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from pathlib import Path
from typing import Any, Callable

from ddr_tpu_torch.observability.events import run_telemetry

log = logging.getLogger(__name__)

__all__ = [
    "FleetDriver",
    "HttpDriver",
    "InProcessDriver",
    "Outcome",
    "build_report",
    "build_synthetic_service",
    "device_label",
    "main",
    "parse_priority_mix",
    "priority_for",
    "render_summary",
    "run_closed_loop",
    "run_loadtest",
    "run_open_loop",
]

#: Latency quantiles every report carries, for each lifecycle phase.
QUANTILES = (0.50, 0.95, 0.99)


@dataclasses.dataclass
class Outcome:
    """One request's terminal result, as the client saw it."""

    status: str  # "ok" | "rejected" | "shed:<reason>" | "error:<what>"
    latency_s: float
    queue_s: float | None = None  # server-reported queue wait (ok only)
    execute_s: float | None = None  # server-reported execution time (ok only)
    priority: str | None = None  # the class the request was sent in

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def parse_priority_mix(spec: str | None) -> list[tuple[str, float]] | None:
    """``"interactive=0.6,batch=0.3,bulk=0.1"`` -> the normalised ``(class,
    weight)`` list, each class checked against the serving tier's; None for
    no spec (every request in the default class)."""
    if not spec:
        return None
    from ddr_tpu_torch.serving.config import priority_rank

    mix: list[tuple[str, float]] = []
    for part in spec.split(","):
        name, _, raw_w = part.partition("=")
        name = name.strip()
        priority_rank(name)  # raises on unknown class names
        try:
            weight = float(raw_w) if raw_w.strip() else 1.0
        except ValueError as e:
            raise ValueError(f"bad priority weight in {part!r}: {e}") from e
        if weight < 0:
            raise ValueError(f"priority weight must be >= 0, got {part!r}")
        mix.append((name, weight))
    total = sum(w for _, w in mix)
    if total <= 0:
        raise ValueError(f"priority mix {spec!r} sums to zero")
    return [(name, w / total) for name, w in mix]


def priority_for(i: int, mix: list[tuple[str, float]] | None, seed: int = 0) -> str | None:
    """Request ``i``'s class under the mix, fixed by ``(seed, i)``: a
    replayed run sends the same class sequence. The draw is seeded with the
    string ``"<seed>:<i>"``, which ``random.Random`` hashes with SHA-512 the
    same way in every process; the JAX package's tuple seed raises
    ``TypeError`` on Python 3.12."""
    if not mix:
        return None
    frac = random.Random(f"{int(seed)}:{int(i)}").random()
    acc = 0.0
    for name, weight in mix:
        acc += weight
        if frac < acc:
            return name
    return mix[-1][0]


# ---------------------------------------------------------------------------
# Drivers: one fire(i) -> Outcome per kind of target, and a stats() snapshot.
# ---------------------------------------------------------------------------


class InProcessDriver:
    """Drive a live :class:`~ddr_tpu_torch.serving.service.ForecastService`
    directly: its own backpressure, no sockets."""

    def __init__(
        self,
        service: Any,
        network: str = "default",
        model: str = "default",
        t0_span: int | None = None,
        deadline_ms: float | None = None,
        priority_mix: list[tuple[str, float]] | None = None,
        ensemble: int = 0,
        seed: int = 0,
    ) -> None:
        self.service = service
        self.network = network
        self.model = model
        self.deadline_ms = deadline_ms
        self.priority_mix = priority_mix
        self.ensemble = int(ensemble)
        self.seed = int(seed)
        net = service.networks()[network]
        if t0_span is None:
            t0_span = 1 if net.forcing is None else max(1, len(net.forcing) - net.horizon + 1)
        self.t0_span = max(1, int(t0_span))
        deadline_s = service.serve_cfg.deadline_s if deadline_ms is None else deadline_ms / 1e3
        self._wait_s = deadline_s + 5.0

    def fire(self, i: int) -> Outcome:
        from ddr_tpu_torch.serving.batcher import QueueFullError, RequestShedError

        prio = priority_for(i, self.priority_mix, self.seed)
        start = time.monotonic()
        try:
            if self.ensemble > 0:
                # on this thread: an E-member request is a batch of device work
                out = self.service.ensemble_forecast(
                    network=self.network, model=self.model, t0=i % self.t0_span,
                    members=self.ensemble, request_id=f"lt-{i}",
                )
            else:
                out = self.service.forecast(
                    network=self.network, model=self.model, t0=i % self.t0_span,
                    deadline_s=None if self.deadline_ms is None else self.deadline_ms / 1e3,
                    request_id=f"lt-{i}", timeout=self._wait_s, priority=prio,
                )
        except QueueFullError:
            return Outcome("rejected", time.monotonic() - start, priority=prio)
        except RequestShedError as e:
            return Outcome(f"shed:{e.reason}", time.monotonic() - start, priority=prio)
        except FutureTimeoutError:
            return Outcome("error:timeout", time.monotonic() - start, priority=prio)
        except Exception as e:  # noqa: BLE001 - an error is a data point here
            return Outcome(f"error:{type(e).__name__}", time.monotonic() - start, priority=prio)
        return Outcome("ok", time.monotonic() - start, out.get("queue_s"), out.get("execute_s"),
                       priority=prio)

    def stats(self) -> dict:
        return self.service.stats()


class FleetDriver:
    """Drive an in-process :class:`~ddr_tpu_torch.fleet.group.ReplicaGroup`
    through its router (``--fleet N``): the same generators and report as
    the single-service path, so a group's record and one service's compare
    directly."""

    def __init__(
        self,
        group: Any,
        network: str = "default",
        model: str = "default",
        t0_span: int | None = None,
        deadline_ms: float | None = None,
        priority_mix: list[tuple[str, float]] | None = None,
        ensemble: int = 0,
        seed: int = 0,
    ) -> None:
        self.group = group
        self.network = network
        self.model = model
        self.deadline_ms = deadline_ms
        self.priority_mix = priority_mix
        self.ensemble = int(ensemble)
        self.seed = int(seed)
        svc = group.replicas[0].service
        net = svc.networks()[network]
        if t0_span is None:
            t0_span = 1 if net.forcing is None else max(1, len(net.forcing) - net.horizon + 1)
        self.t0_span = max(1, int(t0_span))
        deadline_s = svc.serve_cfg.deadline_s if deadline_ms is None else deadline_ms / 1e3
        self._wait_s = deadline_s + 5.0

    def fire(self, i: int) -> Outcome:
        from ddr_tpu_torch.fleet.router import NoHealthyReplicaError
        from ddr_tpu_torch.serving.batcher import QueueFullError, RequestShedError

        prio = priority_for(i, self.priority_mix, self.seed)
        start = time.monotonic()
        try:
            if self.ensemble > 0:
                out = self.group.ensemble(
                    network=self.network, model=self.model, t0=i % self.t0_span,
                    members=self.ensemble, request_id=f"lt-{i}",
                )
            else:
                out = self.group.forecast(
                    network=self.network, model=self.model, t0=i % self.t0_span,
                    deadline_s=None if self.deadline_ms is None else self.deadline_ms / 1e3,
                    request_id=f"lt-{i}", timeout=self._wait_s, priority=prio,
                )
        except QueueFullError:
            return Outcome("rejected", time.monotonic() - start, priority=prio)
        except RequestShedError as e:
            return Outcome(f"shed:{e.reason}", time.monotonic() - start, priority=prio)
        except NoHealthyReplicaError:
            return Outcome("error:unroutable", time.monotonic() - start, priority=prio)
        except FutureTimeoutError:
            return Outcome("error:timeout", time.monotonic() - start, priority=prio)
        except Exception as e:  # noqa: BLE001 - an error is a data point here
            return Outcome(f"error:{type(e).__name__}", time.monotonic() - start, priority=prio)
        return Outcome("ok", time.monotonic() - start, out.get("queue_s"), out.get("execute_s"),
                       priority=prio)

    def stats(self) -> dict:
        """The group's rollup in the single service's shape: queue counters
        summed over the replicas (N half-full replicas are half-full
        capacity, so the report's occupancy keeps its meaning), the config
        of the first replica that answers."""
        merged: dict[str, Any] = {"queue": {}, "replicas": len(self.group.replicas)}
        for r in self.group.replicas:
            try:
                stats = r.stats()
            except Exception:  # a dead replica must not void the measured run
                continue
            if not merged.get("config"):
                merged["config"] = stats.get("config") or {}
            for k, v in (stats.get("queue") or {}).items():
                if isinstance(v, (int, float)):
                    merged["queue"][k] = merged["queue"].get(k, 0) + v
        return merged


class HttpDriver:
    """Drive a running server over its JSON API: 429 -> rejected, 503 with
    a ``reason`` -> ``shed:<reason>``."""

    def __init__(
        self,
        url: str,
        network: str = "default",
        model: str = "default",
        t0_span: int = 24,
        deadline_ms: float | None = None,
        timeout_s: float = 60.0,
        priority_mix: list[tuple[str, float]] | None = None,
        ensemble: int = 0,
        seed: int = 0,
    ) -> None:
        from ddr_tpu_torch.serving.client import HttpForecastClient

        self.client = HttpForecastClient(url, timeout=timeout_s)
        self.network = network
        self.model = model
        self.t0_span = max(1, int(t0_span))
        self.deadline_ms = deadline_ms
        self.priority_mix = priority_mix
        self.ensemble = int(ensemble)
        self.seed = int(seed)

    def fire(self, i: int) -> Outcome:
        prio = priority_for(i, self.priority_mix, self.seed)
        start = time.monotonic()
        try:
            code, body = self.client.forecast_response(
                self.network, model=self.model, t0=i % self.t0_span, deadline_ms=self.deadline_ms,
                request_id=f"lt-{i}", priority=prio,
                ensemble={"members": self.ensemble} if self.ensemble > 0 else None,
            )
        except Exception as e:  # URLError, socket timeouts, connection resets
            return Outcome(f"error:{type(e).__name__}", time.monotonic() - start, priority=prio)
        lat = time.monotonic() - start
        if code == 200:
            return Outcome("ok", lat, body.get("queue_s"), body.get("execute_s"), priority=prio)
        if code == 429:
            return Outcome("rejected", lat, priority=prio)
        reason = body.get("reason")
        if code == 503 and reason:
            return Outcome(f"shed:{reason}", lat, priority=prio)
        return Outcome(f"error:http-{code}", lat, priority=prio)

    def stats(self) -> dict:
        try:
            return self.client.stats()
        except Exception:  # a stats failure must not void the measured run
            log.warning("could not fetch /v1/stats from the target", exc_info=True)
            return {}


# ---------------------------------------------------------------------------
# Generators.
# ---------------------------------------------------------------------------


def run_open_loop(
    fire: Callable[[int], Outcome],
    rps: float,
    duration_s: float,
    seed: int = 0,
    max_inflight: int = 64,
) -> tuple[list[Outcome], float, int]:
    """Poisson arrivals at ``rps`` for ``duration_s`` -> ``(outcomes, wall_s,
    offered)``; ``wall_s`` runs from the first arrival to the last
    completion."""
    if rps <= 0:
        raise ValueError(f"rps must be > 0, got {rps}")
    rng = random.Random(seed)
    outcomes: list[Outcome] = []
    lock = threading.Lock()

    def job(i: int, t_sched: float) -> None:
        # latency counts from the scheduled arrival: a wait for a free worker
        # past --max-inflight is latency the client saw
        wait = time.monotonic() - t_sched
        o = fire(i)
        if wait > 0:
            o.latency_s += wait
        with lock:
            outcomes.append(o)

    start = time.monotonic()
    i = 0
    with ThreadPoolExecutor(max_workers=max(1, int(max_inflight)),
                            thread_name_prefix="ddr-loadtest") as pool:
        t_next = start
        while t_next - start < duration_s:
            delay = t_next - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            pool.submit(job, i, t_next)
            i += 1
            t_next += rng.expovariate(rps)
        # leaving the pool drains the requests in flight before the clock stops
    return outcomes, time.monotonic() - start, i


def run_closed_loop(
    fire: Callable[[int], Outcome],
    clients: int,
    duration_s: float,
) -> tuple[list[Outcome], float, int]:
    """``clients`` synchronous workers, each firing back to back until the
    duration has passed (requests in flight complete); returns as
    :func:`run_open_loop`."""
    if clients < 1:
        raise ValueError(f"clients must be >= 1, got {clients}")
    outcomes: list[Outcome] = []
    lock = threading.Lock()
    counter = [0]
    start = time.monotonic()
    stop_at = start + duration_s

    def worker() -> None:
        while True:
            with lock:
                if time.monotonic() >= stop_at:
                    return
                i = counter[0]
                counter[0] += 1
            o = fire(i)
            with lock:
                outcomes.append(o)

    threads = [threading.Thread(target=worker, name=f"ddr-loadtest-{c}") for c in range(int(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outcomes, time.monotonic() - start, counter[0]


# ---------------------------------------------------------------------------
# Report.
# ---------------------------------------------------------------------------


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    """The nearest-rank quantile of an ascending sample (the JAX package's
    ``ddr metrics summarize`` formula), or None for an empty one."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _quantile_fields(values: list[float], prefix: str) -> dict[str, float | None]:
    """``{<prefix>p50_ms: ..., <prefix>p95_ms: ..., <prefix>p99_ms: ...}``."""
    vals = sorted(values)
    out: dict[str, float | None] = {}
    for q in QUANTILES:
        v = _percentile(vals, q)
        out[f"{prefix}p{int(100 * q)}_ms"] = None if v is None else round(1e3 * v, 3)
    return out


def build_report(
    outcomes: list[Outcome],
    wall_s: float,
    offered: int,
    stats_before: dict | None = None,
    stats_after: dict | None = None,
    **meta: Any,
) -> dict[str, Any]:
    """One flat record of a measured run: latency quantiles per lifecycle
    phase, throughput, shed, reject and error rates by reason, batch
    occupancy from the service's own counters, and SLO attainment and burn
    rates."""
    total = len(outcomes)
    oks = [o for o in outcomes if o.ok]
    sheds_by_reason: dict[str, int] = {}
    rejected = errors = 0
    for o in outcomes:
        if o.status == "rejected":
            rejected += 1
        elif o.status.startswith("shed:"):
            reason = o.status.split(":", 1)[1]
            sheds_by_reason[reason] = sheds_by_reason.get(reason, 0) + 1
        elif o.status.startswith("error:"):
            errors += 1
    shed = sum(sheds_by_reason.values())
    denom = max(1, total)
    wall_s = max(wall_s, 1e-9)

    report: dict[str, Any] = {
        "kind": "loadtest",
        "schema_version": 1,
        **meta,
        "wall_s": round(wall_s, 3),
        "offered": offered,
        "offered_rps": round(offered / wall_s, 3),
        "requests": total,
        "ok": len(oks),
        "rejected": rejected,
        "shed": shed,
        "errors": errors,
        "sheds_by_reason": sheds_by_reason,
        "throughput_rps": round(len(oks) / wall_s, 3),
        "shed_rate": round(shed / denom, 6),
        "reject_rate": round(rejected / denom, 6),
        "error_rate": round(errors / denom, 6),
        **_quantile_fields([o.latency_s for o in oks], ""),
        **_quantile_fields([o.queue_s for o in oks if o.queue_s is not None], "queue_"),
        **_quantile_fields([o.execute_s for o in oks if o.execute_s is not None], "execute_"),
    }

    # the per-class slice under --priority-mix: strict-priority extraction and
    # lowest-class-first shedding show here
    by_priority: dict[str, dict[str, Any]] = {}
    for o in outcomes:
        if o.priority is None:
            continue
        d = by_priority.setdefault(o.priority, {"requests": 0, "ok": 0, "dropped": 0, "_lat": []})
        d["requests"] += 1
        if o.ok:
            d["ok"] += 1
            d["_lat"].append(o.latency_s)
        elif o.status == "rejected" or o.status.startswith("shed:"):
            d["dropped"] += 1
    if by_priority:
        report["by_priority"] = {
            cls: {"requests": d["requests"], "ok": d["ok"], "dropped": d["dropped"],
                  **_quantile_fields(d.pop("_lat"), "")}
            for cls, d in sorted(by_priority.items())
        }

    # batch occupancy from the service's own counters, over the run
    mean_size = occupancy = None
    try:
        qb = (stats_before or {}).get("queue") or {}
        qa = (stats_after or {}).get("queue") or {}
        served = qa.get("served", 0) - qb.get("served", 0)
        batches = qa.get("batches", 0) - qb.get("batches", 0)
        max_batch = ((stats_after or {}).get("config") or {}).get("max_batch")
        if batches > 0:
            mean_size = round(served / batches, 3)
            if max_batch:
                occupancy = round(mean_size / max_batch, 4)
    except TypeError:
        pass
    report["mean_batch_size"] = mean_size
    report["mean_batch_occupancy"] = occupancy

    # SLO: the server's own tracker, as the change of its lifetime counters
    # over the run (earlier traffic and the priming request stay out), else
    # the good fraction the client saw
    slo = (stats_after or {}).get("slo") or {}
    slo_before = (stats_before or {}).get("slo") or {}
    report["slo_target"] = slo.get("target")
    att = None
    after_l = slo.get("lifetime") or {}
    before_l = slo_before.get("lifetime") or {}
    if isinstance(after_l.get("total"), int):
        d_total = after_l["total"] - (before_l.get("total") or 0)
        d_good = (after_l.get("good") or 0) - (before_l.get("good") or 0)
        if d_total > 0:
            att = round(d_good / d_total, 6)
    if att is None and total:
        att = round(len(oks) / denom, 6)
    report["slo_attainment"] = att
    report["slo_burn_rates"] = {w: v.get("burn_rate") for w, v in (slo.get("windows") or {}).items()}
    return report


def render_summary(report: dict[str, Any]) -> str:
    """The lines an operator reads before the JSON."""
    from ddr_tpu_torch.observability.slo import parse_window_label

    def ms(key: str) -> str:
        v = report.get(key)
        return "-" if v is None else f"{v:.1f}"

    lines = [
        f"loadtest [{report.get('mode')}] {report.get('target')}: "
        f"{report['requests']} requests in {report['wall_s']:.2f}s "
        f"({report['offered_rps']:.1f} offered rps, {report['throughput_rps']:.1f} served rps)",
        f"  latency  p50 {ms('p50_ms')}ms  p95 {ms('p95_ms')}ms  p99 {ms('p99_ms')}ms",
        f"  queue    p50 {ms('queue_p50_ms')}ms  p95 {ms('queue_p95_ms')}ms  p99 {ms('queue_p99_ms')}ms",
        f"  execute  p50 {ms('execute_p50_ms')}ms  p95 {ms('execute_p95_ms')}ms  "
        f"p99 {ms('execute_p99_ms')}ms",
    ]
    drops = []
    if report["rejected"]:
        drops.append(f"rejected {report['rejected']}")
    for reason, n in sorted((report.get("sheds_by_reason") or {}).items()):
        drops.append(f"shed:{reason} {n}")
    if report["errors"]:
        drops.append(f"errors {report['errors']}")
    lines.append("  drops    " + (", ".join(drops) if drops else "none"))
    for cls, d in sorted((report.get("by_priority") or {}).items()):
        p99 = d.get("p99_ms")
        lines.append(f"  class    {cls}: {d['requests']} requests, ok {d['ok']}, dropped {d['dropped']}, "
                     "p99 " + ("-" if p99 is None else f"{p99:.1f}ms"))
    att = report.get("slo_attainment")
    target = report.get("slo_target")
    slo_line = "  slo      " + ("-" if att is None else f"attainment {100 * att:.2f}%")
    if target is not None:
        slo_line += f" (target {100 * target:.1f}%)"
    burns = {w: b for w, b in (report.get("slo_burn_rates") or {}).items() if b is not None}
    if burns:
        def _window_seconds(name: str) -> float:
            secs = parse_window_label(name)
            return float("inf") if secs is None else secs

        slo_line += "  burn " + "  ".join(
            f"{w} {b:.2f}x" for w, b in sorted(burns.items(), key=lambda kv: _window_seconds(kv[0])))
    lines.append(slo_line)
    occ = report.get("mean_batch_occupancy")
    if occ is not None:
        lines.append(f"  batches  mean size {report['mean_batch_size']}  occupancy {100 * occ:.0f}%")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Targets and the command.
# ---------------------------------------------------------------------------


def build_synthetic_service(n: int, horizon: int, save_path: str, serve_overrides: dict | None = None,
                            overrides: list[str] | None = None):
    """A warmed service over a synthetic basin (``make_basin(n, 4 gauges,
    seed 11)``), the target that needs no data; returns ``(service, cfg)``.
    Its run config is the JAX command's (10 attributes, the fall 1981
    window) with the ``a.b=c`` ``overrides`` applied: it runs on the card
    unless they say ``device=cpu``."""
    from ddr_tpu_torch.geodatazoo.synthetic import make_basin
    from ddr_tpu_torch.scripts.common import build_kan, kan_arch
    from ddr_tpu_torch.serving.config import ServeConfig
    from ddr_tpu_torch.serving.service import ForecastService
    from ddr_tpu_torch.validation.configs import load_config

    base = {
        "name": "loadtest",
        "geodataset": "synthetic",
        "mode": "testing",
        "kan": {"input_var_names": [f"a{i}" for i in range(10)]},
        "experiment": {"start_time": "1981/10/01", "end_time": "1981/10/10"},
        "params": {"save_path": str(save_path)},
    }
    cfg = load_config(None, list(overrides or []), base=base, save_config=False)
    n_days = max(2, -(-horizon // 24) + 1)  # at least one horizon of t0 slack
    basin = make_basin(n_segments=n, n_gauges=4, n_days=n_days, seed=11)
    service = ForecastService(cfg, ServeConfig.from_env(horizon_hours=horizon, **(serve_overrides or {})),
                              device=cfg.device)
    try:
        service.register_network("default", basin.routing_data, forcing=basin.q_prime)
        service.register_model("default", build_kan(cfg), arch=kan_arch(cfg))
        service.warmup()
    except BaseException:
        service.close(drain=False)
        raise
    return service, cfg


def device_label(service: Any) -> str | None:
    """The in-process service's card (``torch.cuda.get_device_name``) or
    ``"cpu"``; None for a run against ``--url``, whose server this process
    cannot see (its own card, if it has one, served nothing)."""
    if service is None:
        return None
    import torch

    dev = service.device
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_loadtest(driver, args_ns, service: Any = None) -> dict[str, Any]:
    """One measured run against a ready driver: prime, generate, report."""
    # one unmeasured request: the first after warmup still pays one-time host
    # costs that a short run would book into its p99
    driver.fire(0)
    stats_before = driver.stats()
    if args_ns.mode == "open":
        outcomes, wall, offered = run_open_loop(driver.fire, args_ns.rps, args_ns.duration,
                                                seed=args_ns.seed, max_inflight=args_ns.max_inflight)
    else:
        outcomes, wall, offered = run_closed_loop(driver.fire, args_ns.clients, args_ns.duration)
    stats_after = driver.stats()
    fleet_n = int(getattr(args_ns, "fleet", 0) or 0)
    return build_report(
        outcomes, wall, offered,
        stats_before=stats_before, stats_after=stats_after,
        mode=args_ns.mode,
        target=args_ns.url or (f"fleet:{fleet_n}" if fleet_n > 1
                               else "synthetic" if args_ns.synthetic else "config"),
        fleet=fleet_n if fleet_n > 1 else None,
        device=device_label(service),
        rps_target=args_ns.rps if args_ns.mode == "open" else None,
        clients=args_ns.clients if args_ns.mode == "closed" else None,
        duration_s=args_ns.duration,
        network=args_ns.network,
        model=args_ns.model,
        deadline_ms=args_ns.deadline_ms,
        seed=args_ns.seed,
        priority_mix=getattr(args_ns, "priority_mix", None),
        ensemble_members=getattr(args_ns, "ensemble", 0) or None,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ddr loadtest",
        description="Open/closed-loop load generation against a forecast service (HTTP or "
        "in-process); writes a LOADTEST_*.json latency/SLO report.",
    )
    parser.add_argument("config", nargs="*",
                        help="optional config.yaml plus a.b=c overrides for an in-process service "
                        "(with --synthetic, the overrides apply to the synthetic config; ignored "
                        "with --url)")
    parser.add_argument("--url", default=None, help="drive a running server at this base URL instead")
    parser.add_argument("--synthetic", action="store_true",
                        help="drive an in-process service over a synthetic basin")
    parser.add_argument("--n", type=int, default=512, help="synthetic reach count (default 512)")
    parser.add_argument("--horizon", type=int, default=24,
                        help="synthetic forecast horizon, hours (default 24)")
    parser.add_argument("--network", default="default")
    parser.add_argument("--model", default="default")
    parser.add_argument("--mode", choices=("open", "closed"), default="open")
    parser.add_argument("--rps", type=float, default=20.0,
                        help="open-loop target arrival rate (default 20)")
    parser.add_argument("--clients", type=int, default=8, help="closed-loop concurrent clients (default 8)")
    parser.add_argument("--duration", type=float, default=5.0, help="generation window, seconds (default 5)")
    parser.add_argument("--deadline-ms", type=float, default=None,
                        help="per-request deadline override, milliseconds")
    parser.add_argument("--t0-span", type=int, default=None,
                        help="cycle request t0 over this many hourly offsets (default: the "
                        "registered forcing's full span; 24 for --url)")
    parser.add_argument("--max-inflight", type=int, default=64,
                        help="open-loop in-flight request cap (default 64)")
    parser.add_argument("--priority-mix", default=None, dest="priority_mix",
                        help='send requests across priority classes, e.g. '
                        '"interactive=0.6,batch=0.3,bulk=0.1" (weights normalise; the report '
                        "gains a by_priority slice)")
    parser.add_argument("--ensemble", type=int, default=0,
                        help="send E-member ensemble requests instead of single forecasts "
                        "(default 0 = off)")
    parser.add_argument("--fleet", type=int, default=0,
                        help="drive an in-process N-replica group through the fleet router instead of "
                        "one service (synthetic target only; a.b=c overrides reach every replica; "
                        "default 0 = off)")
    parser.add_argument("--seed", type=int, default=0, help="arrival-process RNG seed (default 0)")
    parser.add_argument("--label", default=None,
                        help="report name suffix (LOADTEST_<label>.json; default: a timestamp)")
    parser.add_argument("--out", default=None, help="report directory (default: DDR_METRICS_DIR or .)")
    return parser


def fleet_group(args, overrides: list[str], out_dir: Path) -> Any:
    """``--fleet N``'s group, not yet booted: N in-process synthetic
    services, the ``a.b=c`` overrides reaching every replica."""
    from ddr_tpu_torch.fleet.config import FleetConfig
    from ddr_tpu_torch.fleet.group import ReplicaGroup

    return ReplicaGroup(FleetConfig.from_env(replicas=args.fleet, mode="inprocess"),
                        builder=lambda i: build_synthetic_service(
                            args.n, args.horizon, save_path=str(out_dir), overrides=overrides)[0],
                        workdir=out_dir)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:  # argparse exits for --help (0) and usage errors (2)
        return int(e.code or 0)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    out_dir = Path(args.out or os.environ.get("DDR_METRICS_DIR") or ".")
    out_dir.mkdir(parents=True, exist_ok=True)
    label = args.label or time.strftime("%Y%m%d-%H%M%S")

    service = None
    group = None
    cfg = None
    try:
        mix = parse_priority_mix(args.priority_mix)
        if args.fleet > 1:
            if args.url:
                log.error("--fleet boots its own in-process group; drop --url")
                return 2
            from ddr_tpu_torch.scripts.common import split_config_argv

            path, overrides = split_config_argv(args.config)
            if path is not None:
                log.error("--fleet builds synthetic replicas; pass a.b=c overrides, not a config file")
                return 2
            group = fleet_group(args, overrides, out_dir)
            group.boot()  # a failed boot is closed below, with the replicas it built
            cfg = group.replicas[0].service.cfg
            driver = FleetDriver(group, network=args.network, model=args.model,
                                 t0_span=args.t0_span, deadline_ms=args.deadline_ms,
                                 priority_mix=mix, ensemble=args.ensemble, seed=args.seed)
        elif args.url:
            driver = HttpDriver(args.url, network=args.network, model=args.model,
                                t0_span=24 if args.t0_span is None else args.t0_span,
                                deadline_ms=args.deadline_ms, priority_mix=mix,
                                ensemble=args.ensemble, seed=args.seed)
        else:
            from ddr_tpu_torch.scripts.common import parse_cli, split_config_argv

            path, overrides = split_config_argv(args.config)
            if args.synthetic or path is None:
                service, cfg = build_synthetic_service(args.n, args.horizon, save_path=str(out_dir),
                                                       overrides=overrides)
            else:
                from ddr_tpu_torch.scripts.serve import build_service

                cfg = parse_cli([path, *overrides], mode="testing")
                service = build_service(cfg, watch=False)
            driver = InProcessDriver(service, network=args.network, model=args.model,
                                     t0_span=args.t0_span, deadline_ms=args.deadline_ms,
                                     priority_mix=mix, ensemble=args.ensemble, seed=args.seed)
        with run_telemetry(cfg, "loadtest", mode=args.mode):
            try:
                report = run_loadtest(driver, args, service if group is None else group.replicas[0].service)
            finally:
                # closed inside the run log: close() merges the serve rollup into run_end
                if service is not None:
                    service.close(drain=False)
                    service = None
                if group is not None:
                    split = {r["name"]: r["dispatched"] for r in group.router.status()["replicas"]}
                    log.info(f"fleet router dispatches: {json.dumps(split)}")
                    group.close()
                    group = None
    finally:
        if service is not None:  # construction failed before the run
            service.close(drain=False)
        if group is not None:
            group.close()

    path = out_dir / f"LOADTEST_{label}.json"
    path.write_text(json.dumps(report, indent=2) + "\n")
    log.info(f"loadtest report written to {path}")
    print(render_summary(report))
    print(json.dumps(report))  # the last line of standard output stays machine-readable
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
