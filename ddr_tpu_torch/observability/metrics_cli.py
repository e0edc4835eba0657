"""``ddr metrics`` — summarize, tail, follow and export a run's telemetry JSONL.

The port's copy of ``ddr_tpu/observability/metrics_cli.py`` (standard
library only). It reads the event stream written by
:mod:`ddr_tpu_torch.observability.events` (``run_log.<cmd>.jsonl`` and any
rotated segments or per-host sidecars) and renders it as the JAX package's
command does, for either package's logs:

- ``summarize <log-or-dir>``: the run header, steps/sec, reach-timesteps/sec,
  compile counts per engine, the "Where time went" step-phase split, the
  per-program cost table (``program_card`` events), a sampled loss curve,
  serving latency percentiles with the queue/execute split, SLO attainment
  and burn, health violations, skill and drift, the per-span time breakdown
  and per-host heartbeat liveness;
- ``tail <log-or-dir> [-n N]``: the last N events, one compact line each;
  ``tail --follow [-i SECONDS]`` keeps polling and prints new events as they
  land (corrupt or half-written lines are skipped, a truncated or recreated
  file restarts from its top, Ctrl-C exits 0);
- ``trace <log-or-dir> --out trace.json``: the run as a Chrome/Perfetto
  trace: one process track per host, duration slices for spans, steps,
  requests and batches, instants for faults, recoveries and heartbeats, and
  flow arrows along one ``trace_id`` and from a ``serve_batch`` to its
  member requests.

A directory merges every ``*.jsonl`` inside; corrupt lines are skipped and
counted, never fatal: a run killed mid-write still summarizes.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path
from typing import Any

__all__ = [
    "main", "load_events", "summarize", "tail", "follow", "detect_stalls",
    "aggregate_spatial_health", "perfetto_trace",
]

#: Default stall threshold: a run whose newest step/heartbeat is older than
#: this many times its observed cadence is flagged (a hung collective looks
#: exactly like this — the process is alive, the event stream just stopped).
STALL_FACTOR = 5.0

#: Envelope keys hidden from per-event payload rendering.
_ENVELOPE = ("event", "t", "wall", "host", "pid", "seq", "tags")

#: How far back ``follow`` reads an existing log at startup (the last N
#: events live well inside this; the rest of a huge log is never loaded).
_FOLLOW_INIT_TAIL_BYTES = 1 << 20

#: Head-of-file fingerprint length for ``follow``'s recreation detector —
#: JSONL appends never rewrite the head, so a changed head means a new file
#: (inode numbers alone are unreliable: filesystems recycle them).
_FOLLOW_FP_BYTES = 128


def _rotation_segments(f: Path) -> list[Path]:
    """The numbered rotation segments of one active log (``DDR_METRICS_MAX_MB``
    renames ``run_log.x.jsonl`` to ``run_log.x.segN.jsonl``), oldest first —
    readers of a size-bounded log must see the whole surviving history, not
    just the active tail."""
    segs = []
    for cand in f.parent.glob(f"{f.stem}.seg*{f.suffix}"):
        digits = cand.name[len(f.stem) + 4 : -len(f.suffix)]
        if digits.isdigit():
            segs.append((int(digits), cand))
    return [p for _, p in sorted(segs)]


def load_events(path: str | Path) -> tuple[list[dict], int]:
    """``(events, n_corrupt_lines)`` from one JSONL file or a directory of them.

    Multi-file reads merge on wall-clock (then sequence) order; single files
    keep their native order. A file that was size-rotated
    (``DDR_METRICS_MAX_MB``) is read together with its ``.segN`` segments,
    oldest segment first.
    """
    p = Path(path)
    files = sorted(p.glob("*.jsonl")) if p.is_dir() else [*_rotation_segments(p), p]
    if not files:
        raise FileNotFoundError(f"no .jsonl run logs under {p}")
    events: list[dict] = []
    bad = 0
    for f in files:
        with f.open("r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    bad += 1
                    continue
                if isinstance(ev, dict):
                    events.append(ev)
                else:
                    bad += 1
    if len(files) > 1:
        events.sort(key=lambda e: (e.get("wall", 0.0), e.get("host", 0), e.get("seq", 0)))
    return events, bad


def _table(rows: list[list[str]], header: list[str], indent: str = "  ") -> str:
    """Plain fixed-width text table (no deps)."""
    cols = [header, *rows]
    widths = [max(len(str(r[i])) for r in cols) for i in range(len(header))]
    lines = []
    for r in cols:
        lines.append(indent + "  ".join(str(v).ljust(w) for v, w in zip(r, widths)).rstrip())
    return "\n".join(lines)


def _sample(values: list[float], k: int = 16) -> list[float]:
    """Evenly-spaced ≤k-point sample preserving first and last."""
    if len(values) <= k:
        return values
    idx = [round(i * (len(values) - 1) / (k - 1)) for i in range(k)]
    return [values[i] for i in idx]


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e5 or abs(v) < 1e-3:
        return f"{v:.3g}"
    return f"{v:,.4g}"


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def detect_stalls(
    events: list[dict],
    now: float | None = None,
    factor: float = STALL_FACTOR,
) -> list[dict]:
    """Per-host stall findings over a run's ``step``/``heartbeat`` cadence.

    A host is *stalled* when its newest step/heartbeat ``wall`` stamp is older
    (vs ``now``) than ``factor`` times its observed median inter-event cadence
    — the signature of a hung collective, a wedged input pipeline, or a dead
    process that never wrote ``run_end``. A run WITH a ``run_end`` is finished,
    not stalled; a host with fewer than two liveness events has no cadence to
    judge against and is skipped. Returns one dict per flagged host
    (``host``, ``age_s``, ``cadence_s``, ``ratio``, ``last_event``)."""
    if any(e.get("event") == "run_end" for e in events):
        return []
    now = time.time() if now is None else now
    per_host: dict[int, list[dict]] = {}
    for e in events:
        if e.get("event") in ("step", "heartbeat") and e.get("wall") is not None:
            per_host.setdefault(int(e.get("host", 0)), []).append(e)
    findings: list[dict] = []
    for host, evs in sorted(per_host.items()):
        walls = sorted(float(e["wall"]) for e in evs)
        if len(walls) < 2:
            continue
        deltas = [b - a for a, b in zip(walls, walls[1:]) if b > a]
        if not deltas:
            continue
        cadence = _median(deltas)
        age = now - walls[-1]
        if age > factor * cadence:
            last = max(evs, key=lambda e: float(e["wall"]))
            findings.append({
                "host": host,
                "age_s": round(age, 3),
                "cadence_s": round(cadence, 3),
                "ratio": round(age / cadence, 1) if cadence > 0 else float("inf"),
                "last_event": str(last.get("event")),
            })
    return findings


def summarize(
    events: list[dict],
    bad: int = 0,
    out=None,
    now: float | None = None,
    stall_factor: float = STALL_FACTOR,
) -> int:
    out = out or sys.stdout
    w = out.write
    if not events:
        w("no events found\n")
        return 1
    by_type: dict[str, list[dict]] = {}
    for e in events:
        by_type.setdefault(str(e.get("event")), []).append(e)
    start = by_type.get("run_start", [{}])[0]
    ends = by_type.get("run_end", [])
    end = ends[-1] if ends else {}

    ident = " ".join(
        f"{k}={start[k]}" for k in ("name", "cmd", "mode", "device", "parallel") if k in start
    )
    w(f"run      : {ident or '(no run_start event)'}\n")
    hosts = sorted({int(e.get("host", 0)) for e in events})
    status = end.get("status", "(no run_end — crashed or still running)")
    w(f"status   : {status}   hosts: {len(hosts)} {hosts}\n")
    dur = end.get("duration_s")
    if dur is None and events:
        dur = max(float(e.get("t", 0.0)) for e in events)
    w(f"duration : {float(dur):.3f} s\n")
    counts = ", ".join(f"{k} {len(v)}" for k, v in sorted(by_type.items()))
    w(f"events   : {len(events)} total — {counts}")
    w(f" ({bad} corrupt lines skipped)\n" if bad else "\n")

    # schema line: a reader must keep summarizing logs written by newer (or
    # older) code — unknown event types are reported, never fatal
    from ddr_tpu_torch.observability.events import EVENT_TYPES, SCHEMA_VERSION

    vers = sorted({
        int(e["schema_version"])
        for e in by_type.get("run_start", [])
        if isinstance(e.get("schema_version"), int)
    })
    unknown = sorted(k for k in by_type if k not in EVENT_TYPES)
    if vers or unknown:
        line = "schema   : " + (
            "v" + "/".join(str(v) for v in vers) if vers else "(unversioned run_start)"
        )
        if vers and any(v != SCHEMA_VERSION for v in vers):
            line += f" (reader is v{SCHEMA_VERSION})"
        if unknown:
            line += "   unknown event types: " + ", ".join(
                f"{k} ({len(by_type[k])})" for k in unknown
            )
        w(line + "\n")

    for s in detect_stalls(events, now=now, factor=stall_factor):
        w(
            f"STALL?   : host{s['host']} last {s['last_event']} {s['age_s']:.0f}s ago "
            f"— {s['ratio']}x its ~{s['cadence_s']:.1f}s cadence "
            "(hung collective or dead run?)\n"
        )

    steps = by_type.get("step", [])
    if steps:
        rates = [float(e["reach_timesteps_per_sec"]) for e in steps if "reach_timesteps_per_sec" in e]
        secs = sum(float(e.get("seconds", 0.0)) for e in steps)
        line = f"steps    : {len(steps)}"
        if secs > 0:  # bench-phase step events carry rates but no durations
            line += f"   {len(steps) / secs:.3g} steps/s"
        if rates:
            line += f"   mean {_fmt(sum(rates) / len(rates))} reach-timesteps/s"
        engines = sorted({str(e.get("engine")) for e in steps if e.get("engine")})
        if engines:
            line += f"   engine={','.join(engines)}"
        w(line + "\n")
        losses = [float(e["loss"]) for e in steps if e.get("loss") is not None]
        if losses:
            pts = " ".join(_fmt(v) for v in _sample(losses))
            w(f"loss     : first {_fmt(losses[0])} -> last {_fmt(losses[-1])} (min {_fmt(min(losses))})\n")
            w(f"loss curve: {pts}\n")

    _summarize_phases(by_type, w)
    _summarize_anomalies(by_type, end, w)
    _summarize_program_cards(by_type, w)
    _summarize_serving(by_type, w)
    _summarize_slo(by_type, end, w)
    _summarize_health(by_type, end, w)
    _summarize_skill(by_type, end, w)
    _summarize_spatial(by_type, end, w)
    _summarize_fleet(by_type, w)

    evals = by_type.get("eval", [])
    if evals:
        rates = [float(e["reach_timesteps_per_sec"]) for e in evals if "reach_timesteps_per_sec" in e]
        mean = f"   mean {_fmt(sum(rates) / len(rates))} reach-timesteps/s" if rates else ""
        w(f"evals    : {len(evals)}{mean}\n")

    compiles = by_type.get("compile", [])
    if compiles:
        per_engine: dict[str, dict[str, float]] = {}
        for e in compiles:
            eng = per_engine.setdefault(str(e.get("engine", "?")), {"misses": 0, "build_s": 0.0})
            eng["misses"] += 1
            eng["build_s"] += float(e.get("build_seconds") or 0.0)
        # the trailing hit counters on the last compile event per engine are the
        # richest in-log source; run_end's summary (if present) wins over them
        summary_compile = (end.get("summary") or {}).get("compile", {})
        rows = []
        for eng, agg in sorted(per_engine.items()):
            hits = summary_compile.get(eng, {}).get("hits")
            if hits is None:
                last = [e for e in compiles if str(e.get("engine", "?")) == eng][-1]
                hits = last.get("hits", "?")
            rows.append([eng, str(int(agg["misses"])), str(hits), f"{agg['build_s']:.3f}"])
        w(f"compiles : {len(compiles)} miss events\n")
        w(_table(rows, ["engine", "misses", "hits", "build_s"]) + "\n")

    beats = by_type.get("heartbeat", [])
    if beats:
        per_host: dict[int, dict[str, Any]] = {}
        for e in beats:
            h = per_host.setdefault(int(e.get("host", 0)), {"n": 0, "last_t": 0.0, "last_step": "?"})
            h["n"] += 1
            h["last_t"] = max(h["last_t"], float(e.get("t", 0.0)))
            if e.get("step") is not None:
                h["last_step"] = e["step"]
        rows = [
            [f"host{h}", str(v["n"]), str(v["last_step"]), f"{v['last_t']:.1f}s"]
            for h, v in sorted(per_host.items())
        ]
        w("heartbeats:\n" + _table(rows, ["host", "count", "last step", "last seen"]) + "\n")

    spans = by_type.get("span", [])
    span_agg: dict[str, list[float]] = {}
    for e in spans:
        agg = span_agg.setdefault(str(e.get("name", "?")), [0, 0.0])
        agg[0] += 1
        agg[1] += float(e.get("seconds", 0.0))
    if span_agg:
        rows = [
            [name, str(int(c)), f"{s:.4f}", f"{1e3 * s / c:.2f}"]
            for name, (c, s) in sorted(span_agg.items(), key=lambda kv: -kv[1][1])
        ]
        w("spans (by total time):\n" + _table(rows, ["span", "count", "total_s", "mean_ms"]) + "\n")
    return 0


def _summarize_phases(by_type: dict[str, list[dict]], w) -> None:
    """"Where time went": per-phase totals/percentages aggregated from the
    ``phases`` dicts riding ``step`` events (observability.phases). Shares are
    of the summed phase time — prefetch phases overlap the device step, so
    they don't sum to wall time."""
    from ddr_tpu_torch.observability.phases import summarize_phases

    agg = summarize_phases(by_type.get("step", []))
    overlap = agg.pop("_overlap", None)  # reserved key, not a phase row
    if not agg:
        return
    rows = [
        [name, f"{100 * v['share']:.1f}%", f"{v['seconds']:.4f}",
         f"{1e3 * v['seconds'] / v['count']:.2f}" if v["count"] else "-"]
        for name, v in agg.items()
    ]
    w("where time went (step phases, % of phase time):\n")
    w(_table(rows, ["phase", "share", "total_s", "mean_ms"]) + "\n")
    if overlap:
        w(
            f"overlap  : device busy {100 * overlap['busy_frac']:.1f}% of loop "
            f"wall ({overlap['idle_s']:.3f}s idle of {overlap['loop_s']:.3f}s "
            f"over {int(overlap['count'])} steps)\n"
        )


def _summarize_anomalies(by_type: dict[str, list[dict]], end: dict, w) -> None:
    """The performance-sentinel section: one row per ``anomaly`` episode
    transition (signal, scope, state, baseline vs observed, onset step), plus
    the run's pipeline verdict from the ``run_end`` summary (sentinel
    bottleneck attribution)."""
    anomalies = by_type.get("anomaly", [])
    if anomalies:
        rows = []
        for e in anomalies:
            base, obs = e.get("baseline"), e.get("observed")
            rows.append([
                str(e.get("signal", "?")),
                str(e.get("scope", "-")),
                str(e.get("state", "?")),
                _fmt(float(base)) if base is not None else "-",
                _fmt(float(obs)) if obs is not None else "-",
                str(e.get("onset_step", "-")),
                str(e.get("step", "-")),
            ])
        firing = sum(1 for e in anomalies if e.get("state") == "firing")
        w(f"anomalies: {firing} episode(s), {len(anomalies)} transition(s)\n")
        w(_table(rows, ["signal", "scope", "state", "baseline", "observed",
                        "onset", "step"]) + "\n")
    pipeline = (end.get("summary") or {}).get("pipeline") or {}
    verdict = pipeline.get("verdict")
    if verdict:
        classes = pipeline.get("classes") or {}
        counts = "  ".join(
            f"{k}={v}" for k, v in sorted(classes.items(), key=lambda kv: -kv[1])
        )
        w(f"pipeline verdict: {verdict}  ({counts})\n")
        overlap = pipeline.get("overlap")
        if isinstance(overlap, dict):
            try:
                busy = 100.0 * float(overlap.get("busy_frac", 0.0))
                idle = float(overlap.get("idle_s", 0.0))
                n = int(overlap.get("steps") or overlap.get("count") or 0)
            except (TypeError, ValueError):
                pass  # hand-edited log: skip the line, keep the verdict
            else:
                w(
                    f"  device busy {busy:.1f}% of loop wall "
                    f"({idle:.3f}s idle over {n} steps)\n"
                )
        for rec in pipeline.get("recommendations") or []:
            w(f"  - {rec}\n")


def _summarize_program_cards(by_type: dict[str, list[dict]], w) -> None:
    """The per-program cost table from ``program_card`` events
    (observability.costs): one row per distinct (name, engine, key), last
    card wins — FLOPs, bytes accessed, arithmetic intensity, peak memory,
    collective count."""
    cards = by_type.get("program_card", [])
    if not cards:
        return
    latest: dict[tuple, dict] = {}
    for e in cards:
        latest[(str(e.get("name", "?")), str(e.get("engine") or "-"), e.get("key"))] = e
    rows = []
    for (name, engine, key), e in sorted(latest.items(), key=lambda kv: [str(p) for p in kv[0]]):
        flops = e.get("flops")
        bytes_acc = e.get("bytes_accessed")
        ai = e.get("arithmetic_intensity")
        peak = e.get("peak_bytes")
        rows.append([
            name,
            engine,
            # the topology-hash short form distinguishes K same-named programs
            # (one 'train-step' per distinct batch topology)
            str(key)[:8] if key else "-",
            _fmt(float(flops)) if flops is not None else "-",
            _fmt(float(bytes_acc)) if bytes_acc is not None else "-",
            f"{float(ai):.3g}" if ai is not None else "-",
            f"{float(peak) / 2**20:,.1f}" if peak is not None else "-",
            str(e.get("n_collectives", sum((e.get("collectives") or {}).values()))),
            f"{float(e['compile_seconds']):.2f}" if e.get("compile_seconds") is not None else "-",
        ])
    w(f"programs : {len(cards)} card events, {len(latest)} distinct programs\n")
    w(_table(rows, ["program", "engine", "key", "flops", "bytes", "fl/B",
                    "peak_MB", "coll", "compile_s"]) + "\n")


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample (no numpy dep —
    this CLI needs nothing beyond the standard library)."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _summarize_serving(by_type: dict[str, list[dict]], w) -> None:
    """The forecast-serving section: request latency percentiles, batch
    occupancy, shed reasons (events emitted by :mod:`ddr_tpu_torch.serving`)."""
    reqs = by_type.get("serve_request", [])
    batches = by_type.get("serve_batch", [])
    sheds = by_type.get("serve_shed", [])
    if not (reqs or batches or sheds):
        return
    if reqs:
        statuses: dict[str, int] = {}
        for e in reqs:
            s = str(e.get("status", "?"))
            statuses[s] = statuses.get(s, 0) + 1
        # percentiles over SERVED requests only: sheds/rejects carry ~0
        # latencies and would drag p50 down exactly when the service is
        # overloaded (their counts render below)
        lat = sorted(
            float(e["latency_s"])
            for e in reqs
            if e.get("latency_s") is not None and e.get("status") == "ok"
        )
        line = f"serving  : {len(reqs)} requests — " + ", ".join(
            f"{k} {v}" for k, v in sorted(statuses.items())
        )
        if lat:
            p50, p90, p99 = (_percentile(lat, q) for q in (0.50, 0.90, 0.99))
            line += (
                f"   latency p50 {1e3 * p50:.1f}ms  p90 {1e3 * p90:.1f}ms  "
                f"p99 {1e3 * p99:.1f}ms"
            )
        w(line + "\n")
        # the lifecycle decomposition (request tracing): where requests spent
        # their latency — queued vs executing on device. Filter by field
        # presence, not status: sheds carry queue_s (their wait is the
        # overload signal) and the live ddr_serve_queue_seconds histogram
        # includes them, so the archive replay must agree with the dashboard;
        # execute_s only ever rides served (ok) events.
        parts = []
        for field, label in (("queue_s", "queue"), ("execute_s", "execute")):
            vals = sorted(
                float(e[field]) for e in reqs if e.get(field) is not None
            )
            if vals:
                p50, p99 = _percentile(vals, 0.50), _percentile(vals, 0.99)
                parts.append(
                    f"{label} p50 {1e3 * p50:.1f}ms p99 {1e3 * p99:.1f}ms"
                )
        if parts:
            w("           " + "   ".join(parts) + "\n")
    if batches:
        sizes = [float(e.get("size", 0)) for e in batches]
        occ = [float(e["occupancy"]) for e in batches if e.get("occupancy") is not None]
        secs = [float(e.get("seconds", 0.0)) for e in batches]
        line = f"batches  : {len(batches)}   mean size {sum(sizes) / len(sizes):.2f}"
        if occ:
            line += f"   mean occupancy {100 * sum(occ) / len(occ):.0f}%"
        if any(secs):
            line += f"   mean {1e3 * sum(secs) / len(secs):.1f}ms/batch"
        per_net: dict[str, int] = {}
        for e in batches:
            key = str(e.get("network", "?"))
            per_net[key] = per_net.get(key, 0) + 1
        if len(per_net) > 1:
            line += "   (" + ", ".join(f"{k} {v}" for k, v in sorted(per_net.items())) + ")"
        w(line + "\n")
    if sheds:
        reasons: dict[str, int] = {}
        by_class: dict[str, int] = {}
        for e in sheds:
            r = str(e.get("reason", "?"))
            reasons[r] = reasons.get(r, 0) + 1
            c = str(e.get("priority") or "?")
            by_class[c] = by_class.get(c, 0) + 1
        w(
            f"sheds    : {len(sheds)} — "
            + ", ".join(f"{k} {v}" for k, v in sorted(reasons.items()))
            + "\n"
        )
        if any(c != "?" for c in by_class):
            # which tier paid for the overload: sheds should concentrate in
            # the lowest classes (strict priority's whole promise); pre-v3
            # archives have no priority field and skip this line
            order = {"interactive": 0, "batch": 1, "bulk": 2}
            w(
                "           by class: "
                + ", ".join(
                    f"{k} {v}" for k, v in sorted(
                        by_class.items(), key=lambda kv: order.get(kv[0], 9)
                    )
                )
                + "\n"
            )


def _summarize_fleet(by_type: dict[str, list[dict]], w) -> None:
    """The fleet rollup (multi-host/multi-replica runs): the cross-host
    aggregates an operator asks first — per-host progress and liveness, which
    host is worst (furthest behind the fleet's newest event), recovery totals
    per host, and fleet-wide SLO attainment when serve logs are merged in.
    Shown only when the merged stream spans ≥2 hosts (single-host runs already
    have the heartbeat table)."""
    per: dict[int, dict[str, Any]] = {}
    for name, evs in by_type.items():
        for e in evs:
            h = int(e.get("host", 0))
            s = per.setdefault(h, {
                "steps": 0, "beats": 0, "recov": 0, "good": 0, "served": 0,
                "last_wall": None, "last_event": "?",
            })
            if name == "step":
                s["steps"] += 1
            elif name == "heartbeat":
                s["beats"] += 1
            elif name == "recovery":
                s["recov"] += 1
            elif name == "serve_request":
                ok = e.get("slo_ok")
                if ok is None:
                    ok = e.get("status") == "ok"
                s["served"] += 1
                s["good"] += bool(ok)
            wall = e.get("wall")
            if wall is not None and (
                s["last_wall"] is None or float(wall) > s["last_wall"]
            ):
                s["last_wall"] = float(wall)
                s["last_event"] = name
    if len(per) < 2:
        return
    newest = max(s["last_wall"] for s in per.values() if s["last_wall"] is not None)
    rows = []
    for h, s in sorted(per.items()):
        behind = newest - s["last_wall"] if s["last_wall"] is not None else None
        att = f"{100 * s['good'] / s['served']:.1f}%" if s["served"] else "-"
        rows.append([
            f"host{h}", str(s["steps"]), str(s["beats"]), str(s["recov"]),
            att, s["last_event"],
            f"-{behind:.1f}s" if behind is not None else "?",
        ])
    # the worst host lags the fleet's newest event the most; ties go to the
    # host with the least progress
    worst_h, worst_s = max(
        per.items(),
        key=lambda kv: (
            (newest - kv[1]["last_wall"]) if kv[1]["last_wall"] is not None else float("inf"),
            -kv[1]["steps"],
        ),
    )
    served = sum(s["served"] for s in per.values())
    good = sum(s["good"] for s in per.values())
    recov = sum(s["recov"] for s in per.values())
    line = f"fleet    : {len(per)} hosts   worst host{worst_h}"
    if worst_s["last_wall"] is not None:
        line += f" ({newest - worst_s['last_wall']:.1f}s behind)"
    if served:
        line += f"   aggregate slo {100 * good / served:.2f}% ({good}/{served} good)"
    if recov:
        line += f"   recoveries {recov}"
    w(line + "\n")
    w(_table(rows, ["host", "steps", "beats", "recov", "slo", "last event",
                    "lag"]) + "\n")


def _summarize_slo(by_type: dict[str, list[dict]], end: dict, w) -> None:
    """The SLO section: offline attainment/burn replay over ``serve_request``
    events (``slo_ok`` field; status for pre-tracing logs), using the
    objective the run_end serve rollup recorded when present — the archive
    answer to the live ``ddr_slo_*`` gauges. ``slo`` events (fast-burn alert
    transitions) render beneath."""
    from ddr_tpu_torch.observability.slo import attainment_from_events, parse_window_label

    reqs = by_type.get("serve_request", [])
    rollup = ((end.get("summary") or {}).get("serve") or {}).get("slo") or {}
    target = rollup.get("target")
    windows = [
        secs
        for secs in map(parse_window_label, rollup.get("windows") or {})
        if secs is not None
    ]
    agg = attainment_from_events(
        reqs, windows=windows or (60.0, 300.0, 3600.0), target=target
    )
    alerts = by_type.get("slo", [])
    if agg is None and not alerts:
        return
    if agg is not None:
        line = (
            f"slo      : attainment {100 * agg['attainment']:.2f}% "
            f"({agg['good']}/{agg['total']} good"
        )
        if target is not None:
            line += f", target {100 * float(target):.1f}%"
        line += ")"
        wins = agg.get("windows") or {}
        if wins:
            line += "   " + "  ".join(
                f"{name} {100 * v['attainment']:.1f}%"
                + (
                    f" (burn {v['burn_rate']:.2f}x)"
                    if v.get("burn_rate") is not None
                    else ""
                )
                for name, v in wins.items()
            )
        w(line + "\n")
    if alerts:
        firing = sum(1 for e in alerts if e.get("state") == "firing")
        last = alerts[-1]
        w(
            f"           {len(alerts)} burn-rate alert transitions "
            f"({firing} firing) — last: {last.get('state')} "
            f"burn {last.get('burn_rate')}x over {last.get('window')}\n"
        )


def _summarize_health(by_type: dict[str, list[dict]], end: dict, w) -> None:
    """The numerical-health section: one ``health`` event per violating batch
    (ddr_tpu_torch.observability.health), plus the run_end watchdog rollup when
    present. Shown whenever either source has something to say."""
    events = by_type.get("health", [])
    rollup = (end.get("summary") or {}).get("health") or {}
    if not events and not rollup:
        return
    reasons: dict[str, int] = {}
    worst_nonfinite = 0
    worst_q = None
    worst_grad = None
    last_consecutive = 0
    for e in events:
        for r in e.get("reasons") or ["?"]:
            reasons[str(r)] = reasons.get(str(r), 0) + 1
        worst_nonfinite = max(worst_nonfinite, int(e.get("nonfinite") or 0))
        if e.get("q_max") is not None:
            q = float(e["q_max"])
            worst_q = q if worst_q is None else max(worst_q, q)
        if e.get("grad_norm") is not None:
            g = float(e["grad_norm"])
            if g == g:  # NaN grad norms render via the non-finite count
                worst_grad = g if worst_grad is None else max(worst_grad, g)
        last_consecutive = int(e.get("consecutive") or 0)
    line = f"health   : {len(events)} violating batches"
    if rollup.get("batches"):
        line += f" / {rollup['batches']} observed"
    if reasons:
        line += " — " + ", ".join(f"{k} {v}" for k, v in sorted(reasons.items()))
    w(line + "\n")
    if events:
        details = [f"worst nonfinite {worst_nonfinite}"]
        if worst_q is not None:
            details.append(f"max discharge {_fmt(worst_q)}")
        if worst_grad is not None:
            details.append(f"max grad-norm {_fmt(worst_grad)}")
        details.append(f"last consecutive run {last_consecutive}")
        w("           " + "   ".join(details) + "\n")
    if rollup.get("degraded"):
        w("           DEGRADED at run end "
          f"(consecutive_bad {rollup.get('consecutive_bad')})\n")


def _summarize_skill(by_type: dict[str, list[dict]], end: dict, w) -> None:
    """The hydrologic-skill section: ``skill`` events carry CUMULATIVE
    per-gauge NSE/KGE/percent-bias summaries (ddr_tpu_torch.observability.skill),
    so the LAST event (or the run_end rollup when present) is the run's
    state; worst-K gauges render as a table."""
    events = by_type.get("skill", [])
    rollup = (end.get("summary") or {}).get("skill") or {}
    last = rollup if rollup.get("nse") else (events[-1] if events else None)
    if not last:
        return
    nse = last.get("nse") or {}
    kge = last.get("kge") or {}
    pbias = last.get("pbias") or {}

    def _f(v, pct=False):
        if v is None:
            return "?"
        return f"{100 * float(v):.0f}%" if pct else f"{float(v):.3f}"

    w(
        f"skill    : {last.get('scored', '?')}/{last.get('gauges', '?')} gauges "
        f"scored — NSE median {_f(nse.get('median'))} "
        f"(p10 {_f(nse.get('p10'))}, {_f(nse.get('frac_positive'), pct=True)} > 0)"
        f"   KGE median {_f(kge.get('median'))}"
        f"   |pbias| median {_f(pbias.get('median_abs'))}\n"
    )
    worst = last.get("worst") or []
    if worst:
        rows = [
            [str(g.get("gauge")), _f(g.get("nse")), _f(g.get("kge")),
             "?" if g.get("pbias") is None else f"{float(g['pbias']):.1f}"]
            for g in worst
        ]
        w("worst gauges (by NSE):\n" + _table(rows, ["gauge", "nse", "kge", "pbias"]) + "\n")


def aggregate_spatial_health(
    health_events: list[dict],
) -> tuple[dict[int, dict], dict[int, int]]:
    """Fold ``health`` events' spatial payloads into per-band extrema and a
    worst-reach frequency map — THE one aggregation both ``ddr metrics
    summarize`` and ``ddr audit``'s replay mode render (two renderers, one
    fold, so they cannot disagree about which band is worst).

    Returns ``(bands, reaches)``: ``bands[b]`` holds ``max_abs_residual``,
    ``nonfinite`` (max per event), ``max_ulp``, ``worst_count`` (how often b
    was the event's worst band); ``reaches[r]`` counts worst-set appearances.
    Events without band payloads contribute nothing; malformed values are
    skipped, never fatal (a run killed mid-write must still aggregate)."""
    bands: dict[int, dict] = {}
    reaches: dict[int, int] = {}

    def _slot(b: int) -> dict:
        return bands.setdefault(
            b, {"max_abs_residual": 0.0, "nonfinite": 0, "worst_count": 0,
                "max_ulp": 0.0},
        )

    for e in health_events:
        if not e.get("band_residual"):
            continue
        for b, v in enumerate(e.get("band_residual") or []):
            try:
                slot = _slot(b)
                slot["max_abs_residual"] = max(slot["max_abs_residual"], abs(float(v)))
            except (TypeError, ValueError):
                continue
        for b, v in enumerate(e.get("band_nonfinite") or []):
            try:
                _slot(b)["nonfinite"] = max(_slot(b)["nonfinite"], int(v))
            except (TypeError, ValueError):
                continue
        for b, v in enumerate(e.get("band_ulp_drift") or []):
            try:
                _slot(b)["max_ulp"] = max(_slot(b)["max_ulp"], float(v))
            except (TypeError, ValueError):
                continue
        wb = e.get("worst_band")
        if wb is not None:
            _slot(int(wb))["worst_count"] += 1
        for r in e.get("worst_idx") or []:
            try:
                reaches[int(r)] = reaches.get(int(r), 0) + 1
            except (TypeError, ValueError):
                continue
    return bands, reaches


def _summarize_spatial(by_type: dict[str, list[dict]], end: dict, w) -> None:
    """The spatial-health section: per-band attribution riding ``health``
    events (worst band by frequency + residual extrema,
    ddr_tpu_torch.observability.health band fields) and the last ``drift`` event's
    per-parameter-field state (ddr_tpu_torch.observability.drift)."""
    health = [e for e in by_type.get("health", []) if e.get("band_residual")]
    drifts = by_type.get("drift", [])
    if not health and not drifts:
        return
    if health:
        bands, reaches = aggregate_spatial_health(health)
        w(f"spatial  : {len(health)} violating batches carried band attribution\n")
        ranked = sorted(
            bands,
            key=lambda b: (bands[b]["nonfinite"], bands[b]["worst_count"],
                           bands[b]["max_abs_residual"]),
            reverse=True,
        )[:8]
        rows = [
            [
                f"band{b}",
                str(bands[b]["nonfinite"]),
                _fmt(bands[b]["max_abs_residual"]),
                _fmt(bands[b]["max_ulp"]) if bands[b]["max_ulp"] else "-",
                str(bands[b]["worst_count"]),
            ]
            for b in ranked
        ]
        if rows:
            w("worst bands (by non-finite, then |residual|):\n")
            w(_table(rows, ["band", "nonfinite", "max|resid|", "max ulp", "worst#"]) + "\n")
        if reaches:
            top = sorted(reaches.items(), key=lambda kv: -kv[1])[:8]
            w(
                "worst reaches: "
                + ", ".join(f"{r} (x{c})" for r, c in top)
                + "\n"
            )
    if drifts:
        last = drifts[-1]
        fields = last.get("fields") or {}
        parts = []
        for name, summary in sorted(fields.items()):
            drift = summary.get("drift")
            oob = summary.get("oob")
            seg = f"{name}"
            if drift is not None:
                seg += f" drift {float(drift):.4f}"
            if oob is not None:
                seg += f" oob {int(oob)}"
            parts.append(seg)
        n_viol = sum(1 for e in drifts if e.get("reasons"))
        w(
            f"drift    : {len(drifts)} snapshots ({n_viol} violating) — "
            + "; ".join(parts)
            + "\n"
        )


def _format_event(e: dict) -> str:
    """One event as one compact ``tail`` line (no trailing newline)."""
    payload = " ".join(
        f"{k}={json.dumps(v, default=str) if isinstance(v, (dict, list)) else v}"
        for k, v in e.items()
        if k not in _ENVELOPE
    )
    return (
        f"[{float(e.get('t', 0.0)):10.3f}s] host{e.get('host', 0)} "
        f"{e.get('event', '?'):<10} {payload}"
    ).rstrip()


def tail(events: list[dict], n: int = 20, out=None) -> int:
    out = out or sys.stdout
    if not events:
        out.write("no events found\n")
        return 1
    for e in events[-n:]:
        out.write(_format_event(e) + "\n")
    return 0


# --- Perfetto / Chrome trace export -----------------------------------------

#: Duration-slice sources: event type -> the field holding the slice duration
#: in seconds. These events are emitted at slice END, so start = emit − dur.
_TRACE_DUR_FIELDS = {
    "span": "seconds",
    "step": "seconds",
    "eval": "seconds",
    "serve_batch": "seconds",
    "serve_request": "latency_s",
}


def _flow_int(key: str) -> int:
    """A stable positive flow id from a trace id (hex prefix when possible;
    adopted non-hex ids and composite keys fall back to a checksum)."""
    try:
        return (int(str(key)[:12], 16) & 0x7FFFFFFF) or 1
    except ValueError:
        import zlib

        return (zlib.crc32(str(key).encode("utf-8")) & 0x7FFFFFFF) or 1


def _slice_name(e: dict) -> str:
    kind = str(e.get("event"))
    if kind == "span":
        return str(e.get("name", "span"))
    if kind == "step":
        epoch, i = e.get("epoch"), e.get("i", e.get("step"))
        if epoch is not None or i is not None:
            return f"step {epoch if epoch is not None else '?'}:{i if i is not None else '?'}"
        return "step"
    if kind == "serve_request":
        return f"request {e.get('request_id', '?')}"
    if kind == "serve_batch":
        return f"batch[{e.get('size', '?')}] {e.get('network') or ''}".rstrip()
    return kind


def perfetto_trace(events: list[dict]) -> dict:
    """Render a merged event stream as one Chrome/Perfetto trace dict.

    Layout: one *process* track per host (``pid`` = host index), one *thread*
    track per (host, emitting thread) — span events stamp ``thread``, all
    other events render on ``main``. Duration events (span / step / eval /
    serve_request / serve_batch) are logged at their END, so slices start at
    ``emit − duration``; everything else becomes a thread-scoped instant.

    Cross-host alignment: each host's monotonic ``t`` is mapped onto the
    shared wall clock via that host's median ``wall − t`` offset, preferring
    heartbeat samples (they are emitted on a timer, not under load), which
    cancels per-host process-start skew without trusting any single sample.

    Flow arrows stitch (a) one ``trace_id`` appearing on ≥2 hosts — the fleet
    view of one training step — and (b) each ``serve_batch`` slice to its
    member request slices (the ``members`` id list stamped by the batcher).
    The returned ``traceEvents`` list is metadata-first, then globally
    ts-sorted; open the JSON at https://ui.perfetto.dev.
    """
    samples: dict[int, list[float]] = {}
    beats: dict[int, list[float]] = {}
    for e in events:
        if e.get("wall") is None or e.get("t") is None:
            continue
        h = int(e.get("host", 0))
        d = float(e["wall"]) - float(e["t"])
        samples.setdefault(h, []).append(d)
        if e.get("event") == "heartbeat":
            beats.setdefault(h, []).append(d)
    offsets = {h: _median(beats.get(h) or vals) for h, vals in samples.items()}
    usable = [
        e for e in events
        if e.get("t") is not None and int(e.get("host", 0)) in offsets
    ]
    if not usable:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def _abs(e: dict) -> float:
        return offsets[int(e.get("host", 0))] + float(e["t"])

    base = min(_abs(e) for e in usable)
    meta: list[dict] = []
    tids: dict[tuple[int, str], int] = {}
    for h in sorted(offsets):
        meta.append({"ph": "M", "name": "process_name", "pid": h,
                     "args": {"name": f"host{h}"}})
        meta.append({"ph": "M", "name": "process_sort_index", "pid": h,
                     "args": {"sort_index": h}})

    def _tid(h: int, thread: str) -> int:
        key = (h, thread)
        if key not in tids:
            tids[key] = sum(1 for k in tids if k[0] == h) + 1
            meta.append({"ph": "M", "name": "thread_name", "pid": h,
                         "tid": tids[key], "args": {"name": thread}})
        return tids[key]

    body: list[dict] = []
    by_trace: dict[str, list[dict]] = {}
    req_by_trace: dict[str, dict] = {}
    batch_links: list[tuple[dict, list[str]]] = []
    for e in usable:
        kind = str(e.get("event"))
        h = int(e.get("host", 0))
        tid = _tid(h, str(e.get("thread") or "main"))
        end_us = round((_abs(e) - base) * 1e6)
        args = {k: v for k, v in e.items() if k not in _ENVELOPE}
        dur_field = _TRACE_DUR_FIELDS.get(kind)
        dur_s = e.get(dur_field) if dur_field else None
        if dur_s is not None:
            dur_us = max(1, round(float(dur_s) * 1e6))
            rec = {"ph": "X", "name": _slice_name(e), "cat": kind, "pid": h,
                   "tid": tid, "ts": max(0, end_us - dur_us), "dur": dur_us,
                   "args": args}
            body.append(rec)
            trace_id = e.get("trace_id")
            if trace_id:
                by_trace.setdefault(str(trace_id), []).append(rec)
                if kind == "serve_request":
                    req_by_trace[str(trace_id)] = rec
            if kind == "serve_batch" and e.get("members"):
                batch_links.append((rec, [
                    str(m["trace_id"]) for m in e["members"]
                    if isinstance(m, dict) and m.get("trace_id")
                ]))
        else:
            body.append({"ph": "i", "name": _slice_name(e), "cat": kind,
                         "pid": h, "tid": tid, "ts": end_us, "s": "t",
                         "args": args})

    # (a) one trace id on ≥2 host tracks: arrows follow the step across the
    # fleet (same-host spans already nest visually under their step slice)
    for trace_id, recs in sorted(by_trace.items()):
        if len({r["pid"] for r in recs}) < 2:
            continue
        recs = sorted(recs, key=lambda r: (r["ts"], r["pid"], r["tid"]))
        fid = _flow_int(trace_id)
        for i, r in enumerate(recs):
            ph = "s" if i == 0 else ("f" if i == len(recs) - 1 else "t")
            ev = {"ph": ph, "id": fid, "name": "trace", "cat": "trace",
                  "pid": r["pid"], "tid": r["tid"], "ts": r["ts"]}
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice, not the next one
            body.append(ev)
    # (b) batch -> member requests: one short flow per member, namespaced by
    # the pair so it cannot collide with a member's own cross-host flow id
    for batch_rec, member_ids in batch_links:
        batch_tid = str(batch_rec["args"].get("trace_id", ""))
        for mid in member_ids:
            req = req_by_trace.get(mid)
            if req is None:
                continue
            fid = _flow_int(f"{batch_tid}->{mid}")
            body.append({"ph": "s", "id": fid, "name": "batch-member",
                         "cat": "serve", "pid": req["pid"], "tid": req["tid"],
                         "ts": req["ts"]})
            body.append({"ph": "f", "bp": "e", "id": fid, "name": "batch-member",
                         "cat": "serve", "pid": batch_rec["pid"],
                         "tid": batch_rec["tid"], "ts": batch_rec["ts"]})

    body.sort(key=lambda ev: (ev["ts"], ev.get("pid", 0), ev.get("tid", 0)))
    return {"traceEvents": meta + body, "displayTimeUnit": "ms"}


def _parse_event_line(raw: bytes) -> dict | None:
    """One JSONL line -> event dict, or None for blank/corrupt/partial lines
    (the follow loop's tolerance: a line racing the writer shows up whole on
    a later poll only if the writer appends atomically — ours does — so a
    non-parsing line is garbage, not data to wait for)."""
    line = raw.decode("utf-8", errors="replace").strip()
    if not line:
        return None
    try:
        ev = json.loads(line)
    except json.JSONDecodeError:
        return None
    return ev if isinstance(ev, dict) else None


class _FileCursor:
    """Incremental reader of one JSONL log for ``follow``: a byte offset plus
    a head-of-file fingerprint (JSONL appends never rewrite the head, so a
    changed head means a new file even when inode numbers recycle). Truncation
    and recreation restart from the new content's top; a partial trailing line
    stays buffered in the FILE — we rewind over it and re-read from its offset
    next poll, so torn writes render exactly once."""

    def __init__(self, path: Path, label: str = "") -> None:
        self.path = path
        self.label = label
        self.pos = 0
        self.head = b""

    def bootstrap(self) -> list[dict]:
        """Back-read a bounded tail of an existing file (raises OSError when
        missing) — only the last events matter at startup, and a gigabyte
        run_log must not stall or OOM the follow. Leaves the cursor at EOF."""
        st = self.path.stat()
        with self.path.open("rb") as fh:
            self.head = fh.read(_FOLLOW_FP_BYTES)  # recreation fingerprint
            size = st.st_size
            if size > _FOLLOW_INIT_TAIL_BYTES:
                fh.seek(size - _FOLLOW_INIT_TAIL_BYTES)
                fh.readline()  # drop the line the seek cut in half
                data = fh.read()
            else:
                data = self.head + fh.read()
            self.pos = fh.tell()
        lines = data.split(b"\n")
        carry = lines.pop()  # partial trailing line: render once complete
        self.pos -= len(carry)
        return [ev for ev in (_parse_event_line(ln) for ln in lines) if ev]

    def poll(self) -> list[dict] | None:
        """New complete events since the last poll; ``None`` when the file is
        currently unreadable (rotated away — keep polling for its return)."""
        try:
            size = self.path.stat().st_size
        except OSError:
            return None
        if size < self.pos:
            self.pos = 0  # truncated in place: the new content is the run
        if size == self.pos:
            return []
        try:
            with self.path.open("rb") as fh:
                if self.head and fh.read(len(self.head)) != self.head:
                    # recreated under the same name (a new run, or rotation
                    # moving content to a .segN sibling) — caught by the head
                    # fingerprint even when the new file is already LARGER
                    # than our offset: restart from its top
                    self.pos = 0
                if self.pos == 0:
                    fh.seek(0)
                    self.head = fh.read(_FOLLOW_FP_BYTES)
                fh.seek(self.pos)
                chunk = fh.read()
        except OSError:
            return None
        self.pos += len(chunk)
        *complete, carry = chunk.split(b"\n")
        self.pos -= len(carry)
        return [ev for ev in (_parse_event_line(ln) for ln in complete) if ev]


class _StallWatch:
    """The live twin of ``summarize``'s post-hoc stall check: once the stream
    has shown enough events to know its cadence, a silence longer than
    ``factor`` times that cadence prints one ``STALL?`` line (repeated only
    after events resume and stop again). A ``run_end`` disarms it: a finished
    run is quiet on purpose. Only the LIVE stream counts — the back-read
    history's stamps are the writer's past."""

    def __init__(self, out, factor: float, run_ended: bool) -> None:
        self.out = out
        self.factor = factor
        self.run_ended = run_ended
        self.intervals: list[float] = []
        self.last_arrival = time.monotonic()
        self.warned = False

    def saw(self, new_events: list[dict]) -> None:
        now_m = time.monotonic()
        self.intervals.append(now_m - self.last_arrival)
        del self.intervals[:-32]  # a bounded window tracks cadence drift
        self.last_arrival = now_m
        self.warned = False
        self.run_ended = self.run_ended or any(
            e.get("event") == "run_end" for e in new_events
        )

    def check(self) -> None:
        if self.warned or self.run_ended or len(self.intervals) < 2:
            return
        cadence = _median(self.intervals)
        age = time.monotonic() - self.last_arrival
        if cadence > 0 and age > self.factor * cadence:
            self.out.write(
                f"STALL?   : no events for {age:.1f}s — {age / cadence:.0f}x the "
                f"~{cadence:.1f}s cadence (hung collective or dead run?)\n"
            )
            if hasattr(self.out, "flush"):
                self.out.flush()
            self.warned = True


def _host_label(name: str) -> str:
    """A source label for interleaved directory follows: the ``.host<K>``
    sidecar suffix when present, else ``host0`` (the primary's log)."""
    m = re.search(r"\.host(\d+)\.(?:seg\d+\.)?jsonl$", name)
    return f"host{m.group(1)}" if m else "host0"


def _merge_key(e: dict) -> tuple:
    return (e.get("wall", 0.0), e.get("host", 0), e.get("seq", 0))


def follow(
    path: str | Path,
    n: int = 20,
    interval: float = 0.5,
    out=None,
    max_polls: int | None = None,
    stall_factor: float = STALL_FACTOR,
) -> int:
    """Poll-based live follow of a run log: print the last ``n`` existing
    events, then every new complete line as it lands (``tail -f``, but
    schema-aware and corrupt-line tolerant). A directory interleaves EVERY
    ``*.jsonl`` inside — the primary log plus per-host sidecars — prefixing
    each line with its source ``host<K>`` and merging each poll's batch in
    wall-clock order; sidecars appearing mid-run are picked up. Truncation/
    recreation (a new run reusing the log name) restarts from the new file's
    top. Ctrl-C exits cleanly with status 0; ``max_polls`` bounds the loop
    for tests (None = forever). See :class:`_StallWatch` for the silence
    warning."""
    out = out or sys.stdout
    p = Path(path)
    if p.is_dir():
        return _follow_dir(
            p, n=n, interval=interval, out=out, max_polls=max_polls,
            stall_factor=stall_factor,
        )
    cur = _FileCursor(p)
    existing = cur.bootstrap()  # raises FileNotFoundError on a missing file
    if existing:
        tail(existing, n=n, out=out)
    if hasattr(out, "flush"):
        out.flush()
    watch = _StallWatch(
        out, stall_factor, any(e.get("event") == "run_end" for e in existing)
    )
    polls = 0
    try:
        while max_polls is None or polls < max_polls:
            polls += 1
            time.sleep(max(0.0, interval))
            printed = cur.poll() or []
            for ev in printed:
                out.write(_format_event(ev) + "\n")
            if printed:
                watch.saw(printed)
            else:
                watch.check()
            if hasattr(out, "flush"):
                out.flush()
    except KeyboardInterrupt:
        pass  # the documented exit path of a follow loop
    return 0


def _follow_dir(
    p: Path,
    n: int,
    interval: float,
    out,
    max_polls: int | None,
    stall_factor: float,
) -> int:
    """The directory arm of :func:`follow`: one cursor per ``*.jsonl``,
    re-globbed every poll so per-host sidecars created mid-run join the
    interleave from their first byte."""
    cursors: dict[str, _FileCursor] = {}

    def _scan() -> list[_FileCursor]:
        for f in sorted(p.glob("*.jsonl")):
            if f.name not in cursors:
                cursors[f.name] = _FileCursor(f, label=_host_label(f.name))
        return [cursors[name] for name in sorted(cursors)]

    live = _scan()
    if not live:
        raise FileNotFoundError(f"no .jsonl run logs under {p}")
    out.write(
        "following " + ", ".join(f"{c.label}:{c.path.name}" for c in live) + "\n"
    )
    existing: list[tuple[dict, str]] = []
    for c in live:
        try:
            existing.extend((e, c.label) for e in c.bootstrap())
        except OSError:
            continue  # raced a deletion; its cursor starts at the top
    existing.sort(key=lambda pair: _merge_key(pair[0]))
    for ev, label in existing[-n:]:
        out.write(f"{label}| {_format_event(ev)}\n")
    if hasattr(out, "flush"):
        out.flush()
    watch = _StallWatch(
        out, stall_factor,
        any(e.get("event") == "run_end" for e, _ in existing),
    )
    polls = 0
    try:
        while max_polls is None or polls < max_polls:
            polls += 1
            time.sleep(max(0.0, interval))
            batch: list[tuple[dict, str]] = []
            for c in _scan():
                batch.extend((e, c.label) for e in c.poll() or [])
            # one poll's harvest interleaves on the shared wall clock — the
            # same order a post-hoc merged load would show
            batch.sort(key=lambda pair: _merge_key(pair[0]))
            for ev, label in batch:
                out.write(f"{label}| {_format_event(ev)}\n")
            if batch:
                watch.saw([e for e, _ in batch])
            else:
                watch.check()
            if hasattr(out, "flush"):
                out.flush()
    except KeyboardInterrupt:
        pass
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="ddr metrics",
        description="Summarize or tail a ddr run-telemetry JSONL log "
        "(run_log.*.jsonl written under the run's save_path / DDR_METRICS_DIR).",
    )
    sub = parser.add_subparsers(dest="command")
    p_sum = sub.add_parser("summarize", help="aggregate a run log into a table")
    p_sum.add_argument("log", help="run_log .jsonl file, or a directory of them")
    p_sum.add_argument(
        "--stall-factor", type=float, default=STALL_FACTOR,
        help="flag a run (no run_end) whose last step/heartbeat is older than "
        f"FACTOR x its observed cadence (default {STALL_FACTOR:g})",
    )
    p_tail = sub.add_parser("tail", help="print the last N events")
    p_tail.add_argument("log", help="run_log .jsonl file, or a directory of them")
    p_tail.add_argument("-n", type=int, default=20, help="events to show (default 20)")
    p_tail.add_argument(
        "-f", "--follow", action="store_true",
        help="keep polling and print new events as they land (Ctrl-C to exit; "
        "a directory follows its most recently modified .jsonl)",
    )
    p_tail.add_argument(
        "-i", "--interval", type=float, default=0.5,
        help="--follow poll cadence, seconds (default 0.5)",
    )
    p_tail.add_argument(
        "--stall-factor", type=float, default=STALL_FACTOR,
        help="--follow: warn when the live stream goes silent for FACTOR x its "
        f"observed cadence (default {STALL_FACTOR:g})",
    )
    p_trace = sub.add_parser(
        "trace",
        help="export the run as a Chrome/Perfetto trace (ui.perfetto.dev)",
    )
    p_trace.add_argument("log", help="run_log .jsonl file, or a directory of them")
    p_trace.add_argument(
        "--out", default="trace.json",
        help="output path for the trace JSON (default trace.json)",
    )
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:  # argparse exits for --help (0) and usage errors (2)
        return int(e.code or 0)
    if not args.command:
        parser.print_help()
        return 2
    if args.command == "tail" and args.follow:
        try:
            return follow(
                args.log, n=args.n, interval=args.interval,
                stall_factor=args.stall_factor,
            )
        except (FileNotFoundError, OSError) as e:
            print(f"ddr metrics: {e}", file=sys.stderr)
            return 1
    try:
        events, bad = load_events(args.log)
    except (FileNotFoundError, OSError) as e:
        print(f"ddr metrics: {e}", file=sys.stderr)
        return 1
    if args.command == "summarize":
        return summarize(events, bad, stall_factor=args.stall_factor)
    if args.command == "trace":
        doc = perfetto_trace(events)
        te = doc["traceEvents"]
        Path(args.out).write_text(json.dumps(doc), encoding="utf-8")
        n_slices = sum(1 for ev in te if ev.get("ph") == "X")
        n_flows = sum(1 for ev in te if ev.get("ph") in ("s", "t", "f"))
        hosts = sorted({ev["pid"] for ev in te if "pid" in ev})
        print(
            f"wrote {args.out}: {len(te)} trace events "
            f"({n_slices} slices, {n_flows} flow points) across "
            f"{len(hosts)} host track(s) — open at https://ui.perfetto.dev"
        )
        return 0
    return tail(events, n=args.n)


if __name__ == "__main__":
    raise SystemExit(main())
