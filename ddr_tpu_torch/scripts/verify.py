"""``ddr verify`` on the port: forecast-verification reports and self-test.

The port of ``ddr_tpu/scripts/verify.py``, over
:mod:`ddr_tpu_torch.observability.verification`:

- ``--synthetic`` — the self-test over a synthetic basin: issue E-member
  ensembles against a known truth (the unperturbed forecast of the same
  window), join the truth through the ledger as observations, and require
  the scorers to rank the sharp ensemble above a degraded twin (members
  x1.5); CRPS is a proper score, so a scorer that cannot rank them exits 1.
  The join is host-side: a kernel launched during it is a fault too (the
  JAX command pins its compile cache there instead). ``a.b=c`` overrides
  apply to the synthetic config; it runs on the card unless ``device=cpu``.
- ``--url`` — read a running service's ``/v1/stats`` verification slice
  (the service needs a ledger, ``ForecastService.attach_verifier``);
- ``<logdir>`` — replay: fold the last ``verify`` event of every
  ``run_log*.jsonl`` under the directory (:func:`replay_dir`).

Each mode writes ``VERIFY_<label>.json`` and ``VERIFY_<label>.md``, prints
the summary, and prints the JSON record as the last line of standard output.
``--synthetic`` records its joins in ``run_log.verify.jsonl``
(``DDR_METRICS_DIR``, else the report directory), which the replay mode reads.

    python -m ddr_tpu_torch.cli verify --synthetic --n 64 --members 8 device=cpu
    python -m ddr_tpu_torch.cli verify <logdir>
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from pathlib import Path
from typing import Any

import numpy as np

from ddr_tpu_torch.observability.events import run_telemetry

log = logging.getLogger(__name__)

__all__ = ["main", "render_verify_summary", "replay_dir", "run_live", "run_synthetic"]

#: Degraded-arm bias: members scaled by this factor. Far enough from truth
#: that CRPS must rank it below the sharp arm on any reasonable basin.
DEGRADE_FACTOR = 1.5


def _mean_brier(thresholds: dict[str, Any]) -> float | None:
    """The sample-weighted mean Brier score over the scored thresholds."""
    num = den = 0.0
    for entry in (thresholds or {}).values():
        n = entry.get("n", 0)
        if n and entry.get("brier") is not None:
            num += entry["brier"] * n
            den += n
    return round(num / den, 6) if den else None


def _scores_to_record(scores: dict[str, Any]) -> dict[str, Any]:
    """The report fields every mode shares, from one scorer summary."""
    return {
        "matched_samples": int(scores.get("samples", 0)),
        "nonfinite_samples": int(scores.get("nonfinite_samples", 0)),
        "crps": scores.get("crps"),
        "brier": _mean_brier(scores.get("thresholds")),
        "spread_skill": scores.get("spread_skill"),
        "by_lead": scores.get("by_lead", {}),
        "thresholds": scores.get("thresholds", {}),
        "rank_histogram": scores.get("rank_histogram"),
        "worst": scores.get("worst", []),
    }


def run_synthetic(service: Any, args: Any) -> dict[str, Any]:
    """Issue ensembles against a known truth, join through the ledger, and
    score a degraded twin on the same observations. The service's
    :class:`ForecastLedger` is attached after the truth pass, so the truth
    forecasts (the observations' source) are never ledgered as zero-error
    forecasts."""
    from ddr_tpu_torch.observability.registry import MetricsRegistry
    from ddr_tpu_torch.observability.verification import ForecastLedger
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm

    net = service.networks()["default"]
    t0_span = max(1, len(net.forcing) - net.horizon)
    truths: dict[int, np.ndarray] = {}
    for k in range(args.requests):
        t0 = k % t0_span
        if t0 not in truths:
            truths[t0] = np.asarray(
                service.forecast(network="default", t0=t0, request_id=f"verify-truth-{t0}")["runoff"])
    ledger = ForecastLedger()
    service.attach_verifier(ledger)
    # the degraded arm is a private ledger with its own registry: its scores
    # exist only for the ordering check, never in the exported series
    degraded = ForecastLedger(ledger.config, registry=MetricsRegistry())
    outs = []
    for k in range(args.requests):
        t0 = k % t0_span
        out = service.ensemble_forecast(network="default", t0=t0, members=args.members,
                                        request_id=f"verify-ens-{k}", return_members=True)
        out["_t0"] = t0
        outs.append(out)
        degraded.record_forecast("default", "degraded", out["request_id"], int(t0), out["valid_times"],
                                 [str(g) for g in range(out["member_runoff"].shape[2])],
                                 np.asarray(out["member_runoff"]) * DEGRADE_FACTOR)
    launches_before = wave_scan_tm.launches
    for out in outs:
        truth = truths[out["_t0"]]
        obs = {str(g): [(vh, float(truth[i, g])) for i, vh in enumerate(out["valid_times"])]
               for g in range(truth.shape[1])}
        ledger.observe("default", obs, source="synthetic")
        degraded.observe("default", obs, source="synthetic-degraded")
    launches_during_join = wave_scan_tm.launches - launches_before

    sharp = ledger.scorer.summary()
    degraded_scores = degraded.scorer.summary()
    status = ledger.status()
    return {
        "kind": "verify",
        "mode": "synthetic",
        "requests": args.requests,
        "members": args.members,
        "n_segments": args.n,
        "horizon": args.horizon,
        **_scores_to_record(sharp),
        "crps_degraded": degraded_scores.get("crps"),
        "ordering_ok": (sharp.get("crps") is not None and degraded_scores.get("crps") is not None
                        and sharp["crps"] < degraded_scores["crps"]),
        "unmatched_obs": status["unmatched_obs"],
        "duplicate_obs": status["duplicate_obs"],
        "evicted": status["evicted"],
        "kernel_launches_during_join": int(launches_during_join),
    }


def run_live(url: str) -> dict[str, Any] | None:
    """One ``/v1/stats`` read of a running service's verification slice."""
    import urllib.request

    with urllib.request.urlopen(f"{url.rstrip('/')}/v1/stats", timeout=10) as r:
        stats = json.loads(r.read())
    verification = stats.get("verification")
    if not verification:
        return None
    scorer = verification.get("scorer") or {}
    return {
        "kind": "verify",
        "mode": "live",
        "target": url,
        **_scores_to_record(scorer.get("scores") or {}),
        "unmatched_obs": verification.get("unmatched_obs", 0),
        "duplicate_obs": verification.get("duplicate_obs", 0),
        "evicted": verification.get("evicted", 0),
    }


def replay_dir(logdir: Path) -> dict[str, Any] | None:
    """Fold the last ``verify`` event of every run log under ``logdir`` into
    one rollup. The events carry cumulative scorer summaries, so the fold is
    one sample-weighted mean a score across files (exact for the means; the
    rank histogram and the worst set are per-file shapes and are dropped).
    None when no file holds a ``verify`` event."""
    lasts: list[dict] = []
    for path in sorted(logdir.glob("run_log*.jsonl")):
        last = None
        try:
            with path.open() as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if ev.get("event") == "verify":
                        last = ev
        except OSError as e:
            log.warning(f"skipping unreadable {path}: {e}")
            continue
        if last is not None:
            lasts.append(last)
    if not lasts:
        return None

    def _wmean(pairs: list[tuple[float, float]]) -> float | None:
        num = sum(v * w for v, w in pairs)
        den = sum(w for _, w in pairs)
        return round(num / den, 6) if den else None

    samples = sum(int(ev.get("samples", 0)) for ev in lasts)
    crps = _wmean([(ev["crps"], ev.get("samples", 0)) for ev in lasts if ev.get("crps") is not None])
    spread = _wmean([(ev["spread_skill"], ev.get("samples", 0)) for ev in lasts
                     if ev.get("spread_skill") is not None])
    briers = [(b, ev.get("samples", 0)) for ev in lasts for b in [_mean_brier(ev.get("thresholds"))]
              if b is not None]
    # the lead bins, weighted by each file's n a bin
    by_lead: dict[str, dict[str, float]] = {}
    for ev in lasts:
        for label, entry in (ev.get("by_lead") or {}).items():
            acc = by_lead.setdefault(label, {"n": 0, "crps_num": 0.0})
            acc["n"] += entry.get("n", 0)
            if entry.get("crps") is not None:
                acc["crps_num"] += entry["crps"] * entry.get("n", 0)
    return {
        "kind": "verify",
        "mode": "replay",
        "target": str(logdir),
        "files": len(lasts),
        "matched_samples": samples,
        "crps": crps,
        "brier": _wmean(briers),
        "spread_skill": spread,
        "by_lead": {
            label: {"n": int(acc["n"]), "crps": round(acc["crps_num"] / acc["n"], 6) if acc["n"] else None}
            for label, acc in by_lead.items()
        },
    }


def render_verify_summary(report: dict[str, Any]) -> str:
    """Markdown summary for terminals and ``VERIFY_<label>.md``."""
    lines = [
        f"## ddr verify — {report.get('mode')} ({report.get('label', 'unlabeled')})",
        "",
        "| metric | value |",
        "|---|---|",
        f"| matched samples | {report.get('matched_samples', 0)} |",
        f"| CRPS (fair, mean) | {report.get('crps')} |",
        f"| Brier (weighted mean) | {report.get('brier')} |",
        f"| spread–skill | {report.get('spread_skill')} |",
    ]
    if report.get("mode") == "synthetic":
        lines += [
            f"| CRPS degraded arm | {report.get('crps_degraded')} |",
            f"| ordering (sharp < degraded) | {'OK' if report.get('ordering_ok') else 'FAILED'} |",
            f"| kernel launches during join | {report.get('kernel_launches_during_join')} |",
        ]
    by_lead = report.get("by_lead") or {}
    if by_lead:
        lines += ["", "| lead bin | n | CRPS |", "|---|---|---|"]
        for label, entry in by_lead.items():
            lines.append(f"| {label} | {entry.get('n')} | {entry.get('crps')} |")
    scored = {k: v for k, v in (report.get("thresholds") or {}).items() if v.get("n")}
    if scored:
        lines += ["", "| threshold | n | Brier | REL | RES | base rate |", "|---|---|---|---|---|---|"]
        for label, t in scored.items():
            lines.append(f"| {label} | {t['n']} | {t.get('brier')} | {t.get('reliability')} | "
                         f"{t.get('resolution')} | {t.get('base_rate')} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="ddr verify",
        description="Forecast-verification reporting: synthetic self-test or a live /v1/stats "
        "read; writes a VERIFY_*.json record.",
    )
    parser.add_argument("args", nargs="*",
                        help="a run-log directory (replay mode: fold its verify events), and "
                        "a.b=c overrides of the synthetic config (e.g. device=cpu)")
    parser.add_argument("--url", default=None, help="live mode: read this service's /v1/stats "
                        "verification slice")
    parser.add_argument("--synthetic", action="store_true",
                        help="self-test over a synthetic basin (CRPS must rank a sharp ensemble "
                        "above a degraded one)")
    parser.add_argument("--n", type=int, default=64, help="synthetic reach count (default 64)")
    parser.add_argument("--horizon", type=int, default=24,
                        help="synthetic forecast horizon, hours (default 24)")
    parser.add_argument("--members", type=int, default=8, help="synthetic ensemble size (default 8)")
    parser.add_argument("--requests", type=int, default=6,
                        help="synthetic ensemble forecasts to issue (default 6)")
    parser.add_argument("--label", default=None,
                        help="report name suffix (VERIFY_<label>.json; default: a timestamp)")
    parser.add_argument("--out", default=None, help="report directory (default: DDR_METRICS_DIR or .)")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    overrides = [a for a in args.args if "=" in a]
    logdirs = [a for a in args.args if "=" not in a]
    if len(logdirs) > 1:
        parser.print_usage()
        log.error(f"one run-log directory at most, got {logdirs}")
        return 2
    if not args.synthetic and not args.url and not logdirs:
        parser.print_usage()
        log.error("pick a mode: --synthetic, --url, or a run-log directory")
        return 2

    out_dir = Path(args.out or os.environ.get("DDR_METRICS_DIR") or ".")
    out_dir.mkdir(parents=True, exist_ok=True)
    label = args.label or time.strftime("%Y%m%d-%H%M%S")

    rc = 0
    device = None
    if args.synthetic:
        from ddr_tpu_torch.scripts.loadtest import build_synthetic_service, device_label

        service, cfg = build_synthetic_service(args.n, args.horizon, save_path=str(out_dir),
                                               overrides=overrides)
        try:
            device = device_label(service)
            with run_telemetry(cfg, "verify", mode="synthetic"):
                try:
                    report = run_synthetic(service, args)
                finally:
                    service.close(drain=False)
                    service = None
        finally:
            if service is not None:
                service.close(drain=False)
        if not report["ordering_ok"]:
            log.error("CRPS ordering FAILED: sharp %s vs degraded %s", report.get("crps"),
                      report.get("crps_degraded"))
            rc = 1
        if report["kernel_launches_during_join"]:
            log.error("the observation join launched %d kernels; the verification plane must be "
                      "host-side", report["kernel_launches_during_join"])
            rc = 1
        if not report["matched_samples"]:
            log.error("no forecast-observation pairs matched")
            rc = 1
    elif args.url:
        report = run_live(args.url)
        if report is None:
            log.error(f"{args.url} exposes no verification slice (is a ledger attached via "
                      "attach_verifier?)")
            return 1
    else:
        report = replay_dir(Path(logdirs[0]))
        if report is None:
            log.error(f"no verify events found under {logdirs[0]}")
            return 1

    report["label"] = label
    report["device"] = device
    path = out_dir / f"VERIFY_{label}.json"
    path.write_text(json.dumps(report, indent=2) + "\n")
    (out_dir / f"VERIFY_{label}.md").write_text(render_verify_summary(report) + "\n")
    log.info(f"verify report written to {path}")
    print(render_verify_summary(report))
    print(json.dumps(report))  # the last line of standard output stays machine-readable
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
