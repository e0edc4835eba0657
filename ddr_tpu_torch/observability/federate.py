"""Metrics federation: N replica ``/metrics`` endpoints -> one exposition.

The port's copy of ``ddr_tpu/observability/federate.py`` (standard library
only). Each serving replica exposes its own registry; fleet questions
("which replica burns its SLO budget", "what is the group's request rate")
need the union. :func:`federate_text` scrapes every configured target,
labels every sample ``replica="<label>"``, and renders the union as one
text exposition. ``GET /metrics?federated=1`` on any replica answers for the
targets it knows (``DDR_FEDERATE_REPLICAS``, which a
:class:`~ddr_tpu_torch.fleet.group.ReplicaGroup` publishes) and folds its own
registry in as ``replica="self"`` through
:func:`~ddr_tpu_torch.observability.prometheus.render_text`.

**Cardinality cap**: federation multiplies series by replicas.
``DDR_FEDERATE_MAX_SERIES`` (default 2000) caps the emitted sample lines;
overflow is dropped (later targets lose first) and counted in
``ddr_federate_dropped_series``. Per-target liveness
(``ddr_federate_up{replica=...}`` 1/0) is always emitted and never counts
against the cap. Each scrape has a bounded timeout, so a dead replica costs
one timeout, not the scrape.
"""

from __future__ import annotations

import logging
import os
import re
import urllib.error
import urllib.request
from typing import Sequence

log = logging.getLogger(__name__)

__all__ = [
    "DEFAULT_MAX_SERIES",
    "parse_replicas",
    "replicas_from_env",
    "max_series_from_env",
    "scrape_replica",
    "inject_label",
    "federate_text",
]

#: Default hard cap on federated sample lines (DDR_FEDERATE_MAX_SERIES).
DEFAULT_MAX_SERIES = 2000

#: A Prometheus sample line: metric name, optional {labels}, value[ timestamp].
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)(\s+\d+)?$"
)

#: Replica labels come from CLI/env specs; keep them label-value-safe.
_LABEL_STRIP = re.compile(r'["\\\n]')


def max_series_from_env() -> int:
    """``DDR_FEDERATE_MAX_SERIES`` -> the sample-line cap (default
    ``DEFAULT_MAX_SERIES``; malformed or non-positive values fall back — the
    cap exists to bound damage, so it cannot be talked out of existence)."""
    raw = os.environ.get("DDR_FEDERATE_MAX_SERIES")
    if not raw:
        return DEFAULT_MAX_SERIES
    try:
        n = int(raw)
    except ValueError:
        log.warning(
            f"ignoring malformed DDR_FEDERATE_MAX_SERIES={raw!r} (want an integer)"
        )
        return DEFAULT_MAX_SERIES
    return n if n > 0 else DEFAULT_MAX_SERIES


def parse_replicas(spec: str) -> list[tuple[str, str]]:
    """``"a=http://h:9100,b=h2:9100/metrics"`` -> ``[(label, url), ...]``.

    Entries are comma-separated ``label=url`` pairs or bare urls (the label
    then derives from ``host:port``). Schemes default to ``http://`` and a
    bare authority gets ``/metrics`` appended, so the spec can be exactly what
    ``run_start``'s ``prom_port`` discovery hands back."""
    out: list[tuple[str, str]] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" in entry and not entry.split("=", 1)[0].startswith(("http:", "https:")):
            label, url = entry.split("=", 1)
        else:
            label, url = "", entry
        url = url.strip()
        if not url.startswith(("http://", "https://")):
            url = f"http://{url}"
        # authority-only targets mean "the exporter on that host"
        if "/" not in url.split("://", 1)[1]:
            url += "/metrics"
        if not label:
            label = url.split("://", 1)[1].split("/", 1)[0]
        out.append((_LABEL_STRIP.sub("", label.strip()), url))
    return out


def replicas_from_env() -> list[tuple[str, str]]:
    """``DDR_FEDERATE_REPLICAS`` -> parsed targets (empty when unset)."""
    raw = os.environ.get("DDR_FEDERATE_REPLICAS")
    return parse_replicas(raw) if raw else []


def scrape_replica(url: str, timeout: float = 2.0) -> str:
    """Fetch one target's exposition text; raises on any transport/HTTP
    failure (the caller converts that into ``ddr_federate_up 0``)."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return resp.read().decode("utf-8", errors="replace")


def inject_label(line: str, name: str, value: str) -> str | None:
    """Rewrite one sample line to carry ``name="value"`` as its first label;
    returns None for lines that do not parse as samples (callers skip them —
    a replica's garbage line must not corrupt the federated page)."""
    m = _SAMPLE_RE.match(line)
    if m is None:
        return None
    metric, labels, val, ts = m.group(1), m.group(2), m.group(3), m.group(4) or ""
    esc = value.replace("\\", "\\\\").replace('"', '\\"')
    if labels and labels != "{}":
        body = f'{{{name}="{esc}",{labels[1:-1]}}}'
    else:
        body = f'{{{name}="{esc}"}}'
    return f"{metric}{body} {val}{ts}"


def federate_text(
    replicas: Sequence[tuple[str, str]],
    timeout: float = 2.0,
    max_series: int | None = None,
    local: tuple[str, object] | None = None,
) -> str:
    """Scrape every ``(label, url)`` target and merge into one exposition.

    ``local=(label, registry)`` folds the calling process's own registry in
    without a network hop (the serving API's ``?federated=1`` passes
    ``("self", svc.metrics)``). Per-metric ``# HELP``/``# TYPE`` headers are
    emitted once (first writer wins — duplicate TYPE lines are invalid
    exposition); every sample gains ``replica=<label>``. The hard series cap
    (``max_series``, default from env) drops overflow and reports the count.
    """
    cap = max_series_from_env() if max_series is None else int(max_series)
    # metric name -> [header lines, sample lines...] keeps each metric's
    # samples under its single TYPE header across replicas
    metrics: dict[str, dict] = {}
    up: list[tuple[str, int]] = []
    dropped = 0
    emitted = 0

    def _fold(label: str, text: str) -> None:
        nonlocal dropped, emitted
        current = None
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    name = parts[2]
                    slot = metrics.setdefault(name, {"help": None, "type": None, "samples": []})
                    kind = parts[1].lower()
                    if slot[kind] is None:
                        slot[kind] = line
                    current = name
                continue
            sample = inject_label(line, "replica", label)
            if sample is None:
                continue
            base = _SAMPLE_RE.match(line).group(1)
            # histogram/summary children file under their family header
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix) and base[: -len(suffix)] in metrics:
                    base = base[: -len(suffix)]
                    break
            else:
                if current is not None and base not in metrics and (
                    base.startswith(current)
                ):
                    base = current
            if emitted >= cap:
                dropped += 1
                continue
            emitted += 1
            metrics.setdefault(
                base, {"help": None, "type": None, "samples": []}
            )["samples"].append(sample)

    for label, url in replicas:
        try:
            text = scrape_replica(url, timeout=timeout)
        except (urllib.error.URLError, OSError, ValueError) as e:
            log.warning(f"federation scrape of {label} ({url}) failed: {e}")
            up.append((label, 0))
            continue
        up.append((label, 1))
        _fold(label, text)
    if local is not None:
        from ddr_tpu_torch.observability.prometheus import render_text

        label, registry = local
        up.append((str(label), 1))
        _fold(str(label), render_text(registry))

    out: list[str] = [
        "# HELP ddr_federate_up Whether the last scrape of each replica succeeded",
        "# TYPE ddr_federate_up gauge",
    ]
    for label, ok in up:
        esc = label.replace("\\", "\\\\").replace('"', '\\"')
        out.append(f'ddr_federate_up{{replica="{esc}"}} {ok}')
    out.append(
        "# HELP ddr_federate_dropped_series Sample lines dropped by the "
        "cardinality cap (DDR_FEDERATE_MAX_SERIES)"
    )
    out.append("# TYPE ddr_federate_dropped_series gauge")
    out.append(f"ddr_federate_dropped_series {dropped}")
    for name in sorted(metrics):
        slot = metrics[name]
        if not slot["samples"]:
            continue
        if slot["help"]:
            out.append(slot["help"])
        if slot["type"]:
            out.append(slot["type"])
        out.extend(slot["samples"])
    return "\n".join(out) + "\n"
