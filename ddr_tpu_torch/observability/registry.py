"""In-process metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of ``ddr_tpu/observability/registry.py``, standard library
only. The live half of the serve path's telemetry:
:mod:`ddr_tpu_torch.observability.prometheus` maps the service's and the
watchdog's decisions onto these instruments and renders the Prometheus text
that ``GET /metrics`` answers.

- cheap enough for the serve hot path: one dict lookup and a float add under
  one registry lock per update;
- Prometheus-shaped: counters only go up, histograms have fixed cumulative
  buckets chosen at declaration, every series is (name, label values).

Instruments are declared get-or-create (declaring a name twice returns the
same object; a kind or label mismatch raises).
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading
from typing import Any, Iterable

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
]

#: Default histogram buckets for request and batch latencies, seconds; +Inf
#: is implied.
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _Instrument:
    """One instrument: name, label names and a series map keyed by the
    label-values tuple (``()`` for a label-less instrument)."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str, labels: tuple[str, ...]) -> None:
        self._registry = registry
        self._lock = registry._lock  # one lock per registry, shared
        self.name = name
        self.help = help
        self.labels = labels
        self._series: dict[tuple[str, ...], Any] = {}

    def _key(self, label_values: dict[str, Any]) -> tuple[str, ...]:
        if set(label_values) != set(self.labels):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labels}, "
                f"got {tuple(sorted(label_values))}"
            )
        return tuple(str(label_values[k]) for k in self.labels)

    def series(self) -> dict[tuple[str, ...], Any]:
        """Snapshot of ``label-values -> value`` (a scalar, or a histogram's
        state dict)."""
        with self._lock:
            return {k: (dict(v) if isinstance(v, dict) else v) for k, v in self._series.items()}

    def remove(self, **labels: Any) -> bool:
        """Drop one series by its label values (False when absent): for gauges
        whose subject is gone, such as an unloaded model's version."""
        key = self._key(labels)
        with self._lock:
            return self._series.pop(key, None) is not None


class Counter(_Instrument):
    """Monotonically increasing count (Prometheus ``counter``)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc {amount})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Instrument):
    """Set-to-current-value instrument (Prometheus ``gauge``)."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), math.nan))


class Histogram(_Instrument):
    """Fixed cumulative-bucket histogram (Prometheus ``histogram``): each
    series holds ``{"buckets": [n per bound, +Inf], "sum", "count"}``."""

    kind = "histogram"

    def __init__(self, registry, name, help, labels, buckets: Iterable[float]) -> None:
        super().__init__(registry, name, help, labels)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"histogram {self.name!r} needs at least one bucket")
        if any(not math.isfinite(b) for b in bounds):
            raise ValueError(f"histogram {self.name!r}: +Inf bucket is implicit")
        self.buckets = tuple(bounds)

    def observe(self, value: float, **labels: Any) -> None:
        value = float(value)
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = {
                    "buckets": [0] * (len(self.buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            # a NaN lands in +Inf only and adds nothing to the sum, but counts
            idx = len(self.buckets) if value != value else bisect.bisect_left(self.buckets, value)
            state["buckets"][idx] += 1
            state["sum"] += value if value == value else 0.0
            state["count"] += 1


class MetricsRegistry:
    """Named instruments plus constant labels (attached to every exported
    series), rendered by :func:`~ddr_tpu_torch.observability.prometheus.render_text`."""

    def __init__(self, const_labels: dict[str, Any] | None = None) -> None:
        self._lock = threading.RLock()
        self._metrics: dict[str, _Instrument] = {}
        self.const_labels = {str(k): str(v) for k, v in (const_labels or {}).items()}

    def _declare(self, cls, name: str, help: str, labels: tuple, **kw) -> Any:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for lab in labels:
            if not _LABEL_RE.match(lab):
                raise ValueError(f"invalid label name {lab!r} on metric {name!r}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labels != labels:
                    raise ValueError(
                        f"metric {name!r} already declared as {existing.kind} with "
                        f"labels {existing.labels}; cannot redeclare as {cls.kind} "
                        f"with labels {labels}"
                    )
                return existing
            metric = cls(self, name, help, labels, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Counter:
        return self._declare(Counter, name, help, tuple(labels))

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, tuple(labels))

    def histogram(
        self, name: str, help: str = "", labels: Iterable[str] = (),
        buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
    ) -> Histogram:
        return self._declare(Histogram, name, help, tuple(labels), buckets=buckets)

    def collect(self) -> list[_Instrument]:
        """Declared instruments in declaration order."""
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> _Instrument | None:
        with self._lock:
            return self._metrics.get(name)


_DEFAULT: MetricsRegistry | None = None
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process default registry, created on first use with the process's
    rank as its ``host`` label (``RANK``, as ``torchrun`` sets it; 0 for a
    single process, as the JAX package's single-process registry reads)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry(const_labels={"host": int(os.environ.get("RANK", "0") or 0)})
        return _DEFAULT


def set_registry(registry: MetricsRegistry | None) -> None:
    """Swap (or clear, with None) the process default registry."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = registry
