"""Synthetic in-memory basin: the fixture dataset for tests and the chip smoke.

The port's own copy of ``ddr_tpu/geodatazoo/synthetic.py``'s generators. The
random stream is drawn in the same order, so one seed gives the same basin
here as there. :class:`RoutingData` is a minimal dataclass of the fields the
serving path reads (no dates, no observations).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["N_ATTRIBUTES", "RoutingData", "SyntheticBasin", "make_basin", "make_deep_network"]

N_ATTRIBUTES = 10  # the 10 canonical MERIT attributes


@dataclasses.dataclass
class RoutingData:
    """One routing problem: topology, channel attributes and gauges."""

    n_segments: int = 0
    adjacency_rows: np.ndarray | None = None  # (E,) downstream index per edge
    adjacency_cols: np.ndarray | None = None  # (E,) upstream index per edge
    normalized_spatial_attributes: np.ndarray | None = None  # (N, num_attrs) KAN input
    length: np.ndarray | None = None  # (N,) meters
    slope: np.ndarray | None = None  # (N,) m/m
    x: np.ndarray | None = None  # (N,) Muskingum storage weight
    side_slope: np.ndarray | None = None  # (N,) observed z, or None
    top_width: np.ndarray | None = None  # (N,) observed bankfull width, or None
    outflow_idx: list[np.ndarray] | None = None  # ragged per-gauge inflow columns
    flow_scale: np.ndarray | None = None  # (N,) partial-drainage-area correction


@dataclasses.dataclass
class SyntheticBasin:
    routing_data: RoutingData
    q_prime: np.ndarray  # (T, N) hourly lateral inflow
    true_params: dict[str, np.ndarray]  # physical-space truth
    gauge_segments: np.ndarray | None = None


def _dendritic_network(rng: np.random.Generator, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Random dendritic (single-downstream) topologically-sorted tree."""
    rows, cols = [], []
    for i in range(n - 1):
        lo = i + 1
        hi = min(n, i + max(2, n // 8))
        rows.append(int(rng.integers(lo, hi)))
        cols.append(i)
    return np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64)


def make_deep_network(
    n: int,
    depth: int,
    seed: int | np.random.Generator = 0,
    alpha: float = 0.5,
    trib_reach: float = 8.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Deep dendritic topology with EXACT longest-path depth, shaped like a
    continental river network: headwater-heavy level populations
    ``~ (L + 1) ** -alpha``, one mainstem threaded through every level, and
    tributaries joining ``1 + Geometric(1 / trib_reach)`` levels downstream.
    Returns ``(rows, cols)`` with edge ``cols[i] -> rows[i]``."""
    if depth < 1 or n < depth + 1:
        raise ValueError(f"need n >= depth + 1 (got n={n}, depth={depth})")
    rng = np.random.default_rng(seed)

    raw = (np.arange(1, depth + 2, dtype=np.float64)) ** (-alpha)
    counts = np.maximum(1, np.floor(raw * (n / raw.sum()))).astype(np.int64)
    counts = np.minimum.accumulate(counts)  # non-increasing => primaries feasible
    deficit = n - int(counts.sum())
    while deficit > 0:
        take = min(deficit, depth + 1)
        counts[:take] += 1
        deficit -= take
    while deficit < 0:
        removable = np.flatnonzero(counts > 1)
        shave = removable[-min(-deficit, removable.size):]
        counts[shave] -= 1
        deficit += shave.size
    if counts.sum() != n or not (counts >= 1).all():
        raise RuntimeError("level populations do not sum to n")

    starts = np.concatenate([[0], np.cumsum(counts)])
    src_parts: list[np.ndarray] = []
    tgt_parts: list[np.ndarray] = []
    has_out = np.zeros(n, dtype=bool)
    for L in range(1, depth + 1):
        prev = np.arange(starts[L - 1], starts[L])
        cur = np.arange(starts[L], starts[L + 1])
        chosen = rng.permutation(prev)[: cur.size]
        src_parts.append(chosen)
        tgt_parts.append(cur)
        has_out[chosen] = True

    pending = np.flatnonzero(~has_out[: starts[depth]])
    if pending.size:
        lvl_of = np.repeat(np.arange(depth + 1), counts)
        hop = 1 + rng.geometric(1.0 / trib_reach, size=pending.size)
        tgt_lvl = np.minimum(lvl_of[pending] + hop, depth)
        tgt = starts[tgt_lvl] + rng.integers(0, counts[tgt_lvl])
        src_parts.append(pending)
        tgt_parts.append(tgt)

    cols = np.concatenate(src_parts)
    rows = np.concatenate(tgt_parts)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order]


def make_basin(
    n_segments: int = 64,
    n_gauges: int = 4,
    n_days: int = 8,
    seed: int = 0,
    depth: int | None = None,
) -> SyntheticBasin:
    """A synthetic basin with storm-hydrograph forcing. ``depth`` switches the
    topology to :func:`make_deep_network` with that exact longest-path depth;
    ``None`` keeps the shallow random tree."""
    rng = np.random.default_rng(seed)
    n = n_segments
    if depth is None:
        rows, cols = _dendritic_network(rng, n)
    else:
        rows, cols = make_deep_network(n, depth, seed=rng)

    length = rng.uniform(800, 6000, n)
    slope = rng.uniform(5e-4, 0.02, n)
    x = np.full(n, 0.3)

    attrs = rng.normal(size=(N_ATTRIBUTES, n))

    def sig(z):
        return 1.0 / (1.0 + np.exp(-z))

    n_true = 0.015 + (0.25 - 0.015) * sig(0.8 * attrs[0] - 0.4 * attrs[1])
    q_true = sig(0.7 * attrs[2] + 0.3 * attrs[3])
    true_params = {"n": n_true, "q_spatial": q_true, "p_spatial": np.full(n, 21.0)}
    norm_attrs = (attrs - attrs.mean(1, keepdims=True)) / (attrs.std(1, keepdims=True) + 1e-8)

    T = n_days * 24
    t = np.arange(T)
    area_weight = rng.uniform(0.2, 2.0, n)
    q_prime = 0.05 * area_weight[None, :] * np.ones((T, 1))
    for _ in range(max(2, n_days // 3)):
        t0 = rng.integers(0, T)
        amp = rng.uniform(0.5, 3.0)
        decay = rng.uniform(12, 48)
        pulse = amp * np.exp(-np.maximum(t - t0, 0) / decay) * (t >= t0)
        q_prime += pulse[:, None] * area_weight[None, :] * rng.uniform(0.5, 1.5, n)[None, :]

    # gauges on the largest-drainage segments
    n_up = np.bincount(rows, minlength=n)
    gauge_segments = np.argsort(n_up)[-n_gauges:]
    outflow_idx = []
    for g in gauge_segments:
        ups = cols[rows == g]
        outflow_idx.append(ups if ups.size else np.array([g]))

    rd = RoutingData(
        n_segments=n,
        adjacency_rows=rows,
        adjacency_cols=cols,
        normalized_spatial_attributes=norm_attrs.T.astype(np.float32),
        length=length,
        slope=slope,
        x=x,
        outflow_idx=outflow_idx,
    )
    return SyntheticBasin(
        routing_data=rd,
        q_prime=q_prime.astype(np.float32),
        true_params=true_params,
        gauge_segments=gauge_segments,
    )
