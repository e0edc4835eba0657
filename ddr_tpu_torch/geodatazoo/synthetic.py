"""Synthetic in-memory basin: the fixture dataset for tests, the chip smoke
and the end-to-end twin experiment of ``ddr train``.

The port's copy of ``ddr_tpu/geodatazoo/synthetic.py``. The random stream is
drawn in the same order, so one seed gives the same basin here as there.
:func:`observe` routes the basin with its true parameters to make the twin
experiment's observations, and :class:`Synthetic` is the dataset protocol
over one observed basin: gauge batches in training, day batches in
inference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ddr_tpu_torch.geodatazoo.dataclasses import Dates, RoutingData
from ddr_tpu_torch.io.readers import ObservationSet
from ddr_tpu_torch.validation.enums import Mode

__all__ = [
    "N_ATTRIBUTES",
    "RoutingData",
    "Synthetic",
    "SyntheticBasin",
    "make_basin",
    "make_deep_network",
    "observe",
]

N_ATTRIBUTES = 10  # the 10 canonical MERIT attributes


@dataclasses.dataclass
class SyntheticBasin:
    routing_data: RoutingData
    q_prime: np.ndarray  # (T, N) hourly lateral inflow
    true_params: dict[str, np.ndarray]  # physical-space truth
    gauge_segments: np.ndarray | None = None
    obs_daily: np.ndarray | None = None  # (D-1, G) daily gauge discharge, from observe()


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


def _add_storms(q_prime: np.ndarray, area_weight: np.ndarray, storms) -> None:
    """The JAX generator's ``q_prime += pulse * area_weight * u`` for each
    ``(t0, pulse, u)`` of ``storms`` in turn, in place and bit for bit:
    every element takes the same operations in the same order, but the
    array is walked in blocks of about 2**17 elements (1 MiB), each taking
    every storm while it is in cache, and only over the rows from ``t0`` on
    (the pulse is 0 before)."""
    T, n = q_prime.shape
    cols = min(n, 1 << 14)
    rows = max(1, (1 << 17) // cols)
    buf = np.empty((rows, cols))
    for c0 in range(0, n, cols):
        c1 = min(c0 + cols, n)
        weight = area_weight[None, c0:c1]
        for r0 in range(0, T, rows):
            r1 = min(r0 + rows, T)
            for t0, pulse, u in storms:
                a = max(t0, r0)
                if a < r1:
                    storm = buf[: r1 - a, : c1 - c0]
                    np.multiply(pulse[a:r1, None], weight, out=storm)
                    storm *= u[None, c0:c1]
                    q_prime[a:r1, c0:c1] += storm


def make_basin(
    n_segments: int = 64,
    n_gauges: int = 4,
    n_days: int = 8,
    seed: int = 0,
    depth: int | None = None,
    start_time: str = "1981/10/01",
) -> SyntheticBasin:
    """A synthetic basin with storm-hydrograph forcing over ``n_days`` days
    from ``start_time``. ``depth`` switches the topology to
    :func:`make_deep_network` with that exact longest-path depth; ``None``
    keeps the shallow random tree."""
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
    storms = []
    for _ in range(max(2, n_days // 3)):
        t0 = rng.integers(0, T)
        amp = rng.uniform(0.5, 3.0)
        decay = rng.uniform(12, 48)
        pulse = amp * np.exp(-np.maximum(t - t0, 0) / decay) * (t >= t0)
        storms.append((int(t0), pulse, rng.uniform(0.5, 1.5, n)))
    _add_storms(q_prime, area_weight, storms)

    # gauges on the largest-drainage segments
    n_up = np.bincount(rows, minlength=n)
    gauge_segments = np.argsort(n_up)[-n_gauges:]
    outflow_idx = []
    for g in gauge_segments:
        ups = cols[rows == g]
        outflow_idx.append(ups if ups.size else np.array([g]))

    end = (
        np.datetime64(start_time.replace("/", "-")) + np.timedelta64(n_days - 1, "D")
    ).astype("datetime64[D]")
    rd = RoutingData(
        n_segments=n,
        adjacency_rows=rows,
        adjacency_cols=cols,
        spatial_attributes=attrs,
        normalized_spatial_attributes=norm_attrs.T.astype(np.float32),
        length=length,
        slope=slope,
        x=x,
        dates=Dates(start_time=start_time, end_time=str(end).replace("-", "/")),
        divide_ids=np.arange(n),
        outflow_idx=outflow_idx,
        gage_catchment=[f"{i:08d}" for i in range(len(gauge_segments))],
    )
    return SyntheticBasin(
        routing_data=rd,
        q_prime=q_prime.astype(np.float32),
        true_params=true_params,
        gauge_segments=gauge_segments,
    )


def observe(basin: SyntheticBasin, cfg, device="cuda") -> SyntheticBasin:
    """The twin experiment: route the basin with its true parameters through
    the port's ``route`` (default bounds, as the JAX package's ``observe``
    does) and store the tau-trimmed daily gauge discharge as
    ``basin.obs_daily`` ``(D-1, G)`` and, as the datasets hand observations
    to the scripts, as an :class:`ObservationSet` on the routing data: a
    ``(G, D)`` table whose day 0 is NaN. Runs on ``device`` (default
    ``"cuda"``); ``cfg`` supplies ``params.attribute_minimums["slope"]`` and
    ``params.tau``."""
    import torch

    from ddr_tpu_torch.routing.mc import route
    from ddr_tpu_torch.routing.model import prepare_batch
    from ddr_tpu_torch.scripts_utils import compute_daily_runoff

    network, channels, gauges = prepare_batch(
        basin.routing_data, slope_min=cfg.params.attribute_minimums["slope"], device=device
    )
    dev = network.device
    params = {
        k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        for k, v in basin.true_params.items()
    }
    with torch.no_grad():
        res = route(network, channels, params, torch.as_tensor(basin.q_prime, device=dev),
                    gauges=gauges, device=dev)
    daily = compute_daily_runoff(res.runoff.T, tau=cfg.params.tau)  # (G, D-2)
    basin.obs_daily = daily.T

    rd = basin.routing_data
    full = np.full((daily.shape[0], len(rd.dates.daily_time_range)), np.nan, dtype=np.float32)
    full[:, 1 : 1 + daily.shape[1]] = daily
    rd.observations = ObservationSet(
        gage_ids=list(rd.gage_catchment), time=rd.dates.daily_time_range, streamflow=full
    )
    return basin


class Synthetic:
    """The dataset protocol over one generated, observed basin.

    Training mode iterates gauges and draws a fresh ``rho``-day window per
    batch; inference iterates days over the full-domain routing data.
    :meth:`streamflow` slices the generated hourly forcing to a batch's
    window. The twin's observations are routed on ``device`` (default
    ``cfg.device``); everything the dataset hands out is host numpy.
    """

    def __init__(self, cfg, device=None) -> None:
        self.cfg = cfg
        n_days = len(
            Dates(start_time=cfg.experiment.start_time, end_time=cfg.experiment.end_time)
            .daily_time_range
        )
        self.basin = observe(
            make_basin(
                n_segments=cfg.synthetic_segments or 64,
                n_gauges=4,
                n_days=n_days,
                seed=cfg.np_seed,
                start_time=cfg.experiment.start_time,
                depth=cfg.synthetic_depth,
            ),
            cfg,
            device=cfg.device if device is None else device,
        )
        self.routing_data = self.basin.routing_data
        self.dates = Dates(
            start_time=cfg.experiment.start_time,
            end_time=cfg.experiment.end_time,
            rho=cfg.experiment.rho,
        )
        self.routing_data.dates = self.dates
        self.gage_ids = np.asarray(self.routing_data.gage_catchment)
        self._rng = np.random.default_rng(cfg.np_seed)
        self._full_obs = self.routing_data.observations

    def __len__(self) -> int:
        if self.cfg.mode == Mode.training:
            return len(self.gage_ids)
        return len(self.dates.daily_time_range)

    def __getitem__(self, idx: int):
        if self.cfg.mode == Mode.training:
            return str(self.gage_ids[idx])
        return idx

    def collate_fn(self, batch: list) -> RoutingData:
        """A batch's RoutingData with a SNAPSHOT of its window
        (``Dates.snapshot``) and its observations cut to it; the shared
        ``self.routing_data`` is never mutated, so batches stay valid while
        later ones are prepared ahead."""
        if self.cfg.mode == Mode.training:
            self.dates.calculate_time_period(self._rng)
        else:
            indices = list(batch)
            if 0 not in indices:
                indices.insert(0, indices[0] - 1)  # the previous day keeps chunks continuous
            self.dates.set_date_range(np.asarray(indices))
        obs = ObservationSet(
            gage_ids=list(self._full_obs.gage_ids),
            time=np.asarray(self.dates.batch_daily_time_range),
            streamflow=self._full_obs.streamflow[:, self.dates.daily_indices],
        )
        return dataclasses.replace(self.routing_data, dates=self.dates.snapshot(), observations=obs)

    def streamflow(self, **kwargs) -> np.ndarray:
        """``(T_batch, N)`` hourly lateral inflow of the batch's window."""
        rd = kwargs["routing_dataclass"]
        return self.basin.q_prime[rd.dates.hourly_indices]
