"""The port's dates, synthetic dataset and loader against the JAX package's.

Held exactly (integer indices, day and hour stamps, gauge ids, the order of
a loader's batches and its RNG state): the ``Dates`` windows of 50 seeded
``calculate_time_period`` draws and of ``set_date_range`` chunks;
``Synthetic``'s batches in training and inference mode for the same
``np_seed`` (the lateral-inflow slice too, which both generators draw from
one stream); the ``DataLoader`` order over two epochs, with and without
``prefetch``, and after ``state``/``set_state``. The observations are the
twin experiment's routed gauge flows, made by each package's own route:
held to rtol 1e-5 with an absolute floor of 1e-5 x their largest value, the
tolerance of the port's route tests, with the NaN days equal.
"""

from __future__ import annotations

import numpy as np
import pytest

from ddr_tpu.geodatazoo.dataclasses import Dates as JaxDates
from ddr_tpu.geodatazoo.dataclasses import Gauge as JaxGauge
from ddr_tpu.geodatazoo.loader import DataLoader as JaxDataLoader
from ddr_tpu.geodatazoo.loader import prefetch as jax_prefetch
from ddr_tpu.geodatazoo.synthetic import Synthetic as JaxSynthetic
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch.geodatazoo.dataclasses import Dates, Gauge
from ddr_tpu_torch.geodatazoo.loader import DataLoader, PrefetchStats, prefetch
from ddr_tpu_torch.geodatazoo.synthetic import Synthetic
from ddr_tpu_torch.validation.configs import load_config

CONFIG = "examples/synthetic/config.yaml"
PERIODS = [("1981/10/01", "1982/01/31", 20), ("1981/12/30", "1982/03/02", 7),
           ("2000/02/20", "2000/03/05", 15), ("1981/10/01", "1981/10/03", 1)]


def _days(x):
    return np.asarray(x, dtype="datetime64[D]")


def _hours(x):
    return np.asarray(x, dtype="datetime64[h]")


def _same_window(ours: Dates, ref: JaxDates) -> None:
    np.testing.assert_array_equal(_days(ours.batch_daily_time_range), _days(ref.batch_daily_time_range))
    np.testing.assert_array_equal(_hours(ours.batch_hourly_time_range), _hours(ref.batch_hourly_time_range))
    for name in ("daily_indices", "hourly_indices", "numerical_time_range"):
        np.testing.assert_array_equal(getattr(ours, name), np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("start,end,rho", PERIODS)
def test_dates_windows_match_jax(start, end, rho):
    ours, ref = Dates(start_time=start, end_time=end, rho=rho), JaxDates(start_time=start, end_time=end, rho=rho)
    np.testing.assert_array_equal(_days(ours.daily_time_range), _days(ref.daily_time_range))
    np.testing.assert_array_equal(_hours(ours.hourly_time_range), _hours(ref.hourly_time_range))
    _same_window(ours, ref)
    rng_ours, rng_ref = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(50):
        ours.calculate_time_period(rng_ours)
        ref.calculate_time_period(rng_ref)
        _same_window(ours, ref)
        frozen = ours.snapshot()
        ours.calculate_time_period(np.random.default_rng(0))
        ref.calculate_time_period(np.random.default_rng(0))
        assert frozen.batch_daily_time_range is not ours.batch_daily_time_range
    n = len(ours.daily_time_range)
    for chunk in (np.arange(n), np.arange(n // 2, n), np.array([0]), np.array([n - 2, n - 1])):
        ours.set_date_range(chunk)
        ref.set_date_range(chunk)
        _same_window(ours, ref)
    np.testing.assert_array_equal(ours.create_time_windows(), ref.create_time_windows())


def test_dates_refuse_a_window_longer_than_the_period():
    with pytest.raises(ValueError):
        JaxDates(start_time="1981/10/01", end_time="1981/10/05", rho=6)
    with pytest.raises(ValueError):
        Dates(start_time="1981/10/01", end_time="1981/10/05", rho=6)


@pytest.mark.parametrize("row", [
    {"STAID": "1013500", "DRAIN_SQKM": "2252.7", "STANAME": " Fish River ", "LAT_GAGE": "47.2"},
    {"STAID": "01013500", "DRAIN_SQKM": "5", "COMID": "71"},
])
def test_gauge_rows_match_jax(row):
    ours, ref = Gauge.model_validate(row), JaxGauge.model_validate(row)
    assert (ours.STAID, ours.STANAME, ours.DRAIN_SQKM, ours.LAT_GAGE) == (
        ref.STAID, ref.STANAME, ref.DRAIN_SQKM, ref.LAT_GAGE)
    with pytest.raises(ValueError):
        Gauge.model_validate(dict(row, DRAIN_SQKM="0"))
    with pytest.raises(ValueError):
        JaxGauge.model_validate(dict(row, DRAIN_SQKM="0"))


def _datasets(mode: str, overrides=()):
    ov = ["device=cpu", f"mode={mode}", *overrides]
    ours = Synthetic(load_config(CONFIG, ov, save_config=False))
    ref = JaxSynthetic(jax_load_config(CONFIG, ov, save_config=False))
    return ours, ref


def _same_batch(ours, ref, q_ours, q_ref) -> None:
    _same_window(ours.dates, ref.dates)
    assert ours.observations.gage_ids == ref.observations.gage_ids == list(ours.gage_catchment)
    np.testing.assert_array_equal(q_ours, q_ref)
    a, b = ours.observations.streamflow, np.asarray(ref.observations.streamflow)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    finite = np.isfinite(b)
    np.testing.assert_allclose(a[finite], b[finite], rtol=1e-5, atol=1e-5 * np.abs(b[finite]).max())


@pytest.mark.parametrize("overrides", [[], ["synthetic_segments=96", "synthetic_depth=12", "np_seed=4"]],
                         ids=["shallow", "deep"])
def test_synthetic_training_batches_match_jax(overrides):
    ours, ref = _datasets("training", overrides)
    assert len(ours) == len(ref) == 4
    assert [ours[i] for i in range(len(ours))] == [ref[i] for i in range(len(ref))]
    np.testing.assert_array_equal(ours.basin.q_prime, ref.basin.q_prime)
    for _ in range(6):
        items = [ours[0], ours[2]]
        b_ours, b_ref = ours.collate_fn(items), ref.collate_fn(items)
        _same_batch(b_ours, b_ref, ours.streamflow(routing_dataclass=b_ours),
                    ref.streamflow(routing_dataclass=b_ref))
        np.testing.assert_array_equal(b_ours.normalized_spatial_attributes, b_ref.normalized_spatial_attributes)


def test_synthetic_inference_batches_match_jax():
    ours, ref = _datasets("testing")
    assert len(ours) == len(ref) and ours[5] == ref[5] == 5
    for chunk in ([0, 1, 2], [3, 4, 5], [10]):
        b_ours, b_ref = ours.collate_fn(chunk), ref.collate_fn(chunk)
        _same_batch(b_ours, b_ref, ours.streamflow(routing_dataclass=b_ours),
                    ref.streamflow(routing_dataclass=b_ref))


class _Items:
    """A dataset whose batches are the item lists themselves."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i

    def collate_fn(self, batch):
        return list(batch)


@pytest.mark.parametrize("ahead", [None, 1, 3])
def test_loader_order_and_state_match_jax(ahead):
    def epochs(loader_cls, pf, rng, n_epochs=2):
        loader = loader_cls(_Items(11), batch_size=3, shuffle=True, rng=rng, drop_last=True)
        out = []
        for _ in range(n_epochs):
            stream = iter(loader) if ahead is None else pf(iter(loader), lambda b: b, ahead=ahead)
            out.append(list(stream))
        return out, loader

    ours, loader = epochs(DataLoader, prefetch, np.random.default_rng(5))
    ref, jax_loader = epochs(JaxDataLoader, jax_prefetch, np.random.default_rng(5))
    assert ours == ref and len(ours[0]) == len(loader) == 3
    state = loader.state()
    assert repr(state) == repr(jax_loader.state())
    after, _ = epochs(DataLoader, prefetch, np.random.default_rng(5))
    resumed = DataLoader(_Items(11), batch_size=3, shuffle=True, rng=np.random.default_rng(99), drop_last=True)
    resumed.set_state(state)
    nxt = list(resumed)
    jax_loader_next = list(jax_loader)
    assert nxt == jax_loader_next and nxt != after[0]


def test_prefetch_keeps_synthetic_windows_in_order():
    """Batches prepared ahead keep their own windows: the stream through the
    pool equals the plain stream, batch for batch."""
    plain, _ = _datasets("training")
    pooled, _ = _datasets("training")
    rng = np.random.default_rng(0)
    stats = PrefetchStats()
    direct = [rd.dates.daily_indices for rd in DataLoader(plain, 2, True, np.random.default_rng(0), True)]
    ahead = [rd.dates.daily_indices for rd in
             prefetch(DataLoader(pooled, 2, True, rng, True), lambda rd: rd, ahead=2, stats=stats)]
    assert len(direct) == len(ahead) == 2
    for a, b in zip(direct, ahead):
        np.testing.assert_array_equal(a, b)
    assert stats.depth() is None
