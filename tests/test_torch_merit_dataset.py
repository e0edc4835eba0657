"""The port's ``Merit`` geodataset against the JAX package's, on the CPU.

Both read the example's stores (prepared by the port; equal to JAX's,
``tests/test_torch_merit_stores.py``) from one config and ``np_seed``. In
training, each collate draws the same window and builds the same gauge
union: every ``RoutingData`` array (topology, attributes raw and z-scored,
length, slope, x, divide ids, outflow indices, flow scale, observations) is
bit-equal. The three inference modes (target catchments, gauges, all
segments) give the same routing data and the same day windows.
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest

from ddr_tpu.geodatazoo.merit import Merit as JaxMerit
from ddr_tpu.validation.configs import load_config as jax_load_config
from ddr_tpu_torch.geodatazoo.loader import DataLoader
from ddr_tpu_torch.geodatazoo.lynker import LynkerHydrofabric
from ddr_tpu_torch.geodatazoo.merit import Merit
from ddr_tpu_torch.io import zarrlite
from ddr_tpu_torch.scripts.prepare_merit_example import prepare
from ddr_tpu_torch.validation.configs import load_config
from ddr_tpu_torch.validation.enums import GeoDataset

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "merit_basin"
MODES = {
    "target-catchments": ["mode=testing", 'data_sources.target_catchments=["107", "112"]'],
    "gauges": ["mode=testing"],
    "all-segments": ["mode=routing", "data_sources.gages=null"],
}


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    dst = tmp_path_factory.mktemp("merit_dataset") / "merit_basin"
    shutil.copytree(EXAMPLE, dst, ignore=shutil.ignore_patterns("data", "output"))
    prepare(dst)
    return dst


def data_overrides(example: Path, stats: str) -> list[str]:
    """The example config's ``data_sources`` as absolute paths."""
    d = example / "data"
    return [f"data_sources.attributes={d / 'attributes.zarr'}",
            f"data_sources.conus_adjacency={d / 'merit_conus_adjacency.zarr'}",
            f"data_sources.gages_adjacency={d / 'merit_gages_adjacency.zarr'}",
            f"data_sources.streamflow={d / 'streamflow.zarr'}",
            f"data_sources.observations={d / 'observations.zarr'}",
            f"data_sources.gages={example / 'gages.csv'}",
            f"data_sources.statistics={example / 'output' / stats}"]


def _datasets(example, overrides):
    path = example / "config.yaml"
    cfg = load_config(path, [*data_overrides(example, "port"), "device=cpu", *overrides], save_config=False)
    jcfg = jax_load_config(path, [*data_overrides(example, "jax"), *overrides], save_config=False)
    return Merit(cfg), JaxMerit(jcfg)


def _same(a, b, label):
    if b is None:
        assert a is None, label
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (label, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), label


def assert_same_routing_data(ours, ref) -> None:
    """Every field of two RoutingData equal, arrays bit for bit."""
    assert ours.n_segments == ref.n_segments
    for f in dataclasses.fields(ref):
        name = f.name
        a, b = getattr(ours, name), getattr(ref, name)
        if name == "dates":
            for k in ("numerical_time_range", "daily_indices", "hourly_indices"):
                _same(getattr(a, k), np.asarray(getattr(b, k)), k)
            np.testing.assert_array_equal(np.asarray(a.batch_hourly_time_range, "datetime64[h]"),
                                          np.asarray(b.batch_hourly_time_range, "datetime64[h]"))
        elif name == "observations":
            assert (a is None) == (b is None)
            if b is not None:
                assert a.gage_ids == b.gage_ids
                _same(a.streamflow, b.streamflow, "observations")
                np.testing.assert_array_equal(np.asarray(a.time, "datetime64[D]"), np.asarray(b.time, "datetime64[D]"))
        elif name == "outflow_idx":
            assert (a is None) == (b is None)
            if b is not None:
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    _same(x, y, name)
        elif name in ("gage_catchment", "n_segments"):
            assert a == b, name
        else:
            _same(a, b, name)


def test_training_collates_equal_jax(example):
    ours, ref = _datasets(example, ["mode=training"])
    assert len(ours) == len(ref) == 2 and [ours[i] for i in range(2)] == [ref[i] for i in range(2)]
    np.testing.assert_array_equal(ours.means, ref.means)
    np.testing.assert_array_equal(ours.stds, ref.stds)
    for batch in (["11111111", "22222222"], ["22222222"], ["11111111"], ["22222222", "11111111"]):
        a, b = ours.collate_fn(batch), ref.collate_fn(batch)
        assert_same_routing_data(a, b)
    assert a.n_segments == 12 and a.gage_catchment == [110, 107] and a.flow_scale.tolist() == [1.0] * 12


def test_training_loader_batches_equal_jax(example):
    """The seeded loader of ``ddr train`` over two epochs: the same gauge
    order and windows, and each batch's window frozen in its snapshot."""
    from ddr_tpu.geodatazoo.loader import DataLoader as JaxDataLoader

    ours, ref = _datasets(example, ["mode=training", "np_seed=3"])
    la = DataLoader(ours, batch_size=1, shuffle=True, rng=np.random.default_rng(0), drop_last=True)
    lb = JaxDataLoader(ref, batch_size=1, shuffle=True, rng=np.random.default_rng(0), drop_last=True)
    batches = list(la) + list(la)
    for a, b in zip(batches, list(lb) + list(lb)):
        assert_same_routing_data(a, b)
    assert len({int(b.dates.numerical_time_range[0]) for b in batches}) > 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_inference_modes_equal_jax(example, mode):
    ours, ref = _datasets(example, MODES[mode])
    assert len(ours) == len(ref) == 182
    assert_same_routing_data(ours.routing_data, ref.routing_data)
    n = {"target-catchments": 8, "gauges": 12, "all-segments": 12}[mode]
    assert ours.routing_data.n_segments == n
    for days in ([0, 1, 2], [3, 4, 5], [180, 181]):
        assert_same_routing_data(ours.collate_fn(days), ref.collate_fn(days))


def test_factory_returns_merit_and_refuses_lynker(example, tmp_path):
    """The factory builds the dataset each name asks for: ``Merit`` on the
    example's stores, and ``LynkerHydrofabric`` once the conus store carries
    the Lynker flowpath arrays (top width, side slope, Muskingum x)."""
    cfg = load_config(example / "config.yaml", [*data_overrides(example, "port"), "device=cpu"], save_config=False)
    assert isinstance(GeoDataset.merit.get_dataset_class(cfg), Merit)
    conus = tmp_path / "conus.zarr"
    shutil.copytree(example / "data" / "merit_conus_adjacency.zarr", conus)
    group = zarrlite.open_group(conus)
    n = len(group["order"].read())
    for name, value in (("top_width", 5.0), ("side_slope", 1.5), ("muskingum_x", 0.25)):
        group.create_array(name, np.full(n, value, dtype=np.float32))
    cfg = load_config(example / "config.yaml", [*data_overrides(example, "port"), "device=cpu",
                                                f"data_sources.conus_adjacency={conus}",
                                                "experiment.max_area_diff_sqkm=null"], save_config=False)
    lynker = GeoDataset.lynker_hydrofabric.get_dataset_class(cfg)
    assert isinstance(lynker, LynkerHydrofabric) and not isinstance(lynker, Merit)
    assert (lynker.flowpath_arrays["x"] == 0.25).all()


def test_training_without_gauges_raises(example):
    cfg = load_config(example / "config.yaml", [*data_overrides(example, "port"), "device=cpu",
                                                "data_sources.gages=null"], save_config=False)
    with pytest.raises(ValueError, match="gages"):
        Merit(cfg)
