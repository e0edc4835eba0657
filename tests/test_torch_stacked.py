"""The port's stacked band frame against ``ddr_tpu.routing.stacked.build_stacked_chunked``.

The port keeps its own copy of the numpy builder; the frame it puts on the
device must equal the JAX package's field for field (values and dtypes) for
the same band count, so both routers run identical schedules. Topologies: a
random DAG, a high in-degree confluence (a power-of-two gather bucket of
width 128), a braided fan-out (transposed width above 1) and a deep
synthetic basin, each with explicit cell budgets; then the auto band count
with the same cost constants given to both packages (JAX reads them from
``DDR_WAVE_FIXED_US``/``DDR_WAVE_RING_GBPS``, the port from its module
constants), and the engine ``build_routing_network`` picks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from ddr_tpu.routing import chunked as jax_chunked
from ddr_tpu.routing import stacked as jax_stacked
from ddr_tpu.routing.chunked import build_routing_network as jax_build_routing_network
from ddr_tpu_torch.geodatazoo.synthetic import make_deep_network
from ddr_tpu_torch.routing import stacked
from ddr_tpu_torch.routing.chunked import build_routing_network
from ddr_tpu_torch.routing.model import engine_label
from ddr_tpu_torch.routing.network import RiverNetwork, compute_levels
from ddr_tpu_torch.routing.stacked import StackedChunked, build_stacked_chunked
from tests.test_torch_network import _random_dag


def confluence(n=160, fan_in=100):
    """A chain whose node ``fan_in`` gathers 100 headwaters (in-degree above
    the single-ring cap of 64), with side tributaries further down."""
    rows = list(range(fan_in + 1, n)) + [fan_in] * fan_in + [fan_in + 20] * 3
    cols = list(range(fan_in, n - 1)) + list(range(fan_in)) + [fan_in + 5, fan_in + 9, fan_in + 12]
    return np.asarray(rows, np.int64), np.asarray(cols, np.int64), n


def braided(n=120, seed=9):
    """A DAG whose reaches have up to 3 predecessors and any number of
    successors (transposed width above 1)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 4, n)
    rows = np.repeat(np.arange(1, n), np.minimum(k[1:], np.arange(1, n)))
    cols = np.concatenate([rng.choice(i, size=min(int(k[i]), i), replace=False) for i in range(1, n)])
    return rows.astype(np.int64), cols.astype(np.int64), n


def topologies():
    rows, cols = _random_dag(np.random.default_rng(21), 96)
    deep = make_deep_network(400, 60, seed=4)
    return {
        "random-dag": (rows, cols, 96),
        "confluence": confluence(),
        "braided": braided(),
        "deep-basin": (*deep, 400),
    }


TOPOLOGIES = topologies()
BUDGETS = (40, 300, 5000)


def assert_frames_equal(ours: StackedChunked, ref) -> None:
    for field in dataclasses.fields(ref):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        if torch.is_tensor(a):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype, field.name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=field.name)
        else:
            assert a == b, field.name


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_frame_equals_jax_with_explicit_budget(name, budget):
    rows, cols, n = TOPOLOGIES[name]
    ours = build_stacked_chunked(rows, cols, n, cell_budget=budget, device="cpu")
    assert_frames_equal(ours, jax_stacked.build_stacked_chunked(rows, cols, n, cell_budget=budget))
    if budget == BUDGETS[0]:
        assert ours.n_chunks > 2 and ours.n_boundary > 0
    if name == "braided":
        assert ours.t_width > 1
    if name == "confluence" and budget == BUDGETS[-1]:  # the confluence lies in one band
        assert ours.buckets[0][2] == 128


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_slot_runs_walk_the_frame_buckets(name):
    """``wf_slot``/``wf_width`` give every slot its run of the flat gather
    table, width 0 on the profile's tail (the kernel's slot loop is then
    empty), and every gather slot addresses a ring row the kernels may read."""
    rows, cols, n = TOPOLOGIES[name]
    f = build_stacked_chunked(rows, cols, n, cell_budget=BUDGETS[0], device="cpu")
    slot, width = f.wf_slot.numpy(), f.wf_width.numpy()
    assert f.buckets[0][0] == 0 and f.buckets[-1][1] == f.n_cap
    off = 0
    for start, end, w in f.buckets:
        np.testing.assert_array_equal(slot[start:end], off + np.arange(end - start) * w)
        assert (width[start:end] == w).all()
        off += (end - start) * w
    assert off == int(width.sum()) <= f.wf_row.shape[1]
    assert any(w == 0 for *_, w in f.buckets)
    assert f.wf_row.max() < f.ring_rows - 1 and f.wf_col.max() <= f.n_cap
    assert f.t_row.max() < f.ring_rows - 1 and f.t_col.max() <= f.n_cap
    band = f.band(1)
    assert band.n == f.n_cap and band.depth == f.span_max and band.frame is f
    assert torch.equal(band.level_p, f.level[1]) and band.level_p.is_contiguous()


@pytest.mark.parametrize("constants", [(5.5, "inf"), (30.0, "1")], ids=["h100", "several-bands"])
def test_auto_frame_equals_jax_with_the_same_constants(monkeypatch, constants):
    fixed_us, ring_gbps = constants
    monkeypatch.setenv("DDR_WAVE_FIXED_US", str(fixed_us))
    monkeypatch.setenv("DDR_WAVE_RING_GBPS", ring_gbps)
    monkeypatch.setattr(stacked, "WAVE_FIXED_S", fixed_us * 1e-6)
    monkeypatch.setattr(stacked, "RING_COPY_BYTES_PER_S", float(ring_gbps) * 1e9)
    assert jax_chunked.wave_cost_constants() == (fixed_us * 1e-6, float(ring_gbps) * 1e9)
    rows, cols = make_deep_network(1100, 1030, seed=3)
    ours = build_stacked_chunked(rows, cols, 1100, device="cpu")
    assert_frames_equal(ours, jax_stacked.build_stacked_chunked(rows, cols, 1100))
    # the balanced packer cuts the last level off a 1-band plan, and 4
    # planned bands into 5 (node-heavy headwater levels)
    assert ours.n_chunks == (2 if ring_gbps == "inf" else 5)


def test_h100_constants_give_the_fewest_bands_the_cap_allows(monkeypatch):
    """With no ring-copy term the model takes the smallest power-of-two band
    count whose span-sized ring fits CHUNK_CELL_BUDGET: 16 at the continental
    shape (2.9 M reaches, depth 4000), as the JAX model gives with the same
    constants."""
    monkeypatch.setenv("DDR_WAVE_FIXED_US", "5.5")
    monkeypatch.setenv("DDR_WAVE_RING_GBPS", "inf")
    for cap in (None, 40):
        assert stacked.auto_band_count(2_900_000, 4000, ring_rows_cap=cap) == 16
        assert jax_stacked.auto_band_count(2_900_000, 4000, ring_rows_cap=cap) == 16
    assert stacked.auto_band_count(5000, 0) == 1


@pytest.mark.parametrize("name", ["chain-1100", "confluence", "shallow-tree", "no-edges"])
def test_build_routing_network_picks_the_jax_engine(name):
    if name == "chain-1100":
        n = 1100
        rows, cols = np.arange(1, n), np.arange(0, n - 1)
    elif name == "confluence":
        rows, cols, n = confluence()
    elif name == "shallow-tree":
        n = 200
        rows, cols = make_deep_network(n, 20, seed=1)
    else:
        n = 8
        rows = cols = np.zeros(0, np.int64)
    ours = build_routing_network(rows, cols, n, device="cpu")
    ref = jax_build_routing_network(rows, cols, n)
    assert type(ours).__name__ == type(ref).__name__
    if isinstance(ours, StackedChunked):
        assert engine_label(ours) == f"stacked-chunked-wavefront[{ref.n_chunks}-band-scan]"
        assert ours.n_chunks == ref.n_chunks and ours.span_max == ref.span_max
    else:
        assert isinstance(ours, RiverNetwork) and ours.single_ring == ref.wavefront
        assert engine_label(ours) == ("single-ring-wavefront" if ref.wavefront else "step")
    np.testing.assert_array_equal(compute_levels(rows, cols, n).max(initial=0), ours.depth)


def test_explicit_cell_budget_names_the_unported_unrolled_router():
    """An explicit cell budget selects the unrolled depth-chunked router,
    with the JAX builder's banding."""
    rows, cols = np.arange(1, 1100), np.arange(0, 1099)
    ours = build_routing_network(rows, cols, 1100, cell_budget=500, device="cpu")
    ref = jax_build_routing_network(rows, cols, 1100, cell_budget=500)
    assert type(ours).__name__ == type(ref).__name__ == "ChunkedNetwork"
    assert ours.n_chunks == ref.n_chunks > 1
    assert engine_label(ours) == f"depth-chunked-wavefront[{ref.n_chunks}-band]"
