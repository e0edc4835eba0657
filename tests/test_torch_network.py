"""The port's wavefront tables against ``ddr_tpu.routing.network.build_network``.

The port keeps its own copy of the numpy builders; the tables it puts on the
device must equal the JAX package's exactly, field for field, so the two
engines route identical schedules.
"""

from __future__ import annotations

import numpy as np
import pytest

from ddr_tpu.geodatazoo.synthetic import make_deep_network as jax_make_deep_network
from ddr_tpu.routing.network import build_network as jax_build_network
from ddr_tpu_torch.geodatazoo.synthetic import make_deep_network
from ddr_tpu_torch.routing.network import build_network, compute_levels, single_ring_eligible


def _random_dag(rng, n, max_in=4, p_edge=0.8):
    """Topologically ordered random DAG with bounded in-degree (rows = targets)."""
    rows, cols = [], []
    for i in range(1, n):
        if rng.random() > p_edge:
            continue
        k = int(rng.integers(1, max_in + 1))
        for p in np.atleast_1d(rng.choice(i, size=min(k, i), replace=False)):
            rows.append(i)
            cols.append(int(p))
    return np.asarray(rows, np.int64), np.asarray(cols, np.int64)


def _topologies():
    rng = np.random.default_rng(7)
    dag = _random_dag(rng, 96)
    deep = make_deep_network(128, 16, seed=3)
    chain = (np.arange(1, 40, dtype=np.int64), np.arange(0, 39, dtype=np.int64))
    return {"random-dag": (dag, 96), "deep": (deep, 128), "chain": (chain, 40)}


TOPOLOGIES = _topologies()


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_tables_equal_jax_build_network(name):
    (rows, cols), n = TOPOLOGIES[name]
    ref = jax_build_network(rows, cols, n)
    net = build_network(rows, cols, n, device="cpu")
    assert ref.wavefront and net.single_ring
    assert net.n == ref.n and net.depth == ref.depth and net.n_edges == ref.n_edges
    for field in ("level", "wf_perm", "wf_inv", "wf_idx", "wf_mask", "wf_t_idx"):
        np.testing.assert_array_equal(
            getattr(net, field).numpy(), np.asarray(getattr(ref, field)), err_msg=field
        )
    assert net.wf_buckets == ref.wf_buckets
    assert net.wf_level_runs == ref.wf_level_runs
    assert net.wf_ring_rows == ref.wf_ring_rows
    assert net.wf_t_width == ref.wf_t_width


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_kernel_fields_are_consistent_with_flat_table(name):
    """``wf_row``/``wf_col`` split ``wf_idx``; ``wf_slot``/``wf_width`` walk
    the buckets; ``level_p`` is ``level`` in wf order; every slot addresses a
    ring row the kernel may read."""
    (rows, cols), n = TOPOLOGIES[name]
    net = build_network(rows, cols, n, device="cpu")
    row_len = n + 1
    idx = net.wf_idx.numpy()
    np.testing.assert_array_equal(net.wf_row.numpy() * row_len + net.wf_col.numpy(), idx)
    assert net.wf_row.max() < net.wf_ring_rows - 1 and net.wf_col.max() <= n
    np.testing.assert_array_equal(net.level_p.numpy(), net.level.numpy()[net.wf_perm.numpy()])
    slot, width = net.wf_slot.numpy(), net.wf_width.numpy()
    off = 0
    n_deg0 = net.wf_buckets[0][0]
    assert (width[:n_deg0] == 0).all()
    for start, end, w in net.wf_buckets:
        np.testing.assert_array_equal(slot[start:end], off + np.arange(end - start) * w)
        assert (width[start:end] == w).all()
        off += (end - start) * w
    assert off == idx.size


def test_deep_generator_matches_jax_stream():
    np.testing.assert_array_equal(
        np.stack(make_deep_network(200, 24, seed=5)),
        np.stack(jax_make_deep_network(200, 24, seed=5)),
    )


def test_no_edge_network_builds_empty_tables():
    empty = np.zeros(0, np.int64)
    net = build_network(empty, empty, 6, wavefront=True, device="cpu")
    assert net.depth == 0 and net.wf_ring_rows == 2 and net.wf_buckets == ()
    assert net.wf_idx.numel() == 0 and (net.wf_width == 0).all() and net.wf_width.numel() == 6
    assert not net.single_ring  # as in the JAX package: no single-ring engine at depth 0
    # left to the JAX rule, a depth-0 network gets no wavefront tables: the step engine routes it
    plain, ref = build_network(empty, empty, 6, device="cpu"), jax_build_network(empty, empty, 6)
    assert not plain.wavefront and not ref.wavefront and plain.wf_ring_rows == ref.wf_ring_rows == 0


def test_levels_and_eligibility():
    rows, cols = np.array([2, 2, 3]), np.array([0, 1, 2])
    np.testing.assert_array_equal(compute_levels(rows, cols, 4), [0, 0, 1, 2])
    assert single_ring_eligible(2, 2, 4)
    assert not single_ring_eligible(2000, 2, 4)
    with pytest.raises(ValueError, match="cycle"):
        compute_levels(np.array([1, 0]), np.array([0, 1]), 2)
