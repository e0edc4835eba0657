"""The port's wave scan against the JAX package's two forward scans.

``wave_scan_reference`` (the plain PyTorch version of the CUDA kernel) runs
on identical tables, inflow rows and physics as
``ddr_tpu.routing.pallas_kernel.fused_wave_scan`` (the real Pallas body,
interpreted on the CPU) and ``ddr_tpu.routing.wavefront._run_wave_scan``
(the XLA scan). Cases: in-band hotstart, carried ``q_init``, ``T = 1`` and a
network with no edges. Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x
the largest magnitude, the forward tolerance of the JAX package's own kernel
and adjoint tests (float32 physics in XLA and PyTorch differ by ulps, and
the recurrence carries them along the longest path).

The CUDA kernel itself runs only on a card: its tests are in
``test_torch_cuda.py``, marked ``cuda``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing.pallas_kernel import fused_wave_scan
from ddr_tpu.routing.wavefront import _run_wave_scan
from ddr_tpu_torch.routing import mc
from ddr_tpu_torch.routing.network import build_network
from ddr_tpu_torch.routing.wave_kernel import (
    ReachPhysics,
    _check_tables,
    reduce_gathered,
    wave_scan,
    wave_scan_reference,
)
from tests.test_torch_network import _random_dag

LB = 1e-4


def _close(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-8)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


def _physics(rng, n):
    """Per-reach physics in wf order, as numpy float32 arrays."""
    return {
        "n": rng.uniform(0.02, 0.06, n), "p": rng.uniform(5.0, 30.0, n),
        "q": rng.uniform(0.2, 0.8, n), "slope": rng.uniform(1e-3, 1e-2, n),
        "length": rng.uniform(500.0, 5000.0, n), "x": rng.uniform(0.1, 0.4, n),
    }


def _torch_physics(ph, device="cpu"):
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in ph.items()}
    return ReachPhysics(
        n=t["n"], p_spatial=t["p"], q_spatial=t["q"],
        channels=mc.ChannelState(length=t["length"], slope=t["slope"], x_storage=t["x"]),
        bounds=mc.Bounds(discharge=LB), dt=mc.DT_SECONDS,
    )


def _jax_physics_fn(ph):
    j = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in ph.items()}
    ch = jax_mc.ChannelState(length=j["length"], slope=j["slope"], x_storage=j["x"])
    bounds = jax_mc.Bounds(discharge=LB)

    def physics(q_prev):
        c = jax_mc.celerity(q_prev, j["n"], j["p"], j["q"], ch, bounds)[0]
        return jax_mc.muskingum_coefficients(ch.length, c, ch.x_storage, jax_mc.DT_SECONDS)

    return physics


def _case(name, device="cpu"):
    rng = np.random.default_rng(sum(ord(c) for c in name))
    if name == "no-edges":
        n, T = 10, 6
        rows = cols = np.zeros(0, np.int64)
    else:
        n, T = 64, 1 if name == "T=1" else 12
        rows, cols = _random_dag(rng, n)
    net = build_network(rows, cols, n, wavefront=True, device=device)  # tables at depth 0 too
    W = T + net.depth
    B = 2
    qs = rng.uniform(0.0, 2.0, (B, W, n)).astype(np.float32)
    qs[rng.random((B, W, n)) < 0.25] = 0.0  # drives raw values below the clamp
    q_init = rng.uniform(0.0, 3.0, (B, n)).astype(np.float32) if name == "q_init" else None
    return net, _physics(rng, n), qs, q_init, T


CASES = ("hotstart", "q_init", "T=1", "no-edges")


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_pallas_and_xla_scans(name):
    net, ph, qs, q_init, T = _case(name)
    n, depth, R = net.n, net.depth, net.wf_ring_rows
    ys = wave_scan_reference(
        torch.as_tensor(qs), net, _torch_physics(ph),
        None if q_init is None else torch.as_tensor(q_init), T=T,
    ).numpy()
    assert ys.shape == qs.shape and np.isfinite(ys).all()

    physics = _jax_physics_fn(ph)
    lvl = jnp.asarray(net.level_p.numpy())
    wf_idx = jnp.asarray(net.wf_idx.numpy())
    mask = jnp.asarray(net.wf_mask.numpy())
    for b in range(qs.shape[0]):
        qi = None if q_init is None else jnp.asarray(q_init[b])
        pallas = fused_wave_scan(
            physics, lvl, jnp.asarray(net.wf_row.numpy()), jnp.asarray(net.wf_col.numpy()),
            mask, net.wf_buckets, jnp.asarray(qs[b]), q_init=qi,
            T=T, n=n, span=depth, lb=LB, interpret=True, ring_rows=R,
        )
        xla = _run_wave_scan(
            physics, lvl, wf_idx, mask, net.wf_buckets, T=T, n=n, depth=depth,
            qs=jnp.asarray(qs[b]), xe=None, se=None, has_ext=False, q_init=qi,
            discharge_lb=LB, ring_rows=R,
        )
        _close(pallas, ys[b], f"{name}: reference vs fused_wave_scan, request {b}")
        _close(xla, ys[b], f"{name}: reference vs _run_wave_scan, request {b}")


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    net, ph, qs, q_init, T = _case("q_init")
    phys = _torch_physics(ph)
    args = (torch.as_tensor(qs), net, phys, torch.as_tensor(q_init))
    before = wave_scan.launches
    torch.testing.assert_close(wave_scan(*args, T=T), wave_scan_reference(*args, T=T),
                               rtol=0, atol=0)
    assert wave_scan.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wave_scan(torch.as_tensor(qs, device="meta"), net, phys, None, T=T)


def test_table_range_check_rejects_out_of_range_rows():
    net, *_ = _case("hotstart")
    _check_tables(net)
    bad = dataclasses.replace(net, wf_row=net.wf_row.clone().fill_(net.wf_ring_rows - 1))
    with pytest.raises(ValueError, match="out of range"):
        _check_tables(bad)


def test_reduce_gathered_sums_raw_and_clamped_per_bucket():
    # 1 node without predecessors, 2 of width 1, 1 of width 2 (one pad slot)
    buckets = ((1, 3, 1), (3, 4, 2))
    gathered = torch.tensor([[0.5, -1.0, 2.0, 0.0]])
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    raw = reduce_gathered(gathered, mask, buckets, 1, 0.1, False, False)
    clamped = reduce_gathered(gathered, mask, buckets, 1, 0.1, True, False)
    torch.testing.assert_close(raw, torch.tensor([[0.0, 0.5, -1.0, 2.0]]))
    torch.testing.assert_close(clamped, torch.tensor([[0.0, 0.5, 0.1, 2.0]]))
