"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA card and skip without one. The file imports
neither ``jax`` nor ``ddr_tpu``, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x the largest magnitude.
The kernel evaluates the same float32 operations as the plain version
without FMA contraction, but the card's ``powf`` and PyTorch's ``pow`` may
differ by an ulp, and the recurrence carries that along the longest path.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ddr_tpu_torch.geodatazoo.synthetic import make_basin, make_deep_network
from ddr_tpu_torch.routing import mc
from ddr_tpu_torch.routing.model import prepare_batch
from ddr_tpu_torch.routing.network import build_network
from ddr_tpu_torch.routing.wave_kernel import ReachPhysics, wave_scan, wave_scan_reference
from ddr_tpu_torch.routing.wavefront import wavefront_route_core

CASES = ("hotstart", "q_init", "T=1", "no-edges")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(ref, out, label):
    ref, out = ref.double().cpu().numpy(), out.double().cpu().numpy()
    assert np.isfinite(out).all(), label
    scale = max(np.abs(ref).max(), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


def _case(name, dev):
    rng = np.random.default_rng(sum(ord(c) for c in name))
    if name == "no-edges":
        n, T = 10, 6
        rows = cols = np.zeros(0, np.int64)
    else:
        n, T = 256, 1 if name == "T=1" else 12
        rows, cols = make_deep_network(n, 16, seed=rng)
    net = build_network(rows, cols, n, device=dev)
    B, W = 3, T + net.depth

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    phys = ReachPhysics(
        n=f32(rng.uniform(0.02, 0.06, n)), p_spatial=f32(rng.uniform(5.0, 30.0, n)),
        q_spatial=f32(rng.uniform(0.2, 0.8, n)),
        channels=mc.ChannelState(length=f32(rng.uniform(500.0, 5000.0, n)),
                                 slope=f32(rng.uniform(1e-3, 1e-2, n)),
                                 x_storage=f32(rng.uniform(0.1, 0.4, n))),
        bounds=mc.Bounds(discharge=1e-4), dt=mc.DT_SECONDS,
    )
    qs = rng.uniform(0.0, 2.0, (B, W, n))
    qs[rng.random(qs.shape) < 0.25] = 0.0  # raw values below the discharge clamp
    q_init = f32(rng.uniform(0.0, 3.0, (B, n))) if name == "q_init" else None
    return net, phys, f32(qs), q_init, T


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_wave_scan_kernel_matches_reference(card, name):
    net, phys, qs, q_init, T = _case(name, card)
    before = wave_scan.launches
    ys = wave_scan(qs, net, phys, q_init, T=T)
    torch.cuda.synchronize()
    assert wave_scan.launches == before + 1
    _close(wave_scan_reference(qs, net, phys, q_init, T=T), ys, f"{name}: kernel vs plain")


@pytest.mark.cuda
def test_wave_scan_rejects_what_the_kernel_does_not_take(card):
    net, phys, qs, _, T = _case("hotstart", card)
    with pytest.raises(ValueError, match="float32"):
        wave_scan(qs.to(torch.bfloat16), net, phys, None, T=T)
    with pytest.raises(ValueError, match="contiguous"):
        wave_scan(qs.transpose(0, 1).contiguous().transpose(0, 1), net, phys, None, T=T)
    with pytest.raises(ValueError, match="does not match"):
        wave_scan(qs[:, 1:].contiguous(), net, phys, None, T=T)


@pytest.mark.cuda
def test_route_on_the_card_runs_the_kernel(card):
    basin = make_basin(n_segments=512, n_gauges=4, n_days=2, seed=3, depth=24)
    net, ch, gauges = prepare_batch(basin.routing_data, 0.001, device=card)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=card)
              for k, v in basin.true_params.items()}
    q = torch.as_tensor(basin.q_prime[:24], device=card)
    batch = torch.stack([q, 0.5 * q])
    with torch.no_grad():
        before = wave_scan.launches
        out = mc.route(net, ch, params, batch, gauges=gauges, device=card)
        torch.cuda.synchronize()
        assert wave_scan.launches == before + 1
        ref = mc.route(net, ch, params, batch, gauges=gauges, kernel="reference", device=card)
    assert wave_scan.launches == before + 1  # the plain path launches nothing
    _close(ref.runoff, out.runoff, "gauge runoff")
    _close(ref.final_discharge, out.final_discharge, "final discharge")


@pytest.mark.cuda
def test_engine_raises_on_inputs_that_require_grad(card):
    net, phys, qs, _, T = _case("hotstart", card)
    q = torch.ones(2, T, net.n, device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        wavefront_route_core(net, phys, q, None)
