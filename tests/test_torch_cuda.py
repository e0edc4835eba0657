"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA card and skip without one. They cover both
time-major kernels (``wave_scan_tm``, ``reverse_scan_tm``) on the single
ring and on the bands of a stacked frame (external series, ``mask_raw``,
width-0 gather buckets, transposed width 16), the forward kernel's bf16 ring
on both, a network wide enough that a reach's pair moves between threads
and blocks from wave to wave, a NaN-poisoned inflow, the stacked band router
on the card (``n_chunks`` launches of each kernel), the unrolled chunked
router's variant (a band's own ring with external series and unmasked raw
sums, a band of local depth 0) and its route, and the step engine in
float64 on the card. The file imports
neither ``jax`` nor ``ddr_tpu``, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x the largest magnitude.
The kernels evaluate the same float32 operations as the plain versions
without FMA contraction, but the card's ``powf`` and PyTorch's ``pow`` may
differ by an ulp, the plain reverse scan may sum a node's successor slots in
another order, and the recurrences carry that along the longest path.
The bf16 ring: ``|a - b| <= 2**-7 |ref| + 1e-5 max|ref|``, one bf16 epsilon,
since a ``powf`` ulp can flip one rounding and the flip carries downstream.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ddr_tpu_torch.geodatazoo.synthetic import make_basin, make_deep_network
from ddr_tpu_torch.routing import mc
from ddr_tpu_torch.routing.chunked import ChunkedNetwork, build_routing_network
from ddr_tpu_torch.routing.model import prepare_batch
from ddr_tpu_torch.routing.network import build_network
from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm, reverse_scan_tm_reference
from ddr_tpu_torch.routing.stacked import StackedChunked
from ddr_tpu_torch.routing.wave_kernel import (
    ReachPhysics,
    wave_scan,
    wave_scan_reference,
    wave_scan_tm,
    wave_scan_tm_reference,
)
from ddr_tpu_torch.routing.wavefront import _ext_skews, _input_skews, _skew_by_level_runs
from chip_smoke import (
    band_frame,
    band_scan_case,
    fan_out_network,
    random_physics,
    reverse_inputs,
    reverse_streams,
    scan_case,
    small_chunked,
)

CASES = ("hotstart", "q_init", "T=1", "no-edges")
REVERSE_CASES = ("tree", "fan-out", "T=1")
BAND_CASES = ("hotstart", "q_init", "T=1")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(ref, out, label, rtol=1e-5):
    ref, out = ref.double().cpu().numpy(), out.double().cpu().numpy()
    assert np.isfinite(out).all(), label
    scale = max(np.abs(ref).max(), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-5 * scale, err_msg=label)


def _case(name, dev):
    rng = np.random.default_rng(sum(ord(c) for c in name))
    if name == "no-edges":
        n, T = 10, 6
        rows = cols = np.zeros(0, np.int64)
    else:
        n, T = 256, 1 if name == "T=1" else 12
        rows, cols = make_deep_network(n, 16, seed=rng)
    net = build_network(rows, cols, n, wavefront=True, device=dev)  # tables at depth 0 too
    B = 3

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
    q = rng.uniform(0.0, 2.0, (B, T, n))
    q[rng.random(q.shape) < 0.25] = 0.0  # raw values below the discharge clamp
    q_init = f32(rng.uniform(0.0, 3.0, (B, n))) if name == "q_init" else None
    return net, phys, f32(q), q_init, T


def _reverse_net(name, device):
    seed = sum(ord(c) for c in name)
    T = 1 if name == "T=1" else 12
    if name == "tree":
        net = build_network(*make_deep_network(96, 12, seed=seed), 96, device=device)
    else:
        net = fan_out_network(96, seed, device)
    return net, T, seed


def reverse_case(name, device="cpu"):
    """A network and reverse streams shaped as the analytic backward builds
    them (``chip_smoke.py``'s builders), in the pre-skewed layout: a
    dendritic tree (one successor a reach), a DAG with fan-out (``t_width >
    1``) or ``T = 1``."""
    net, T, seed = _reverse_net(name, device)
    return net, reverse_streams(net, 2, T, seed, device), T


@pytest.mark.cuda
@pytest.mark.parametrize("name", REVERSE_CASES)
def test_reverse_scan_kernel_matches_reference(card, name):
    net, T, seed = _reverse_net(name, card)
    rev = reverse_inputs(net, 2, T, seed, card)
    assert (net.wf_t_width > 1) == (name != "tree")
    before = reverse_scan_tm.launches
    lam = reverse_scan_tm(*rev, net)
    torch.cuda.synchronize()
    assert reverse_scan_tm.launches == before + 1
    _close(reverse_scan_tm_reference(*rev, net), lam, f"{name}: kernel vs plain")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_wave_scan_kernel_matches_reference(card, name):
    net, phys, q, q_init, T = _case(name, card)
    before = wave_scan_tm.launches
    raw = wave_scan_tm(q, net, phys, q_init)
    torch.cuda.synchronize()
    assert wave_scan_tm.launches == before + 1
    _close(wave_scan_tm_reference(q, net, phys, q_init), raw, f"{name}: kernel vs plain")


@pytest.mark.cuda
def test_wave_scan_rejects_what_the_kernel_does_not_take(card):
    net, phys, q, _, T = _case("hotstart", card)
    with pytest.raises(ValueError, match="float32"):
        wave_scan_tm(q.to(torch.bfloat16), net, phys, None)
    with pytest.raises(ValueError, match="contiguous"):
        wave_scan_tm(q.transpose(0, 1).contiguous().transpose(0, 1), net, phys, None)
    with pytest.raises(ValueError, match="does not match"):
        wave_scan_tm(q[..., 1:].contiguous(), net, phys, None)
    with pytest.raises(ValueError, match="CPU tensors"):
        wave_scan(q, net, phys, None, T=T)  # the pre-skewed layout has no kernel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_time_major_kernels_where_pair_ownership_moves(card, dtype):
    """A network wide enough for a grid of many blocks: each wave's in-band
    ranges shift, so a reach's pair is owned by another thread, often on
    another SM, from wave to wave, and the carried ``s``, ``gx`` and ring
    must be read past L1."""
    rows, cols = make_deep_network(100_000, 100, seed=5)
    net = build_network(rows, cols, 100_000, device=card)
    phys = random_physics(net.n, 6, card)
    q, _ = scan_case(net, phys, 8, 24, 7, False, card)
    raw = wave_scan_tm(q, net, phys, None, compute_dtype=dtype)
    rev = reverse_inputs(net, 4, 24, 8, card)
    lam = reverse_scan_tm(*rev, net)
    torch.cuda.synchronize()
    ref = wave_scan_tm_reference(q, net, phys, None, compute_dtype=dtype)
    if dtype == "bf16":
        assert torch.equal(raw, ref), "bf16 kernel vs plain"
    else:
        _close(ref, raw, "fp32 kernel vs plain")
    _close(reverse_scan_tm_reference(*rev, net), lam, "reverse kernel vs plain")


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["ring", "band"])
def test_nan_poisoned_inflow_on_the_card(card, where):
    """A NaN in ``q'`` at one reach and timestep: the kernel's ``raw`` has
    the NaN pattern of the pre-skewed plain scan (the ring keeps a reach's
    stale values after its band, and no slot reads them)."""
    if where == "ring":
        net, phys, q, q_init, T = _case("hotstart", card)
        kw, skew_kw = {}, {}
    else:
        frame = band_frame(card)
        net = frame.band(1)
        phys = random_physics(frame.n_cap, 1, card)
        q, xe, se, q_init = band_scan_case(net, 3, 24, 1, False, card)
        T = 24
        kw = dict(x_ext=xe, s_ext=se, mask_raw=True)
        skew_kw = dict(zip(("xe", "se"), _ext_skews(xe, se, net.level_p.long(), net.depth, T)),
                       mask_raw=True)
    succ = net.wf_t_col.reshape(net.n, -1)[:, 0]
    i0 = int(torch.nonzero(succ < net.n)[0])
    q[:, T // 2, i0] = float("nan")
    raw = wave_scan_tm(q, net, phys, q_init, **kw)
    torch.cuda.synchronize()
    lvl = net.level_p.long()
    ys = wave_scan_reference(_input_skews(q, lvl, net.depth, T).contiguous(), net, phys, q_init, T=T,
                             **skew_kw)
    ref = _skew_by_level_runs(ys, lvl, T)
    nan = torch.isnan(ref)
    assert int(nan.sum()) > q.shape[0] and torch.equal(torch.isnan(raw), nan)
    _close(torch.nan_to_num(ref), torch.nan_to_num(raw), f"{where}: finite values")


@pytest.mark.cuda
def test_route_on_the_card_runs_the_kernel(card):
    basin = make_basin(n_segments=512, n_gauges=4, n_days=2, seed=3, depth=24)
    net, ch, gauges = prepare_batch(basin.routing_data, 0.001, device=card)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=card)
              for k, v in basin.true_params.items()}
    q = torch.as_tensor(basin.q_prime[:24], device=card)
    batch = torch.stack([q, 0.5 * q])
    with torch.no_grad():
        before = wave_scan_tm.launches
        out = mc.route(net, ch, params, batch, gauges=gauges, device=card)
        torch.cuda.synchronize()
        assert wave_scan_tm.launches == before + 1
        ref = mc.route(net, ch, params, batch, gauges=gauges, kernel="reference", device=card)
    assert wave_scan_tm.launches == before + 1  # the plain path launches nothing
    _close(ref.runoff, out.runoff, "gauge runoff")
    _close(ref.final_discharge, out.final_discharge, "final discharge")


@pytest.mark.cuda
@pytest.mark.parametrize("init", ["hotstart", "q_init"])
def test_engine_raises_on_inputs_that_require_grad(card, init):
    """Inputs that require grad: ``adjoint="ad"`` on the kernels raises
    (autograd runs through the plain scan only: ``kernel="reference"``); the
    analytic adjoint launches each kernel once, and its gradients are finite
    and match the plain scans'. The
    ``q_init`` case puts some initial states below the discharge bound and
    some on it."""
    basin = make_basin(n_segments=512, n_gauges=4, n_days=2, seed=3, depth=24)
    net, ch, gauges = prepare_batch(basin.routing_data, 0.001, device=card)
    q = torch.tensor(basin.q_prime[:24], device=card, requires_grad=True)
    params = {k: torch.tensor(v, dtype=torch.float32, device=card) for k, v in basin.true_params.items()}
    with pytest.raises(ValueError, match="kernel='reference'"):
        mc.route(net, ch, params, q, gauges=gauges, adjoint="ad", device=card)
    q_init = np.random.default_rng(4).uniform(0.0, 3.0, 512).astype(np.float32)
    q_init[::5] = 0.0
    q_init[1::7] = np.float32(mc.Bounds().discharge)
    grads = {}
    for kernel in (None, "reference"):
        params = {k: torch.tensor(v, dtype=torch.float32, device=card, requires_grad=True)
                  for k, v in basin.true_params.items()}
        q = torch.tensor(basin.q_prime[:24], device=card, requires_grad=True)
        qi = torch.tensor(q_init, device=card, requires_grad=True) if init == "q_init" else None
        before = (wave_scan_tm.launches, reverse_scan_tm.launches)
        out = mc.route(net, ch, params, q, q_init=qi, gauges=gauges, kernel=kernel, device=card)
        (out.runoff.sum() + out.final_discharge.sum()).backward()
        torch.cuda.synchronize()
        launched = 1 if kernel is None else 0
        assert (wave_scan_tm.launches, reverse_scan_tm.launches) == (before[0] + launched, before[1] + launched)
        grads[kernel] = [params["n"].grad, params["q_spatial"].grad, q.grad] + ([qi.grad] if qi is not None else [])
    for ref, got, label in zip(grads["reference"], grads[None], ("n", "q_spatial", "q_prime", "q_init")):
        assert torch.isfinite(got).all(), label
        _close(ref, got, f"{init}: gradient of {label}, kernels vs plain scans")


@pytest.mark.cuda
@pytest.mark.parametrize("name", BAND_CASES)
def test_band_wave_scan_kernel_matches_reference(card, name):
    frame = band_frame(card)
    T, B = (1, 2) if name == "T=1" else (24, 3)
    for c in range(frame.n_chunks):
        band = frame.band(c)
        phys = random_physics(frame.n_cap, c, card)
        q, xe, se, q_init = band_scan_case(band, B, T, c, name == "q_init", card)
        kw = dict(x_ext=xe, s_ext=se, mask_raw=True)
        before = wave_scan_tm.launches
        raw = wave_scan_tm(q, band, phys, q_init, **kw)
        torch.cuda.synchronize()
        assert wave_scan_tm.launches == before + 1
        _close(wave_scan_tm_reference(q, band, phys, q_init, **kw), raw, f"{name}: band {c}, kernel vs plain")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [24, 1])
def test_band_reverse_scan_kernel_matches_reference(card, T):
    frame = band_frame(card)
    assert frame.t_width > 1
    for c in range(frame.n_chunks):
        band = frame.band(c)
        rev = reverse_inputs(band, 2, T, c, card)
        before = reverse_scan_tm.launches
        lam = reverse_scan_tm(*rev, band)
        torch.cuda.synchronize()
        assert reverse_scan_tm.launches == before + 1
        _close(reverse_scan_tm_reference(*rev, band), lam, f"T {T}: band {c}, kernel vs plain")


@pytest.mark.cuda
def test_stacked_route_on_the_card_runs_the_band_kernels(card):
    """A basin deeper than the single-ring cap routes on the stacked band
    router: ``n_chunks`` launches of each kernel, and answers and gradients
    that match the plain scans'."""
    basin = make_basin(n_segments=3000, n_gauges=4, n_days=2, seed=3, depth=1100)
    net, ch, gauges = prepare_batch(basin.routing_data, 0.001, device=card)
    assert isinstance(net, StackedChunked) and net.n_chunks >= 2
    out = {}
    for kernel in (None, "reference"):
        params = {k: torch.tensor(v, dtype=torch.float32, device=card, requires_grad=True)
                  for k, v in basin.true_params.items()}
        q = torch.tensor(basin.q_prime[:24], device=card, requires_grad=True)
        before = (wave_scan_tm.launches, reverse_scan_tm.launches)
        res = mc.route(net, ch, params, q, gauges=gauges, kernel=kernel, device=card)
        (res.runoff.sum() + res.final_discharge.sum()).backward()
        torch.cuda.synchronize()
        launched = net.n_chunks if kernel is None else 0
        assert (wave_scan_tm.launches, reverse_scan_tm.launches) == (before[0] + launched, before[1] + launched)
        out[kernel] = [res.runoff.detach(), res.final_discharge.detach(), params["n"].grad, q.grad]
    for ref, got, label in zip(out["reference"], out[None], ("runoff", "final", "d/dn", "d/dq_prime")):
        assert torch.isfinite(got).all(), label
        _close(ref, got, f"stacked {label}, kernels vs plain scans")


@pytest.mark.cuda
def test_stacked_route_on_the_card_under_deterministic_algorithms(card):
    """The boundary buffer's duplicate pad writes do not turn the stacked
    route or its backward into an error when PyTorch is asked for
    deterministic algorithms."""
    basin = make_basin(n_segments=3000, n_gauges=4, n_days=2, seed=3, depth=1100)
    net, ch, gauges = prepare_batch(basin.routing_data, 0.001, device=card)
    params = {k: torch.tensor(v, dtype=torch.float32, device=card, requires_grad=True)
              for k, v in basin.true_params.items()}
    q = torch.as_tensor(basin.q_prime[:24], device=card)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        res = mc.route(net, ch, params, q, gauges=gauges, device=card)
        res.runoff.sum().backward()
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.isfinite(res.runoff).all() and torch.isfinite(params["n"].grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_bf16_wave_scan_kernel_matches_reference(card, name):
    net, phys, q, q_init, T = _case(name, card)
    before = wave_scan_tm.launches
    raw = wave_scan_tm(q, net, phys, q_init, compute_dtype="bf16")
    torch.cuda.synchronize()
    assert wave_scan_tm.launches == before + 1
    assert torch.equal(raw.to(torch.bfloat16).float(), raw)  # every value the rounded store
    ref = wave_scan_tm_reference(q, net, phys, q_init, compute_dtype="bf16")
    _close(ref, raw, f"{name}: bf16 kernel vs plain", rtol=2.0**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("name", BAND_CASES)
def test_bf16_band_wave_scan_kernel_matches_reference(card, name):
    frame = band_frame(card)
    T, B = (1, 2) if name == "T=1" else (24, 3)
    for c in range(frame.n_chunks):
        band = frame.band(c)
        phys = random_physics(frame.n_cap, c, card)
        q, xe, se, q_init = band_scan_case(band, B, T, c, name == "q_init", card)
        kw = dict(x_ext=xe, s_ext=se, mask_raw=True, compute_dtype="bf16")
        before = wave_scan_tm.launches
        raw = wave_scan_tm(q, band, phys, q_init, **kw)
        torch.cuda.synchronize()
        assert wave_scan_tm.launches == before + 1
        _close(wave_scan_tm_reference(q, band, phys, q_init, **kw), raw,
               f"{name}: band {c}, bf16 kernel vs plain", rtol=2.0**-7)


@pytest.mark.cuda
def test_wave_scan_compute_dtype_axis_on_the_card(card):
    """An unknown compute dtype raises before any launch; ``"fp32"`` is the
    default kernel bit for bit; bf16 differs from it, and the gauge runoff
    of a route through the kernels stays within the JAX bound (stated, as
    in ``tests/routing/test_pallas_kernel.py``, for a route's runoff: raw
    values near zero are differences of large terms that a bf16 ring moves
    by more)."""
    net, phys, q, q_init, T = _case("q_init", card)
    before = wave_scan_tm.launches
    with pytest.raises(ValueError, match="unknown routing dtype"):
        wave_scan_tm(q, net, phys, q_init, compute_dtype="fp16")
    assert wave_scan_tm.launches == before
    default = wave_scan_tm(q, net, phys, q_init)
    fp32 = wave_scan_tm(q, net, phys, q_init, compute_dtype="fp32")
    bf16 = wave_scan_tm(q, net, phys, q_init, compute_dtype="bf16")
    torch.cuda.synchronize()
    assert torch.equal(default, fp32) and not torch.equal(fp32, bf16)
    basin = make_basin(n_segments=512, n_gauges=4, n_days=2, seed=3, depth=24)
    net, ch, gauges = prepare_batch(basin.routing_data, 0.001, device=card)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=card) for k, v in basin.true_params.items()}
    q = torch.as_tensor(basin.q_prime[:24], device=card)
    with torch.no_grad():
        r32, r16 = (mc.route(net, ch, params, q, gauges=gauges, device=card, dtype=d).runoff
                    for d in ("fp32", "bf16"))
    rel = ((r16 - r32).abs() / (r32.abs() + 1e-6)).double()
    assert float(rel.max()) <= 0.3 and float(rel.mean()) <= 0.02


@pytest.mark.cuda
def test_bf16_route_and_health_on_the_card(card):
    """``route(dtype="bf16", collect_health=True)`` on the card, single ring
    and stacked: one (or ``n_chunks``) bf16 launch, answers and health as
    the plain scans give them."""
    for depth, n in ((24, 512), (1100, 3000)):
        basin = make_basin(n_segments=n, n_gauges=4, n_days=2, seed=3, depth=depth)
        net, ch, gauges = prepare_batch(basin.routing_data, 0.001, device=card)
        params = {k: torch.as_tensor(v, dtype=torch.float32, device=card) for k, v in basin.true_params.items()}
        q = torch.as_tensor(basin.q_prime[:24], device=card)
        out = {}
        with torch.no_grad():
            for kernel in (None, "reference"):
                before = wave_scan_tm.launches
                out[kernel] = mc.route(net, ch, params, q, gauges=gauges, kernel=kernel, device=card,
                                       dtype="bf16", collect_health=True, health_bands=4)
                torch.cuda.synchronize()
                launched = (net.n_chunks if isinstance(net, StackedChunked) else 1) if kernel is None else 0
                assert wave_scan_tm.launches == before + launched
        h = out[None].health
        assert int(h.overflow) == 0 and int(h.nonfinite) == 0 and np.isfinite(float(h.ulp_drift))
        _close(out["reference"].runoff, out[None].runoff, f"depth {depth}: bf16 runoff", rtol=2.0**-7)
        _close(out["reference"].health.band_q_max, h.band_q_max, f"depth {depth}: band_q_max", rtol=2.0**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", BAND_CASES)
def test_ext_wave_scan_kernel_matches_reference(card, name, dtype):
    """The unrolled chunked router's variant (a band's own single ring,
    external rows, unmasked raw sums) on every band of a small
    ``ChunkedNetwork`` and on a band of local depth 0."""
    deep, chain = small_chunked(card)
    T, B = (1, 2) if name == "T=1" else (24, 3)
    for i, net in enumerate([*deep.chunks, chain.chunks[-1]]):
        phys = random_physics(net.n, i, card)
        q, xe, se, q_init = band_scan_case(net, B, T, i, name == "q_init", card)
        kw = dict(x_ext=xe, s_ext=se, compute_dtype=dtype)
        before = wave_scan_tm.launches
        ys = wave_scan_tm(q, net, phys, q_init, **kw)
        torch.cuda.synchronize()
        assert wave_scan_tm.launches == before + 1
        ref = wave_scan_tm_reference(q, net, phys, q_init, **kw)
        if dtype == "bf16":
            assert torch.equal(ys, ref), f"{name}: band {i} ({net.depth=}), bf16 kernel vs plain"
        else:
            _close(ref, ys, f"{name}: band {i} ({net.depth=}), kernel vs plain")


@pytest.mark.cuda
def test_chunked_route_on_the_card_runs_a_kernel_per_band(card):
    """A ``ChunkedNetwork`` routes with one launch of each kernel a band,
    with answers and gradients that match the plain scans'."""
    basin = make_basin(n_segments=3000, n_gauges=4, n_days=2, seed=3, depth=1100)
    rd = basin.routing_data
    net = build_routing_network(rd.adjacency_rows, rd.adjacency_cols, rd.n_segments, cell_budget=400_000,
                                device=card)
    _, ch, gauges = prepare_batch(rd, 0.001, device=card)
    assert isinstance(net, ChunkedNetwork) and net.n_chunks >= 2
    out = {}
    for kernel in (None, "reference"):
        params = {k: torch.tensor(v, dtype=torch.float32, device=card, requires_grad=True)
                  for k, v in basin.true_params.items()}
        q = torch.tensor(basin.q_prime[:24], device=card, requires_grad=True)
        before = (wave_scan_tm.launches, reverse_scan_tm.launches)
        res = mc.route(net, ch, params, q, gauges=gauges, kernel=kernel, device=card)
        (res.runoff.sum() + res.final_discharge.sum()).backward()
        torch.cuda.synchronize()
        launched = net.n_chunks if kernel is None else 0
        assert (wave_scan_tm.launches, reverse_scan_tm.launches) == (before[0] + launched, before[1] + launched)
        out[kernel] = [res.runoff.detach(), res.final_discharge.detach(), params["n"].grad, q.grad]
    for ref, got, label in zip(out["reference"], out[None], ("runoff", "final", "d/dn", "d/dq_prime")):
        assert torch.isfinite(got).all(), label
        _close(ref, got, f"chunked {label}, kernels vs plain scans")


#: JAX's own float32 single-ring wavefront (on the CPU) against JAX's own
#: float64 step route on :func:`step_oracle_case`'s inputs: ``(rel_max,
#: 1 - NSE)``. ``tests/test_torch_numerics.py`` recomputes them with the JAX
#: package and holds the port's float64 step route to JAX's within 1e-12.
JAX_STEP_ORACLE_ERRORS = (1.0152487160467283e-04, 7.784984331988817e-12)


def step_oracle_case(dtype, device):
    """A 400-reach, depth-40 network with 24 h of inflow: ``(network,
    channels, params, q_prime)`` in ``dtype`` on ``device``; the inputs are
    the same draws in every dtype."""
    rows, cols = make_deep_network(400, 40, seed=1)
    net = build_network(rows, cols, 400, device=device)
    rng = np.random.default_rng(2)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    ch = mc.ChannelState(length=t(rng.uniform(1000, 5000, 400)), slope=t(rng.uniform(1e-3, 1e-2, 400)),
                         x_storage=t(np.full(400, 0.3)))
    params = {k: t(np.full(400, v)) for k, v in (("n", 0.05), ("q_spatial", 0.5), ("p_spatial", 21.0))}
    return net, ch, params, t(rng.uniform(0.01, 1.0, (24, 400)))


def step_oracle_errors(runoff, oracle) -> tuple[float, float]:
    """``(rel_max, 1 - NSE)`` of a float32 route against the float64 oracle."""
    sim, obs = np.asarray(runoff, np.float64), np.asarray(oracle, np.float64)
    rel = float((np.abs(sim - obs) / (np.abs(obs) + 1e-6)).max())
    return rel, float(((sim - obs) ** 2).sum() / ((obs - obs.mean(axis=0)) ** 2).sum())


@pytest.mark.cuda
def test_step_engine_on_the_card_computes_in_the_inputs_dtype(card):
    """The step engine runs on the card in float64 and float32 alike, and
    its float64 route is the oracle of the single-ring kernel route, whose
    ``rel_max`` and 1 - NSE are held to 10x JAX's own float32 wavefront's on
    the same inputs (the bound of ``tests/test_torch_numerics.py``)."""
    runoff = {}
    for dtype in (torch.float64, torch.float32):
        net, ch, params, q = step_oracle_case(dtype, card)
        step = mc.route(net, ch, params, q, engine="step", device=card)
        assert step.runoff.dtype == dtype and step.runoff.device.type == "cuda"
        runoff[dtype] = step.runoff
    before = wave_scan_tm.launches
    wave = mc.route(net, ch, params, q, device=card).runoff
    assert wave_scan_tm.launches == before + 1
    errors = step_oracle_errors(wave.double().cpu(), runoff[torch.float64].cpu())
    for name, got, jax_own in zip(("rel_max", "1-NSE"), errors, JAX_STEP_ORACLE_ERRORS):
        assert got <= 10 * jax_own, (name, got, jax_own)
