"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA card and skip without one. They cover both
time-major kernels (``wave_scan_tm``, ``reverse_scan_tm``) on the single
ring and on the bands of a stacked frame (external series, ``mask_raw``,
width-0 gather buckets, transposed width 16), the forward kernel's bf16 ring
on both, a network wide enough that a reach's pair moves between threads
and blocks from wave to wave, a NaN-poisoned inflow (one value, and the
fault-injection storm's every third value, which must reach the watchdog's
non-finite gate), the stacked band router
on the card (``n_chunks`` launches of each kernel), the unrolled chunked
router's variant (a band's own ring with external series and unmasked raw
sums, a band of local depth 0) and its route, the step engine in
float64 on the card, and one forecast served over the HTTP front on the
card, and a profiler capture naming the forward scan's kernel. The file imports
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

import urllib.request

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
def test_nan_storm_inflow_on_the_card_matches_the_plain_scan_and_trips_the_watchdog(card):
    """The ``nan@device.step`` storm's poison (every third inflow value NaN,
    the first +inf: ``faults._poison_array``) through ``wave_scan_tm`` on
    the card: the same NaN and inf pattern as its plain version on the same
    inputs, equal finite values, and through ``route`` the health stats'
    ``non-finite`` gate that the recovery ladder answers."""
    from ddr_tpu_torch.observability.faults import _poison_array
    from ddr_tpu_torch.observability.health import HealthWatchdog

    net, phys, q, q_init, T = _case("hotstart", card)
    bad = torch.as_tensor(_poison_array(q.cpu().numpy()), device=card)
    raw = wave_scan_tm(bad, net, phys, q_init)
    torch.cuda.synchronize()
    ref = wave_scan_tm_reference(bad, net, phys, q_init)
    assert not torch.isfinite(raw).all()
    assert torch.equal(torch.isnan(raw), torch.isnan(ref)) and torch.equal(torch.isinf(raw), torch.isinf(ref))
    finite = torch.isfinite(ref)
    _close(torch.where(finite, ref, 0.0), torch.where(finite, raw, 0.0), "finite values")

    basin = make_basin(n_segments=512, n_gauges=4, n_days=2, seed=3, depth=24)
    net, ch, gauges = prepare_batch(basin.routing_data, 0.001, device=card)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=card) for k, v in basin.true_params.items()}
    q = torch.as_tensor(_poison_array(basin.q_prime[:24]), device=card)[None]
    with torch.no_grad():
        before = wave_scan_tm.launches
        out = mc.route(net, ch, params, q, gauges=gauges, device=card, collect_health=True)
        torch.cuda.synchronize()
    assert wave_scan_tm.launches == before + 1
    assert int(out.health.nonfinite) > 0 and "non-finite" in HealthWatchdog().check(out.health)


@pytest.mark.cuda
def test_gauge_sums_on_the_card_repeat_bit_for_bit_and_equal_the_cpu(card):
    """``GaugeIndex.sum_groups`` on the card (``segment_reduce``, one thread
    a sum, terms left to right): the same bits on every call, equal to the
    CPU's ``index_add_`` bit for bit, for a gauge of every reach beside small
    ones; a resumed ``ddr train`` retraces its uninterrupted twin only so."""
    rng = np.random.default_rng(5)
    groups = [np.arange(4096)] + [rng.choice(4096, 9, replace=False) for _ in range(5)] + [np.array([7])]
    q = torch.as_tensor(rng.gamma(2.0, 3.0, (2, 48, 4096)).astype(np.float32), device=card)
    g = mc.GaugeIndex.from_ragged(groups, device=card)
    sums = [g.aggregate(q) for _ in range(3)]
    cpu = mc.GaugeIndex.from_ragged(groups, device="cpu").aggregate(q.cpu())
    assert sums[0].shape == (2, 48, 7)
    assert all(torch.equal(sums[0], s) for s in sums[1:]) and torch.equal(sums[0].cpu(), cpu)


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


@pytest.mark.cuda
def test_served_http_round_trip_on_the_card(card):
    """One forecast over the port's HTTP front, served on the card: the
    answer equals the in-process service's bit for bit (the same kernel on the
    same shapes; JSON carries float32 values exactly), one ``wave_scan``
    launch carried the batch, and ``/metrics`` counts it."""
    from ddr_tpu_torch.nn.kan import Kan
    from ddr_tpu_torch.observability.registry import MetricsRegistry, set_registry
    from ddr_tpu_torch.serving.client import HttpForecastClient
    from ddr_tpu_torch.serving.config import ServeConfig
    from ddr_tpu_torch.serving.http_api import serve_http
    from ddr_tpu_torch.serving.service import ForecastService
    from ddr_tpu_torch.validation.configs import Config, KanConfig

    names = [f"a{i}" for i in range(10)]
    basin = make_basin(n_segments=4096, n_gauges=4, n_days=2, depth=64, seed=1)
    set_registry(MetricsRegistry(const_labels={"host": 0}))  # this test's counts alone
    svc = ForecastService(Config(kan=KanConfig(input_var_names=names)),
                          ServeConfig(max_batch=4, horizon_hours=24, batch_wait_s=0.0), device=card)
    server = None
    try:
        svc.register_network("basin", basin.routing_data, forcing=basin.q_prime)
        svc.register_model("default", Kan(names, ("n", "q_spatial"), generator=torch.Generator().manual_seed(0)))
        svc.warmup()
        server = serve_http(svc, port=0)
        client = HttpForecastClient(server.url)
        assert client.ready()
        before = wave_scan_tm.launches
        ans = client.forecast("basin", t0=5, gauges=[0, 2], priority="interactive", request_id="card-1")
        assert wave_scan_tm.launches == before + 1
        inproc = svc.forecast(network="basin", t0=5, gauges=[0, 2], timeout=120)
        assert ans["request_id"] == "card-1" and ans["engine"] == "basin:wavefront"
        assert np.isfinite(ans["runoff"]).all() and ans["runoff"].shape == (24, 2)
        np.testing.assert_array_equal(ans["runoff"], inproc["runoff"])
        assert ans["device_ms"] > 0
        with urllib.request.urlopen(server.url + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
        assert 'status="ok"} 2' in text and "ddr_batches_total" in text
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        svc.close()
        set_registry(None)


@pytest.mark.cuda
@pytest.mark.parametrize("members", [8, 32])
def test_ensemble_launch_equals_single_launches_and_the_plain_scan(card, members):
    """An E-member ensemble on the card: the perturbed windows are routed in
    one ``wave_scan`` launch with B = E; each member equals the same window
    routed alone (B = 1) bit for bit, the whole launch equals the plain scan
    on the same members bit for bit, and the service's ensemble answer is
    that launch's."""
    from ddr_tpu_torch.fleet.ensemble import member_windows, perturbation_seed
    from ddr_tpu_torch.nn.kan import Kan
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters
    from ddr_tpu_torch.serving.config import ServeConfig
    from ddr_tpu_torch.serving.service import ForecastService
    from ddr_tpu_torch.validation.configs import Config, KanConfig

    names = [f"a{i}" for i in range(10)]
    basin = make_basin(n_segments=4096, n_gauges=4, n_days=3, depth=64, seed=2)
    cfg = Config(kan=KanConfig(input_var_names=names))
    svc = ForecastService(cfg, ServeConfig(max_batch=4, horizon_hours=24, batch_wait_s=0.0), device=card)
    try:
        svc.register_network("basin", basin.routing_data, forcing=basin.q_prime)
        svc.register_model("default", Kan(names, ("n", "q_spatial"), generator=torch.Generator().manual_seed(3)))
        svc.warmup()
        net = svc.networks()["basin"]
        p = cfg.params
        with torch.no_grad():
            phys = denormalize_spatial_parameters(svc.registry.get("default").kan(net.attrs), p.parameter_ranges,
                                                  p.log_space_parameters, p.defaults, net.n_segments)
            q = torch.as_tensor(basin.q_prime[7:31], device=card)
            qe = member_windows(q, perturbation_seed("card-ens", 0), members, 0.1)
            if net.flow_scale is not None:
                qe = qe * net.flow_scale
            before = wave_scan_tm.launches
            launch = mc.route(net.network, net.channels, phys, qe, gauges=net.gauge_index, bounds=svc.bounds,
                              device=card).runoff
            assert wave_scan_tm.launches == before + 1
            plain = mc.route(net.network, net.channels, phys, qe, gauges=net.gauge_index, bounds=svc.bounds,
                             kernel="reference", device=card).runoff
            torch.testing.assert_close(launch, plain, rtol=0, atol=0)
            for m in range(members):
                alone = mc.route(net.network, net.channels, phys, qe[m:m + 1].contiguous(),
                                 gauges=net.gauge_index, bounds=svc.bounds, device=card).runoff
                torch.testing.assert_close(alone[0], launch[m], rtol=0, atol=0)
        before = wave_scan_tm.launches
        ans = svc.ensemble_forecast(network="basin", t0=7, members=members, request_id="card-ens",
                                    return_members=True)
        assert wave_scan_tm.launches == before + 1
        np.testing.assert_array_equal(ans["member_runoff"], launch.cpu().numpy())
        assert ans["runoff"].shape == (3, 24, 4) and np.isfinite(ans["runoff"]).all()
    finally:
        svc.close()


@pytest.mark.cuda
def test_merit_example_commands_launch_once_a_step_and_once_a_chunk(card, tmp_path):
    """``ddr train`` and ``ddr test`` on the MERIT example's stores, on the
    card: one ``wave_scan`` and one ``reverse_scan`` launch a train step (no
    twin observation route on a store-backed dataset), one ``wave_scan``
    launch an evaluation chunk, each chunk after the first from the carried
    ``q_init``."""
    import logging
    import shutil
    from pathlib import Path

    from ddr_tpu_torch import cli
    from ddr_tpu_torch.scripts.prepare_merit_example import prepare
    from ddr_tpu_torch.training import latest_checkpoint
    from chip_smoke import EvalLog, TrainLog, merit_overrides

    example = tmp_path / "merit_basin"
    shutil.copytree(Path(__file__).resolve().parents[1] / "examples" / "merit_basin", example,
                    ignore=shutil.ignore_patterns("data", "output"))
    prepare(example)
    overrides = merit_overrides(example / "data", example / "gages.csv", tmp_path / "run")
    train_log, eval_log = TrainLog(), EvalLog()
    loggers = [logging.getLogger(n) for n in ("ddr_tpu_torch.scripts.train", "ddr_tpu_torch.scripts.common")]
    for logger, handler in zip(loggers, (train_log, eval_log)):
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    try:
        wave_scan_tm.launches = reverse_scan_tm.launches = 0
        assert cli.main(["train", str(example / "config.yaml"), *overrides]) == 0
        steps = len(train_log.steps)
        assert steps == 2 and (wave_scan_tm.launches, reverse_scan_tm.launches) == (steps, steps)
        ckpt = latest_checkpoint(tmp_path / "run" / "saved_models")
        wave_scan_tm.launches = wave_scan_tm.q_init_launches = reverse_scan_tm.launches = 0
        assert cli.main(["test", str(example / "config.yaml"), *overrides, f"experiment.checkpoint={ckpt}"]) == 0
        chunks = len(eval_log.chunks)
        assert chunks == 91
        assert (wave_scan_tm.launches, wave_scan_tm.q_init_launches, reverse_scan_tm.launches) == (
            chunks, chunks - 1, 0)
    finally:
        for logger, handler in zip(loggers, (train_log, eval_log)):
            logger.removeHandler(handler)


def _losses_and_launches(cli_argv):
    """``ddr train`` through the CLI: its step losses and the kernels' launches."""
    import logging

    from ddr_tpu_torch import cli
    from chip_smoke import TrainLog

    log = TrainLog()
    logger = logging.getLogger("ddr_tpu_torch.scripts.train")
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    try:
        assert cli.main(cli_argv) == 0
    finally:
        logger.removeHandler(log)
    return [s[2] for s in log.steps], (wave_scan_tm.launches, reverse_scan_tm.launches)


@pytest.mark.cuda
def test_lynker_train_on_the_card_matches_the_cpu(card, tmp_path):
    """``ddr train`` on a 12-flowpath Lynker hydrofabric (per-reach Muskingum
    x from ``MusX``): the card's losses against the CPU's from one initial
    checkpoint, one launch of each kernel a step."""
    from pathlib import Path

    from ddr_tpu_torch.scripts.common import build_kan, kan_arch
    from ddr_tpu_torch.training import save_state
    from ddr_tpu_torch.validation.configs import load_config
    from chip_smoke import MERIT_EXAMPLE, build_lynker_stores, lynker_forcing, lynker_overrides, write_hydrofabric

    down = np.asarray([2, 2, 4, 4, 8, 7, 7, 8, 10, 10, -1, 9])
    rng = np.random.default_rng(3)
    fab = write_hydrofabric(tmp_path, down, rng.uniform(800.0, 4000.0, 12), rng.uniform(1e-3, 0.02, 12),
                            {"01300004": 4, "01300010": 10}, seed=5)
    data = tmp_path / "data"
    build_lynker_stores(tmp_path / "hydrofabric.gpkg", data, tmp_path / "gages.csv")
    lynker_forcing(data, fab["ids"], seed=6)
    config = str(Path(__file__).resolve().parents[1] / MERIT_EXAMPLE / "config.yaml")
    cfg = load_config(config, lynker_overrides(data, tmp_path / "gages.csv", tmp_path / "init"), save_config=False)
    init = save_state(tmp_path / "init", cfg.name, 1, 0, build_kan(cfg, device="cpu").state_dict(), None,
                      arch=kan_arch(cfg))
    runs = {}
    for device in ("cpu", "cuda"):
        runs[device] = _losses_and_launches(["train", config, *lynker_overrides(data, tmp_path / "gages.csv",
                                                                                tmp_path / device),
                                             f"device={device}", f"experiment.checkpoint={init}"])
    (cpu, _), (card_losses, launches) = runs["cpu"], runs["cuda"]
    assert len(card_losses) == len(cpu) == 2 and launches == (2, 2)
    np.testing.assert_allclose(card_losses, cpu, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_eval_q_prime_on_the_card_matches_the_cpu(card, tmp_path):
    """``ddr summed-q-prime`` on the MERIT example: ``torch.nansum`` on the
    card against the CPU within 1e-6 relative."""
    import shutil
    from pathlib import Path

    from ddr_tpu_torch.scripts.prepare_merit_example import prepare
    from ddr_tpu_torch.scripts.summed_q_prime import eval_q_prime
    from ddr_tpu_torch.validation.configs import load_config
    from chip_smoke import merit_overrides

    example = tmp_path / "merit_basin"
    shutil.copytree(Path(__file__).resolve().parents[1] / "examples" / "merit_basin", example,
                    ignore=shutil.ignore_patterns("data", "output"))
    prepare(example)
    preds = {}
    for device in ("cpu", "cuda"):
        cfg = load_config(example / "config.yaml", [*merit_overrides(example / "data", example / "gages.csv",
                                                                     tmp_path / device),
                                                    f"device={device}", "mode=testing"], save_config=False)
        preds[device] = np.asarray(eval_q_prime(cfg).pred)
    assert preds["cuda"].shape == preds["cpu"].shape and np.isfinite(preds["cuda"]).all()
    np.testing.assert_allclose(preds["cuda"], preds["cpu"], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_run_log_on_the_card_carries_device_peak_bytes(card, tmp_path):
    """A run log written while routing on the card: its heartbeat carries the
    card's memory, whose peak is ``device_peak_bytes``."""
    import json

    from ddr_tpu_torch.observability.events import device_peak_bytes, emit_heartbeat, run_telemetry

    basin = make_basin(n_segments=512, n_gauges=2, n_days=2, depth=16, seed=4)
    net, ch, gauges = prepare_batch(basin.routing_data, 1e-4, device=card)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=card) for k, v in basin.true_params.items()}
    with run_telemetry(None, "route", base_dir=tmp_path, device="cuda"):
        out = mc.route(net, ch, params, torch.as_tensor(basin.q_prime, device=card), gauges=gauges, device=card)
        assert torch.isfinite(out.runoff).all()
        emit_heartbeat(step=1)
        peak = device_peak_bytes()
    events = [json.loads(line) for line in (tmp_path / "run_log.route.jsonl").read_text().splitlines()]
    beat, = [e for e in events if e["event"] == "heartbeat"]
    entry = beat["devices"][0]
    assert entry["platform"] == "gpu" and peak is not None and peak > 0
    assert entry["peak_bytes_in_use"] <= peak and entry["bytes_limit"] > entry["peak_bytes_in_use"] > 0
    assert device_peak_bytes("cpu") is None


@pytest.mark.cuda
def test_profiler_capture_names_the_scan_kernel(card, tmp_path):
    """``capture_profile`` (``POST /v1/profile``'s capture) while another
    thread routes on the card: its trace names the forward scan's kernel."""
    import json
    import threading

    from ddr_tpu_torch.observability.spans import capture_profile, trace_active

    basin = make_basin(n_segments=512, n_gauges=2, n_days=2, depth=16, seed=4)
    net, ch, gauges = prepare_batch(basin.routing_data, 1e-4, device=card)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=card) for k, v in basin.true_params.items()}
    q = torch.as_tensor(basin.q_prime, device=card)
    mc.route(net, ch, params, q, gauges=gauges, device=card)  # the kernel is built before the capture
    owner = capture_profile(str(tmp_path), 1.0)

    def work():
        with torch.no_grad():
            for _ in range(3):
                mc.route(net, ch, params, q, gauges=gauges, device=card)
        torch.cuda.synchronize(card)

    worker = threading.Thread(target=work)
    worker.start()
    worker.join(timeout=60)
    owner.join(timeout=60)
    assert not trace_active()
    trace, = tmp_path.glob("capture_*.json")
    names = {str(e.get("name")) for e in json.loads(trace.read_text())["traceEvents"]}
    assert any("wave_scan_tm_kernel" in n for n in names)
