"""The port's stacked band router against the JAX package's ``route_stacked``.

The same frames (the port's builder equals the JAX builder, see
``test_torch_stacked.py``), channels, parameters and inflows go through JAX
``mc.route`` on a ``StackedChunked`` (XLA scans, and once the real Pallas
kernel bodies in interpret mode) and the port's ``route`` on the CPU (the
plain versions of the CUDA kernels): runoff and final discharge with gauges
and without, in-band hotstart and carried ``q_init``, ``T = 1``, a batch;
the analytic band adjoint against ``jax.grad``, with ``q_init`` below and on
the discharge bound (the clamp's 0.5 tie); and each band kernel's plain
version against the JAX band scans (``mask_raw`` with external rows, frames
whose gather buckets reach width 0 and whose transposed width exceeds 1).

Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x the largest magnitude,
as for the single-ring engine (float32 physics differs by ulps between XLA
and PyTorch and the recurrences carry that along the longest path).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing import stacked as jax_stacked
from ddr_tpu.routing.model import prepare_channels as jax_prepare_channels
from ddr_tpu.routing.pallas_kernel import fused_reverse_scan
from ddr_tpu_torch.geodatazoo.synthetic import make_basin
from ddr_tpu_torch.routing import mc
from ddr_tpu_torch.routing.model import prepare_channels
from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_reference
from ddr_tpu_torch.routing.stacked import build_stacked_chunked
from ddr_tpu_torch.routing.wave_kernel import wave_scan, wave_scan_reference
from chip_smoke import reverse_streams
from tests.test_torch_adjoint import _inputs
from tests.test_torch_stacked import braided
from tests.test_torch_wave_kernel import LB, _jax_physics_fn, _physics, _torch_physics

SLOPE_MIN = 0.001
BUDGET = 120  # 3-7 bands on the test basins


def _close(ref, out, label):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = max(np.max(np.abs(ref)), np.max(np.abs(out)), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


class _Basin:
    """One synthetic basin as both packages' stacked frames and channels."""

    def __init__(self, seed=11, budget=BUDGET):
        kw = dict(n_segments=96, n_gauges=4, n_days=2, seed=seed, depth=12)
        ours, ref = make_basin(**kw), jax_make_basin(**kw)
        rd = ours.routing_data
        self.n = rd.n_segments
        self.q = ours.q_prime
        self.frame = build_stacked_chunked(rd.adjacency_rows, rd.adjacency_cols, self.n,
                                           cell_budget=budget, device="cpu")
        self.jframe = jax_stacked.build_stacked_chunked(rd.adjacency_rows, rd.adjacency_cols,
                                                        self.n, cell_budget=budget)
        self.channels, self.gauges = prepare_channels(rd, SLOPE_MIN, device="cpu")
        self.jchannels, self.jgauges = jax_prepare_channels(ref.routing_data, SLOPE_MIN)
        rng = np.random.default_rng(seed + 2)
        self.params = {
            "n": rng.uniform(0.02, 0.1, self.n).astype(np.float32),
            "q_spatial": rng.uniform(0.1, 0.9, self.n).astype(np.float32),
            "p_spatial": np.full(self.n, 21.0, np.float32),
        }

    def route(self, q, q_init=None, gauged=True):
        return mc.route(
            self.frame, self.channels, {k: torch.as_tensor(v) for k, v in self.params.items()},
            torch.as_tensor(q), q_init=None if q_init is None else torch.as_tensor(q_init),
            gauges=self.gauges if gauged else None, device="cpu",
        )

    def jax_route(self, q, q_init=None, gauged=True, kernel="xla"):
        def run(params, qp, qi):  # jitted: one XLA compile instead of op by op
            return jax_mc.route(self.jframe, self.jchannels, params, qp, q_init=qi,
                                gauges=self.jgauges if gauged else None, kernel=kernel)

        return jax.jit(run)(
            {k: jnp.asarray(v) for k, v in self.params.items()}, jnp.asarray(q),
            None if q_init is None else jnp.asarray(q_init),
        )


@pytest.fixture(scope="module")
def basin():
    return _Basin()


@pytest.mark.parametrize("gauged", [True, False], ids=["gauges", "full-domain"])
@pytest.mark.parametrize("init", ["hotstart", "q_init", "T=1"])
def test_stacked_route_matches_jax(basin, init, gauged):
    T = 1 if init == "T=1" else 24
    q = basin.q[:T].copy()
    q[:, ::7] = 0.0  # headwater inflows below the discharge clamp
    q_init = None
    if init == "q_init":
        q_init = np.random.default_rng(17).uniform(0.0, 3.0, basin.n).astype(np.float32)
    assert basin.frame.n_chunks >= 3 and basin.frame.n_boundary > 0
    res, ref = basin.route(q, q_init, gauged), basin.jax_route(q, q_init, gauged)
    assert res.runoff.shape == ref.runoff.shape
    _close(ref.runoff, res.runoff, f"{init}: runoff")
    _close(ref.final_discharge, res.final_discharge, f"{init}: final discharge")


def test_stacked_route_matches_the_pallas_kernels_in_interpret_mode(basin):
    """JAX's band scans as the real Pallas kernel bodies (``fused_wave_scan``
    with ``mask_raw`` and external rows), interpreted on the CPU."""
    q = basin.q[:6]
    ref = basin.jax_route(q, kernel="pallas")
    res = basin.route(q)
    _close(ref.runoff, res.runoff, "runoff vs the pallas band scans")
    _close(ref.final_discharge, res.final_discharge, "final discharge vs the pallas band scans")


def test_batched_stacked_route_equals_per_request_routes(basin):
    q = torch.as_tensor(basin.q[:24])
    batch = torch.stack([q, 0.5 * q, 2.0 * q])
    res_b = basin.route(batch.numpy())
    for i in range(3):
        res_i = basin.route(batch[i].numpy())
        torch.testing.assert_close(res_b.runoff[i], res_i.runoff)
        torch.testing.assert_close(res_b.final_discharge[i], res_i.final_discharge)


def test_stacked_route_runs_under_deterministic_algorithms(basin):
    """The boundary buffer's pad slots all write the scratch column; the
    route and its backward still run when PyTorch is asked for
    deterministic algorithms, with the same answers."""
    q = torch.as_tensor(basin.q[:24])
    expect = basin.route(q.numpy()).runoff
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        params = {k: torch.tensor(v, requires_grad=True) for k, v in basin.params.items()}
        res = mc.route(basin.frame, basin.channels, params, q, gauges=basin.gauges, device="cpu")
        res.runoff.sum().backward()
    finally:
        torch.use_deterministic_algorithms(was)
    torch.testing.assert_close(res.runoff.detach(), expect, rtol=0, atol=0)
    assert torch.isfinite(params["n"].grad).all() and params["n"].grad.abs().sum() > 0


# ---- the analytic band adjoint against jax.grad ----


def _grads(args, budget, gauges):
    """``(JAX grads, port leaves)`` of a dense weighted loss over runoff and
    final discharge, on both packages' frames of the same DAG."""
    (rows, cols), ch, params, q, w, wf, q_init = args
    n = q.shape[1]
    jframe = jax_stacked.build_stacked_chunked(rows, cols, n, cell_budget=budget)
    frame = build_stacked_chunked(rows, cols, n, cell_budget=budget, device="cpu")
    assert frame.n_chunks >= 3 and frame.t_width > 1
    w = w[:, : len(gauges)] if gauges is not None else w

    jch = jax_mc.ChannelState(length=jnp.asarray(ch["length"]), slope=jnp.asarray(ch["slope"]),
                              x_storage=jnp.asarray(ch["x"]))
    jg = None if gauges is None else jax_mc.GaugeIndex.from_ragged(gauges)

    def loss(p, qp, length, qi):
        res = jax_mc.route(jframe, dataclasses.replace(jch, length=length), p, qp, q_init=qi,
                           gauges=jg, bounds=jax_mc.Bounds(discharge=LB), kernel="xla")
        return (res.runoff * w).sum() + (res.final_discharge * wf).sum()

    qi = None if q_init is None else jnp.asarray(q_init)
    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2) if qi is None else (0, 1, 2, 3)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(q), jnp.asarray(ch["length"]), qi
    )

    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    length = torch.tensor(ch["length"], requires_grad=True)
    channels = mc.ChannelState(length=length, slope=torch.tensor(ch["slope"]),
                               x_storage=torch.tensor(ch["x"]))
    qp = torch.tensor(q, requires_grad=True)
    qit = None if q_init is None else torch.tensor(q_init, requires_grad=True)
    g = None if gauges is None else mc.GaugeIndex.from_ragged(gauges, device="cpu")
    res = mc.route(frame, channels, p, qp, q_init=qit, gauges=g, bounds=mc.Bounds(discharge=LB),
                   device="cpu")
    ((res.runoff * torch.tensor(w)).sum() + (res.final_discharge * torch.tensor(wf)).sum()).backward()
    return ref, (p, qp, length, qit)


@pytest.mark.parametrize("case", ["hotstart", "q_init", "gauges", "T=1"])
def test_band_adjoint_gradients_match_jax(case):
    """Gradients w.r.t. the three parameters, ``q'``, ``length`` and
    ``q_init``; the ``q_init`` case sets some initial states below the bound
    and some exactly on it."""
    T = 1 if case == "T=1" else 12
    args = _inputs({"hotstart": 41, "q_init": 43, "gauges": 11, "T=1": 3}[case], 72, T, case == "q_init")
    gauges = None
    if case == "gauges":
        rng = np.random.default_rng(12)
        gauges = [rng.choice(72, size=3, replace=False) for _ in range(4)]
    ref, (p, qp, length, qi) = _grads(args, 120, gauges)
    for k in ("n", "q_spatial", "p_spatial"):
        _close(ref[0][k], p[k].grad, f"{case}: d/d{k}")
    _close(ref[1], qp.grad, f"{case}: d/dq_prime")
    _close(ref[2], length.grad, f"{case}: d/dlength")
    if qi is not None:
        q_init = args[-1]
        _close(ref[3], qi.grad, f"{case}: d/dq_init")
        on = torch.as_tensor(q_init == np.float32(LB))
        assert on.any() and (qi.grad[on] != 0).any()  # the tie passes half its gradient
        assert (qi.grad[torch.as_tensor(q_init < LB)] == 0).all()


# ---- the band kernels' plain versions against the JAX band scans ----


def _band_case(name):
    """Band 1 of a braided frame, random physics on its slots, and random
    pre-skewed inflow and external rows."""
    rng = np.random.default_rng(sum(ord(c) for c in name))
    rows, cols, n = braided()
    frame = build_stacked_chunked(rows, cols, n, cell_budget=60, device="cpu")
    band = frame.band(1)
    T = 1 if name == "T=1" else 12
    B, W, n_cap = 2, T + frame.span_max, frame.n_cap
    ph = _physics(rng, n_cap)
    qs, xe, se = (rng.uniform(0.0, 2.0, (B, W, n_cap)).astype(np.float32) for _ in range(3))
    qs[rng.random(qs.shape) < 0.25] = 0.0
    q_init = rng.uniform(0.0, 3.0, (B, n_cap)).astype(np.float32) if name == "q_init" else None
    return frame, band, ph, qs, xe, se, q_init, T


@pytest.mark.parametrize("name", ["hotstart", "q_init", "T=1"])
def test_band_wave_scan_matches_jax_frame_scans(name):
    frame, band, ph, qs, xe, se, q_init, T = _band_case(name)
    assert any(w == 0 for *_, w in frame.buckets) and max(w for *_, w in frame.buckets) > 1
    t = torch.as_tensor
    ys = wave_scan_reference(t(qs), band, _torch_physics(ph), None if q_init is None else t(q_init),
                             T=T, xe=t(xe), se=t(se), mask_raw=True).numpy()
    args = [jnp.asarray(a.numpy()) for a in (band.level_p, band.wf_row, band.wf_col, band.wf_mask)]
    for b in range(qs.shape[0]):
        qi = jnp.zeros(frame.n_cap) if q_init is None else jnp.asarray(q_init[b])
        for kernel in ("xla", "pallas"):
            ref = jax_stacked._frame_wave_scan(
                _jax_physics_fn(ph), *args, jnp.asarray(qs[b]), jnp.asarray(xe[b]), jnp.asarray(se[b]),
                qi, T=T, n_cap=frame.n_cap, span=frame.span_max, lb=LB, buckets=frame.buckets,
                has_init=q_init is not None, dtype=jnp.float32, kernel=kernel,
                ring_rows=frame.ring_rows,
            )
            _close(ref, ys[b], f"{name}: band scan vs JAX {kernel}, request {b}")


def test_band_wave_scan_wrapper_takes_the_plain_version_on_the_cpu():
    frame, band, ph, qs, xe, se, _, T = _band_case("hotstart")
    t = torch.as_tensor
    before = wave_scan.launches
    out = wave_scan(t(qs), band, _torch_physics(ph), None, T=T, xe=t(xe), se=t(se), mask_raw=True)
    ref = wave_scan_reference(t(qs), band, _torch_physics(ph), None, T=T, xe=t(xe), se=t(se),
                              mask_raw=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert wave_scan.launches == before
    with pytest.raises(ValueError, match="xe and se"):
        wave_scan(t(qs), band, _torch_physics(ph), None, T=T, xe=t(xe))


@pytest.mark.parametrize("name", ["braided", "T=1"])
def test_band_reverse_scan_matches_fused_reverse_scan(name):
    """The reverse scan on a band (band-local levels, ``depth = span_max``,
    the band's transposed rows, the frame's ring rows) against the Pallas
    body, including sentinel slots (level 0, no successors)."""
    frame, band, *_ = _band_case(name)
    T = 1 if name == "T=1" else 12
    assert frame.t_width > 1 and bool((frame.gidx[1] == frame.n).any())
    rows_s = reverse_streams(band, 2, T, 7, "cpu")
    lams = reverse_scan_reference(rows_s, band, T=T).numpy()
    assert np.abs(lams).max() > 0
    t_row, t_col = jnp.asarray(band.wf_t_row.numpy()), jnp.asarray(band.wf_t_col.numpy())
    for b in range(2):
        ref = fused_reverse_scan(
            jnp.asarray(rows_s[b].numpy()), t_row, t_col, n=frame.n_cap, t_width=frame.t_width,
            span=frame.span_max, interpret=True, ring_rows=frame.ring_rows,
        )
        _close(ref, lams[b], f"{name}: band reverse scan vs fused_reverse_scan, request {b}")
