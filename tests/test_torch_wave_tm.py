"""The time-major scans' plain versions: run tables, layouts, JAX parity, NaN.

``wave_scan_tm_reference`` and ``reverse_scan_tm_reference`` are the plain
PyTorch versions of the card's time-major kernels: they read and write
``(B, T, .)`` arrays and walk, per wave, only the reaches in band
(``active_runs``). Checked here on the CPU:

(a) the run table of every wave equals the in-band mask (forward ``0 <= w -
    1 - L(i) < T``, reverse ``0 <= T - v + depth - L(i) < T``) on a random
    single ring, a fan-out DAG (``t_width > 1``), the bands of a stacked
    frame, a chunked band, a band of depth 0 and ``T = 1``;
(b) each equals the pre-skewed plain scan between its skews bit for bit:
    fp32 and bf16, hotstart and ``q_init``, with and without external
    series, ``mask_raw`` 0 and 1;
(c) against JAX on the CPU: ``mc.route(kernel="xla")`` (runoff, final
    discharge and the gradients w.r.t. ``q'``, ``n`` and ``q_spatial``) on a
    single ring, a stacked frame and a chunked network, and ``fused_wave_scan``
    in interpret mode unskewed here. Tolerance: rtol 1e-5 in fp32 with an
    absolute floor of 1e-5 x the largest magnitude (float32 physics differs
    by ulps between XLA and PyTorch and the recurrence carries that along the
    longest path); bf16: one bf16 epsilon, 2**-7, as the bf16 parity tests;
(d) a NaN-poisoned ``q'`` at one reach gives the pre-skewed plain path's NaN
    pattern in ``raw``: the ring policy (only reaches in band write the ring)
    lets no poisoned value reach a masked slot; a table that would is refused.

Every input is made with numpy from fixed integer seeds.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing import stacked as jax_stacked
from ddr_tpu.routing.chunked import build_chunked_network as jax_build_chunked_network
from ddr_tpu.routing.pallas_kernel import fused_wave_scan
from ddr_tpu_torch.geodatazoo.synthetic import make_deep_network
from ddr_tpu_torch.routing import mc
from ddr_tpu_torch.routing.chunked import build_chunked_network
from ddr_tpu_torch.routing.network import build_network
from ddr_tpu_torch.routing.reverse_kernel import (
    reverse_scan_reference,
    reverse_scan_tm,
    reverse_scan_tm_reference,
)
from ddr_tpu_torch.routing.stacked import build_stacked_chunked
from ddr_tpu_torch.routing.wave_kernel import (
    active_runs,
    wave_scan_reference,
    wave_scan_tm,
    wave_scan_tm_reference,
)
from ddr_tpu_torch.routing.wavefront import (
    _ext_skews,
    _input_skews,
    _reverse_index,
    _skew,
    _skew_by_level_runs,
    _unskew_reverse,
)
from chip_smoke import fan_out_edges
from tests.test_torch_adjoint import _inputs
from tests.test_torch_network import _random_dag
from tests.test_torch_stacked import braided
from tests.test_torch_wave_kernel import LB, _jax_physics_fn, _physics, _torch_physics

EPS_BF16 = 2.0**-7


def _close(ref, out, label, rtol=1e-5):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    assert ref.shape == out.shape, label
    scale = max(np.max(np.abs(ref)), np.max(np.abs(out)), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-5 * scale, err_msg=label)


def _tables(name):
    """``(tables, T, mask_raw, has_ext)`` of one table kind: a network or a
    band, with the variant of the scan that runs on it."""
    if name in ("ring", "T=1"):
        rng = np.random.default_rng(5)
        return build_network(*_random_dag(rng, 64), 64, device="cpu"), (1 if name == "T=1" else 12), False, False
    if name == "fan-out":
        net = build_network(*fan_out_edges(96, 3), 96, device="cpu")
        assert net.wf_t_width > 1
        return net, 12, False, False
    if name.startswith("band"):
        rows, cols, n = braided()
        frame = build_stacked_chunked(rows, cols, n, cell_budget=60, device="cpu")
        assert frame.n_chunks >= 3 and frame.t_width > 1
        return frame.band(int(name[-1])), 12, True, True
    if name == "chunked":
        rows, cols = make_deep_network(320, 80, seed=2)
        net = build_chunked_network(rows, cols, 320, cell_budget=8000, device="cpu").chunks[1]
        return net, 12, False, True
    assert name == "depth-0"
    net = build_chunked_network(np.arange(1, 28), np.arange(0, 27), 28, cell_budget=120,
                                device="cpu").chunks[-1]
    assert net.depth == 0
    return net, 12, False, True


TABLES = ("ring", "fan-out", "band0", "band1", "band2", "chunked", "depth-0", "T=1")


# ---- (a) the run tables ----


@pytest.mark.parametrize("name", TABLES)
def test_active_runs_equal_the_in_band_mask(name):
    net, T, _, _ = _tables(name)
    lvl = net.level_p.numpy().astype(np.int64)
    W = T + net.depth
    for reverse in (False, True):
        runs = active_runs(net, T, reverse=reverse)
        assert runs.table.shape == (W, 2 * runs.n_runs + 1) and runs.table.dtype == torch.int32
        np.testing.assert_array_equal(runs.table[:, : runs.n_runs].numpy(), runs.starts)
        np.testing.assert_array_equal(runs.table[:, runs.n_runs :].numpy(), runs.offsets)
        counts = []
        for w in range(1, W + 1):
            t = (T - w + net.depth - lvl) if reverse else (w - 1 - lvl)
            expect = np.flatnonzero((t >= 0) & (t < T))
            np.testing.assert_array_equal(runs.nodes(w).numpy(), expect, err_msg=f"{name} wave {w}")
            counts.append(expect.size)
        assert runs.widest == max(counts)
        # every reach is in band at exactly T waves
        assert sum(counts) == T * net.n
    assert active_runs(net, T) is active_runs(net, T)  # cached


# ---- (b) bit for bit against the pre-skewed plain scans ----


def _forward_inputs(net, T, has_ext, init, seed, B=2):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 2.0, (B, T, net.n)).astype(np.float32)
    q[rng.random(q.shape) < 0.25] = 0.0  # raw values below the discharge clamp
    xe = se = None
    if has_ext:
        xe, se = (torch.as_tensor(rng.uniform(0.0, 1.0, (B, T, net.n)).astype(np.float32)) for _ in range(2))
    q_init = torch.as_tensor(rng.uniform(0.0, 3.0, (B, net.n)).astype(np.float32)) if init else None
    return torch.as_tensor(q), xe, se, q_init, _physics(rng, net.n)


def _skewed_forward(net, phys, q, q_init, xe, se, mask_raw, dtype):
    """The pre-skewed plain scan between the skews, as the analytic route ran it."""
    T, lvl = q.shape[1], net.level_p.long()
    ext = {}
    if xe is not None:
        ext = dict(zip(("xe", "se"), _ext_skews(xe, se, lvl, net.depth, T)))
    ys = wave_scan_reference(_input_skews(q, lvl, net.depth, T).contiguous(), net, phys, q_init, T=T,
                             mask_raw=mask_raw, compute_dtype=dtype, **ext)
    return _skew_by_level_runs(ys, lvl, T)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("init", ["hotstart", "q_init"])
@pytest.mark.parametrize("name", ["ring", "T=1", "band1", "chunked", "depth-0"])
def test_wave_scan_tm_reference_equals_the_skewed_scan(name, init, dtype):
    net, T, mask_raw, has_ext = _tables(name)
    q, xe, se, q_init, ph = _forward_inputs(net, T, has_ext, init == "q_init", 31)
    phys = _torch_physics(ph)
    raw = wave_scan_tm_reference(q, net, phys, q_init, x_ext=xe, s_ext=se, mask_raw=mask_raw,
                                 compute_dtype=dtype)
    ref = _skewed_forward(net, phys, q, q_init, xe, se, mask_raw, dtype)
    assert raw.shape == q.shape and torch.isfinite(raw).all()
    torch.testing.assert_close(raw, ref, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["ring", "band1"])
def test_wave_scan_tm_reference_without_external_series_or_mask(name):
    """The band frame's tables with neither external series nor masked raw
    sums, and the ring's with masked sums: every flag combination runs."""
    net, T, mask_raw, _ = _tables(name)
    q, _, _, q_init, ph = _forward_inputs(net, T, False, False, 37)
    phys = _torch_physics(ph)
    for flag in (mask_raw, not mask_raw):
        torch.testing.assert_close(
            wave_scan_tm_reference(q, net, phys, q_init, mask_raw=flag),
            _skewed_forward(net, phys, q, q_init, None, None, flag, "fp32"), rtol=0, atol=0)


def _reverse_inputs(net, T, seed, B=2):
    """``(gbar, ow, zce, duce)`` shaped as the analytic backward builds them:
    ``ow`` and ``duce`` zero at ``t = 0``, weights nonnegative and summing
    below 1 a wave."""
    rng = np.random.default_rng(seed)
    n, tw = net.n, net.wf_t_width
    gbar = rng.normal(size=(B, T, n))
    ow = 0.3 * rng.random((B, T, n))
    zce, duce = ((0.3 / tw) * rng.random((B, T, n * tw)) for _ in range(2))
    ow[:, 0] = 0.0
    duce[:, 0] = 0.0
    return tuple(torch.as_tensor(a.astype(np.float32)) for a in (gbar, ow, zce, duce))


def _streamed_reverse(net, gbar, ow, zce, duce):
    """The pre-skewed plain reverse scan between its streams."""
    B, T, n = gbar.shape
    depth, tw, lvl = net.depth, net.wf_t_width, net.level_p.long()
    node_idx = _reverse_index(lvl, depth, T, T + depth)
    edge_idx = _reverse_index(lvl.repeat_interleave(tw), depth, T, T + depth)
    rows_s = torch.cat([_skew(gbar, *node_idx), _skew(ow, *node_idx), _skew(zce, *edge_idx),
                        _skew(duce, *edge_idx)], dim=-1)
    return _unskew_reverse(reverse_scan_reference(rows_s, net, T=T), lvl, depth, T)


@pytest.mark.parametrize("name", ["ring", "fan-out", "T=1", "band0", "band1", "band2", "chunked", "depth-0"])
def test_reverse_scan_tm_reference_equals_the_streamed_scan(name):
    net, T, _, _ = _tables(name)
    args = _reverse_inputs(net, T, 41)
    lam = reverse_scan_tm_reference(*args, net)
    assert lam.shape == args[0].shape and torch.isfinite(lam).all()
    torch.testing.assert_close(lam, _streamed_reverse(net, *args), rtol=0, atol=0)


def test_wrappers_take_the_plain_versions_only_for_cpu_tensors():
    net, T, mask_raw, has_ext = _tables("band1")
    q, xe, se, q_init, ph = _forward_inputs(net, T, has_ext, True, 43)
    phys = _torch_physics(ph)
    kw = dict(x_ext=xe, s_ext=se, mask_raw=mask_raw)
    before = wave_scan_tm.launches
    torch.testing.assert_close(wave_scan_tm(q, net, phys, q_init, **kw),
                               wave_scan_tm_reference(q, net, phys, q_init, **kw), rtol=0, atol=0)
    assert wave_scan_tm.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wave_scan_tm(q.to("meta"), net, phys, None)
    with pytest.raises(ValueError, match="x_ext and s_ext"):
        wave_scan_tm(q, net, phys, None, x_ext=xe)
    args = _reverse_inputs(net, T, 47)
    before = reverse_scan_tm.launches
    torch.testing.assert_close(reverse_scan_tm(*args, net), reverse_scan_tm_reference(*args, net),
                               rtol=0, atol=0)
    assert reverse_scan_tm.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        reverse_scan_tm(*(a.to("meta") for a in args), net)


# ---- (c) against JAX ----


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["ring", "band1", "chunked", "depth-0"])
def test_wave_scan_tm_reference_matches_fused_wave_scan(name, dtype):
    """``fused_wave_scan`` (the real Pallas body in interpret mode) on the
    pre-skewed rows, its ``(W, n)`` output unskewed here: reach ``i``'s
    timestep ``t`` sits at row ``t + L(i)``."""
    net, T, mask_raw, has_ext = _tables(name)
    q, xe, se, q_init, ph = _forward_inputs(net, T, has_ext, name != "band1", 53)
    raw = wave_scan_tm_reference(q, net, _torch_physics(ph), q_init, x_ext=xe, s_ext=se,
                                 mask_raw=mask_raw, compute_dtype=dtype).numpy()
    lvl = net.level_p.long()
    qs = _input_skews(q, lvl, net.depth, T).numpy()
    ext = _ext_skews(xe, se, lvl, net.depth, T) if has_ext else (None, None)
    tables = [jnp.asarray(a.numpy()) for a in (net.level_p, net.wf_row, net.wf_col, net.wf_mask)]
    rows = lvl.numpy()[None, :] + np.arange(T)[:, None]
    for b in range(q.shape[0]):
        ys = fused_wave_scan(
            _jax_physics_fn(ph), *tables, net.wf_buckets, jnp.asarray(qs[b]),
            *(None if a is None else jnp.asarray(a[b].numpy()) for a in ext),
            None if q_init is None else jnp.asarray(q_init[b].numpy()),
            T=T, n=net.n, span=net.depth, lb=LB, mask_raw=mask_raw, compute_dtype=dtype,
            interpret=True, ring_rows=net.wf_ring_rows,
        )
        ref = np.take_along_axis(np.asarray(ys), rows, axis=0)
        _close(ref, raw[b], f"{name} {dtype}: time-major plain scan vs fused_wave_scan, request {b}",
               rtol=EPS_BF16 if dtype == "bf16" else 1e-5)


def _loss_weights(seed, T, n):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(T, n)).astype(np.float32), rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("engine", ["ring", "stacked", "chunked"])
def test_time_major_route_and_gradients_match_jax(engine):
    """``route`` on the CPU runs both time-major plain scans (the analytic
    adjoint's forward and reverse); JAX routes the same DAG with its XLA
    scans. Runoff, final discharge and the gradients w.r.t. ``q'``, ``n``
    and ``q_spatial``."""
    (rows, cols), ch, params, q, _, _, _ = _inputs(61, 72, 12, False)
    n = q.shape[1]
    w, wf = _loss_weights(62, *q.shape)
    if engine == "ring":
        net, jnet = build_network(rows, cols, n, device="cpu"), None
        from ddr_tpu.routing.network import build_network as jax_build_network

        jnet = jax_build_network(rows, cols, n)
    elif engine == "stacked":
        net = build_stacked_chunked(rows, cols, n, cell_budget=120, device="cpu")
        jnet = jax_stacked.build_stacked_chunked(rows, cols, n, cell_budget=120)
        assert net.n_chunks >= 3
    else:
        net = build_chunked_network(rows, cols, n, cell_budget=120, device="cpu")
        jnet = jax_build_chunked_network(rows, cols, n, cell_budget=120)
        assert net.n_chunks >= 2

    jch = jax_mc.ChannelState(length=jnp.asarray(ch["length"]), slope=jnp.asarray(ch["slope"]),
                              x_storage=jnp.asarray(ch["x"]))

    def jax_loss(p, qp):
        res = jax_mc.route(jnet, jch, p, qp, bounds=jax_mc.Bounds(discharge=LB), kernel="xla")
        return (res.runoff * w).sum() + (res.final_discharge * wf).sum(), res

    (_, jres), jgrad = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(q))

    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    qp = torch.tensor(q, requires_grad=True)
    channels = mc.ChannelState(length=torch.tensor(ch["length"]), slope=torch.tensor(ch["slope"]),
                               x_storage=torch.tensor(ch["x"]))
    res = mc.route(net, channels, p, qp, bounds=mc.Bounds(discharge=LB), kernel="reference",
                   device="cpu")
    ((res.runoff * torch.tensor(w)).sum() + (res.final_discharge * torch.tensor(wf)).sum()).backward()
    _close(jres.runoff, res.runoff.detach(), f"{engine}: runoff")
    _close(jres.final_discharge, res.final_discharge.detach(), f"{engine}: final discharge")
    _close(jgrad[1], qp.grad, f"{engine}: d/dq_prime")
    for k in ("n", "q_spatial"):
        _close(jgrad[0][k], p[k].grad, f"{engine}: d/d{k}")


# ---- (d) a NaN-poisoned inflow ----


@pytest.mark.parametrize("name", ["ring", "band1", "chunked"])
def test_nan_poisoned_inflow_gives_the_skewed_scans_nan_pattern(name):
    net, T, mask_raw, has_ext = _tables(name)
    q, xe, se, q_init, ph = _forward_inputs(net, T, has_ext, False, 67)
    phys = _torch_physics(ph)
    # poison a reach that has a successor in the table, at one timestep
    succ = net.wf_t_col.reshape(net.n, -1)[:, 0]
    i0 = int(torch.nonzero(succ < net.n)[0])
    q[:, T // 2, i0] = float("nan")
    raw = wave_scan_tm_reference(q, net, phys, q_init, x_ext=xe, s_ext=se, mask_raw=mask_raw)
    ref = _skewed_forward(net, phys, q, q_init, xe, se, mask_raw, "fp32")
    nan = torch.isnan(ref)
    assert nan.sum() > q.shape[0], "the poison must spread downstream"
    assert torch.equal(torch.isnan(raw), nan)
    torch.testing.assert_close(raw, ref, rtol=0, atol=0, equal_nan=True)


def test_a_table_whose_pad_slot_reads_a_reach_is_refused():
    """The ring policy rests on every pad slot reading the zero sentinel: a
    pad slot aimed at a reach's column (which may hold a stale, even NaN,
    value out of band) is refused before any scan."""
    net, T, _, _ = _tables("ring")
    pad = int(torch.nonzero(net.wf_mask == 0)[0])
    bad_col = net.wf_col.clone()
    bad_col[pad] = 0
    bad = dataclasses.replace(net, wf_col=bad_col)
    with pytest.raises(ValueError, match="pad slot"):
        active_runs(bad, T)
