"""The port's unrolled depth-chunked router against the JAX package's.

``build_chunked_network`` bands a deep network into per-band networks with
forced wavefront tables; ``route_chunked`` routes them one after another,
each band's scan taking the raw (``x_ext``) and clamped (``s_ext``) sums of
its predecessors in earlier bands with unmasked raw sums: the
``fused_wave_scan`` variant with external rows and ``mask_raw=False``. The
same topologies, channels, parameters and inflows, made from fixed seeds
with numpy, go through:

* both builders, field for field, at cell budgets 60,000 / 8,000 / 4,000 on
  ``make_deep_network(320, 80)`` and 120 on 32- and 28-reach chains (the
  28-reach chain's last band is one level: local depth 0, no in-band edge,
  one external predecessor);
* the plain scan ``wave_scan_reference(xe, se, mask_raw=False)`` against
  ``fused_wave_scan`` in interpret mode, fp32 and bf16, with and without
  ``q_init``, on a band with external rows and on the depth-0 band;
* ``route`` on both packages' ``ChunkedNetwork`` (JAX jitted, XLA scans):
  runoff and final discharge with gauges and ``q_init``, fp32 and bf16; the
  analytic gradients against ``jax.grad``; a batch against its requests;
* one train step on a ``ChunkedNetwork`` against JAX's.

Tolerances: fp32 rtol 1e-5 with an absolute floor of 1e-5 x the largest
magnitude (float32 physics differs by ulps between XLA and PyTorch); bf16
one bf16 epsilon, ``|a - b| <= 2**-7 |ref| + 1e-5 max|ref|``; gradients and
the train step as in ``test_torch_training.py``.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu import training as jax_training
from ddr_tpu.geodatazoo.synthetic import make_basin as jax_make_basin
from ddr_tpu.geodatazoo.synthetic import observe as jax_observe
from ddr_tpu.nn.kan import Kan as FlaxKan
from ddr_tpu.routing import chunked as jax_chunked
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing.model import prepare_channels as jax_prepare_channels
from ddr_tpu.routing.pallas_kernel import fused_wave_scan
from ddr_tpu_torch import training
from ddr_tpu_torch.geodatazoo.synthetic import make_basin, make_deep_network, observe
from ddr_tpu_torch.nn.convert import kan_state_from_flax
from ddr_tpu_torch.nn.kan import Kan
from ddr_tpu_torch.routing import chunked, mc, stacked
from ddr_tpu_torch.routing.chunked import ChunkedNetwork, build_chunked_network, build_routing_network
from ddr_tpu_torch.routing.model import engine_label, prepare_channels
from ddr_tpu_torch.routing.wave_kernel import wave_scan, wave_scan_reference
from ddr_tpu_torch.validation.configs import Config, KanConfig
from tests.test_torch_training import _check_params
from tests.test_torch_wave_kernel import LB, _jax_physics_fn, _physics, _torch_physics

EPS_BF16 = 2.0**-7
TOPOLOGIES = {
    "deep-60000": (320, 80, 60_000),
    "deep-8000": (320, 80, 8_000),
    "deep-4000": (320, 80, 4_000),
    "chain-32": (32, None, 120),
    "chain-28": (28, None, 120),
}
NETWORK_FIELDS = ("level", "level_p", "wf_perm", "wf_inv", "wf_idx", "wf_mask", "wf_t_idx", "lvl_src",
                  "lvl_tgt", "edge_src", "edge_tgt")
NETWORK_STATICS = ("n", "depth", "n_edges", "wf_buckets", "wf_level_runs", "wf_t_width", "wf_ring_rows",
                   "wavefront", "fused")


def _close(ref, out, label, rtol=1e-5):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = max(np.max(np.abs(ref)), np.max(np.abs(out)), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-5 * scale, err_msg=label)


def _topology(name):
    n, depth, budget = TOPOLOGIES[name]
    if depth is None:
        return np.arange(1, n), np.arange(0, n - 1), n, budget
    rows, cols = make_deep_network(n, depth, seed=2)
    return rows, cols, n, budget


def _networks(name):
    rows, cols, n, budget = _topology(name)
    return (build_chunked_network(rows, cols, n, cell_budget=budget, device="cpu"),
            jax_chunked.build_chunked_network(rows, cols, n, cell_budget=budget))


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_build_chunked_network_equals_jax(name):
    ours, ref = _networks(name)
    for field in ("n", "depth", "n_edges", "n_boundary", "n_chunks"):
        assert getattr(ours, field) == getattr(ref, field), field
    np.testing.assert_array_equal(ours.level.numpy(), np.asarray(ref.level))
    np.testing.assert_array_equal(ours.out_inv.numpy(), np.asarray(ref.out_inv))
    for c in range(ref.n_chunks):
        for field in ("gidx", "pub_idx", "ext_cols", "ext_tgt"):
            np.testing.assert_array_equal(getattr(ours, field)[c].numpy(),
                                          np.asarray(getattr(ref, field)[c]), err_msg=f"{field}[{c}]")
        net, jnet = ours.chunks[c], ref.chunks[c]
        for field in NETWORK_FIELDS:
            expect = np.asarray(jnet.level)[np.asarray(jnet.wf_perm)] if field == "level_p" else \
                np.asarray(getattr(jnet, field))
            np.testing.assert_array_equal(getattr(net, field).numpy(), expect, err_msg=f"band {c} {field}")
        for field in NETWORK_STATICS:
            assert getattr(net, field) == getattr(jnet, field), f"band {c} {field}"
    if name == "chain-28":
        last = ours.chunks[-1]
        assert last.depth == 0 and last.n_edges == 0 and ours.ext_cols[-1].numel() == 1


def test_build_routing_network_with_a_budget_builds_the_chunked_router():
    rows, cols = make_deep_network(1500, 1100, seed=0)
    net = build_routing_network(rows, cols, 1500, cell_budget=100_000, device="cpu")
    ref = jax_chunked.build_routing_network(rows, cols, 1500, cell_budget=100_000)
    assert isinstance(net, ChunkedNetwork) and net.n_chunks == ref.n_chunks > 1
    assert engine_label(net) == f"depth-chunked-wavefront[{ref.n_chunks}-band]"


def test_auto_cell_budget_takes_the_port_constants_and_the_overrides(monkeypatch):
    """The H100 model has no ring-copy term: the fewest bands whose budget
    fits the cap. The constants are arguments, as for ``auto_band_count``:
    the JAX package's v5e literals passed in give the JAX budget, and the
    ``DDR_WAVE_*`` variables (which only the JAX package reads) do not
    reach the port."""
    n, depth = 2_900_000, 4000
    monkeypatch.setenv("DDR_WAVE_FIXED_US", "35")
    monkeypatch.setenv("DDR_WAVE_RING_GBPS", "210")
    budget = chunked.auto_cell_budget(n, depth)
    span = depth // 16  # 16 bands: the first power of two whose span-sized ring fits 2^26 cells
    assert budget == (span + 1) * (int(span * n / depth) + 1) <= chunked.CHUNK_CELL_BUDGET
    assert budget == chunked.auto_cell_budget(n, depth, wave_fixed_s=stacked.WAVE_FIXED_S,
                                              ring_copy_bps=stacked.RING_COPY_BYTES_PER_S)
    with monkeypatch.context() as mp:  # the JAX literals give the JAX budget
        mp.delenv("DDR_WAVE_FIXED_US")
        mp.delenv("DDR_WAVE_RING_GBPS")
        assert jax_chunked.wave_cost_constants() == pytest.approx((35e-6, 2.1e11))
        jax_budget = jax_chunked.auto_cell_budget(n, depth, ring_rows_cap=40)
    ours = chunked.auto_cell_budget(n, depth, ring_rows_cap=40, wave_fixed_s=35e-6, ring_copy_bps=2.1e11)
    assert ours == jax_budget < chunked.auto_cell_budget(n, depth, ring_rows_cap=40) == budget


# ---- the plain scan's external-row, mask_raw=False variant against Pallas ----


def _ext_case(band_name, dtype_name, init):
    cn, _ = _networks("deep-8000" if band_name == "ext-band" else "chain-28")
    c = 1 if band_name == "ext-band" else cn.n_chunks - 1
    net = cn.chunks[c]
    assert cn.ext_cols[c].numel() > 0
    rng = np.random.default_rng(sum(ord(ch) for ch in band_name + dtype_name + init))
    T, B = 12, 2
    W = T + net.depth
    qs, xe, se = (rng.uniform(0.0, 2.0, (B, W, net.n)).astype(np.float32) for _ in range(3))
    qs[rng.random(qs.shape) < 0.25] = 0.0  # raw values below the discharge clamp
    q_init = rng.uniform(0.0, 3.0, (B, net.n)).astype(np.float32) if init == "q_init" else None
    return net, _physics(rng, net.n), qs, xe, se, q_init, T


@pytest.mark.parametrize("init", ["hotstart", "q_init"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("band", ["ext-band", "depth-0-band"])
def test_ext_scan_matches_the_pallas_kernel_in_interpret_mode(band, dtype, init):
    net, ph, qs, xe, se, q_init, T = _ext_case(band, dtype, init)
    assert (net.depth == 0) == (band == "depth-0-band")
    t = torch.as_tensor
    ys = wave_scan_reference(t(qs), net, _torch_physics(ph), None if q_init is None else t(q_init),
                             T=T, xe=t(xe), se=t(se), mask_raw=False, compute_dtype=dtype).numpy()
    assert ys.shape == qs.shape and np.isfinite(ys).all()
    for b in range(qs.shape[0]):
        ref = fused_wave_scan(
            _jax_physics_fn(ph), jnp.asarray(net.level_p.numpy()), jnp.asarray(net.wf_row.numpy()),
            jnp.asarray(net.wf_col.numpy()), jnp.asarray(net.wf_mask.numpy()), net.wf_buckets,
            jnp.asarray(qs[b]), jnp.asarray(xe[b]), jnp.asarray(se[b]),
            None if q_init is None else jnp.asarray(q_init[b]), T=T, n=net.n, span=net.depth, lb=LB,
            mask_raw=False, compute_dtype=dtype, interpret=True, ring_rows=net.wf_ring_rows,
        )
        _close(ref, ys[b], f"{band} {dtype} {init}: plain scan vs fused_wave_scan, request {b}",
               rtol=EPS_BF16 if dtype == "bf16" else 1e-5)
    before = wave_scan.launches  # on CPU tensors the wrapper is the plain version
    again = wave_scan(t(qs), net, _torch_physics(ph), None if q_init is None else t(q_init), T=T,
                      xe=t(xe), se=t(se), compute_dtype=dtype)
    assert wave_scan.launches == before and np.array_equal(again.numpy(), ys)


# ---- route on a ChunkedNetwork against JAX ----


class _Routes:
    """Both packages' ``ChunkedNetwork`` of one deep synthetic basin (3 bands)."""

    def __init__(self):
        kw = dict(n_segments=320, n_gauges=4, n_days=2, seed=9, depth=60)
        ours, ref = make_basin(**kw), jax_make_basin(**kw)
        rd = ours.routing_data
        self.n = rd.n_segments
        self.q = ours.q_prime[:24].copy()
        self.q[:, ::7] = 0.0  # headwater inflows below the discharge clamp
        self.net = build_chunked_network(rd.adjacency_rows, rd.adjacency_cols, self.n, cell_budget=4000,
                                         device="cpu")
        self.jnet = jax_chunked.build_chunked_network(rd.adjacency_rows, rd.adjacency_cols, self.n,
                                                      cell_budget=4000)
        assert self.net.n_chunks >= 3 and self.net.n_boundary > 0
        self.channels, self.gauges = prepare_channels(rd, 0.001, device="cpu")
        self.jchannels, self.jgauges = jax_prepare_channels(ref.routing_data, 0.001)
        rng = np.random.default_rng(10)
        self.params = {"n": rng.uniform(0.02, 0.1, self.n).astype(np.float32),
                       "q_spatial": rng.uniform(0.1, 0.9, self.n).astype(np.float32),
                       "p_spatial": np.full(self.n, 21.0, np.float32)}
        self.q_init = rng.uniform(0.0, 3.0, self.n).astype(np.float32)
        self.q_init[::5] = 0.0

    def jax_route(self, q, q_init, gauged, dtype="fp32", weights=None):
        def run(params, qp, qi):
            res = jax_mc.route(self.jnet, self.jchannels, params, qp, q_init=qi,
                               gauges=self.jgauges if gauged else None, kernel="xla", dtype=dtype)
            if weights is None:
                return res
            return (res.runoff * weights[0]).sum() + (res.final_discharge * weights[1]).sum()

        args = ({k: jnp.asarray(v) for k, v in self.params.items()}, jnp.asarray(q),
                None if q_init is None else jnp.asarray(q_init))
        if weights is None:
            return jax.jit(run)(*args)
        return jax.jit(jax.grad(run, argnums=(0, 1, 2) if q_init is not None else (0, 1)))(*args)


@pytest.fixture(scope="module")
def routes():
    return _Routes()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["gauges/hotstart", "full-domain/q_init"])
def test_chunked_route_matches_jax(routes, case, dtype):
    gauged, init = case.split("/")
    q_init = routes.q_init if init == "q_init" else None
    res = mc.route(routes.net, routes.channels, {k: torch.as_tensor(v) for k, v in routes.params.items()},
                   torch.as_tensor(routes.q), q_init=None if q_init is None else torch.as_tensor(q_init),
                   gauges=routes.gauges if gauged == "gauges" else None, dtype=dtype, device="cpu")
    ref = routes.jax_route(routes.q, q_init, gauged == "gauges", dtype)
    assert res.runoff.shape == ref.runoff.shape
    rtol = EPS_BF16 if dtype == "bf16" else 1e-5
    _close(ref.runoff, res.runoff, f"{case} {dtype}: runoff", rtol)
    _close(ref.final_discharge, res.final_discharge, f"{case} {dtype}: final discharge", rtol)


@pytest.mark.parametrize("init", ["hotstart", "q_init"])
def test_chunked_analytic_gradients_match_jax(routes, init):
    rng = np.random.default_rng(21)
    w = rng.normal(size=(routes.q.shape[0], routes.gauges.n_gauges)).astype(np.float32)
    wf = rng.normal(size=routes.n).astype(np.float32)
    q_init = routes.q_init if init == "q_init" else None
    ref = routes.jax_route(routes.q, q_init, True, weights=(w, wf))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in routes.params.items()}
    qp = torch.tensor(routes.q, requires_grad=True)
    qi = None if q_init is None else torch.tensor(q_init, requires_grad=True)
    res = mc.route(routes.net, routes.channels, p, qp, q_init=qi, gauges=routes.gauges, device="cpu")
    ((res.runoff * torch.as_tensor(w)).sum() + (res.final_discharge * torch.as_tensor(wf)).sum()).backward()
    for k in ("n", "q_spatial", "p_spatial"):
        _close(ref[0][k], p[k].grad, f"{init}: d/d{k}", rtol=1e-4)
    _close(ref[1], qp.grad, f"{init}: d/dq_prime", rtol=1e-4)
    if qi is not None:
        _close(ref[2], qi.grad, f"{init}: d/dq_init", rtol=1e-4)


def test_batched_chunked_route_equals_per_request_routes(routes):
    params = {k: torch.as_tensor(v) for k, v in routes.params.items()}
    q = torch.as_tensor(routes.q)
    batch = torch.stack([q, 0.5 * q, 2.0 * q])
    res_b = mc.route(routes.net, routes.channels, params, batch, gauges=routes.gauges, device="cpu")
    for i in range(3):
        res_i = mc.route(routes.net, routes.channels, params, batch[i], gauges=routes.gauges, device="cpu")
        torch.testing.assert_close(res_b.runoff[i], res_i.runoff)
        torch.testing.assert_close(res_b.final_discharge[i], res_i.final_discharge)
    with pytest.raises(ValueError, match="banded wavefront"):
        mc.route(routes.net, routes.channels, params, q, engine="step", device="cpu")


def test_chunked_train_step_matches_jax():
    names = tuple(f"a{i}" for i in range(10))
    n_days, warmup, lr = 3, 1, 0.005
    cfg = Config(kan=KanConfig(input_var_names=list(names)))
    p = cfg.params
    jcfg = types.SimpleNamespace(params=types.SimpleNamespace(attribute_minimums=p.attribute_minimums,
                                                              tau=p.tau))
    kw = dict(n_segments=240, n_gauges=4, n_days=n_days, seed=12, depth=40)
    ours = observe(make_basin(**kw), cfg, device="cpu")
    ref = jax_observe(jax_make_basin(**kw), jcfg)
    rd = ours.routing_data
    obs = ref.obs_daily[: n_days - 2]
    mask = np.isfinite(obs)
    attrs = rd.normalized_spatial_attributes
    q = ours.q_prime[: (n_days - 1) * 24]
    bounds_kw = {k: v for k, v in p.attribute_minimums.items() if k != "slope"}

    jnet = jax_chunked.build_chunked_network(rd.adjacency_rows, rd.adjacency_cols, rd.n_segments,
                                             cell_budget=3000)
    net = build_chunked_network(rd.adjacency_rows, rd.adjacency_cols, rd.n_segments, cell_budget=3000,
                                device="cpu")
    assert net.n_chunks == jnet.n_chunks >= 2
    fk = FlaxKan(input_var_names=names, learnable_parameters=("n", "q_spatial"))
    jparams = jax.tree_util.tree_map(np.asarray, fk.init(jax.random.PRNGKey(0), attrs))
    jopt = jax_training.make_optimizer(lr)
    jch, jg = jax_prepare_channels(ref.routing_data, p.attribute_minimums["slope"])
    jstep = jax_training.make_batch_train_step(fk, jax_mc.Bounds(**bounds_kw), p.parameter_ranges,
                                               p.log_space_parameters, p.defaults, p.tau, warmup, jopt,
                                               donate=False)
    jnew, _, jloss, jdaily = jstep(jparams, jopt.init(jparams), jnet, jch, jg, jnp.asarray(attrs),
                                   jnp.asarray(q), jnp.asarray(np.nan_to_num(obs)), jnp.asarray(mask))

    kan = Kan(names, ("n", "q_spatial"))
    kan.load_state_dict(kan_state_from_flax(jparams))
    before = {k: v.detach().clone() for k, v in kan.state_dict().items()}
    opt = training.make_optimizer(kan.parameters(), lr)
    ch, g = prepare_channels(rd, p.attribute_minimums["slope"], device="cpu")
    step = training.make_batch_train_step(kan, mc.Bounds(**bounds_kw), p.parameter_ranges,
                                          p.log_space_parameters, p.defaults, p.tau, warmup, opt,
                                          device="cpu")
    grads = {}
    hooks = [t.register_hook(lambda gr, k=k: grads.__setitem__(k, gr.clone()))
             for k, t in kan.named_parameters()]
    loss, daily = step(net, ch, g, torch.as_tensor(attrs), torch.as_tensor(q),
                       torch.as_tensor(np.nan_to_num(obs)), torch.as_tensor(mask))
    for h in hooks:
        h.remove()
    _close(jloss, loss, "loss")
    _close(jdaily, daily, "daily predictions")
    _check_params(kan_state_from_flax(jparams), kan_state_from_flax(jax.tree_util.tree_map(np.asarray, jnew)),
                  before, kan.state_dict(), grads, lr, "chunked train step")
