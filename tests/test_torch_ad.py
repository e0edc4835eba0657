"""``adjoint="ad"``: autograd through the port's plain forward scan.

The analytic reverse-wavefront adjoint is the port's default backward; the
JAX package keeps standard AD through its wave scan as the in-framework
check of it (``tests/routing/test_adjoint.py::TestAnalyticMatchesAD``). The
port's counterpart differentiates ``wave_scan_autograd``, the plain scan
with an out-of-place ring, whose forward equals ``wave_scan_reference`` bit
for bit (fp32 and bf16, with and without external rows). The same DAG,
channels, parameters and inflows, made from fixed seeds with numpy, give:

* gradients of a dense weighted loss through ``adjoint="ad"`` against the
  port's analytic adjoint and against JAX ``route(adjoint="ad")``, on the
  single ring (hotstart and ``q_init``), and against the analytic adjoint on
  a stacked frame and a ``ChunkedNetwork``;
* the same forward with ``remat_physics`` on and off, and the same
  gradients within float tolerance.

Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x the leaf's largest
gradient magnitude, as in ``tests/routing/test_adjoint.py:92-102``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ddr_tpu_torch.routing import mc
from ddr_tpu_torch.routing.chunked import build_chunked_network
from ddr_tpu_torch.routing.network import build_network
from ddr_tpu_torch.routing.stacked import build_stacked_chunked
from ddr_tpu_torch.routing.wave_kernel import wave_scan_autograd, wave_scan_reference
from tests.test_torch_adjoint import PARAMS, _close, _inputs, _jax_grads
from tests.test_torch_wave_kernel import LB, _case, _torch_physics


def _grads(net, args, adjoint, remat_physics=True, gauges=None):
    """Gradients of the dense weighted loss of ``test_torch_adjoint.py`` on
    any network the port routes: ``(params, q', length, q_init)`` leaves."""
    topo, ch, params, q, w, wf, q_init = args
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    length = torch.tensor(ch["length"], requires_grad=True)
    channels = mc.ChannelState(length=length, slope=torch.tensor(ch["slope"]), x_storage=torch.tensor(ch["x"]))
    qp = torch.tensor(q, requires_grad=True)
    qi = None if q_init is None else torch.tensor(q_init, requires_grad=True)
    res = mc.route(net, channels, p, qp, q_init=qi, bounds=mc.Bounds(discharge=LB), adjoint=adjoint,
                   remat_physics=remat_physics, device="cpu")
    ((res.runoff * torch.tensor(w)).sum() + (res.final_discharge * torch.tensor(wf)).sum()).backward()
    return res.runoff.detach(), (p, qp, length, qi)


def _assert_same(ref, ours, label):
    (p_r, q_r, l_r, qi_r), (p_o, q_o, l_o, qi_o) = ref, ours
    for k in PARAMS:
        _close(p_r[k].grad, p_o[k].grad, f"{label}: d/d{k}")
    _close(q_r.grad, q_o.grad, f"{label}: d/dq_prime")
    _close(l_r.grad, l_o.grad, f"{label}: d/dlength")
    if qi_r is not None:
        _close(qi_r.grad, qi_o.grad, f"{label}: d/dq_init")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["hotstart", "q_init", "T=1", "no-edges"])
def test_autograd_scan_forward_is_the_reference_bit_for_bit(case, dtype):
    net, ph, qs, q_init, T = _case(case)
    phys = _torch_physics(ph)
    rng = np.random.default_rng(4)
    xe, se = (torch.as_tensor(rng.uniform(0.0, 1.0, qs.shape).astype(np.float32)) for _ in range(2))
    qi = None if q_init is None else torch.as_tensor(q_init)
    for ext in ({}, {"xe": xe, "se": se}):
        kw = dict(T=T, compute_dtype=dtype, **ext)
        ref = wave_scan_reference(torch.as_tensor(qs), net, phys, qi, **kw)
        for remat in (True, False):
            got = wave_scan_autograd(torch.as_tensor(qs), net, phys, qi, remat_physics=remat, **kw)
            torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("init", ["hotstart", "q_init"])
def test_ad_gradients_match_the_analytic_adjoint_and_jax_ad(init):
    args = _inputs(41 if init == "hotstart" else 43, 72, 12, init == "q_init")
    net = build_network(*args[0], 72, device="cpu")
    runoff_a, analytic = _grads(net, args, "analytic")
    runoff_d, ad = _grads(net, args, "ad")
    torch.testing.assert_close(runoff_d, runoff_a, rtol=0, atol=0)  # one forward scan, either way
    _assert_same(analytic, ad, f"{init}: ad vs analytic")
    ref = _jax_grads(*args, "ad", gauges=None)
    p, qp, length, qi = ad
    for k in PARAMS:
        _close(ref[0][k], p[k].grad, f"{init}: d/d{k} vs JAX ad")
    _close(ref[1], qp.grad, f"{init}: d/dq_prime vs JAX ad")
    _close(ref[2], length.grad, f"{init}: d/dlength vs JAX ad")
    if qi is not None:
        _close(ref[3], qi.grad, f"{init}: d/dq_init vs JAX ad")


def test_remat_physics_keeps_the_forward_and_the_gradients():
    args = _inputs(47, 72, 12, True)
    net = build_network(*args[0], 72, device="cpu")
    runoff_on, on = _grads(net, args, "ad", remat_physics=True)
    runoff_off, off = _grads(net, args, "ad", remat_physics=False)
    torch.testing.assert_close(runoff_on, runoff_off, rtol=0, atol=0)
    _assert_same(off, on, "remat_physics on vs off")


@pytest.mark.parametrize("router", ["stacked", "chunked"])
def test_ad_through_band_routers_matches_the_analytic_adjoint(router):
    args = _inputs(53, 72, 12, True)
    rows, cols = args[0]
    if router == "stacked":
        net = build_stacked_chunked(rows, cols, 72, cell_budget=120, device="cpu")
    else:
        net = build_chunked_network(rows, cols, 72, cell_budget=600, device="cpu")
    assert net.n_chunks >= 2
    _, analytic = _grads(net, args, "analytic")
    _, ad = _grads(net, args, "ad")
    _assert_same(analytic, ad, f"{router}: ad vs analytic")
