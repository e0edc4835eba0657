"""The port's analytic adjoint against the JAX package's gradients of ``route``.

The same random DAG, channels, parameters and inflows go through JAX
``mc.route`` (XLA scan, ``adjoint="analytic"`` and ``adjoint="ad"``) and the
port's ``route`` on the CPU (its analytic adjoint over the plain scans). The
loss weights are those of ``tests/routing/test_adjoint.py``: dense,
sign-mixed weights on every runoff entry and on the final discharge, so
every reach-timestep contributes a distinct cotangent. About a quarter of the
inflows are zero, which drives raw solve values below the discharge clamp,
and the ``q_init`` case sets some initial states below the bound and some
exactly on it: ``max(q_init, lb)`` then makes ``raw == lb`` exactly, where
the clamp's gradient splits 0.5/0.5 in JAX and must do so here.

Tolerance: rtol 1e-5 with an absolute floor of 1e-5 x the leaf's largest
gradient magnitude, as in ``tests/routing/test_adjoint.py:91-104`` (float32
physics and reductions differ by ulps between XLA and PyTorch).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing.network import build_network as jax_build_network
from ddr_tpu_torch.routing import mc
from ddr_tpu_torch.routing.network import build_network
from ddr_tpu_torch.routing.wave_kernel import physics_derivatives, physics_pullback
from tests.test_torch_network import _random_dag
from tests.test_torch_wave_kernel import LB, _physics, _torch_physics

PARAMS = ("n", "q_spatial", "p_spatial")
OPERANDS = ("n", "p_spatial", "q_spatial", "slope", "length", "x_storage")  # reach_operands order


def _close(ref, out, label):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = max(np.max(np.abs(ref)), np.max(np.abs(out)), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * scale, err_msg=label)


def _inputs(seed, n, t, with_init):
    rng = np.random.default_rng(seed)
    rows, cols = _random_dag(rng, n)
    ch = {"length": rng.uniform(500.0, 5000.0, n), "slope": rng.uniform(1e-3, 1e-2, n),
          "x": rng.uniform(0.1, 0.4, n)}
    params = {"n": rng.uniform(0.02, 0.06, n), "q_spatial": rng.uniform(0.2, 0.8, n),
              "p_spatial": rng.uniform(5.0, 30.0, n)}
    q = rng.uniform(0.0, 2.0, (t, n))
    q[rng.random((t, n)) < 0.25] = 0.0
    w, wf = rng.normal(size=(t, n)), rng.normal(size=n)
    q_init = None
    if with_init:
        q_init = rng.uniform(0.0, 3.0, n).astype(np.float32)
        q_init[::5] = 0.0  # below the bound
        q_init[1::7] = np.float32(LB)  # exactly on it
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}  # noqa: E731
    return (rows, cols), f32(ch), f32(params), np.float32(q), np.float32(w), np.float32(wf), q_init


def _jax_grads(topo, ch, params, q, w, wf, q_init, adjoint, gauges):
    net = jax_build_network(*topo, q.shape[1])
    channels = jax_mc.ChannelState(length=jnp.asarray(ch["length"]), slope=jnp.asarray(ch["slope"]),
                                   x_storage=jnp.asarray(ch["x"]))
    g = None if gauges is None else jax_mc.GaugeIndex.from_ragged(gauges)
    w = w[:, : len(gauges)] if gauges is not None else w

    def loss(p, qp, length, qi):
        res = jax_mc.route(net, dataclasses.replace(channels, length=length), p, qp, q_init=qi,
                           gauges=g, bounds=jax_mc.Bounds(discharge=LB), adjoint=adjoint, kernel="xla")
        return (res.runoff * w).sum() + (res.final_discharge * wf).sum()

    qi = None if q_init is None else jnp.asarray(q_init)
    argnums = (0, 1, 2) if qi is None else (0, 1, 2, 3)
    return jax.grad(loss, argnums=argnums)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(q), jnp.asarray(ch["length"]), qi
    )


def _port_grads(topo, ch, params, q, w, wf, q_init, gauges):
    n = q.shape[1]
    net = build_network(*topo, n, device="cpu")
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    length = torch.tensor(ch["length"], requires_grad=True)
    channels = mc.ChannelState(length=length, slope=torch.tensor(ch["slope"]),
                               x_storage=torch.tensor(ch["x"]))
    qp = torch.tensor(q, requires_grad=True)
    qi = None if q_init is None else torch.tensor(q_init, requires_grad=True)
    g = None if gauges is None else mc.GaugeIndex.from_ragged(gauges, device="cpu")
    w = w[:, : len(gauges)] if gauges is not None else w
    res = mc.route(net, channels, p, qp, q_init=qi, gauges=g, bounds=mc.Bounds(discharge=LB),
                   device="cpu")
    ((res.runoff * torch.tensor(w)).sum() + (res.final_discharge * torch.tensor(wf)).sum()).backward()
    return p, qp, length, qi


def _assert_match(ref, ours, label):
    p, qp, length, qi = ours
    for k in PARAMS:
        _close(ref[0][k], p[k].grad, f"{label}: d/d{k}")
    _close(ref[1], qp.grad, f"{label}: d/dq_prime")
    _close(ref[2], length.grad, f"{label}: d/dlength")
    if qi is not None:
        _close(ref[3], qi.grad, f"{label}: d/dq_init")


@pytest.mark.parametrize("adjoint", ["analytic", "ad"])
@pytest.mark.parametrize("init", ["hotstart", "q_init"])
def test_route_gradients_match_jax(init, adjoint):
    args = _inputs(41 if init == "hotstart" else 43, 72, 12, init == "q_init")
    ours = _port_grads(*args, gauges=None)
    _assert_match(_jax_grads(*args, adjoint, gauges=None), ours, f"{init} vs JAX {adjoint}")


def test_q_init_on_and_below_the_bound_splits_the_clamp_gradient():
    """Reaches with ``q_init <= lb`` start at ``raw == lb`` exactly: their
    ``q_init`` gradient is 0 below the bound and half the upstream
    cotangent on it, as JAX's ``_dmax`` gives."""
    args = _inputs(43, 72, 12, True)
    q_init = args[-1]
    _, _, _, qi = _port_grads(*args, gauges=None)
    ref = _jax_grads(*args, "ad", gauges=None)[3]
    below, on = q_init < LB, q_init == np.float32(LB)
    assert below.any() and on.any()
    assert (qi.grad[torch.as_tensor(below)] == 0).all()
    _close(np.asarray(ref)[on], qi.grad[torch.as_tensor(on)], "q_init gradient on the bound")
    assert (qi.grad[torch.as_tensor(on)] != 0).any()


@pytest.mark.parametrize("adjoint", ["analytic", "ad"])
def test_gauge_aggregated_gradients_match_jax(adjoint):
    args = _inputs(11, 64, 10, False)
    rng = np.random.default_rng(12)
    gauges = [rng.choice(64, size=3, replace=False) for _ in range(4)]
    ours = _port_grads(*args, gauges=gauges)
    _assert_match(_jax_grads(*args, adjoint, gauges=gauges), ours, f"gauges vs JAX {adjoint}")


def test_single_timestep_window_matches_jax():
    """T = 1: only the hotstart diagonal exists."""
    args = _inputs(3, 40, 1, False)
    ours = _port_grads(*args, gauges=None)
    _assert_match(_jax_grads(*args, "ad", gauges=None), ours, "T=1")


def test_batched_gradients_equal_per_request_gradients():
    (rows, cols), ch, params, q, w, wf, _ = _inputs(17, 48, 8, False)
    net = build_network(rows, cols, 48, device="cpu")
    channels = mc.ChannelState(length=torch.tensor(ch["length"]), slope=torch.tensor(ch["slope"]),
                               x_storage=torch.tensor(ch["x"]))
    batch = torch.tensor(np.stack([q, 0.5 * q, 2.0 * q]))

    def grad_n(qp):
        p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
        res = mc.route(net, channels, p, qp, device="cpu")
        (res.runoff * torch.tensor(w)).sum().backward()
        return p["n"].grad

    per_request = sum(grad_n(batch[i]) for i in range(3))
    torch.testing.assert_close(grad_n(batch), per_request, rtol=1e-5, atol=1e-5 * float(per_request.abs().max()))


def test_physics_derivatives_and_pullback_match_jax():
    """The chain's elementwise ``q_prev`` derivatives (one forward-mode pass)
    and the pullback of ``(c1..c4)`` cotangents to the per-reach operands over
    a ``(T, n)`` batch, against ``jax.jvp`` / ``jax.vjp`` of the same chain."""
    rng = np.random.default_rng(37)
    n, t = 64, 9
    ph = _physics(rng, n)
    q_prev = rng.uniform(LB, 30.0, (t, n)).astype(np.float32)
    c_bar = [rng.normal(size=(t, n)).astype(np.float32) for _ in range(4)]
    phys = _torch_physics(ph)
    (cs, ds) = physics_derivatives(torch.as_tensor(q_prev), phys)
    theta = physics_pullback(torch.as_tensor(q_prev), phys, tuple(map(torch.as_tensor, c_bar)),
                             [True] * len(OPERANDS))

    keys = ("n", "p", "q", "slope", "length", "x")  # OPERANDS in _physics's names
    consts = tuple(jnp.asarray(np.asarray(ph[k], np.float32)) for k in keys)

    def chain(qp, n_mann, p, q, slope, length, x):
        ch = jax_mc.ChannelState(length=length, slope=slope, x_storage=x)
        c = jax_mc.celerity(qp, n_mann, p, q, ch, jax_mc.Bounds(discharge=LB))[0]
        return jax_mc.muskingum_coefficients(length, c, x, jax_mc.DT_SECONDS)

    ref_c, ref_d = jax.jvp(lambda qp: chain(qp, *consts), (jnp.asarray(q_prev),),
                           (jnp.ones_like(q_prev),))
    _, pull = jax.vjp(lambda *ops: chain(jnp.asarray(q_prev), *ops), *consts)
    ref_theta = pull(tuple(jnp.asarray(c) for c in c_bar))
    for k in range(4):
        _close(ref_c[k], cs[k], f"c{k + 1}")
        _close(ref_d[k], ds[k], f"d{k + 1}")
    for name, r, g in zip(OPERANDS, ref_theta, theta):
        _close(r, g, f"pullback to {name}")
