"""The port's level-scheduled triangular solve against the JAX package's and SciPy's.

``ddr_tpu_torch.routing.solver`` solves ``(I - diag(c1) N) x = b`` on both
schedules a network carries (the rectangle of level rows, and the fused
level-contiguous gather schedule) and differentiates it by the transposed
sweep. The same random DAGs and coefficients go through JAX
``solve_lower_triangular``/``solve_transposed`` (float32) and SciPy's float64
``spsolve_triangular``; gradients are held against ``jax.grad`` of JAX's
custom VJP and against finite differences in float64
(``torch.autograd.gradcheck``). The builders' step-engine tables equal the
JAX builder's field for field, including a level split into several
rectangle rows.

Tolerances: float32 against JAX rtol 1e-5 with an absolute floor of 1e-5 x
the largest magnitude (the sums along the longest path reassociate); float64
against SciPy rtol 1e-12.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve_triangular
import torch

from ddr_tpu.routing import solver as jax_solver
from ddr_tpu.routing.network import build_network as jax_build_network
from ddr_tpu.routing.network import level_schedule as jax_level_schedule
from ddr_tpu_torch.geodatazoo.synthetic import make_deep_network
from ddr_tpu_torch.routing import solver
from ddr_tpu_torch.routing.network import build_network, level_schedule

SCHEDULES = ("fused", "rectangle")


def _close(ref, out, label, rtol=1e-5):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = max(np.max(np.abs(ref)), np.max(np.abs(out)), 1e-8)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * scale, err_msg=label)


def _topology(name):
    """``(rows, cols, n)``: a river tree with confluences (fused-eligible),
    or the same kind of tree with one wide level whose 1,500 edges split
    into two rectangle rows."""
    if name == "dag":
        n = 150
        rows, cols = make_deep_network(n, 15, seed=3)
        return rows, cols, n
    rows, cols = make_deep_network(300, 30, seed=4)
    star = np.arange(300, 1800)  # 1,500 new headwaters draining into reach 299
    return np.concatenate([rows, np.full(star.size, 299)]), np.concatenate([cols, star]), 1800


def _system(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 0.9, n).astype(dtype), rng.uniform(0.0, 2.0, n).astype(dtype)


def _scipy_matrix(rows, cols, n, c1):
    adj = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
    return (sp.eye(n) - sp.diags(c1.astype(np.float64)) @ adj).tocsr()


def _networks(rows, cols, n, schedule):
    fused = schedule == "fused"
    net = build_network(rows, cols, n, fused=fused, wavefront=False, device="cpu")
    assert net.fused == fused
    return net, jax_build_network(rows, cols, n, fused=fused, wavefront=False)


@pytest.mark.parametrize("name", ["dag", "wide-level"])
def test_step_engine_tables_equal_jax(name):
    rows, cols, n = _topology(name)
    ref = jax_build_network(rows, cols, n)
    net = build_network(rows, cols, n, device="cpu")
    for field in ("edge_src", "edge_tgt", "lvl_src", "lvl_tgt", "perm", "inv_perm", "pred", "down",
                  "level"):
        np.testing.assert_array_equal(getattr(net, field).numpy(), np.asarray(getattr(ref, field)),
                                      err_msg=field)
    for field in ("n", "depth", "n_edges", "level_starts", "fused", "wavefront"):
        assert getattr(net, field) == getattr(ref, field), field
    lvl_src, lvl_tgt, depth = level_schedule(rows, cols, n)
    j_src, j_tgt, j_depth = jax_level_schedule(rows, cols, n)
    np.testing.assert_array_equal(lvl_src, j_src)
    np.testing.assert_array_equal(lvl_tgt, j_tgt)
    assert depth == j_depth
    if name == "wide-level":
        assert lvl_src.shape[0] > depth and not net.fused  # in-degree 1,501: no fused schedule


def test_fused_schedule_refuses_networks_past_its_limits():
    rows, cols, n = _topology("wide-level")
    with pytest.raises(ValueError, match="fused-schedule limits"):
        build_network(rows, cols, n, fused=True, device="cpu")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_solves_match_jax_and_scipy(schedule):
    rows, cols, n = _topology("dag")
    net, jnet = _networks(rows, cols, n, schedule)
    c1, b = _system(n, 5)
    x = solver.solve_lower_triangular(net, torch.as_tensor(c1), torch.as_tensor(b))
    ref_x, ref_y = jax.jit(lambda c, bb: (jax_solver.solve_lower_triangular(jnet, c, bb),
                                         jax_solver.solve_transposed(jnet, c, bb)))(c1, b)
    _close(ref_x, x, "solve vs JAX")
    _close(ref_y, solver.solve_transposed(net, torch.as_tensor(c1), torch.as_tensor(b)),
           "transposed solve vs JAX")

    a = _scipy_matrix(rows, cols, n, c1)
    c64, b64 = torch.as_tensor(c1, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    x64 = solver.solve_lower_triangular(net, c64, b64)
    assert x64.dtype == torch.float64
    _close(spsolve_triangular(a, b64.numpy(), lower=True), x64, "solve vs scipy", rtol=1e-12)
    y64 = solver.solve_transposed(net, c64, b64)
    _close(spsolve_triangular(a.T.tocsr(), b64.numpy(), lower=False), y64, "transposed vs scipy",
           rtol=1e-12)


def test_rectangle_with_split_levels_matches_scipy():
    rows, cols, n = _topology("wide-level")
    net = build_network(rows, cols, n, fused=False, wavefront=False, device="cpu")
    c1, b = _system(n, 6, np.float64)
    a = _scipy_matrix(rows, cols, n, c1)
    x = solver.solve_lower_triangular(net, torch.as_tensor(c1), torch.as_tensor(b))
    _close(spsolve_triangular(a, b, lower=True), x, "split-level solve vs scipy", rtol=1e-12)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_solve_gradients_match_jax_custom_vjp(schedule):
    rows, cols, n = _topology("dag")
    net, jnet = _networks(rows, cols, n, schedule)
    c1, b = _system(n, 7)
    w = np.random.default_rng(8).normal(size=n).astype(np.float32)

    def loss(c, bb):
        return (jax_solver.solve_lower_triangular(jnet, c, bb) * w).sum()

    ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(c1), jnp.asarray(b))
    ct, bt = torch.tensor(c1, requires_grad=True), torch.tensor(b, requires_grad=True)
    (solver.solve_lower_triangular(net, ct, bt) * torch.as_tensor(w)).sum().backward()
    _close(ref[0], ct.grad, "d/dc1")
    _close(ref[1], bt.grad, "d/db")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_solve_gradients_match_finite_differences(schedule):
    rows, cols = make_deep_network(40, 8, seed=9)
    net = build_network(rows, cols, 40, fused=schedule == "fused", device="cpu")
    c1, b = _system(40, 10, np.float64)
    args = (torch.tensor(c1, requires_grad=True), torch.tensor(b, requires_grad=True))
    assert torch.autograd.gradcheck(lambda c, bb: solver.solve_lower_triangular(net, c, bb), args)


def test_batched_solve_equals_per_row_solves():
    rows, cols, n = _topology("dag")
    for schedule in SCHEDULES:
        net, _ = _networks(rows, cols, n, schedule)
        c1 = torch.as_tensor(np.stack([_system(n, s)[0] for s in range(3)]))
        b = torch.as_tensor(np.stack([_system(n, s)[1] for s in range(3)]))
        x = solver.solve_lower_triangular(net, c1, b)
        for i in range(3):
            torch.testing.assert_close(x[i], solver.solve_lower_triangular(net, c1[i], b[i]))
    with pytest.raises(ValueError, match="one shape"):
        solver.solve_lower_triangular(net, c1, b[0])
