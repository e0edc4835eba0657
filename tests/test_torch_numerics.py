"""The port's float32 error budget against the JAX package's.

``ddr_tpu_torch.benchmarks.numerics.measure_engine_errors`` routes one deep
synthetic basin through every float32 engine and the float64 step oracle
(torch float64, where the JAX package needs x64: here scoped,
``jax.enable_x64()``). At a tiny shape both packages must report the same
engines under the same keys, and each error (``rel_max``, 1 - NSE) within
10x of the JAX package's: the same arithmetic, rounded by different float32
libraries.

The card test of the single-ring kernel route against the float64 step
oracle (``tests/test_torch_cuda.py``) holds its errors to 10x constants
that stand for JAX's own float32 wavefront against JAX's own float64 step
route on the same inputs; here JAX recomputes them (within 1%, far inside
the 10x bound), the port's float64 oracle is held to JAX's within 1e-12,
and the port's plain route, which the kernel equals bit for bit, meets the
bound.
"""

from __future__ import annotations

import jax
import numpy as np

import torch

from ddr_tpu.benchmarks.numerics import measure_engine_errors as jax_measure_engine_errors
from ddr_tpu.routing import mc as jax_mc
from ddr_tpu.routing.network import build_network as jax_build_network
from ddr_tpu_torch.benchmarks import numerics
from ddr_tpu_torch.geodatazoo.synthetic import make_deep_network
from ddr_tpu_torch.routing import mc
from tests.test_torch_cuda import JAX_STEP_ORACLE_ERRORS, step_oracle_case, step_oracle_errors


def test_measure_engine_errors_matches_the_jax_table():
    shape = (200, 32, 12)
    ours = numerics.measure_engine_errors(*shape, device="cpu")
    with jax.enable_x64():
        ref = jax_measure_engine_errors(*shape)
    assert list(ours) == list(ref)
    assert any(k.startswith("chunked-f32") for k in ours) and "wavefront-f32" in ours
    for engine, errors in ours.items():
        for name, got, want in zip(("rel_max", "1-NSE"), errors, ref[engine]):
            assert np.isfinite(got) and 0 < got < 1e-4, (engine, name, got)
            assert want / 10 <= got <= want * 10, (engine, name, got, want)


def test_main_prints_the_table(monkeypatch, capsys):
    seen = []

    def fake(n, depth, T, device):
        seen.append((n, depth, T, device))
        return {"step-f32": (1e-6, 1e-12)}

    monkeypatch.setattr(numerics, "measure_engine_errors", fake)
    numerics.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "rel_max" in lines[0] and len(lines) == 1 + len(seen) == 13
    assert seen[-1] == (6000, 2048, 240, "cpu")


def test_the_card_bound_on_the_step_oracle_is_jax_own_error():
    """The constants are JAX's own: its float32 wavefront against its own
    float64 step route (scoped ``jax.enable_x64()``), recomputed within 1%.
    The port's float64 step route, the card test's oracle, equals JAX's
    within 1e-12, and the port's plain float32 route meets the bound."""
    net, ch, params, q = step_oracle_case(torch.float64, "cpu")
    oracle = mc.route(net, ch, params, q, engine="step", device="cpu").runoff.numpy()
    rows, cols = make_deep_network(400, 40, seed=1)
    as_jax = lambda t: jax.numpy.asarray(t.numpy())  # noqa: E731

    def jax_route(ch, params, q, **kw):
        jax_ch = jax_mc.ChannelState(length=as_jax(ch.length), slope=as_jax(ch.slope),
                                     x_storage=as_jax(ch.x_storage))
        return np.asarray(jax_mc.route(jax_build_network(rows, cols, 400), jax_ch,
                                       {k: as_jax(v) for k, v in params.items()}, as_jax(q), **kw).runoff)

    with jax.enable_x64():
        jax_oracle = jax_route(ch, params, q, engine="step")
    assert jax_oracle.dtype == np.float64
    np.testing.assert_allclose(oracle, jax_oracle, rtol=1e-12, atol=0)
    net, ch, params, q = step_oracle_case(torch.float32, "cpu")
    port = mc.route(net, ch, params, q, device="cpu").runoff
    jax_own = step_oracle_errors(jax_route(ch, params, q), jax_oracle)
    np.testing.assert_allclose(jax_own, JAX_STEP_ORACLE_ERRORS, rtol=1e-2)
    for got, bound in zip(step_oracle_errors(port, oracle), JAX_STEP_ORACLE_ERRORS):
        assert 0 < got <= 10 * bound
