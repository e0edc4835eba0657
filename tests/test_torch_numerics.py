"""The port's float32 error budget against the JAX package's.

``ddr_tpu_torch.benchmarks.numerics.measure_engine_errors`` routes one deep
synthetic basin through every float32 engine and the float64 step oracle
(torch float64, where the JAX package needs x64: here scoped,
``jax.enable_x64()``). At a tiny shape both packages must report the same
engines under the same keys, and each error (``rel_max``, 1 - NSE) within
10x of the JAX package's: the same arithmetic, rounded by different float32
libraries.
"""

from __future__ import annotations

import jax
import numpy as np

from ddr_tpu.benchmarks.numerics import measure_engine_errors as jax_measure_engine_errors
from ddr_tpu_torch.benchmarks import numerics


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
