"""Float32 error budget against depth and T: every engine against the float64 oracle.

The port of ``ddr_tpu/benchmarks/numerics.py``. Each float32 engine (the
per-timestep step engine, the single-ring wavefront where its caps fit, the
unrolled depth-chunked wavefront, the stacked band router) routes the same
deep synthetic basin as the float64 step engine, the oracle (itself held to
SciPy's float64 forward substitution in ``tests/test_torch_solver.py``), and
records

* ``rel_max``: the largest elementwise relative error over the ``(T, N)``
  runoff, and
* ``one_minus_nse``: 1 - NSE of the float32 series against the float64 one.

The JAX package measured on a CPU that ``rel_max`` stays flat in depth and T
and 1 - NSE grows about as depth^2, to ~1e-7 at depth 2048. The oracle needs
no global switch here: torch computes in float64 wherever its inputs are.

Run: ``python -m ddr_tpu_torch.benchmarks.numerics [--device cpu]`` (prints
the table; the default device is the card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device

__all__ = ["main", "measure_engine_errors"]


def _nse_complement(sim: np.ndarray, obs: np.ndarray) -> float:
    obs_m = obs.mean(axis=0, keepdims=True)
    return float(((sim - obs) ** 2).sum() / (((obs - obs_m) ** 2).sum() + 1e-30))


def measure_engine_errors(
    n: int, depth: int, T: int, seed: int = 0, chunk_bands: int = 4,
    device: str | torch.device = "cuda",
) -> dict[str, tuple[float, float]]:
    """``{engine: (rel_max, 1 - NSE)}`` for each float32 engine against the
    float64 step oracle, on ``make_deep_network(n, depth, seed)`` with
    ``T`` hourly steps. ``chunk_bands`` sizes the chunked build's budget so
    that it has about that many bands and cross-band error is exercised.
    The keys are the JAX package's."""
    from ddr_tpu_torch.geodatazoo.synthetic import make_deep_network
    from ddr_tpu_torch.routing.chunked import build_chunked_network
    from ddr_tpu_torch.routing.mc import ChannelState, route
    from ddr_tpu_torch.routing.network import build_network
    from ddr_tpu_torch.routing.stacked import build_stacked_chunked

    dev = resolve_device(device)
    rows, cols = make_deep_network(n, depth, seed=seed)

    def channels(dtype):
        rng = np.random.default_rng(seed)
        return ChannelState(
            length=torch.as_tensor(rng.uniform(1000, 5000, n), dtype=dtype, device=dev),
            slope=torch.as_tensor(rng.uniform(1e-3, 1e-2, n), dtype=dtype, device=dev),
            x_storage=torch.full((n,), 0.3, dtype=dtype, device=dev),
        )

    def params(dtype):
        return {k: torch.full((n,), v, dtype=dtype, device=dev)
                for k, v in (("n", 0.05), ("q_spatial", 0.5), ("p_spatial", 21.0))}

    qp = np.random.default_rng(seed + 1).uniform(0.01, 1.0, (T, n))
    f32, f64 = torch.float32, torch.float64

    def run(net, dtype, **kw):
        with torch.no_grad():
            out = route(net, channels(dtype), params(dtype),
                        torch.as_tensor(qp, dtype=dtype, device=dev), device=dev, **kw).runoff
        return out.double().cpu().numpy()

    net_step = build_network(rows, cols, n, fused=False, device=dev)
    oracle = run(net_step, f64, engine="step")
    out = {"step-f32": run(net_step, f32, engine="step")}
    net_auto = build_network(rows, cols, n, device=dev)
    if net_auto.wavefront:
        out["wavefront-f32"] = run(net_auto, f32, engine="wavefront")
    budget = max(4000, (depth // chunk_bands + 2) * (n + 1))
    cn = build_chunked_network(rows, cols, n, cell_budget=budget, device=dev)
    out[f"chunked-f32[{cn.n_chunks}]"] = run(cn, f32)
    sn = build_stacked_chunked(rows, cols, n, device=dev)
    out[f"stacked-f32[{sn.n_chunks}]"] = run(sn, f32)
    return {
        k: (float(np.max(np.abs(v - oracle) / (np.abs(oracle) + 1e-9))), _nse_complement(v, oracle))
        for k, v in out.items()
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(f"{'n':>7} {'depth':>5} {'T':>4} | {'engine':<16} {'rel_max':>9} {'1-NSE':>9}")
    for n, depth in [(2000, 64), (2000, 256), (4000, 1024), (6000, 2048)]:
        for T in (24, 96, 240):
            for k, (rel, one_nse) in measure_engine_errors(n, depth, T, device=args.device).items():
                print(f"{n:>7} {depth:>5} {T:>4} | {k:<16} {rel:9.2e} {one_nse:9.2e}")


if __name__ == "__main__":
    main()
