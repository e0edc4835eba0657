#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card visible. Phases, each fatal
on failure (non-zero exit, no result line):

1. build   every CUDA kernel of the port from ``ddr_tpu_torch/csrc`` with
           ``nvcc`` into ``build/kernels`` (one ``nvcc`` per source, started
           together);
2. parity  each kernel's wrapper against its plain PyTorch version on the
           card, at a small shape and at the serving shape, including the
           hotstart, ``q_init`` and ``T = 1`` cases;
3. serve   ``ForecastService(device="cuda")`` on the synthetic deep basin
           (65,536 reaches, depth 512, 8 gauges), horizon 72 h, batch 8, KAN
           from a fixed seed: warm up, answer 4 batches of 8 requests, check
           the answers are finite, that the kernel carried every batch
           (launch counts zeroed just before, read just after) and that one
           answer matches the plain path (``kernel="reference"``), then
           one more batch under ``torch.profiler`` (device time by
           operation);
4. timing  each kernel at the serving shape against its bound and its plain
           version (CUDA events).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# Rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float32 operations of the wave scan, counted from its plain version: the MC
# chain plus the update for one (request, reach, timestep) past the hotstart
# row, and the raw + clamped sums for one gather slot.
FLOPS_PER_PAIR = 66
FLOPS_PER_SLOT = 4
RTOL = ATOL_SCALE = 1e-5  # parity tolerance: |a - b| <= 1e-5 |ref| + 1e-5 max|ref|

N_SEGMENTS, DEPTH, N_GAUGES, HORIZON, MAX_BATCH, N_BATCHES = 65536, 512, 8, 72, 8, 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def compare(ref, out, label: str) -> float:
    """Max abs error of ``out`` against ``ref``; fails past the tolerance."""
    import torch

    ref, out = ref.double(), out.double()
    if ref.shape != out.shape:
        fail(f"{label}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: non-finite values")
    err = (out - ref).abs()
    scale = float(ref.abs().max())
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
    ok = bool((err <= RTOL * ref.abs() + ATOL_SCALE * scale).all())
    print(f"parity {label}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"(tolerance rtol {RTOL:g}, atol {ATOL_SCALE:g} x {scale:.3e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}: outside tolerance")
    return max_abs


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_case(net, phys, B, T, seed, with_q_init, dev):
    """Pre-skewed inflow rows for ``B`` requests and an optional carried state."""
    import numpy as np
    import torch

    from ddr_tpu_torch.routing.wavefront import _input_skews

    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 2.0, (B, T, net.n)).astype(np.float32)
    q[rng.random(q.shape) < 0.25] = 0.0  # raw values below the discharge clamp
    qs = _input_skews(torch.as_tensor(q, device=dev), net.level_p.long(), net.depth, T)
    q_init = None
    if with_q_init:
        q_init = torch.as_tensor(rng.uniform(0.0, 3.0, (B, net.n)).astype(np.float32), device=dev)
    return qs.contiguous(), q_init


def profile_batch(svc, starts) -> None:
    """One served batch under ``torch.profiler``: device time by operation,
    largest first, and the device's busy share of the batch's host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in [svc.submit("conus-synthetic", t0=int(s)) for s in starts]:
            f.result(timeout=600)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    # self device time counts each kernel and copy once (a CPU op's is 0)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    device_ms = sum(ms for ms, _, _ in rows)
    if not rows:
        print("profile: the profiler saw no device time (device breakdown not measured)")
        return
    print(f"profile of one served batch: host {host_ms:.3f} ms, device busy {device_ms:.3f} ms "
          f"({100 * device_ms / host_ms:.1f}%)")
    for ms, count, key in rows[:10]:
        print(f"  {ms:9.3f} ms  x{count:<4d} {key[:90]}")


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / "ddr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (ddr_tpu_torch/ not beside the "
              "script)", file=sys.stderr)
        return 2
    import numpy as np

    from ddr_tpu_torch.geodatazoo.synthetic import make_basin
    from ddr_tpu_torch.nn.kan import Kan
    from ddr_tpu_torch.routing import _build
    from ddr_tpu_torch.routing.mc import Bounds, reach_physics, route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, prepare_batch
    from ddr_tpu_torch.routing.wave_kernel import wave_scan, wave_scan_reference
    from ddr_tpu_torch.serving.config import ServeConfig
    from ddr_tpu_torch.serving.service import ForecastService
    from ddr_tpu_torch.validation.configs import Config, KanConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")

    # ---- 1. build ----
    t0 = time.perf_counter()
    seconds = _build.build(_build.KERNELS, verbose=True)
    print(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"({time.perf_counter() - t0:.2f}s wall) into {_build.build_dir()}")

    # ---- 2. kernel parity: small shape, then the serving shape ----
    cfg = Config(kan=KanConfig(input_var_names=[f"a{i}" for i in range(10)]))
    p = cfg.params
    small = make_basin(n_segments=4096, n_gauges=4, n_days=2, depth=64, seed=1)
    net_s, ch_s, _ = prepare_batch(small.routing_data, p.attribute_minimums["slope"], device=dev)
    params_s = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in small.true_params.items()}
    bounds = Bounds.from_config(p.attribute_minimums)
    phys_s = reach_physics(net_s, ch_s, params_s, bounds)
    with torch.no_grad():
        for label, B, T, with_init in (("small/hotstart", 3, 24, False),
                                       ("small/q_init", 3, 24, True),
                                       ("small/T=1", 2, 1, False)):
            qs, qi = scan_case(net_s, phys_s, B, T, 7, with_init, dev)
            ys = wave_scan(qs, net_s, phys_s, qi, T=T)
            torch.cuda.synchronize()
            compare(wave_scan_reference(qs, net_s, phys_s, qi, T=T), ys, label)

    basin = make_basin(n_segments=N_SEGMENTS, n_gauges=N_GAUGES, n_days=8, depth=DEPTH, seed=0)
    kan = Kan(cfg.kan.input_var_names, cfg.kan.learnable_parameters,
              hidden_size=11, num_hidden_layers=1, grid=3, k=3,
              generator=torch.Generator().manual_seed(0))
    svc = ForecastService(cfg, ServeConfig(max_batch=MAX_BATCH, horizon_hours=HORIZON), device=dev)
    try:
        t0 = time.perf_counter()
        entry = svc.register_network("conus-synthetic", basin.routing_data, forcing=basin.q_prime)
        svc.register_model("default", kan)
        net = entry.network
        print(f"network: n {net.n} depth {net.depth} edges {net.n_edges} ring_rows "
              f"{net.wf_ring_rows} bucket widths {[w for *_, w in net.wf_buckets]} level runs "
              f"{len(net.wf_level_runs)} ({time.perf_counter() - t0:.2f}s to build)")
        with torch.no_grad():
            raw = kan(entry.attrs)
            phys_params = denormalize_spatial_parameters(
                raw, p.parameter_ranges, p.log_space_parameters, p.defaults, net.n
            )
            phys = reach_physics(net, entry.channels, phys_params, svc.bounds)
            max_abs = 0.0
            for label, with_init in (("serve-shape/hotstart", False), ("serve-shape/q_init", True)):
                qs, qi = scan_case(net, phys, MAX_BATCH, HORIZON, 11, with_init, dev)
                ys = wave_scan(qs, net, phys, qi, T=HORIZON)
                torch.cuda.synchronize()
                err = compare(wave_scan_reference(qs, net, phys, qi, T=HORIZON), ys, label)
                max_abs = max(max_abs, err)
            del ys

        # ---- 3. serve ----
        t0 = time.perf_counter()
        svc.warmup()
        print(f"warmup: {time.perf_counter() - t0:.2f}s")
        starts = np.arange(MAX_BATCH * N_BATCHES) % (basin.q_prime.shape[0] - HORIZON + 1)
        wave_scan.launches = 0
        futures = [svc.submit("conus-synthetic", t0=int(s)) for s in starts]
        answers = [f.result(timeout=600) for f in futures]
        launches = wave_scan.launches
        batches = svc.stats()["queue"]["batches"]
        print(f"serve: {len(answers)} requests in {batches} batches, "
              f"wave_scan.launches {launches}")
        if launches < 1 or batches < 3 or launches != batches:
            fail(f"expected one wave_scan launch per batch (>= 3): {launches} launches, "
                 f"{batches} batches")
        per_batch = {}
        for a in answers:
            if a["runoff"].shape != (HORIZON, N_GAUGES) or not np.isfinite(a["runoff"]).all():
                fail(f"request {a['request_id']}: runoff {a['runoff'].shape} not finite "
                     f"({HORIZON}, {N_GAUGES})")
            per_batch[(a["execute_s"], a["device_ms"])] = a["batch_size"]
        for (execute_s, device_ms), size in per_batch.items():
            print(f"batch of {size}: device {device_ms:.3f} ms (CUDA events), "
                  f"host {execute_s * 1e3:.3f} ms on {smi}")

        # one answer against the plain path on the card
        with torch.no_grad():
            q = torch.as_tensor(basin.q_prime[starts[0] : starts[0] + HORIZON], device=dev)
            expect = route(net, entry.channels, phys_params, q, gauges=entry.gauge_index,
                           bounds=svc.bounds, kernel="reference", device=dev).runoff
        compare(expect.cpu(), torch.as_tensor(answers[0]["runoff"]), "served request vs plain path")
        profile_batch(svc, starts[:MAX_BATCH])
    finally:
        svc.close()

    # ---- 4. timing at the serving shape ----
    B, T, n = MAX_BATCH, HORIZON, net.n
    W = T + net.depth
    with torch.no_grad():
        qs, _ = scan_case(net, phys, B, T, 13, False, dev)
        for _ in range(2):
            wave_scan(qs, net, phys, None, T=T)
        kernel_ms = cuda_ms(lambda: wave_scan(qs, net, phys, None, T=T), 10)
        wave_scan_reference(qs, net, phys, None, T=T)
        plain_ms = cuda_ms(lambda: wave_scan_reference(qs, net, phys, None, T=T), 2)
        # one request: the same W waves and barriers over an eighth of the bytes
        qs1 = qs[:1].contiguous()
        wave_scan(qs1, net, phys, None, T=T)
        kernel_b1_ms = cuda_ms(lambda: wave_scan(qs1, net, phys, None, T=T), 10)
    # bytes the scan must move: each reach is in its valid band for T of the W
    # waves, so the in-band inflow read once and the in-band solve values
    # written once (B * T * n each; the rest of the (B, W, n) rows are zeros
    # the un-skew never reads), the tables and per-reach operands once
    slots = int(net.wf_idx.numel())
    bytes_moved = 4 * 2 * B * T * n + 4 * (3 * n + 3 * slots) + 4 * 6 * n
    flops = B * (T - 1) * n * FLOPS_PER_PAIR + B * T * slots * FLOPS_PER_SLOT
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    print(f"timing wave_scan (B {B}, W {W}, n {n}): kernel {kernel_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bytes_moved / 1e9:.3f} GB -> "
          f"{bytes_ms:.4f} ms, {flops / 1e9:.3f} GFLOP -> {flops_ms:.4f} ms); "
          f"kernel at B 1: {kernel_b1_ms:.3f} ms")

    print(nvidia_smi())
    print(json.dumps({"kernels": [{
        "name": "wave_scan",
        "route": "cuda",
        "source": "ddr_tpu_torch/csrc/wave_scan.cu",
        "replaces": "ddr_tpu/routing/pallas_kernel.py:193",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
