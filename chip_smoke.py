#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --old-kernels LOG   # also each kernel's time in an earlier run's LOG
    python3 chip_smoke.py --time-fp32   # only the fp32 forward kernel's times
    python3 chip_smoke.py --ddr-train   # only the build and phase 18 (ddr train)
    python3 chip_smoke.py --ddr-cli     # only the build and phases 18-19 (every ported command)

From the root of a checkout, with one CUDA card visible. Phases, each fatal
on failure (non-zero exit, no result line):

1. build   every CUDA kernel of the port from ``ddr_tpu_torch/csrc`` with
           ``nvcc`` into ``build/kernels`` (one ``nvcc`` per source, started
           together);
2. parity  each kernel's wrapper against its plain PyTorch version on the
           card: the time-major forward scan (``wave_scan_tm``, named
           ``wave_scan`` in the kernels line) at a small shape, at the
           serving shape and at the evaluation commands' 2-day chunk (B 1,
           T 48, ``q_init``), including the hotstart, ``q_init`` and
           ``T = 1`` cases; the time-major reverse scan (``reverse_scan_tm``, named
           ``reverse_scan``) at a small shape, ``T = 1``, a DAG with fan-out
           (``t_width > 1``) and the training shape;
3. serve   ``ForecastService(device="cuda")`` on the synthetic deep basin
           (65,536 reaches, depth 512, 8 gauges; the single-ring engine),
           horizon 72 h, batch 8, KAN from a fixed seed: warm up, answer 3
           batches of 8 requests, check the answers are finite, that the
           kernel carried every batch (launch counts zeroed just before,
           read just after) and that one answer matches the plain path
           (``kernel="reference"``), then one more batch under
           ``torch.profiler`` (device time by operation);
4. train   ``make_batch_train_step(device="cuda")`` on the same basin over a
           10-day window (T = 240 h), observed by the twin experiment: the
           KAN gradients of one step through the kernels against those
           through the plain scans, then 3 steps (lr 0.005, 0.001 from step
           3) with finite losses and exactly one ``wave_scan`` and one
           ``reverse_scan`` launch a step, then one more step under
           ``torch.profiler``;
5. timing  each single-ring kernel at its main path's shape against its
           bound and its plain version (CUDA events), and the barrier floor:
           the same number of empty waves, grid barriers only, on the grid
           the kernel takes, and one barrier's cost from 1 block to a
           co-resident grid (the band and chunked timings of phases 9, 14
           and 15 add their own floors);
6. parity  (band frame) the band variant of each kernel (``wave_scan`` with
           external rows and ``mask_raw``, ``reverse_scan`` over a band's
           transposed tables) against its plain version on a small stacked
           frame with 3 bands, a 100-way confluence (gather width 128), a
           width-0 bucket tail and fan-out (``t_width`` 16): hotstart,
           ``q_init`` and ``T = 1``;
7. serve   (deep) the same service on the continental shape, 2.9 M reaches
           of longest-path depth 4000 (the stacked band router): build the
           frame, hold both band kernels against their plain versions on
           one band of it, warm up, answer 3 batches with exactly
           ``n_chunks`` ``wave_scan`` launches each, check one answer
           against the plain path, profile a batch;
8. train   (deep) ``observe`` and 3 train steps on the same basin (T = 240,
           B 1) with exactly ``n_chunks`` launches of each kernel a step,
           the peak device memory and a profiled step; then the KAN
           gradients through the kernels against the plain scans on a
           smaller stacked basin (65,536 reaches, depth 2048, 3 bands);
9. timing  each band kernel at its main path's shape: one band, and all
           ``n_chunks`` bands of a route, against the bound counted per
           band, and the plain version on one band;
10. parity (bf16) the forward kernel with its ring in bfloat16 against its
           plain version: the small single ring and the small 3-band frame
           (hotstart, ``q_init``, ``T = 1``) and the serving shape, within
           one bf16 epsilon, with the share of exactly equal elements;
11. train  (bf16, regional) the regional basin's runoff in bf16 against
           fp32 on the same weights (the JAX package's bound), 3 bf16 train
           steps with ``collect_health`` and 16 health bands (one launch of
           each kernel a step, no overflow, a finite ulp drift), 2 fp32
           steps with the same health for comparison, the cost of the
           health reductions, the first stage of the recovery ladder (a
           violating bf16 step re-run on the fp32 twin from the pre-step
           state), and the bf16 kernel's time at the training shape;
12. train  (bf16, continental) the same on the continental basin
           (``n_chunks`` launches a step), and the bf16 band kernel's time;
13. parity (chunked) the forward kernel's variant of the unrolled
           depth-chunked router (a band's own single ring with external rows
           and unmasked raw sums) against its plain version, fp32 and bf16
           (equal on every element), and ``reverse_scan`` over each band:
           every band of a 2-band ``ChunkedNetwork`` and a band of local
           depth 0, hotstart, ``q_init`` and ``T = 1``;
14. serve  (chunked) the continental basin's ``ChunkedNetwork`` at the
           2^26-cell cap (13 bands): 3 batches (B 8, T 72) of KAN ->
           denormalize -> ``route`` with gauges, one ``wave_scan`` launch a
           band a batch, gauge runoff held to the stacked router's within
           1e-3, a profiled batch, and the variant on the largest band
           (parity, times, bound) and on every band;
15. train  (chunked) 3 fp32 train steps on it (one launch of each kernel a
           band a step) and a profiled step, the KAN gradients against the
           stacked router's within 2e-2, one bf16 step with health, the
           bf16 variant's time beside fp32, and ``reverse_scan`` on the
           largest band at the step's shape (parity, times, bound) and on
           every band;
16. numerics every float32 engine against the float64 step oracle on the
           card (1 - NSE held to 1e-5), and the oracle's route time beside
           the single-ring kernel's;
17. AD     gradients through ``adjoint="ad"`` (the plain scan) against the
           analytic adjoint on the kernels, within rtol 1e-5;
18. ddr train  ``python -m ddr_tpu_torch.cli train examples/synthetic/config.yaml``
           (the example's 2 epochs at rho 20, batch 2: 4 steps) in-process:
           at 4,096 reaches and depth 64 once with ``device=cpu`` (the plain
           scans) and once on the card, per-step losses held to rtol 1e-4;
           then on the card at the regional size (65,536 reaches, depth 512)
           with the launch counts zeroed just before and read just after
           (one ``wave_scan`` launch a step plus one for the twin's
           observation route, one ``reverse_scan`` a step), finite losses, a
           checkpoint per mini-batch, and a second run with
           ``experiment.checkpoint=<saved_models>`` and 3 epochs that must
           resume from epoch 2's last mini-batch, skip the rest of epoch 2
           and train epoch 3; per-step times and each run's wall time;
19. ddr test, route, train-and-test, benchmark  the other ported commands
           through the CLI in-process, from phase 18's newest checkpoints:
           ``ddr test`` and ``ddr route`` at the regional size over the
           example's window (2-day chunks with carried discharge), launch
           counts zeroed just before and read just after each (one
           ``wave_scan`` launch a chunk, all but the first from the carried
           ``q_init``, plus one for the twin's observation route; no
           ``reverse_scan``), stores written and finite; ``ddr test`` at
           4,096 reaches over the window's first 41 days with ``device=cpu``
           and on the card, daily
           predictions held to rtol 1e-5; ``ddr train-and-test`` at that
           size (one epoch, a 25-day test); ``ddr benchmark`` at the regional
           size (the same launch counts, the LTI comparator's time and peak
           device memory, the store finite); each chunk's host ms and each
           run's wall time.
The service of phases 3 and 7 runs with its health watchdog on, which must
have seen every served batch and not be degraded; phase 8's gradient check
also holds the bf16 kernels against the bf16 plain scans. Every kernel's
inputs are time-major ``(B, T, .)`` arrays, as the routers hand them over.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero without a card.
"""

from __future__ import annotations

import copy
import gc
import json
import logging
import re
import shutil
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
# ... and of the reverse scan for one in-band (request, reach, timestep): the
# lam and gx updates, and two multiply-adds for each successor slot.
REVERSE_FLOPS_PER_PAIR = 4
REVERSE_FLOPS_PER_SLOT = 4
RTOL = ATOL_SCALE = 1e-5  # parity tolerance: |a - b| <= 1e-5 |ref| + 1e-5 max|ref|
GRAD_RTOL = 1e-4  # KAN gradients, kernels vs plain scans: the reductions over reaches differ
# bf16 ring: one bf16 epsilon, since a powf ulp can flip one rounding and the
# flip carries downstream; its KAN gradients rtol 1e-3; bf16 runoff against
# fp32 within the JAX package's bound (tests/routing/test_pallas_kernel.py)
BF16_RTOL, BF16_GRAD_RTOL = 2.0**-7, 1e-3
BF16_MAX_REL, BF16_MEAN_REL = 0.3, 0.02
HEALTH_BANDS = 16

N_SEGMENTS, DEPTH, N_GAUGES, HORIZON, MAX_BATCH, N_BATCHES = 65536, 512, 8, 72, 8, 3
TRAIN_DAYS, TRAIN_STEPS = 10, 3  # T = 240 h
# The continental shape: global MERIT over CONUS, ~2.9 M reaches of
# longest-path depth 2k-5k (docs/tpu.md); and the smaller stacked basin of
# the gradient check, where the plain scans take seconds, not minutes.
DEEP_SEGMENTS, DEEP_DEPTH = 2_900_000, 4000
GRAD_SEGMENTS, GRAD_DEPTH = 65536, 2048
# The unrolled depth-chunked router: the small networks of its kernel
# variant's parity (make_deep_network(320, 80) at a budget of 8,000 ring
# cells: 2 bands; a 28-reach chain at 120 cells, whose last band is a single
# level), the engines' gradients held to the bound the JAX package holds
# them to across engines (tests/routing/test_chunked.py), the float32 error
# budget's shapes and limit, and the AD check's small basin.
CHUNK_SMALL, CHUNK_SMALL_BUDGET, CHAIN_REACHES, CHAIN_BUDGET = (320, 80), 8000, 28, 120
ENGINE_GRAD_RTOL, CHUNK_STACKED_MAX_REL = 2e-2, 1e-3
NUMERICS_SHAPES, NUMERICS_MAX_ONE_MINUS_NSE = ((4000, 1024, 96), (6000, 2048, 96)), 1e-5
AD_SEGMENTS, AD_DEPTH, AD_T = 512, 64, 24
# `ddr train` on the example config: 4 gauges at batch 2 over 2 epochs. Its
# CPU-vs-card parity at a width the plain scans train in seconds, its run at
# the regional width.
DDR_TRAIN_CONFIG, DDR_TRAIN_STEPS = "examples/synthetic/config.yaml", 4
DDR_TRAIN_PARITY = ("synthetic_segments=4096", "synthetic_depth=64")
DDR_TRAIN_RTOL = 1e-4  # per-step losses, the CPU's plain scans against the card's kernels
# `ddr test`'s CPU-against-card parity: the first 41 days of the example's
# window (20 chunks; the CPU's plain scans take ~0.18 s a chunk)
DDR_TEST_PARITY_WINDOW = ("experiment.end_time=1981/11/10",)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def compare(ref, out, label: str, rtol: float = RTOL) -> float:
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
    ok = bool((err <= rtol * ref.abs() + ATOL_SCALE * scale).all())
    print(f"parity {label}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"(tolerance rtol {rtol:g}, atol {ATOL_SCALE:g} x {scale:.3e}) -> {'ok' if ok else 'FAIL'}")
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


def time_barrier(label, tables, B, T, smi, dev, reverse=False) -> dict:
    """The floor under one scan: its ``W`` waves as empty grid barriers and
    nothing else, on the grid the forward kernel takes for this scan's
    widest wave (CUDA events, 5 launches)."""
    from ddr_tpu_torch.routing.wave_kernel import active_runs, wave_barrier

    W = T + tables.depth
    pairs = B * active_runs(tables, T, reverse=reverse).widest
    blocks = wave_barrier(W, pairs, dev)
    ms = cuda_ms(lambda: wave_barrier(W, pairs, dev), 5)
    print(f"barrier floor, {label}: {W} empty waves on {blocks} blocks of 256 threads (widest wave "
          f"{pairs} pairs): {ms:.3f} ms, {1e3 * ms / W:.3f} us a wave on {smi}")
    return {"ms": ms, "blocks": blocks, "waves": W}


def barrier_sweep(waves, smi, dev) -> None:
    """What one grid barrier costs by grid size: ``waves`` empty waves on
    grids from 1 block to co-residency (the grid the forward kernel takes
    for a widest wave of ``blocks * 256`` pairs)."""
    from ddr_tpu_torch.routing.wave_kernel import wave_barrier

    for want in (1, 33, 66, 132, 264, 396, 1 << 30):
        blocks = wave_barrier(waves, want * 256, dev)
        ms = cuda_ms(lambda: wave_barrier(waves, want * 256, dev), 5)
        print(f"barrier sweep: {blocks:5d} blocks of 256 threads, {waves} waves: {ms:.3f} ms, "
              f"{1e3 * ms / waves:.3f} us a barrier on {smi}")


def old_times(path, kernels) -> None:
    """Beside each kernel of this run, its time in an earlier run of this
    script (the ``{"kernels": ...}`` line of that run's output at ``path``),
    matched by name; ``not measured`` where that run lacks it."""
    old = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith('{"kernels"'):
            old = {k["name"]: k for k in json.loads(line)["kernels"]}
    for k in kernels:
        o = old.get(k["name"])
        was = "not measured" if o is None else f"{o['ms']:.3f} ms"
        text = f"old/new {k['name']}: {was} -> {k['ms']:.3f} ms (bound {k['bound_ms']:.4f} ms)"
        if "ms_all_bands" in k:
            was_all = "not measured" if o is None or "ms_all_bands" not in o else f"{o['ms_all_bands']:.3f} ms"
            text += f"; all bands {was_all} -> {k['ms_all_bands']:.3f} ms"
        print(text)


def scan_case(net, phys, B, T, seed, with_q_init, dev):
    """Inflow ``q' (B, T, n)`` for ``B`` requests and an optional carried state."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 2.0, (B, T, net.n)).astype(np.float32)
    q[rng.random(q.shape) < 0.25] = 0.0  # raw values below the discharge clamp
    q_init = None
    if with_q_init:
        q_init = torch.as_tensor(rng.uniform(0.0, 3.0, (B, net.n)).astype(np.float32), device=dev)
    return torch.as_tensor(q, device=dev), q_init


def reverse_inputs(net, B, T, seed, dev):
    """The reverse scan's inputs ``(gbar, ow, zce, duce)``, ``(B, T, n)``
    twice and ``(B, T, n t_width)`` twice, shaped as the analytic backward
    builds them: ``ow`` and ``duce`` zero at ``t = 0``, weights nonnegative
    and summing below 1 a wave (``lam`` stays bounded)."""
    import torch

    n, tw = net.n, net.wf_t_width
    gen = torch.Generator(device=dev).manual_seed(seed)
    gbar = torch.randn(B, T, n, generator=gen, device=dev)
    ow = 0.3 * torch.rand(B, T, n, generator=gen, device=dev)
    edges = (0.3 / tw) * torch.rand(B, T, 2 * n * tw, generator=gen, device=dev)
    zce, duce = edges[..., : n * tw].contiguous(), edges[..., n * tw :].contiguous()
    ow[:, 0] = 0.0
    duce[:, 0] = 0.0
    return gbar, ow, zce, duce


def reverse_streams(net, B, T, seed, dev):
    """:func:`reverse_inputs` as the pre-skewed plain reverse scan's stream
    ``(B, W, 2n + 2n t_width)``: skewed into reverse wave order, zeros out of
    band."""
    import torch

    from ddr_tpu_torch.routing.wavefront import _reverse_stream

    tw = net.wf_t_width
    lvl = net.level_p.long()
    levels = torch.cat([lvl, lvl, lvl.repeat_interleave(tw), lvl.repeat_interleave(tw)])
    a = torch.cat(reverse_inputs(net, B, T, seed, dev), dim=-1)
    return _reverse_stream(a, levels, net.depth, T + net.depth).contiguous()


def fan_out_edges(n, seed, confluence=0):
    """A random DAG whose reaches have up to 3 predecessors and any number of
    successors; ``confluence > 0`` makes reach ``confluence`` gather every
    reach before it instead."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = rng.integers(1, 4, n)
    rows = np.repeat(np.arange(1, n), np.minimum(k[1:], np.arange(1, n)))
    cols = np.concatenate([rng.choice(i, size=min(int(k[i]), i), replace=False) for i in range(1, n)])
    if confluence:
        keep = rows != confluence
        rows = np.concatenate([rows[keep], np.full(confluence, confluence)])
        cols = np.concatenate([cols[keep], np.arange(confluence)])
    return rows, cols


def fan_out_network(n, seed, dev):
    """The fan-out DAG as a single-ring network, so the reverse scan's slot
    loop runs more than once."""
    from ddr_tpu_torch.routing.network import build_network

    return build_network(*fan_out_edges(n, seed), n, device=dev)


def band_frame(dev):
    """A small stacked frame: the fan-out DAG of 4096 reaches with a 100-way
    confluence, banded by a cell budget into 3 bands: gather buckets of width
    128 down to a width-0 tail, transposed width 16."""
    from ddr_tpu_torch.routing.stacked import build_stacked_chunked

    frame = build_stacked_chunked(*fan_out_edges(4096, 2, confluence=100), 4096, cell_budget=20000,
                                  device=dev)
    widths = [w for *_, w in frame.buckets]
    if frame.n_chunks < 3 or max(widths) < 64 or 0 not in widths or frame.t_width < 2:
        fail(f"small band frame: {frame.n_chunks} bands, bucket widths {widths}, "
             f"t_width {frame.t_width}")
    return frame


def random_physics(n, seed, dev):
    """Random per-slot physics (the ranges of the port's kernel tests)."""
    import numpy as np
    import torch

    from ddr_tpu_torch.routing import mc
    from ddr_tpu_torch.routing.wave_kernel import ReachPhysics

    rng = np.random.default_rng(seed)

    def f32(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, n).astype(np.float32), device=dev)

    return ReachPhysics(
        n=f32(0.02, 0.06), p_spatial=f32(5.0, 30.0), q_spatial=f32(0.2, 0.8),
        channels=mc.ChannelState(length=f32(500.0, 5000.0), slope=f32(1e-3, 1e-2),
                                 x_storage=f32(0.1, 0.4)),
        bounds=mc.Bounds(), dt=mc.DT_SECONDS,
    )


def band_scan_case(band, B, T, seed, with_q_init, dev):
    """Inflow and external series ``(B, T, n)`` for one band (or chunked
    band), as the router hands them to the scan, and an optional carried
    state."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    n = band.n

    def series(scale):
        return scale * torch.rand(B, T, n, generator=gen, device=dev)

    q = series(2.0)
    q[torch.rand(B, T, n, generator=gen, device=dev) < 0.25] = 0.0  # below the discharge clamp
    xe, se = series(1.0), series(1.0)
    q_init = 3.0 * torch.rand(B, n, generator=gen, device=dev) if with_q_init else None
    return q, xe, se, q_init


def band_bounds(frame, c, B, T):
    """``(bytes ms, operations ms)`` of band ``c``'s two scans at batch B and
    T timesteps, counting only in-band work of its real reaches and real
    gather slots, as the single-ring bounds do: the forward reads q', x_ext
    and s_ext and writes raw once per (request, reach, timestep), reads its
    tables and operands once; the reverse reads its four inputs and writes
    lam once, reads its transposed tables once."""
    n = int((frame.gidx[c] < frame.n).sum())
    slots = int(frame.wf_mask[c].sum())
    t_slots = int((frame.t_col[c] < frame.n_cap).sum())
    fwd_bytes = 4 * 4 * B * T * n + 4 * (3 * n + 3 * slots) + 4 * 6 * n
    # the band variant adds xe and se once a pair and the mask once a slot
    fwd_flops = B * (T - 1) * n * (FLOPS_PER_PAIR + 2) + B * T * slots * (FLOPS_PER_SLOT + 1)
    tw = frame.t_width
    rev_bytes = 4 * (B * T * n * (2 + 2 * tw) + B * T * n) + 4 * (2 * n * tw + n)
    rev_flops = B * T * (n * REVERSE_FLOPS_PER_PAIR + t_slots * REVERSE_FLOPS_PER_SLOT)
    ms = lambda b, f: (b / HBM_BYTES_PER_S * 1e3, f / FP32_FLOP_PER_S * 1e3)  # noqa: E731
    return ms(fwd_bytes, fwd_flops), ms(rev_bytes, rev_flops)


def device_profile(prof, ranges=(), sub_ranges=()) -> float:
    """Busy device time from a ``torch.profiler`` trace: every kernel, copy
    and memset once (the GPU spans of ``record_function`` ranges are not
    device work), by name, within each range's GPU span, and outside all of
    them. ``sub_ranges`` nest inside ``ranges`` on the host, but the GPU span
    of a range need not cover a nested ``autograd.grad``, so each is read on
    its own. Returns the busy milliseconds (0.0 when the profiler saw no
    device time)."""
    from torch.autograd import DeviceType

    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    work = [e for e in gpu if not e.is_user_annotation]
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    if not work:
        print("profile: the profiler saw no device time (device breakdown not measured)")
        return 0.0
    spans = {}
    for e in gpu:
        if e.is_user_annotation:
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))

    def inside(e, names):
        return any(s <= e.time_range.start < t for name in names for s, t in spans.get(name, ()))

    for name in (*ranges, *sub_ranges):
        kernels = [e for e in work if inside(e, (name,))]
        ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        span_ms = sum(t - s for s, t in spans.get(name, ())) / 1e3
        print(f"  {'range' if name in ranges else '  sub-range'} {name:26s} busy {ms:9.3f} ms in a GPU "
              f"span of {span_ms:9.3f} ms ({len(kernels)} kernels)")
    if ranges:
        rest = [e for e in work if not inside(e, (*ranges, *sub_ranges))]
        print(f"  outside every range              busy {sum(e.time_range.elapsed_us() for e in rest) / 1e3:9.3f}"
              f" ms ({len(rest)} kernels: autograd of the KAN, permutes, skews, gauges, loss, clip)")
    by_name = {}
    for e in work:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:9.3f} ms  x{count:<4d} {name[:90]}")
    return busy_ms


def executed_batches(answers) -> int:
    """How many batches served ``answers``: requests of one batch share its
    timings. (The batcher's own count is raised after the futures resolve,
    so reading it here would race with the last batch.)"""
    return len({(a["execute_s"], a["device_ms"]) for a in answers})


def check_watchdog(svc, batches, label) -> None:
    """The service's health watchdog (on by default) observed every served
    batch and is not degraded."""
    status = svc.status()
    print(f"{label} health watchdog: {status['batches']} batches observed, {status['violations']} "
          f"violations, degraded {svc.degraded}, worst gauges {status['spatial']}")
    if status["batches"] != batches or svc.degraded:
        fail(f"{label}: the watchdog observed {status['batches']} of {batches} batches, "
             f"degraded {svc.degraded}")


def profile_batch(svc, name, starts) -> None:
    """One served batch under ``torch.profiler``: device time by operation,
    largest first, and the device's busy share of the batch's host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in [svc.submit(name, t0=int(s)) for s in starts]:
            f.result(timeout=600)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    print(f"profile of one served batch of {name}: host {host_ms:.3f} ms")
    device_ms = device_profile(prof)
    print(f"  device busy {device_ms:.3f} ms ({100 * device_ms / host_ms:.1f}% of the host time)")


def profile_band_step(step, batch, label) -> None:
    """One more train step of a band router under ``torch.profiler``:
    device time by range (the adjoint's sub-ranges read on their own) and by
    operation, and the device's busy share of the step's host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    print(f"profile of one {label} train step: host {host_ms:.3f} ms")
    device_ms = device_profile(
        prof, ("ddr::kan", "ddr::band_inputs", "ddr::forward_scan", "ddr::band_publish",
               "ddr::adjoint_prepasses", "ddr::reverse_scan", "ddr::adjoint_postpasses",
               "ddr::optimizer"),
        ("ddr::adjoint_physics", "ddr::adjoint_pullback"),
    )
    print(f"  device busy {device_ms:.3f} ms ({100 * device_ms / host_ms:.1f}% of the host time)")


def band_parity_small(dev) -> tuple[float, float]:
    """Phase 6: both band kernels against their plain versions on the small
    frame; returns their max abs errors."""
    import torch

    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm, reverse_scan_tm_reference
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference

    frame = band_frame(dev)
    print(f"small band frame: {frame.n_chunks} bands, n_cap {frame.n_cap}, span_max "
          f"{frame.span_max}, ring_rows {frame.ring_rows}, bucket widths "
          f"{[w for *_, w in frame.buckets]}, t_width {frame.t_width}, boundary {frame.n_boundary}")
    wave_err = reverse_err = 0.0
    with torch.no_grad():
        for c in range(frame.n_chunks):
            band = frame.band(c)
            phys = random_physics(frame.n_cap, 3 + c, dev)
            for label, B, T, with_init in (("hotstart", 3, 24, False), ("q_init", 3, 24, True),
                                           ("T=1", 2, 1, False)):
                q, xe, se, qi = band_scan_case(band, B, T, 7 + c, with_init, dev)
                kw = dict(x_ext=xe, s_ext=se, mask_raw=True)
                raw = wave_scan_tm(q, band, phys, qi, **kw)
                torch.cuda.synchronize()
                wave_err = max(wave_err, compare(wave_scan_tm_reference(q, band, phys, qi, **kw), raw,
                                                 f"wave_scan/band small band {c} {label}"))
            for label, B, T in (("T 24", 2, 24), ("T=1", 2, 1)):
                rev = reverse_inputs(band, B, T, 5 + c, dev)
                lam = reverse_scan_tm(*rev, band)
                torch.cuda.synchronize()
                reverse_err = max(reverse_err, compare(
                    reverse_scan_tm_reference(*rev, band), lam,
                    f"reverse_scan/band small band {c} {label} (t_width {frame.t_width})"))
    return wave_err, reverse_err


def new_kan(cfg, dev):
    """The KAN of every phase: hidden 11, one layer, grid 3, order 3, seed 0."""
    import torch

    from ddr_tpu_torch.nn.kan import Kan

    return Kan(cfg.kan.input_var_names, cfg.kan.learnable_parameters, hidden_size=11,
               num_hidden_layers=1, grid=3, k=3,
               generator=torch.Generator().manual_seed(0)).to(dev)


def serve_deep(cfg, basin, smi, dev) -> dict:
    """Phase 7: the service on the continental basin. Returns the registered
    entry, the KAN, the serving launches and the band kernels' errors."""
    import gc

    import numpy as np
    import torch

    from ddr_tpu_torch.routing.mc import DT_SECONDS, route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, engine_label
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm, reverse_scan_tm_reference
    from ddr_tpu_torch.routing.stacked import StackedChunked, band_physics, frame_operands
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference
    from ddr_tpu_torch.serving.config import ServeConfig
    from ddr_tpu_torch.serving.service import ForecastService

    p = cfg.params
    kan = new_kan(cfg, dev)
    # a continental batch takes seconds on the host: give requests room
    svc = ForecastService(cfg, ServeConfig(max_batch=MAX_BATCH, horizon_hours=HORIZON,
                                           deadline_s=600.0), device=dev)
    out = {"kan": kan}
    try:
        t0 = time.perf_counter()
        entry = svc.register_network("conus-deep", basin.routing_data, forcing=basin.q_prime)
        build_s = time.perf_counter() - t0
        svc.register_model("default", kan)
        net = entry.network
        if not isinstance(net, StackedChunked):
            fail(f"the continental basin did not build a stacked frame: {engine_label(net)}")
        out["entry"] = entry
        print(f"deep network: {engine_label(net)}, n {net.n}, depth {net.depth}, edges "
              f"{net.n_edges}, n_chunks {net.n_chunks}, n_cap {net.n_cap}, span_max "
              f"{net.span_max}, ring_rows {net.ring_rows}, t_width {net.t_width}, boundary "
              f"{net.n_boundary}, bucket widths {[w for *_, w in net.buckets]} "
              f"({build_s:.2f}s to build)")

        # both band kernels on one band of this frame, at the main path's shapes
        with torch.no_grad():
            raw = kan(entry.attrs)
            phys_params = denormalize_spatial_parameters(
                raw, p.parameter_ranges, p.log_space_parameters, p.defaults, net.n)
            ops_pad = frame_operands(entry.channels, phys_params, net.n, dev)
            c = 0
            band = net.band(c)
            phys = band_physics(ops_pad, net.gidx[c].long(), svc.bounds, DT_SECONDS)
            q, xe, se, _ = band_scan_case(band, MAX_BATCH, HORIZON, 19, False, dev)
            kw = dict(x_ext=xe, s_ext=se, mask_raw=True)
            raw = wave_scan_tm(q, band, phys, None, **kw)
            torch.cuda.synchronize()
            out["wave_err"] = compare(wave_scan_tm_reference(q, band, phys, None, **kw), raw,
                                      f"wave_scan/band serve-frame band {c} (B {MAX_BATCH}, T {HORIZON})")
            del q, xe, se, raw
            T_rev = TRAIN_DAYS * 24
            rev = reverse_inputs(band, 1, T_rev, 23, dev)
            lam = reverse_scan_tm(*rev, band)
            torch.cuda.synchronize()
            out["reverse_err"] = compare(reverse_scan_tm_reference(*rev, band), lam,
                                         f"reverse_scan/band serve-frame band {c} (B 1, T {T_rev})")
            del rev, lam
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        svc.warmup()
        print(f"deep warmup: {time.perf_counter() - t0:.2f}s")
        starts = np.arange(MAX_BATCH * N_BATCHES) % (basin.q_prime.shape[0] - HORIZON + 1)
        torch.cuda.reset_peak_memory_stats()
        wave_scan_tm.launches = 0
        futures = [svc.submit("conus-deep", t0=int(s)) for s in starts]
        answers = [f.result(timeout=900) for f in futures]
        launches = wave_scan_tm.launches
        batches = executed_batches(answers)
        print(f"deep serve: {len(answers)} requests in {batches} batches, wave_scan_tm.launches "
              f"{launches} ({net.n_chunks} bands), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {smi}")
        if batches < 3 or launches != batches * net.n_chunks:
            fail(f"expected n_chunks = {net.n_chunks} wave_scan launches per batch (>= 3 "
                 f"batches): {launches} launches, {batches} batches")
        check_watchdog(svc, batches, "deep serve")
        out["launches"] = launches
        per_batch = {}
        for a in answers:
            if a["runoff"].shape != (HORIZON, N_GAUGES) or not np.isfinite(a["runoff"]).all():
                fail(f"deep request {a['request_id']}: runoff {a['runoff'].shape} not finite "
                     f"({HORIZON}, {N_GAUGES})")
            per_batch[(a["execute_s"], a["device_ms"])] = a["batch_size"]
        for (execute_s, device_ms), size in per_batch.items():
            device = "not measured" if device_ms is None else f"{device_ms:.3f} ms (CUDA events)"
            print(f"deep batch of {size}: device {device}, host {execute_s * 1e3:.3f} ms on {smi}")

        with torch.no_grad():
            q = torch.as_tensor(basin.q_prime[starts[0] : starts[0] + HORIZON], device=dev)
            t0 = time.perf_counter()
            expect = route(net, entry.channels, phys_params, q, gauges=entry.gauge_index,
                           bounds=svc.bounds, kernel="reference", device=dev).runoff
            print(f"deep plain route of one request: {time.perf_counter() - t0:.2f}s")
        compare(expect.cpu(), torch.as_tensor(answers[0]["runoff"]), "deep served request vs plain path")
        del q, expect
        # by operation only: the batch runs on the batcher's thread, whose
        # record_function ranges the profiler does not carry to the device
        profile_batch(svc, "conus-deep", starts[:MAX_BATCH])
    finally:
        svc.close()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_deep(cfg, basin, entry, kan, smi, dev) -> tuple[dict, tuple]:
    """Phase 8: ``observe`` and 3 train steps on the continental basin, with
    the service's network, channels and gauges. Returns the launches and
    the batch."""
    import numpy as np
    import torch

    from ddr_tpu_torch import training
    from ddr_tpu_torch.geodatazoo.synthetic import observe
    from ddr_tpu_torch.routing.mc import Bounds
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts_utils import resolve_learning_rate

    p = cfg.params
    t0 = time.perf_counter()
    observe(basin, cfg, device=dev)
    print(f"deep observe (a frame build and a T {basin.q_prime.shape[0]} route): "
          f"{time.perf_counter() - t0:.2f}s")
    net = entry.network
    obs = basin.obs_daily
    batch = (net, entry.channels, entry.gauge_index, entry.attrs,
             torch.as_tensor(basin.q_prime, device=dev),
             torch.as_tensor(np.nan_to_num(obs), device=dev),
             torch.as_tensor(np.isfinite(obs), device=dev))
    train_args = (Bounds.from_config(p.attribute_minimums), p.parameter_ranges,
                  p.log_space_parameters, p.defaults, p.tau, cfg.experiment.warmup)
    kan.train()
    schedule = cfg.experiment.learning_rate
    opt = training.make_optimizer(kan.parameters(), resolve_learning_rate(schedule, 1))
    step = training.make_batch_train_step(kan, *train_args, opt, device=dev)
    torch.cuda.reset_peak_memory_stats()
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    losses = []
    for i in range(1, TRAIN_STEPS + 1):
        training.set_learning_rate(opt, resolve_learning_rate(schedule, i))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, daily = step(*batch)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        print(f"deep train step {i}: loss {losses[-1]:.6f} (lr {opt.param_groups[0]['lr']:g}), device "
              f"{start.elapsed_time(end):.3f} ms (CUDA events), host {host_ms:.3f} ms on {smi}")
    launches = {"wave_scan": wave_scan_tm.launches, "reverse_scan": reverse_scan_tm.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"deep train: {TRAIN_STEPS} steps, launches {launches} ({net.n_chunks} bands), peak device "
          f"memory {peak_gb:.3f} GB on {smi}")
    expect = TRAIN_STEPS * net.n_chunks
    if not all(np.isfinite(losses)) or daily.shape != (obs.shape[0], N_GAUGES):
        fail(f"deep train: losses {losses}, daily {tuple(daily.shape)}")
    if launches != {"wave_scan": expect, "reverse_scan": expect}:
        fail(f"expected n_chunks = {net.n_chunks} launches of each kernel a step: {launches}")
    profile_band_step(step, batch, "deep")
    del opt, step
    return launches, batch


def stacked_gradients(cfg, dev) -> None:
    """Phase 8, end: KAN gradients through the band kernels against those
    through the plain scans, on the 65,536-reach, depth-2048 stacked basin:
    fp32 within ``GRAD_RTOL``, and bf16 (the bf16 kernels against the bf16
    plain scans) within ``BF16_GRAD_RTOL``."""
    import numpy as np
    import torch

    from ddr_tpu_torch import training
    from ddr_tpu_torch.geodatazoo.synthetic import make_basin, observe
    from ddr_tpu_torch.routing.mc import Bounds
    from ddr_tpu_torch.routing.model import engine_label, prepare_batch
    from ddr_tpu_torch.routing.stacked import StackedChunked

    p = cfg.params
    basin = observe(make_basin(n_segments=GRAD_SEGMENTS, n_gauges=N_GAUGES, n_days=TRAIN_DAYS,
                               depth=GRAD_DEPTH, seed=0), cfg, device=dev)
    net, ch, gauges = prepare_batch(basin.routing_data, p.attribute_minimums["slope"], device=dev)
    if not isinstance(net, StackedChunked) or net.n_chunks < 2:
        fail(f"the gradient basin did not build a multi-band frame: {engine_label(net)}")
    print(f"gradient basin: {engine_label(net)}, n {net.n}, depth {net.depth}, n_cap {net.n_cap}, "
          f"span_max {net.span_max}")
    obs = basin.obs_daily
    batch = (net, ch, gauges, torch.as_tensor(basin.routing_data.normalized_spatial_attributes, device=dev),
             torch.as_tensor(basin.q_prime, device=dev), torch.as_tensor(np.nan_to_num(obs), device=dev),
             torch.as_tensor(np.isfinite(obs), device=dev))
    kan = new_kan(cfg, dev)
    train_args = (Bounds.from_config(p.attribute_minimums), p.parameter_ranges,
                  p.log_space_parameters, p.defaults, p.tau, cfg.experiment.warmup)
    for dtype, rtol in (("fp32", GRAD_RTOL), ("bf16", BF16_GRAD_RTOL)):
        grads = {}
        for kernel in (None, "reference"):
            kan.zero_grad(set_to_none=True)
            loss, _ = training.make_batch_loss(kan, *train_args, kernel=kernel, device=dev,
                                               dtype=dtype)(*batch)
            loss.backward()
            torch.cuda.synchronize()
            grads[kernel] = {k: v.grad.detach().clone() for k, v in kan.named_parameters()}
            print(f"stacked {dtype} train loss through {kernel or 'the kernels'}: "
                  f"{float(loss.detach()):.6f}")
        for k in grads[None]:
            compare(grads["reference"][k], grads[None][k],
                    f"stacked {dtype} KAN gradient {k}, kernels vs plain scans", rtol=rtol)


def time_bands(cfg, entry, kan, smi, dev) -> dict:
    """Phase 9: each band kernel at its main path's shape (serving for the
    forward, B 8, T 72; training for the reverse, B 1, T 240): one band, all
    ``n_chunks`` bands of a route back to back, the bound per band and
    summed, and the plain version on one band."""
    import torch

    from ddr_tpu_torch.routing.mc import DT_SECONDS, Bounds
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm, reverse_scan_tm_reference
    from ddr_tpu_torch.routing.stacked import band_physics, frame_operands
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference

    p = cfg.params
    net = entry.network
    C = net.n_chunks
    bounds = Bounds.from_config(p.attribute_minimums)
    out = {}
    with torch.no_grad():
        raw = kan(entry.attrs)
        phys_params = denormalize_spatial_parameters(
            raw, p.parameter_ranges, p.log_space_parameters, p.defaults, net.n)
        ops_pad = frame_operands(entry.channels, phys_params, net.n, dev)
        gidx = net.gidx.long()
        phys = [band_physics(ops_pad, gidx[c], bounds, DT_SECONDS) for c in range(C)]
        bands = [net.band(c) for c in range(C)]

        B, T = MAX_BATCH, HORIZON
        q, xe, se, _ = band_scan_case(bands[0], B, T, 29, False, dev)
        kw = dict(x_ext=xe, s_ext=se, mask_raw=True)
        for c in range(C):  # every band's run table, as the route's first batch builds them
            wave_scan_tm(q, bands[c], phys[c], None, **kw)
        def every_band():  # each output dropped at once, as the route drops its raw
            for c in range(C):
                wave_scan_tm(q, bands[c], phys[c], None, **kw)

        one_ms = cuda_ms(lambda: wave_scan_tm(q, bands[0], phys[0], None, **kw), 5)
        all_ms = cuda_ms(every_band, 2)
        plain_ms = cuda_ms(lambda: wave_scan_tm_reference(q, bands[0], phys[0], None, **kw), 1)
        fwd = [band_bounds(net, c, B, T)[0] for c in range(C)]
        out["wave"] = dict(ms=one_ms, all_ms=all_ms, plain_ms=plain_ms, bound=fwd[0],
                           all_bound_ms=sum(max(b) for b in fwd),
                           barrier_ms=time_barrier(f"wave_scan/band band 0 (B {B}, T {T})", bands[0], B, T, smi,
                                                   dev)["ms"])
        print(f"timing wave_scan/band (B {B}, W {T + net.span_max}, n_cap {net.n_cap}): one band "
              f"{one_ms:.3f} ms, all {C} bands {all_ms:.3f} ms, plain one band {plain_ms:.3f} ms, "
              f"bound one band {max(fwd[0]):.4f} ms (bytes {fwd[0][0]:.4f}, operations "
              f"{fwd[0][1]:.4f}), all bands {out['wave']['all_bound_ms']:.4f} ms on {smi}")
        del q, xe, se
        torch.cuda.empty_cache()

        B, T = 1, TRAIN_DAYS * 24
        rev = reverse_inputs(bands[0], B, T, 31, dev)
        for c in range(C):
            reverse_scan_tm(*rev, bands[c])
        def every_reverse_band():
            for c in range(C):
                reverse_scan_tm(*rev, bands[c])

        one_ms = cuda_ms(lambda: reverse_scan_tm(*rev, bands[0]), 5)
        all_ms = cuda_ms(every_reverse_band, 2)
        plain_ms = cuda_ms(lambda: reverse_scan_tm_reference(*rev, bands[0]), 1)
        rev = [band_bounds(net, c, B, T)[1] for c in range(C)]
        out["reverse"] = dict(ms=one_ms, all_ms=all_ms, plain_ms=plain_ms, bound=rev[0],
                              all_bound_ms=sum(max(b) for b in rev),
                              barrier_ms=time_barrier(f"reverse_scan/band band 0 (B {B}, T {T})", bands[0], B,
                                                      T, smi, dev, reverse=True)["ms"])
        print(f"timing reverse_scan/band (B {B}, W {T + net.span_max}, n_cap {net.n_cap}, t_width "
              f"{net.t_width}): one band {one_ms:.3f} ms, all {C} bands {all_ms:.3f} ms, plain one "
              f"band {plain_ms:.3f} ms, bound one band {max(rev[0]):.4f} ms (bytes {rev[0][0]:.4f}, "
              f"operations {rev[0][1]:.4f}), all bands {out['reverse']['all_bound_ms']:.4f} ms on {smi}")
    return out


def compare_bf16(ref, out, label: str, exact: bool = False) -> float:
    """:func:`compare` within one bf16 epsilon; also prints the share of
    elements the kernel and the plain version give exactly alike, and under
    ``exact`` fails unless that share is 100%."""
    err = compare(ref, out, label, rtol=BF16_RTOL)
    share = float((ref == out).double().mean())
    print(f"  {label}: {100 * share:.3f}% of elements equal exactly")
    if exact and share != 1.0:
        fail(f"{label}: {100 * share:.3f}% of elements equal, not all")
    return err


def bf16_parity(net_s, phys_s, dev) -> tuple[float, float]:
    """Phase 10: the bf16 ring against its plain version on the small single
    ring and on the small 3-band frame; returns both max abs errors."""
    import torch

    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference

    ring_err = band_err = 0.0
    cases = (("hotstart", 3, 24, False), ("q_init", 3, 24, True), ("T=1", 2, 1, False))
    with torch.no_grad():
        for label, B, T, with_init in cases:
            q, qi = scan_case(net_s, phys_s, B, T, 7, with_init, dev)
            raw = wave_scan_tm(q, net_s, phys_s, qi, compute_dtype="bf16")
            torch.cuda.synchronize()
            ring_err = max(ring_err, compare_bf16(
                wave_scan_tm_reference(q, net_s, phys_s, qi, compute_dtype="bf16"), raw,
                f"wave_scan/bf16 small/{label}"))
        frame = band_frame(dev)
        for c in range(frame.n_chunks):
            band = frame.band(c)
            phys = random_physics(frame.n_cap, 3 + c, dev)
            for label, B, T, with_init in cases:
                q, xe, se, qi = band_scan_case(band, B, T, 7 + c, with_init, dev)
                kw = dict(x_ext=xe, s_ext=se, mask_raw=True, compute_dtype="bf16")
                raw = wave_scan_tm(q, band, phys, qi, **kw)
                torch.cuda.synchronize()
                band_err = max(band_err, compare_bf16(wave_scan_tm_reference(q, band, phys, qi, **kw), raw,
                                                      f"wave_scan/band-bf16 small band {c} {label}"))
    return ring_err, band_err


def bf16_against_fp32(cfg, kan, net, ch, gauges, attrs, q, label, hold, dev) -> None:
    """The runoff of one window in bf16 against fp32, same weights and
    inflow: max and mean relative error of the gauge runoff (the output a
    train step or a forecast reads), held to the JAX package's bound where
    ``hold``, and of the full-domain runoff, printed. Full-domain runoff
    holds reaches whose small discharge is a difference of large terms; a
    bf16 ring moves those by more than the bound, in the JAX package as in
    the port (``tests/test_torch_bf16.py``)."""
    import torch

    from ddr_tpu_torch.routing.mc import Bounds, route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters

    p = cfg.params
    with torch.no_grad():
        phys_params = denormalize_spatial_parameters(
            kan(attrs), p.parameter_ranges, p.log_space_parameters, p.defaults, net.n)
        kw = dict(bounds=Bounds.from_config(p.attribute_minimums), device=dev)
        for where, g in (("gauge", gauges), ("full-domain", None)):
            r32 = route(net, ch, phys_params, q, gauges=g, **kw).runoff
            r16 = route(net, ch, phys_params, q, gauges=g, dtype="bf16", **kw).runoff
            rel = (r16 - r32).abs() / (r32.abs() + 1e-6)
            max_rel, mean_rel = float(rel.max()), float(rel.mean(dtype=torch.float64))
            finite = bool(torch.isfinite(r16).all())
            del r32, r16, rel
            held = hold and where == "gauge"
            print(f"bf16 vs fp32 {where} runoff, {label} (T {q.shape[0]}): max rel {max_rel:.4e}, mean rel "
                  f"{mean_rel:.4e} (JAX bound {BF16_MAX_REL} / {BF16_MEAN_REL}"
                  f"{', held' if held else ', printed only'})")
            if not finite or (held and (max_rel > BF16_MAX_REL or mean_rel > BF16_MEAN_REL)):
                fail(f"bf16 vs fp32 {where} runoff, {label}: max rel {max_rel}, mean rel {mean_rel}, "
                     f"finite {finite}")

def bf16_train(cfg, batch, n_launch, label, smi, dev) -> dict:
    """Phases 11-12: 3 bf16 train steps with ``collect_health`` and
    ``HEALTH_BANDS`` bands (``n_launch`` launches of each kernel a step, no
    overflow, finite ulp drift), then 2 fp32 steps with the same health for
    comparison. Returns the launches, step times and peak memory."""
    import numpy as np
    import torch

    from ddr_tpu_torch import training
    from ddr_tpu_torch.routing.mc import Bounds
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts_utils import resolve_learning_rate

    p = cfg.params
    train_args = (Bounds.from_config(p.attribute_minimums), p.parameter_ranges,
                  p.log_space_parameters, p.defaults, p.tau, cfg.experiment.warmup)
    kan = new_kan(cfg, dev).train()
    schedule = cfg.experiment.learning_rate
    opt = training.make_optimizer(kan.parameters(), resolve_learning_rate(schedule, 1))
    health_kw = dict(collect_health=True, health_bands=HEALTH_BANDS)
    steps = {dtype: training.make_batch_train_step(kan, *train_args, opt, device=dev, dtype=dtype,
                                                   **health_kw) for dtype in ("bf16", "fp32")}

    def timed(dtype, i):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, daily, health = steps[dtype](*batch)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = start.elapsed_time(end)
        print(f"{label} {dtype} train step {i}: loss {float(loss):.6f}, overflow {health.overflow}, "
              f"ulp_drift {health.ulp_drift}, pre-clip grad norm {float(health.grad_norm):.6e}, worst band "
              f"{worst_of(health)}, device {dev_ms:.3f} ms (CUDA events), host "
              f"{host_ms:.3f} ms on {smi}")
        return float(loss), health, dev_ms

    torch.cuda.reset_peak_memory_stats()
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    out = {"bf16_ms": [], "fp32_ms": []}
    losses = []
    for i in range(1, TRAIN_STEPS + 1):
        training.set_learning_rate(opt, resolve_learning_rate(schedule, i))
        loss, health, ms = timed("bf16", i)
        losses.append(loss)
        out["bf16_ms"].append(ms)
        if int(health.overflow) != 0 or not np.isfinite(float(health.ulp_drift)):
            fail(f"{label} bf16 step {i}: overflow {health.overflow}, ulp_drift {health.ulp_drift}")
    launches = {"wave_scan": wave_scan_tm.launches, "reverse_scan": reverse_scan_tm.launches}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label} bf16 train: {TRAIN_STEPS} steps, launches {launches}, peak device memory "
          f"{out['peak_gb']:.3f} GB on {smi}")
    expect = TRAIN_STEPS * n_launch
    if not all(np.isfinite(losses)):
        fail(f"{label} bf16 train: losses {losses}")
    if launches != {"wave_scan": expect, "reverse_scan": expect}:
        fail(f"{label} bf16 train: expected {n_launch} launches of each kernel a step: {launches}")
    out["launches"] = launches["wave_scan"]
    for i in range(1, 3):
        out["fp32_ms"].append(timed("fp32", i)[2])
    return out


def worst_of(health) -> str:
    """The worst band and worst reaches of a step's spatial attribution."""
    from ddr_tpu_torch.observability import HealthWatchdog

    spatial = HealthWatchdog.spatial_summary(health) or {}
    return f"{spatial.get('worst_band')} reaches {spatial.get('worst_idx', [])[:3]}"


def recovery_reroute(cfg, batch, dev) -> None:
    """Phase 11, end: the first stage of the recovery ladder, as ``ddr
    train`` drives it (``ddr_tpu/scripts/train.py:511-536``). With
    ``max_ulp_drift = 0`` a bf16 step violates on ``ulp-drift`` only; the
    supervisor picks ``fp32-reroute``; the step is re-run on the fp32 twin
    from a copy of the pre-step KAN and optimizer state, which the watchdog
    must find clean."""
    import torch

    from ddr_tpu_torch import training
    from ddr_tpu_torch.observability import (
        HealthConfig,
        HealthWatchdog,
        RecoveryConfig,
        RecoverySupervisor,
    )
    from ddr_tpu_torch.routing.mc import Bounds

    p = cfg.params
    train_args = (Bounds.from_config(p.attribute_minimums), p.parameter_ranges,
                  p.log_space_parameters, p.defaults, p.tau, cfg.experiment.warmup)
    kan = new_kan(cfg, dev).train()
    opt = training.make_optimizer(kan.parameters(), 0.005)
    health_kw = dict(collect_health=True, health_bands=HEALTH_BANDS)
    step_bf16, step_fp32 = (training.make_batch_train_step(kan, *train_args, opt, device=dev, dtype=d,
                                                           **health_kw) for d in ("bf16", "fp32"))
    watchdog = HealthWatchdog(HealthConfig(max_ulp_drift=0.0))
    supervisor = RecoverySupervisor(RecoveryConfig(enabled=True))
    step_fp32(*batch)  # a healthy first step: the optimizer has state to restore
    backup = copy.deepcopy((kan.state_dict(), opt.state_dict()))
    _, _, health = step_bf16(*batch)
    reasons = watchdog.observe(health, epoch=1, batch=1)
    stage = supervisor.decide(reasons, fp32_available=True)
    print(f"recovery: bf16 step ulp_drift {float(health.ulp_drift):.4f} -> reasons {reasons}, stage {stage}")
    if reasons != ["ulp-drift"] or stage != "fp32-reroute":
        fail(f"recovery: expected an ulp-drift violation and an fp32 re-route: {reasons}, {stage}")
    kan.load_state_dict(backup[0])
    opt.load_state_dict(backup[1])
    loss, _, health = step_fp32(*batch)
    torch.cuda.synchronize()
    again = watchdog.check(health)
    supervisor.record("fp32-reroute", reasons, epoch=1, batch=1, outcome="violated" if again else "clean")
    if again:
        fail(f"recovery: the fp32 re-run violated too: {again}")
    watchdog.reset_streaks()
    moved = max(float((kan.state_dict()[k] - v).abs().max()) for k, v in backup[0].items())
    print(f"recovery: fp32 re-run clean (loss {float(loss):.6f}, parameters moved up to {moved:.3e} from "
          f"the pre-step copy), supervisor {supervisor.summary()['counts']}, watchdog "
          f"{ {k: watchdog.status()[k] for k in ('batches', 'violations', 'degraded')} }")
    if not moved > 0.0:
        fail("recovery: the fp32 re-run did not update the restored parameters")


def time_health(T, n_gauges, field_shape, level, depth, out_map, clamp, label, smi, dev) -> float:
    """The device cost of a train step's health reductions at its shapes:
    the global stats over ``(T, G)`` runoff and ``(T, N)`` inflow, the
    per-reach reductions over the full-domain field (clamped first where
    ``clamp``, as the stacked router clamps its per-slot field for them),
    the band fields and the worst reaches, in bf16. Inputs are random."""
    import torch

    from ddr_tpu_torch.geometry.trapezoidal import maximum
    from ddr_tpu_torch.observability.health import (
        compute_band_health,
        compute_health,
        compute_reach_stats,
    )
    from ddr_tpu_torch.routing.mc import band_ids

    gen = torch.Generator(device=dev).manual_seed(43)
    n = level.shape[0]
    runoff = torch.rand(T, n_gauges, generator=gen, device=dev)
    q = torch.rand(T, n, generator=gen, device=dev)
    field = torch.rand(field_shape, generator=gen, device=dev)
    ids, nb = band_ids(level, depth, HEALTH_BANDS)

    def run():
        compute_health(runoff, q, final_discharge=q[-1], compute_dtype="bf16")
        reach = compute_reach_stats(maximum(field, 1e-4) if clamp else field, q, compute_dtype="bf16",
                                    runoff_inv=out_map)
        compute_band_health(reach, ids, nb, compute_dtype="bf16")

    run()
    ms = cuda_ms(run, 3)
    print(f"timing health reductions, {label} (field {tuple(field_shape)}, inflow ({T}, {n}), "
          f"{nb} bands): {ms:.3f} ms on {smi}")
    del field, q
    torch.cuda.empty_cache()
    return ms


def time_bf16_ring(cfg, kan, net, ch, attrs, smi, dev) -> dict:
    """Phase 11: the bf16 kernel on the single ring at its main path's shape
    (a train step: B 1, T 240) beside the fp32 kernel on the same input, in
    turns (fp32, bf16, bf16, fp32), with its bound, its plain version and
    its parity there; then both kernels at the serving shape for
    comparison."""
    import torch

    from ddr_tpu_torch.routing.mc import Bounds, reach_physics
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference

    p = cfg.params
    out = {}
    with torch.no_grad():
        phys_params = denormalize_spatial_parameters(
            kan(attrs), p.parameter_ranges, p.log_space_parameters, p.defaults, net.n)
        phys = reach_physics(net, ch, phys_params, Bounds.from_config(p.attribute_minimums))
        for shape, B, T in (("train", 1, TRAIN_DAYS * 24), ("serve", MAX_BATCH, HORIZON)):
            q, _ = scan_case(net, phys, B, T, 37, False, dev)

            def run(dtype):
                return wave_scan_tm(q, net, phys, None, compute_dtype=dtype)

            for dtype in ("fp32", "bf16"):
                run(dtype)
            turns = [cuda_ms(lambda d=d: run(d), 10) for d in ("fp32", "bf16", "bf16", "fp32")]
            ms16, ms32 = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            print(f"timing wave_scan/bf16 vs fp32 at the {shape} shape (B {B}, W {T + net.depth}, "
                  f"n {net.n}), in turns fp32/bf16/bf16/fp32: {' / '.join(f'{t:.3f}' for t in turns)} ms; "
                  f"bf16 {ms16:.3f} ms = {100 * (ms16 / ms32 - 1):+.1f}% of fp32 on {smi}")
            if shape != "train":
                continue
            raw = run("bf16")
            ref = wave_scan_tm_reference(q, net, phys, None, compute_dtype="bf16")
            out["err"] = compare_bf16(ref, raw, f"wave_scan/bf16 train shape (B {B}, T {T}, n {net.n})")
            del raw, ref
            out["plain_ms"] = cuda_ms(
                lambda: wave_scan_tm_reference(q, net, phys, None, compute_dtype="bf16"), 1)
            slots = int(net.wf_idx.numel())
            n = net.n
            bytes_ms = (4 * 2 * B * T * n + 4 * (3 * n + 3 * slots) + 4 * 6 * n) / HBM_BYTES_PER_S * 1e3
            flops_ms = (B * (T - 1) * n * FLOPS_PER_PAIR + B * T * slots * FLOPS_PER_SLOT) / FP32_FLOP_PER_S * 1e3
            out.update(ms=ms16, fp32_ms=ms32, bound=(bytes_ms, flops_ms))
            print(f"timing wave_scan/bf16 (train shape): kernel {ms16:.3f} ms, plain {out['plain_ms']:.3f} ms, "
                  f"bound {max(bytes_ms, flops_ms):.4f} ms (bytes {bytes_ms:.4f}, operations "
                  f"{flops_ms:.4f}) on {smi}")
    return out


def time_bf16_bands(cfg, entry, kan, smi, dev) -> dict:
    """Phase 12: the bf16 band kernel at its main path's shape (a train step:
    B 1, T 240) on one band and on all ``n_chunks`` bands, beside the fp32
    band kernel in turns, with the bound per band and summed, its plain
    version on one band and its parity there."""
    import torch

    from ddr_tpu_torch.routing.mc import DT_SECONDS, Bounds
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters
    from ddr_tpu_torch.routing.stacked import band_physics, frame_operands
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference

    p = cfg.params
    net = entry.network
    C = net.n_chunks
    B, T = 1, TRAIN_DAYS * 24
    with torch.no_grad():
        phys_params = denormalize_spatial_parameters(
            kan(entry.attrs), p.parameter_ranges, p.log_space_parameters, p.defaults, net.n)
        ops_pad = frame_operands(entry.channels, phys_params, net.n, dev)
        gidx = net.gidx.long()
        bounds = Bounds.from_config(p.attribute_minimums)
        phys = [band_physics(ops_pad, gidx[c], bounds, DT_SECONDS) for c in range(C)]
        bands = [net.band(c) for c in range(C)]
        q, xe, se, _ = band_scan_case(bands[0], B, T, 41, False, dev)

        def one(dtype, c=0):
            return wave_scan_tm(q, bands[c], phys[c], None, x_ext=xe, s_ext=se, mask_raw=True,
                                compute_dtype=dtype)

        def every_band(dtype):  # each output dropped at once, as the route drops its raw
            for c in range(C):
                one(dtype, c)

        for dtype in ("fp32", "bf16"):
            every_band(dtype)
        turns = [cuda_ms(lambda d=d: one(d), 5) for d in ("fp32", "bf16", "bf16", "fp32")]
        all_turns = [cuda_ms(lambda d=d: every_band(d), 2) for d in ("fp32", "bf16", "bf16", "fp32")]
        ms16, ms32 = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        all16, all32 = (all_turns[1] + all_turns[2]) / 2, (all_turns[0] + all_turns[3]) / 2
        raw = one("bf16")
        ref = wave_scan_tm_reference(q, bands[0], phys[0], None, x_ext=xe, s_ext=se, mask_raw=True,
                                     compute_dtype="bf16")
        err = compare_bf16(ref, raw, f"wave_scan/band-bf16 train-shape band 0 (B {B}, T {T})")
        del raw, ref
        plain_ms = cuda_ms(lambda: wave_scan_tm_reference(q, bands[0], phys[0], None, x_ext=xe, s_ext=se,
                                                          mask_raw=True, compute_dtype="bf16"), 1)
    fwd = [band_bounds(net, c, B, T)[0] for c in range(C)]
    out = dict(ms=ms16, fp32_ms=ms32, all_ms=all16, all_fp32_ms=all32, plain_ms=plain_ms, bound=fwd[0],
               all_bound_ms=sum(max(b) for b in fwd), err=err)
    print(f"timing wave_scan/band-bf16 (B {B}, W {T + net.span_max}, n_cap {net.n_cap}), in turns "
          f"fp32/bf16/bf16/fp32: one band {' / '.join(f'{t:.3f}' for t in turns)} ms, all {C} bands "
          f"{' / '.join(f'{t:.3f}' for t in all_turns)} ms; bf16 one band {ms16:.3f} ms = "
          f"{100 * (ms16 / ms32 - 1):+.1f}% of fp32; plain one band {plain_ms:.3f} ms; bound one band "
          f"{max(fwd[0]):.4f} ms (bytes {fwd[0][0]:.4f}, operations {fwd[0][1]:.4f}), all bands "
          f"{out['all_bound_ms']:.4f} ms on {smi}")
    del q, xe, se
    torch.cuda.empty_cache()
    return out


def small_chunked(dev):
    """Phase 13's networks: ``make_deep_network(320, 80)`` banded by a cell
    budget of 8,000 into 2 bands, and a 28-reach chain at 120 cells whose
    last band is a single level (local depth 0: no in-band edge, no gather
    table, one external predecessor)."""
    import numpy as np

    from ddr_tpu_torch.geodatazoo.synthetic import make_deep_network
    from ddr_tpu_torch.routing.chunked import build_chunked_network

    n, depth = CHUNK_SMALL
    deep = build_chunked_network(*make_deep_network(n, depth, seed=2), n, cell_budget=CHUNK_SMALL_BUDGET,
                                 device=dev)
    m = CHAIN_REACHES
    chain = build_chunked_network(np.arange(1, m), np.arange(0, m - 1), m, cell_budget=CHAIN_BUDGET,
                                  device=dev)
    last = chain.chunks[-1]
    if deep.n_chunks < 2 or last.depth != 0 or last.n_edges or not chain.ext_cols[-1].numel():
        fail(f"small chunked networks: {deep.n_chunks} bands; chain's last band depth {last.depth}, "
             f"{last.n_edges} edges, {chain.ext_cols[-1].numel()} external edges")
    return deep, chain


def ext_parity_small(dev) -> tuple[float, float, float]:
    """Phase 13: the ``wave_scan`` variant of the unrolled chunked router
    (a band's own single ring, external rows ``xe``/``se``, unmasked raw
    sums) against its plain version: every band of the small chunked
    network and the chain's depth-0 band, hotstart, ``q_init`` and ``T =
    1``; fp32 within ``RTOL``, bf16 equal on every element; and
    ``reverse_scan`` over each of these bands (its backward) within
    ``RTOL``. Returns the three max abs errors."""
    import torch

    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm, reverse_scan_tm_reference
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference

    deep, chain = small_chunked(dev)
    print(f"small chunked network: {deep.n_chunks} bands of {[c.n for c in deep.chunks]} reaches, local "
          f"depths {[c.depth for c in deep.chunks]}, boundary {deep.n_boundary}; chain of "
          f"{CHAIN_REACHES}: {chain.n_chunks} bands, the last of depth {chain.chunks[-1].depth}")
    bands = [(f"band {c}", net) for c, net in enumerate(deep.chunks)] + [("depth-0 band", chain.chunks[-1])]
    err32 = err16 = err_rev = 0.0
    with torch.no_grad():
        for i, (name, net) in enumerate(bands):
            for label, B, T in (("B 3, T 24", 3, 24), ("T=1", 2, 1)):
                rev = reverse_inputs(net, B, T, 90 + i, dev)
                lam = reverse_scan_tm(*rev, net)
                torch.cuda.synchronize()
                err_rev = max(err_rev, compare(reverse_scan_tm_reference(*rev, net), lam,
                                               f"reverse_scan/ext small {name} {label}"))
            phys = random_physics(net.n, 50 + i, dev)
            for label, B, T, with_init in (("hotstart", 3, 24, False), ("q_init", 3, 24, True),
                                           ("T=1", 2, 1, False)):
                q, xe, se, qi = band_scan_case(net, B, T, 60 + i, with_init, dev)
                for dtype in ("fp32", "bf16"):
                    kw = dict(x_ext=xe, s_ext=se, compute_dtype=dtype)
                    ys = wave_scan_tm(q, net, phys, qi, **kw)
                    torch.cuda.synchronize()
                    ref = wave_scan_tm_reference(q, net, phys, qi, **kw)
                    what = f"wave_scan/ext{'-bf16' if dtype == 'bf16' else ''} small {name} {label}"
                    if dtype == "fp32":
                        err32 = max(err32, compare(ref, ys, what))
                    else:
                        err16 = max(err16, compare_bf16(ref, ys, what, exact=True))
    return err32, err16, err_rev


def chunk_physics(net, c, channels, phys_params, bounds):
    """Band ``c``'s :class:`~ddr_tpu_torch.routing.wave_kernel.ReachPhysics`
    in its wf order, gathered from original-order operands as
    ``route_chunked`` gathers them."""
    from ddr_tpu_torch.routing.mc import DT_SECONDS
    from ddr_tpu_torch.routing.stacked import band_physics, frame_operands

    ops = frame_operands(channels, phys_params, net.n, channels.length.device)
    return band_physics(ops, net.gidx[c].long(), bounds, DT_SECONDS)


def ext_bounds(net, B, T) -> tuple[float, float]:
    """``(bytes ms, operations ms)`` of one chunked band's forward scan at
    batch B and T timesteps, counted as the band rows are: ``q'``,
    ``x_ext`` and ``s_ext`` read and ``raw`` written once per (request,
    reach, timestep), the tables and operands once; the ring is not
    counted."""
    n = net.n
    slots = int(net.wf_mask.sum()) if net.wf_mask.numel() else 0
    bytes_moved = 4 * 4 * B * T * n + 4 * (3 * n + 3 * slots) + 4 * 6 * n
    flops = B * (T - 1) * n * (FLOPS_PER_PAIR + 2) + B * T * slots * FLOPS_PER_SLOT
    return bytes_moved / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3


def reverse_ext_bounds(net, B, T) -> tuple[float, float]:
    """``(bytes ms, operations ms)`` of one chunked band's reverse scan at
    batch B and T timesteps, counted as the band rows are: the four inputs
    read and ``lam`` written once per (request, reach, timestep),
    the transposed tables once; operations for the reaches and their real
    successor slots."""
    n, tw = net.n, net.wf_t_width
    t_slots = int((net.wf_t_col < n).sum())
    bytes_moved = 4 * (B * T * n * (2 + 2 * tw) + B * T * n) + 4 * (2 * n * tw + n)
    flops = B * T * (n * REVERSE_FLOPS_PER_PAIR + t_slots * REVERSE_FLOPS_PER_SLOT)
    return bytes_moved / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3


def gauge_rel(a, b) -> float:
    """Max of ``|a - b| / (|b| + 1e-6)``, the JAX package's engine-parity
    measure (``tests/routing/test_chunked.py``)."""
    return float(((a.double() - b.double()).abs() / (b.double().abs() + 1e-6)).max())


def serve_chunked(cfg, basin, entry, kan, smi, dev) -> dict:
    """Phase 14: the continental basin on the unrolled depth-chunked router
    at the memory cap: build its ``ChunkedNetwork``, route 3 batches (B 8,
    T 72) of KAN -> denormalize -> ``route`` with gauges (one ``wave_scan``
    launch a band a batch), hold the gauge runoff against the stacked
    router's on the same inputs and weights, profile a batch, and hold the
    kernel variant against its plain version on the largest band. Returns
    the network, the launches, the error and the variant's times."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddr_tpu_torch.routing.chunked import CHUNK_CELL_BUDGET, ChunkedNetwork, build_routing_network
    from ddr_tpu_torch.routing.mc import Bounds, route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, engine_label
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference

    p = cfg.params
    rd = basin.routing_data
    t0 = time.perf_counter()
    net = build_routing_network(rd.adjacency_rows, rd.adjacency_cols, rd.n_segments,
                                cell_budget=CHUNK_CELL_BUDGET, device=dev)
    build_s = time.perf_counter() - t0
    if not isinstance(net, ChunkedNetwork):
        fail(f"the continental basin with a cell budget did not build a ChunkedNetwork: {engine_label(net)}")
    C = net.n_chunks
    sizes = [c.n for c in net.chunks]
    spans = [c.depth + 1 for c in net.chunks]
    print(f"chunked network: {engine_label(net)}, band spans {min(spans)}-{max(spans)} levels "
          f"({spans}), band sizes {min(sizes)}-{max(sizes)} reaches, boundary columns {net.n_boundary}, "
          f"ring rows {[c.wf_ring_rows for c in net.chunks]} ({build_s:.2f}s to build on the host)")
    stacked = entry.network
    out = {"net": net}
    windows = np.arange(MAX_BATCH * N_BATCHES) % (basin.q_prime.shape[0] - HORIZON + 1)

    def batch_q(i):
        starts = windows[i * MAX_BATCH : (i + 1) * MAX_BATCH]
        return np.stack([basin.q_prime[s : s + HORIZON] for s in starts])

    def serve(network, q_host):
        with torch.no_grad():
            params = denormalize_spatial_parameters(kan(entry.attrs), p.parameter_ranges,
                                                    p.log_space_parameters, p.defaults, network.n)
            q = torch.as_tensor(q_host, device=dev)
            return route(network, entry.channels, params, q, gauges=entry.gauge_index,
                         bounds=Bounds.from_config(p.attribute_minimums), device=dev).runoff

    serve(net, batch_q(0))  # warm-up: allocator and library state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wave_scan_tm.launches = 0
    answers = []
    for i in range(N_BATCHES):
        q_host = batch_q(i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        runoff = serve(net, q_host)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        if runoff.shape != (MAX_BATCH, HORIZON, N_GAUGES) or not bool(torch.isfinite(runoff).all()):
            fail(f"chunked batch {i}: runoff {tuple(runoff.shape)} not finite")
        answers.append(runoff)
        print(f"chunked batch {i + 1} (B {MAX_BATCH}, T {HORIZON}): device {start.elapsed_time(end):.3f} ms "
              f"(CUDA events), host {host_ms:.3f} ms on {smi}")
    launches = wave_scan_tm.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"chunked serve: {N_BATCHES} batches, wave_scan_tm.launches {launches} ({C} bands), peak device "
          f"memory {peak_gb:.3f} GB on {smi}")
    if launches != N_BATCHES * C:
        fail(f"chunked serve: expected {C} wave_scan launches a batch: {launches} in {N_BATCHES} batches")
    out.update(launches=launches, peak_gb=peak_gb)

    rel = max(gauge_rel(answers[i], serve(stacked, batch_q(i))) for i in range(N_BATCHES))
    print(f"chunked vs stacked gauge runoff, same inputs and weights: max rel {rel:.3e} "
          f"(held to {CHUNK_STACKED_MAX_REL:g})")
    if not rel <= CHUNK_STACKED_MAX_REL:
        fail(f"chunked vs stacked gauge runoff: max rel {rel}")
    del answers
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(net, batch_q(0))
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    print(f"profile of one chunked batch: host {host_ms:.3f} ms")
    device_ms = device_profile(prof, ("ddr::band_inputs", "ddr::forward_scan", "ddr::band_publish"))
    print(f"  device busy {device_ms:.3f} ms ({100 * device_ms / host_ms:.1f}% of the host time)")
    del prof
    gc.collect()
    torch.cuda.empty_cache()

    # the variant on the largest band at the serving shape, then every band
    # one at a time (their inputs do not fit the card together)
    bounds = Bounds.from_config(p.attribute_minimums)
    with torch.no_grad():
        params = denormalize_spatial_parameters(kan(entry.attrs), p.parameter_ranges,
                                                p.log_space_parameters, p.defaults, net.n)
        big = int(np.argmax(sizes))
        B, T = MAX_BATCH, HORIZON
        per_band, bound_all = [], 0.0
        for c in [big] + [c for c in range(C) if c != big]:
            band = net.chunks[c]
            phys = chunk_physics(net, c, entry.channels, params, bounds)
            q, xe, se, _ = band_scan_case(band, B, T, 70 + c, False, dev)
            kw = dict(x_ext=xe, s_ext=se)
            wave_scan_tm(q, band, phys, None, **kw)
            per_band.append(cuda_ms(lambda: wave_scan_tm(q, band, phys, None, **kw), 2 if c != big else 5))
            bound_all += max(ext_bounds(band, B, T))
            if c == big:
                raw = wave_scan_tm(q, band, phys, None, **kw)
                torch.cuda.synchronize()
                ref = wave_scan_tm_reference(q, band, phys, None, **kw)
                out["err"] = compare(ref, raw, f"wave_scan/ext continental band {c} ({band.n} reaches, "
                                               f"B {B}, T {T})")
                del raw, ref
                out["plain_ms"] = cuda_ms(lambda: wave_scan_tm_reference(q, band, phys, None, **kw), 1)
                out["bound"] = ext_bounds(band, B, T)
                out["barrier_ms"] = time_barrier(f"wave_scan/ext largest band (B {B}, T {T})", band, B, T,
                                                 smi, dev)["ms"]
            del q, xe, se
            torch.cuda.empty_cache()
    out.update(ms=per_band[0], all_ms=sum(per_band), all_bound_ms=bound_all)
    bytes_ms, flops_ms = out["bound"]
    print(f"timing wave_scan/ext (B {B}, T {T}): largest band ({sizes[big]} reaches, W "
          f"{T + net.chunks[big].depth}) {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, bound "
          f"{max(bytes_ms, flops_ms):.4f} ms (bytes {bytes_ms:.4f}, operations {flops_ms:.4f}); all {C} "
          f"bands one at a time {out['all_ms']:.3f} ms against {bound_all:.4f} ms bound on {smi}")
    return out


def deep_batch_of(network, entry, basin, dev):
    """The continental train batch ``(network, channels, gauges, attrs, q',
    obs, mask)`` of an observed basin on ``network``."""
    import numpy as np
    import torch

    obs = basin.obs_daily
    return (network, entry.channels, entry.gauge_index, entry.attrs,
            torch.as_tensor(basin.q_prime, device=dev), torch.as_tensor(np.nan_to_num(obs), device=dev),
            torch.as_tensor(np.isfinite(obs), device=dev))


def train_chunked(cfg, basin, entry, net, smi, dev) -> dict:
    """Phase 15: 3 fp32 train steps (B 1, T 240) on the continental
    ``ChunkedNetwork`` with one launch of each kernel a band a step, their
    times and peak memory, and one profiled step; the KAN gradients against the stacked router's on
    the same batch (``ENGINE_GRAD_RTOL``); then one bf16 step with
    ``collect_health`` and ``HEALTH_BANDS`` bands that ends with finite
    stats. Returns the launches, times and peak memory."""
    import numpy as np
    import torch

    from ddr_tpu_torch import training
    from ddr_tpu_torch.routing.mc import Bounds
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts_utils import resolve_learning_rate

    p = cfg.params
    C = net.n_chunks
    batch = deep_batch_of(net, entry, basin, dev)
    train_args = (Bounds.from_config(p.attribute_minimums), p.parameter_ranges,
                  p.log_space_parameters, p.defaults, p.tau, cfg.experiment.warmup)
    grads = {}
    for label, network in (("chunked", net), ("stacked", entry.network)):
        kan = new_kan(cfg, dev)
        loss, _ = training.make_batch_loss(kan, *train_args, device=dev)(network, *batch[1:])
        loss.backward()
        torch.cuda.synchronize()
        grads[label] = {k: v.grad.detach().clone() for k, v in kan.named_parameters()}
        print(f"continental train loss through the {label} router: {float(loss.detach()):.6f}")
        del kan, loss
        gc.collect()
        torch.cuda.empty_cache()
    worst = 0.0
    for k in grads["chunked"]:
        g_c, g_s = grads["chunked"][k], grads["stacked"][k]
        worst = max(worst, gauge_rel(g_c, g_s))
        compare(g_s, g_c, f"KAN gradient {k}, chunked vs stacked router", rtol=ENGINE_GRAD_RTOL)
    print(f"chunked vs stacked KAN gradients: max |a - b| / (|b| + 1e-6) {worst:.3e}")
    del grads

    kan = new_kan(cfg, dev).train()
    schedule = cfg.experiment.learning_rate
    opt = training.make_optimizer(kan.parameters(), resolve_learning_rate(schedule, 1))
    step = training.make_batch_train_step(kan, *train_args, opt, device=dev)
    torch.cuda.reset_peak_memory_stats()
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    out = {"step_ms": []}
    losses = []
    for i in range(1, TRAIN_STEPS + 1):
        training.set_learning_rate(opt, resolve_learning_rate(schedule, i))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, daily = step(*batch)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        out["step_ms"].append(start.elapsed_time(end))
        print(f"chunked train step {i}: loss {losses[-1]:.6f}, device {out['step_ms'][-1]:.3f} ms (CUDA "
              f"events), host {host_ms:.3f} ms on {smi}")
    out["launches"] = {"wave_scan": wave_scan_tm.launches, "reverse_scan": reverse_scan_tm.launches}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"chunked train: {TRAIN_STEPS} steps, launches {out['launches']} ({C} bands), peak device memory "
          f"{out['peak_gb']:.3f} GB on {smi}")
    expect = TRAIN_STEPS * C
    if not all(np.isfinite(losses)) or out["launches"] != {"wave_scan": expect, "reverse_scan": expect}:
        fail(f"chunked train: losses {losses}, launches {out['launches']}, expected {C} of each a step")
    profile_band_step(step, batch, "chunked")
    del step

    step16 = training.make_batch_train_step(kan, *train_args, opt, device=dev, dtype="bf16",
                                            collect_health=True, health_bands=HEALTH_BANDS)
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss, _, health = step16(*batch)
    end.record()
    torch.cuda.synchronize()
    out["bf16_launches"] = wave_scan_tm.launches
    out["bf16_ms"] = start.elapsed_time(end)
    stats = {k: getattr(health, k) for k in ("nonfinite", "q_min", "q_max", "mass_residual", "overflow",
                                              "ulp_drift", "grad_norm")}
    finite = all(bool(torch.isfinite(torch.as_tensor(v, dtype=torch.float64)).all()) for v in stats.values())
    print(f"chunked bf16 train step with health: loss {float(loss):.6f}, device {out['bf16_ms']:.3f} ms, "
          f"launches {wave_scan_tm.launches}/{reverse_scan_tm.launches}, "
          f"{ {k: float(v) for k, v in stats.items()} }, worst band {worst_of(health)} on {smi}")
    if not finite or int(health.nonfinite) != 0 or out["bf16_launches"] != C or reverse_scan_tm.launches != C:
        fail(f"chunked bf16 step: stats {stats}, launches {wave_scan_tm.launches}/{reverse_scan_tm.launches}")
    del step16, opt, kan
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_ext_bf16(cfg, entry, net, kan, smi, dev) -> dict:
    """Phase 15, end: the bf16 variant at its main path's shape (a train
    step: B 1, T 240) on the largest continental band, beside the fp32
    variant in turns, with its bound, its plain version and its parity there
    (equal on every element); every band one at a time."""
    import numpy as np
    import torch

    from ddr_tpu_torch.routing.mc import Bounds
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference

    p = cfg.params
    B, T = 1, TRAIN_DAYS * 24
    sizes = [c.n for c in net.chunks]
    big = int(np.argmax(sizes))
    out = {}
    with torch.no_grad():
        params = denormalize_spatial_parameters(kan(entry.attrs), p.parameter_ranges, p.log_space_parameters,
                                                p.defaults, net.n)
        bounds = Bounds.from_config(p.attribute_minimums)
        all16 = all32 = bound_all = 0.0
        for c in [big] + [c for c in range(net.n_chunks) if c != big]:
            band = net.chunks[c]
            phys = chunk_physics(net, c, entry.channels, params, bounds)
            q, xe, se, _ = band_scan_case(band, B, T, 80 + c, False, dev)

            def one(dtype):
                return wave_scan_tm(q, band, phys, None, x_ext=xe, s_ext=se, compute_dtype=dtype)

            for dtype in ("fp32", "bf16"):
                one(dtype)
            reps = 5 if c == big else 2
            turns = [cuda_ms(lambda d=d: one(d), reps) for d in ("fp32", "bf16", "bf16", "fp32")]
            ms16, ms32 = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            all16, all32 = all16 + ms16, all32 + ms32
            bound_all += max(ext_bounds(band, B, T))
            if c == big:
                ref = wave_scan_tm_reference(q, band, phys, None, x_ext=xe, s_ext=se, compute_dtype="bf16")
                out["err"] = compare_bf16(ref, one("bf16"), f"wave_scan/ext-bf16 continental band {c} "
                                                            f"(B {B}, T {T})", exact=True)
                del ref
                out["plain_ms"] = cuda_ms(lambda: wave_scan_tm_reference(q, band, phys, None, x_ext=xe,
                                                                         s_ext=se, compute_dtype="bf16"), 1)
                out.update(ms=ms16, fp32_ms=ms32, bound=ext_bounds(band, B, T), turns=turns)
            del q, xe, se
            torch.cuda.empty_cache()
    out.update(all_ms=all16, all_fp32_ms=all32, all_bound_ms=bound_all)
    bytes_ms, flops_ms = out["bound"]
    print(f"timing wave_scan/ext-bf16 (B {B}, T {T}), largest band ({sizes[big]} reaches) in turns "
          f"fp32/bf16/bf16/fp32: {' / '.join(f'{t:.3f}' for t in out['turns'])} ms; bf16 {out['ms']:.3f} ms "
          f"= {100 * (out['ms'] / out['fp32_ms'] - 1):+.1f}% of fp32; plain {out['plain_ms']:.3f} ms; bound "
          f"{max(bytes_ms, flops_ms):.4f} ms (bytes {bytes_ms:.4f}, operations {flops_ms:.4f}); all "
          f"{net.n_chunks} bands one at a time bf16 {all16:.3f} ms, fp32 {all32:.3f} ms, bound "
          f"{bound_all:.4f} ms on {smi}")
    return out


def time_reverse_ext(net, smi, dev) -> dict:
    """Phase 15, end: ``reverse_scan`` at its main path's shape on the
    chunked router (a train step's backward: B 1, T 240) on the largest
    continental band, held against its plain version on the same streams,
    timed beside it with its bound; then every band one at a time."""
    import numpy as np
    import torch

    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm, reverse_scan_tm_reference

    B, T = 1, TRAIN_DAYS * 24
    sizes = [c.n for c in net.chunks]
    big = int(np.argmax(sizes))
    out, per_band, bound_all = {}, [], 0.0
    with torch.no_grad():
        for c in [big] + [c for c in range(net.n_chunks) if c != big]:
            band = net.chunks[c]
            rev = reverse_inputs(band, B, T, 100 + c, dev)
            lam = reverse_scan_tm(*rev, band)
            torch.cuda.synchronize()
            if c == big:
                out["err"] = compare(reverse_scan_tm_reference(*rev, band), lam,
                                     f"reverse_scan/ext continental band {c} ({band.n} reaches, B {B}, T {T}, "
                                     f"t_width {band.wf_t_width})")
                out["plain_ms"] = cuda_ms(lambda: reverse_scan_tm_reference(*rev, band), 1)
                out["bound"] = reverse_ext_bounds(band, B, T)
                out["barrier_ms"] = time_barrier(f"reverse_scan/ext largest band (B {B}, T {T})", band, B, T,
                                                 smi, dev, reverse=True)["ms"]
            del lam
            per_band.append(cuda_ms(lambda: reverse_scan_tm(*rev, band), 5 if c == big else 2))
            bound_all += max(reverse_ext_bounds(band, B, T))
            del rev
            torch.cuda.empty_cache()
    out.update(ms=per_band[0], all_ms=sum(per_band), all_bound_ms=bound_all)
    bytes_ms, flops_ms = out["bound"]
    print(f"timing reverse_scan/ext (B {B}, T {T}): largest band ({sizes[big]} reaches, W "
          f"{T + net.chunks[big].depth}) {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, bound "
          f"{max(bytes_ms, flops_ms):.4f} ms (bytes {bytes_ms:.4f}, operations {flops_ms:.4f}); all "
          f"{net.n_chunks} bands one at a time {out['all_ms']:.3f} ms against {bound_all:.4f} ms bound on {smi}")
    return out


def numerics_basin(n, depth, T, dtype, dev, seed=0):
    """The error budget's basin (``ddr_tpu_torch.benchmarks.numerics``):
    topology, channels, parameters and inflow in ``dtype`` on ``dev``."""
    import numpy as np
    import torch

    from ddr_tpu_torch.geodatazoo.synthetic import make_deep_network
    from ddr_tpu_torch.routing.mc import ChannelState

    rows, cols = make_deep_network(n, depth, seed=seed)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    channels = ChannelState(length=t(rng.uniform(1000, 5000, n)), slope=t(rng.uniform(1e-3, 1e-2, n)),
                            x_storage=torch.full((n,), 0.3, dtype=dtype, device=dev))
    params = {k: torch.full((n,), v, dtype=dtype, device=dev)
              for k, v in (("n", 0.05), ("q_spatial", 0.5), ("p_spatial", 21.0))}
    q = t(np.random.default_rng(seed + 1).uniform(0.01, 1.0, (T, n)))
    return rows, cols, channels, params, q


def engine_numerics(smi, dev) -> dict:
    """Phase 16: every float32 engine against the float64 step oracle on
    the card (``measure_engine_errors``, ``chunk_bands=4``), 1 - NSE held to
    ``NUMERICS_MAX_ONE_MINUS_NSE``; then the oracle's cost: one float64 step
    route beside one single-ring kernel route on the same input."""
    import torch

    from ddr_tpu_torch.benchmarks.numerics import measure_engine_errors
    from ddr_tpu_torch.routing.mc import route
    from ddr_tpu_torch.routing.network import build_network

    out = {"errors": {}}
    for n, depth, T in NUMERICS_SHAPES:
        t0 = time.perf_counter()
        errors = measure_engine_errors(n, depth, T, chunk_bands=4, device=dev)
        out["errors"][(n, depth, T)] = errors
        print(f"engine numerics (n {n}, depth {depth}, T {T}; {time.perf_counter() - t0:.1f}s):")
        for engine, (rel, one_nse) in errors.items():
            print(f"  {engine:<18} rel_max {rel:.3e}  1-NSE {one_nse:.3e}")
            if not one_nse <= NUMERICS_MAX_ONE_MINUS_NSE:
                fail(f"engine numerics {engine} at (n {n}, depth {depth}, T {T}): 1-NSE {one_nse}")
    # measure_engine_errors has just routed both at this shape: no warm-up
    n, depth, T = NUMERICS_SHAPES[0]
    with torch.no_grad():
        for label, dtype, kw in (("step engine, float64", torch.float64, {"engine": "step"}),
                                 ("single ring on the kernel, float32", torch.float32, {})):
            rows, cols, channels, params, q = numerics_basin(n, depth, T, dtype, dev)
            net = build_network(rows, cols, n, fused=False if kw else None, device=dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            res = route(net, channels, params, q, device=dev, **kw)
            end.record()
            torch.cuda.synchronize()
            out[label] = start.elapsed_time(end)
            print(f"timing route (n {n}, depth {depth}, T {T}), {label}: {out[label]:.3f} ms (CUDA events), "
                  f"host {(time.perf_counter() - t0) * 1e3:.3f} ms, runoff {res.runoff.dtype} on {smi}")
    return out


def ad_against_analytic(dev) -> None:
    """Phase 17: gradients of a weighted loss w.r.t. ``n``, ``q_spatial``
    and ``q'`` on a small single ring, once by autograd through the plain
    scan (``adjoint="ad", kernel="reference"``) and once by the analytic
    adjoint on the kernels, within ``RTOL`` (the JAX package's
    ``tests/routing/test_adjoint.py``); ``adjoint="ad"`` with the kernels
    must raise."""
    import numpy as np
    import torch

    from ddr_tpu_torch.geodatazoo.synthetic import make_basin
    from ddr_tpu_torch.routing.mc import route
    from ddr_tpu_torch.routing.model import prepare_batch

    basin = make_basin(n_segments=AD_SEGMENTS, n_gauges=4, n_days=2, seed=3, depth=AD_DEPTH)
    net, ch, gauges = prepare_batch(basin.routing_data, 0.001, device=dev)
    w = torch.as_tensor(np.random.default_rng(5).normal(size=(AD_T, AD_SEGMENTS)).astype(np.float32), device=dev)
    try:
        route(net, ch, {k: torch.as_tensor(v, device=dev) for k, v in basin.true_params.items()},
              torch.as_tensor(basin.q_prime[:AD_T], device=dev), adjoint="ad", device=dev)
        fail("adjoint='ad' on the kernels did not raise")
    except ValueError as e:
        print(f"adjoint='ad' with kernel=None on the card raises: {e}")
    grads = {}
    for adjoint, kernel in (("analytic", None), ("ad", "reference")):
        params = {k: torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=True)
                  for k, v in basin.true_params.items()}
        q = torch.tensor(basin.q_prime[:AD_T], device=dev, requires_grad=True)
        res = route(net, ch, params, q, adjoint=adjoint, kernel=kernel, device=dev)
        ((res.runoff * w).sum() + res.final_discharge.sum()).backward()
        torch.cuda.synchronize()
        grads[adjoint] = {"n": params["n"].grad, "q_spatial": params["q_spatial"].grad, "q_prime": q.grad}
    for k in grads["ad"]:
        compare(grads["ad"][k], grads["analytic"][k],
                f"gradient d/d{k}, analytic adjoint on the kernels vs ad through the plain scan "
                f"(n {net.n}, depth {net.depth}, T {AD_T})")


def time_fp32_only() -> int:
    """``python3 chip_smoke.py --time-fp32``: only the fp32 forward kernel's
    times (CUDA events, 10 launches) at the serving shape (B 8, T 72), on
    the regional single ring and on band 0 of the 3-band 65,536-reach,
    depth-2048 frame, as one JSON line. It uses only the time-major scan's
    entry point, so that two checkouts that have it can be compared on one
    card: copy this script into each and run them in turns (parent, change,
    change, parent)."""
    import torch

    from ddr_tpu_torch.geodatazoo.synthetic import make_basin
    from ddr_tpu_torch.routing import _build
    from ddr_tpu_torch.routing.mc import DT_SECONDS, Bounds, reach_physics
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, prepare_batch
    from ddr_tpu_torch.routing.stacked import band_physics, frame_operands
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.validation.configs import Config, KanConfig

    dev = torch.device("cuda")
    _build.build(_build.KERNELS)
    cfg = Config(kan=KanConfig(input_var_names=[f"a{i}" for i in range(10)]))
    p = cfg.params
    bounds = Bounds.from_config(p.attribute_minimums)
    kan = new_kan(cfg, dev)
    out = {}
    for label, depth in (("wave_scan", DEPTH), ("wave_scan/band", GRAD_DEPTH)):
        rd = make_basin(n_segments=N_SEGMENTS, n_gauges=N_GAUGES, n_days=8, depth=depth, seed=0).routing_data
        net, ch, _ = prepare_batch(rd, p.attribute_minimums["slope"], device=dev)
        with torch.no_grad():
            params = denormalize_spatial_parameters(
                kan(torch.as_tensor(rd.normalized_spatial_attributes, device=dev)), p.parameter_ranges,
                p.log_space_parameters, p.defaults, net.n)
            if label == "wave_scan":
                phys = reach_physics(net, ch, params, bounds)
                q, _ = scan_case(net, phys, MAX_BATCH, HORIZON, 13, False, dev)

                def run():
                    return wave_scan_tm(q, net, phys, None)
            else:
                band = net.band(0)
                phys = band_physics(frame_operands(ch, params, net.n, dev), net.gidx[0].long(), bounds,
                                    DT_SECONDS)
                q, xe, se, _ = band_scan_case(band, MAX_BATCH, HORIZON, 29, False, dev)

                def run():
                    return wave_scan_tm(q, band, phys, None, x_ext=xe, s_ext=se, mask_raw=True)

            for _ in range(2):
                run()
            out[label] = cuda_ms(run, 10)
    print(nvidia_smi())
    print(json.dumps(out))
    return 0


class TrainLog(logging.Handler):
    """What the port's train loop logs: each step's (epoch, mini-batch, loss,
    host ms, engine), where it resumed, and the mini-batches it skipped."""

    STEP = re.compile(r"epoch (\d+) mini-batch (\d+): loss=(\S+) \(.* reach-timesteps/s, (\S+) ms, (\S+)\)")

    def __init__(self):
        super().__init__()
        self.steps, self.resumed, self.skipped = [], [], []

    def emit(self, record):
        msg = record.getMessage()
        if m := self.STEP.match(msg):
            self.steps.append((int(m[1]), int(m[2]), float(m[3]), float(m[4]), m[5]))
        elif m := re.match(r"Resuming from (\S+) at epoch (\d+)", msg):
            self.resumed.append((Path(m[1]).name, int(m[2])))
        elif m := re.match(r"Skipping mini-batch (\d+)", msg):
            self.skipped.append(int(m[1]))


def ddr_train(smi, dev) -> dict:
    """Phase 18: ``ddr train`` through the port's CLI (see the module
    docstring). Returns the regional run's launch counts."""
    from ddr_tpu_torch import cli
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts import train as train_script
    from ddr_tpu_torch.training import latest_checkpoint

    root = Path(__file__).resolve().parent / "build" / "ddr_train"
    shutil.rmtree(root, ignore_errors=True)
    logger = logging.getLogger(train_script.__name__)
    logger.setLevel(logging.INFO)

    def run(name, *overrides):
        log = TrainLog()
        logger.addHandler(log)
        t0 = time.perf_counter()
        try:
            code = cli.main(["train", DDR_TRAIN_CONFIG, *overrides, f"params.save_path={root / name}"])
            torch.cuda.synchronize()
        finally:
            logger.removeHandler(log)
        wall = time.perf_counter() - t0
        losses = [loss for *_, loss, _, _ in log.steps]
        if code != 0 or not np.all(np.isfinite(losses)):
            fail(f"ddr train {name}: exit {code}, losses {losses}")
        ms = ", ".join(f"{step_ms:.1f}" for *_, step_ms, _ in log.steps)
        engines = sorted({engine for *_, engine in log.steps})
        print(f"ddr train {name}: {len(log.steps)} steps {[(e, b) for e, b, *_ in log.steps]}, "
              f"losses {losses}, step host ms [{ms}], engine {engines}, run wall {wall:.2f} s on {smi}")
        return log, wall

    import numpy as np
    import torch

    cpu, _ = run("parity-cpu", *DDR_TRAIN_PARITY, "device=cpu")
    card, _ = run("parity-card", *DDR_TRAIN_PARITY)
    if [s[:2] for s in cpu.steps] != [s[:2] for s in card.steps] or len(card.steps) != DDR_TRAIN_STEPS:
        fail(f"ddr train parity: the CPU ran {[s[:2] for s in cpu.steps]}, the card {[s[:2] for s in card.steps]}")
    for (epoch, mb, ref, *_), (*_, got, _, _) in zip(cpu.steps, card.steps):
        rel = abs(got - ref) / abs(ref)
        print(f"ddr train parity epoch {epoch} mini-batch {mb}: card {got!r} cpu {ref!r} rel {rel:.3e}")
        if rel > DDR_TRAIN_RTOL:
            fail(f"ddr train parity: epoch {epoch} mini-batch {mb} loss rel {rel:.3e} > {DDR_TRAIN_RTOL}")

    full_size = (f"synthetic_segments={N_SEGMENTS}", f"synthetic_depth={DEPTH}")
    torch.cuda.reset_peak_memory_stats()
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    full, wall = run("regional", *full_size)
    launches = {"wave_scan": wave_scan_tm.launches, "reverse_scan": reverse_scan_tm.launches}
    steps = len(full.steps)
    print(f"ddr train regional: launches {launches} over {steps} steps (+1 wave_scan: the twin's "
          f"observation route), peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if steps != DDR_TRAIN_STEPS or launches != {"wave_scan": steps + 1, "reverse_scan": steps}:
        fail(f"ddr train regional: {steps} steps, launches {launches}")
    saved = root / "regional" / "saved_models"
    newest = latest_checkpoint(saved)
    if newest is None or not newest.name.endswith("_epoch_2_mb_1.pkl") or len(list(saved.glob("*.pkl"))) != steps:
        fail(f"ddr train regional: checkpoints {sorted(p.name for p in saved.glob('*.pkl'))}")
    resumed, _ = run("regional", *full_size, "experiment.epochs=3", f"experiment.checkpoint={saved}")
    if (resumed.resumed != [(newest.name, 2)] or resumed.skipped != [0, 1]
            or [s[:2] for s in resumed.steps] != [(3, 0), (3, 1)]):
        fail(f"ddr train resume: resumed {resumed.resumed}, skipped {resumed.skipped}, "
             f"steps {[s[:2] for s in resumed.steps]}")
    print(f"ddr train resume: from {newest.name} at epoch 2, skipped mini-batches {resumed.skipped}, "
          f"then epoch 3 {[s[:2] for s in resumed.steps]}")
    return launches


class EvalLog(logging.Handler):
    """What the port's evaluation commands log: each chunk's (index, host ms,
    hours) and the LTI route's (ms, peak GB, GB above its inputs)."""

    CHUNK = re.compile(r"(?:evaluate|route) batch (\d+): \S+ reach-timesteps/s \((\S+) ms, (\d+) h\)")
    LTI = re.compile(r"LTI route: (\S+) ms for T=\d+ h x \d+ reaches, peak device memory (\S+) GB "
                     r"\((\S+) GB above its inputs\)")

    def __init__(self):
        super().__init__()
        self.chunks, self.lti = [], []

    def emit(self, record):
        msg = record.getMessage()
        if m := self.CHUNK.match(msg):
            self.chunks.append((int(m[1]), float(m[2]), int(m[3])))
        elif m := self.LTI.match(msg):
            self.lti.append((float(m[1]), float(m[2]), float(m[3])))


def ddr_eval(smi, dev) -> dict:
    """Phase 19: ``ddr test``, ``ddr route``, ``ddr train-and-test`` and
    ``ddr benchmark`` through the port's CLI (see the module docstring), from
    phase 18's checkpoints. Returns the launch counts of the full-width runs."""
    import numpy as np
    import torch

    from ddr_tpu_torch import cli
    from ddr_tpu_torch.io import zarrlite
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.training import latest_checkpoint

    here = Path(__file__).resolve().parent / "build"
    root = here / "ddr_eval"
    shutil.rmtree(root, ignore_errors=True)
    regional = latest_checkpoint(here / "ddr_train" / "regional" / "saved_models")
    small = latest_checkpoint(here / "ddr_train" / "parity-card" / "saved_models")
    if regional is None or small is None:
        fail("ddr eval: phase 18 left no checkpoints")
    loggers = [logging.getLogger(name) for name in (
        "ddr_tpu_torch.scripts.common", "ddr_tpu_torch.scripts.router", "ddr_tpu_torch.benchmarks.benchmark")]
    for logger in loggers:
        logger.setLevel(logging.INFO)

    def run(command, name, *overrides):
        log = EvalLog()
        for logger in loggers:
            logger.addHandler(log)
        t0 = time.perf_counter()
        try:
            code = cli.main([command, DDR_TRAIN_CONFIG, *overrides, f"params.save_path={root / name}"])
            torch.cuda.synchronize()
        finally:
            for logger in loggers:
                logger.removeHandler(log)
        wall = time.perf_counter() - t0
        if code != 0:
            fail(f"ddr {command} {name}: exit {code}")
        ms = [c[1] for c in log.chunks]
        if ms:
            print(f"ddr {command} {name}: {len(ms)} chunks of {sorted({c[2] for c in log.chunks})} h, chunk "
                  f"host ms median {np.median(ms):.2f} min {min(ms):.2f} max {max(ms):.2f} (first "
                  f"{ms[0]:.2f}), sum {sum(ms) / 1e3:.2f} s, run wall {wall:.2f} s on {smi}")
        return log, wall

    def store(name, zarr, arrays):
        group = zarrlite.open_group(root / name / zarr)
        out = {}
        for a in arrays:
            out[a] = group[a][:]
            if not np.isfinite(out[a]).all() or out[a].size == 0:
                fail(f"ddr eval {name}/{zarr}: {a} {out[a].shape} is empty or not finite")
        return out

    full_size = (f"synthetic_segments={N_SEGMENTS}", f"synthetic_depth={DEPTH}")
    counts = {}
    for command, name, zarr, arrays in (
            ("test", "test", "model_test.zarr", ("predictions", "observations")),
            ("route", "route", "chrout.zarr", ("discharge",))):
        wave_scan_tm.launches = wave_scan_tm.q_init_launches = reverse_scan_tm.launches = 0
        log, _ = run(command, name, *full_size, f"experiment.checkpoint={regional}")
        chunks = len(log.chunks)
        launches = {"wave_scan": wave_scan_tm.launches, "q_init": wave_scan_tm.q_init_launches,
                    "reverse_scan": reverse_scan_tm.launches}
        print(f"ddr {command} regional: launches {launches} over {chunks} chunks (+1 wave_scan: the "
              f"twin's observation route), from {regional.name}")
        # one launch a chunk, each after the first from the carried discharge
        if chunks < 2 or launches != {"wave_scan": chunks + 1, "q_init": chunks - 1, "reverse_scan": 0}:
            fail(f"ddr {command} regional: {chunks} chunks, launches {launches}")
        counts[command] = launches
        out = store(name, zarr, arrays)
        print(f"ddr {command} regional: {zarr} {[(a, v.shape) for a, v in out.items()]}, finite")

    # the same evaluation on the CPU's plain scans and on the card's kernels
    preds = {}
    for device in ("cpu", "cuda"):
        run("test", f"parity-{device}", *DDR_TRAIN_PARITY, *DDR_TEST_PARITY_WINDOW, f"device={device}",
            f"experiment.checkpoint={small}")
        preds[device] = torch.as_tensor(store(f"parity-{device}", "model_test.zarr", ("predictions",))["predictions"])
    compare(preds["cpu"], preds["cuda"], "ddr test 4,096 reaches, card against CPU")

    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    _, wall = run("train-and-test", "train-and-test", *DDR_TRAIN_PARITY, "experiment.epochs=1",
                  "experiment.test_start_time=1981/10/01", "experiment.test_end_time=1981/10/25")
    out = store("train-and-test", "model_test.zarr", ("predictions", "observations"))
    print(f"ddr train-and-test 4,096 reaches: 1 epoch then a 25-day test, launches wave_scan "
          f"{wave_scan_tm.launches} reverse_scan {reverse_scan_tm.launches}, predictions "
          f"{out['predictions'].shape}, run wall {wall:.2f} s on {smi}")
    if reverse_scan_tm.launches != 2:
        fail(f"ddr train-and-test: {reverse_scan_tm.launches} reverse_scan launches, want 2 (one a step)")

    wave_scan_tm.launches = wave_scan_tm.q_init_launches = 0
    # the example config says mode: training, under which the loop evaluates random windows
    log, _ = run("benchmark", "benchmark", *full_size, "mode=testing", f"experiment.checkpoint={regional}")
    chunks = len(log.chunks)
    if (wave_scan_tm.launches, wave_scan_tm.q_init_launches) != (chunks + 1, chunks - 1) or not log.lti:
        fail(f"ddr benchmark: {chunks} chunks, launches {wave_scan_tm.launches}/{wave_scan_tm.q_init_launches}, "
             f"LTI {log.lti}")
    counts["benchmark"] = {"wave_scan": wave_scan_tm.launches, "q_init": wave_scan_tm.q_init_launches}
    lti_ms, peak_gb, above_gb = log.lti[0]
    out = store("benchmark", "benchmark_results.zarr", ("mc_predictions", "lti_predictions", "observations"))
    print(f"ddr benchmark regional: launches {counts['benchmark']} over {chunks} chunks, LTI route "
          f"{lti_ms:.1f} ms, peak device memory {peak_gb:.3f} GB ({above_gb:.3f} GB above its inputs), "
          f"{[(a, v.shape) for a, v in out.items()]} finite, on {smi}")
    return {k: sum(c[k] for c in counts.values()) for k in ("wave_scan", "q_init")}


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
    if sys.argv[1:] == ["--time-fp32"]:
        return time_fp32_only()
    only_ddr_train = sys.argv[1:] == ["--ddr-train"]
    only_ddr_cli = sys.argv[1:] == ["--ddr-cli"]
    old_log = None
    if len(sys.argv) == 3 and sys.argv[1] == "--old-kernels":
        old_log = sys.argv[2]
    elif sys.argv[1:] and not (only_ddr_train or only_ddr_cli):
        print("usage: chip_smoke.py [--time-fp32 | --ddr-train | --ddr-cli | --old-kernels LOG]",
              file=sys.stderr)
        return 2
    import numpy as np

    from ddr_tpu_torch import training
    from ddr_tpu_torch.geodatazoo.synthetic import make_basin, observe
    from ddr_tpu_torch.routing import _build
    from ddr_tpu_torch.routing.mc import Bounds, reach_physics, route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, prepare_batch
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm, reverse_scan_tm_reference
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference
    from ddr_tpu_torch.scripts_utils import resolve_learning_rate
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
    if only_ddr_train or only_ddr_cli:
        t0 = time.perf_counter()
        ddr_train(smi, dev)
        print(f"ddr train phase: {time.perf_counter() - t0:.1f}s")
        if only_ddr_cli:
            t0 = time.perf_counter()
            ddr_eval(smi, dev)
            print(f"ddr test, route, train-and-test and benchmark phase: {time.perf_counter() - t0:.1f}s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0

    # ---- 2. kernel parity: small shape, then the serving shape ----
    t_regional = time.perf_counter()
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
            q, qi = scan_case(net_s, phys_s, B, T, 7, with_init, dev)
            raw = wave_scan_tm(q, net_s, phys_s, qi)
            torch.cuda.synchronize()
            compare(wave_scan_tm_reference(q, net_s, phys_s, qi), raw, label)
        # reverse scan: the small tree (t_width 1), T = 1, and a DAG with fan-out
        net_f = fan_out_network(4096, 2, dev)
        reverse_err = 0.0
        for label, net_r, B, T in (("small/tree", net_s, 3, 24), ("small/T=1", net_s, 2, 1),
                                   (f"small/fan-out t_width {net_f.wf_t_width}", net_f, 2, 24)):
            rev = reverse_inputs(net_r, B, T, 5, dev)
            lam = reverse_scan_tm(*rev, net_r)
            torch.cuda.synchronize()
            err = compare(reverse_scan_tm_reference(*rev, net_r), lam, f"reverse_scan {label}")
            reverse_err = max(reverse_err, err)
        if net_f.wf_t_width < 2:
            fail(f"the fan-out network has t_width {net_f.wf_t_width}; the slot loop was not exercised")

    basin = make_basin(n_segments=N_SEGMENTS, n_gauges=N_GAUGES, n_days=8, depth=DEPTH, seed=0)
    kan = new_kan(cfg, dev)
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
            # the serving shape, and the 2-day chunk of the evaluation commands (phase 19)
            for label, B, T, with_init in (("serve-shape/hotstart", MAX_BATCH, HORIZON, False),
                                           ("serve-shape/q_init", MAX_BATCH, HORIZON, True),
                                           ("eval-chunk/q_init", 1, 48, True)):
                q, qi = scan_case(net, phys, B, T, 11, with_init, dev)
                raw = wave_scan_tm(q, net, phys, qi)
                torch.cuda.synchronize()
                err = compare(wave_scan_tm_reference(q, net, phys, qi), raw, label)
                max_abs = max(max_abs, err)
            del raw, q
            # the training phase routes this topology (same seed) over T = 240 h
            T_rev = TRAIN_DAYS * 24
            rev = reverse_inputs(net, 1, T_rev, 17, dev)
            lam = reverse_scan_tm(*rev, net)
            torch.cuda.synchronize()
            err = compare(reverse_scan_tm_reference(*rev, net), lam,
                          f"reverse_scan train-shape (T {T_rev}, n {net.n}, t_width {net.wf_t_width})")
            reverse_err = max(reverse_err, err)
            del rev, lam

        # ---- 3. serve ----
        t0 = time.perf_counter()
        svc.warmup()
        print(f"warmup: {time.perf_counter() - t0:.2f}s")
        starts = np.arange(MAX_BATCH * N_BATCHES) % (basin.q_prime.shape[0] - HORIZON + 1)
        wave_scan_tm.launches = 0
        futures = [svc.submit("conus-synthetic", t0=int(s)) for s in starts]
        answers = [f.result(timeout=600) for f in futures]
        launches = wave_scan_tm.launches
        batches = executed_batches(answers)
        print(f"serve: {len(answers)} requests in {batches} batches, "
              f"wave_scan_tm.launches {launches}")
        if launches < 1 or batches < 3 or launches != batches:
            fail(f"expected one wave_scan launch per batch (>= 3): {launches} launches, "
                 f"{batches} batches")
        check_watchdog(svc, batches, "serve")
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
        profile_batch(svc, "conus-synthetic", starts[:MAX_BATCH])
    finally:
        svc.close()

    # ---- 4. train: the twin experiment on the same basin, T = 240 h ----
    train_basin = observe(
        make_basin(n_segments=N_SEGMENTS, n_gauges=N_GAUGES, n_days=TRAIN_DAYS, depth=DEPTH, seed=0),
        cfg, device=dev,
    )
    rd = train_basin.routing_data
    net_t, ch_t, gauges_t = prepare_batch(rd, p.attribute_minimums["slope"], device=dev)
    T_train = train_basin.q_prime.shape[0]
    obs = train_basin.obs_daily  # (D-1, G): days 1..D-1 of the 10-day window
    batch = (net_t, ch_t, gauges_t,
             torch.as_tensor(rd.normalized_spatial_attributes, device=dev),
             torch.as_tensor(train_basin.q_prime, device=dev),
             torch.as_tensor(np.nan_to_num(obs), device=dev),
             torch.as_tensor(np.isfinite(obs), device=dev))
    print(f"train batch: T {T_train} h, n {net_t.n}, gauges {gauges_t.n_gauges}, daily obs "
          f"{obs.shape}, t_width {net_t.wf_t_width}, warmup {cfg.experiment.warmup} days")
    kan_t = new_kan(cfg, dev)
    train_args = (bounds, p.parameter_ranges, p.log_space_parameters, p.defaults, p.tau,
                  cfg.experiment.warmup)
    # one step's KAN gradients through the kernels against the plain scans
    grads = {}
    for kernel in (None, "reference"):
        kan_t.zero_grad(set_to_none=True)
        loss_fn = training.make_batch_loss(kan_t, *train_args, kernel=kernel, device=dev)
        loss, _ = loss_fn(*batch)
        loss.backward()
        torch.cuda.synchronize()
        grads[kernel] = {k: v.grad.detach().clone() for k, v in kan_t.named_parameters()}
        print(f"train loss through {kernel or 'the kernels'}: {float(loss.detach()):.6f}")
    for k in grads[None]:
        compare(grads["reference"][k], grads[None][k], f"KAN gradient {k}, kernels vs plain scans",
                rtol=GRAD_RTOL)
    kan_t.zero_grad(set_to_none=True)

    # each step plays one epoch of the learning-rate schedule: 0.005, then 0.001 from 3
    schedule = cfg.experiment.learning_rate
    opt = training.make_optimizer(kan_t.parameters(), resolve_learning_rate(schedule, 1))
    step = training.make_batch_train_step(kan_t, *train_args, opt, device=dev)
    torch.cuda.reset_peak_memory_stats()
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    losses = []
    for i in range(1, TRAIN_STEPS + 1):
        training.set_learning_rate(opt, resolve_learning_rate(schedule, i))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, daily = step(*batch)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        print(f"train step {i}: loss {losses[-1]:.6f} (lr {opt.param_groups[0]['lr']:g}), device "
              f"{start.elapsed_time(end):.3f} ms (CUDA events), host {host_ms:.3f} ms on {smi}")
    train_launches = {"wave_scan": wave_scan_tm.launches, "reverse_scan": reverse_scan_tm.launches}
    print(f"train: {TRAIN_STEPS} steps, launches {train_launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if not all(np.isfinite(losses)) or daily.shape != (obs.shape[0], N_GAUGES):
        fail(f"train: losses {losses}, daily {tuple(daily.shape)}")
    if train_launches != {"wave_scan": TRAIN_STEPS, "reverse_scan": TRAIN_STEPS}:
        fail(f"expected one wave_scan and one reverse_scan launch per step: {train_launches}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    print(f"profile of one train step: host {host_ms:.3f} ms")
    device_ms = device_profile(
        prof, ("ddr::kan", "ddr::forward_scan", "ddr::adjoint_prepasses", "ddr::reverse_scan",
               "ddr::adjoint_postpasses", "ddr::optimizer"),
        ("ddr::adjoint_physics", "ddr::adjoint_pullback"),
    )
    print(f"  device busy {device_ms:.3f} ms ({100 * device_ms / host_ms:.1f}% of the host time)")

    # ---- 5. timing: wave_scan at the serving shape ----
    B, T, n = MAX_BATCH, HORIZON, net.n
    W = T + net.depth
    with torch.no_grad():
        q, _ = scan_case(net, phys, B, T, 13, False, dev)
        for _ in range(2):
            wave_scan_tm(q, net, phys, None)
        kernel_ms = cuda_ms(lambda: wave_scan_tm(q, net, phys, None), 10)
        plain_ms = cuda_ms(lambda: wave_scan_tm_reference(q, net, phys, None), 2)
        # one request: the same W waves and barriers over an eighth of the bytes
        q1 = q[:1].contiguous()
        wave_scan_tm(q1, net, phys, None)
        kernel_b1_ms = cuda_ms(lambda: wave_scan_tm(q1, net, phys, None), 10)
    # bytes the scan must move: the inflow read once and the solve values
    # written once (B * T * n each), the tables and per-reach operands once
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
    del q, q1
    wave_barrier_ms = time_barrier(f"wave_scan (B {B}, T {T})", net, B, T, smi, dev)["ms"]
    barrier_sweep(W, smi, dev)

    # ---- 5. timing: reverse_scan at the training shape ----
    T, n, tw = T_train, net_t.n, net_t.wf_t_width
    rev = reverse_inputs(net_t, 1, T, 17, dev)
    for _ in range(2):
        reverse_scan_tm(*rev, net_t)
    reverse_ms = cuda_ms(lambda: reverse_scan_tm(*rev, net_t), 10)
    reverse_plain_ms = cuda_ms(lambda: reverse_scan_tm_reference(*rev, net_t), 2)
    # bytes the scan must move: each reach's T rows of gbar, ow and its
    # t_width slots of zce and duce read once, its T lams written once, and the
    # transposed tables and levels
    rev_bytes = 4 * (T * n * (2 + 2 * tw) + T * n) + 4 * (2 * n * tw + n)
    rev_flops = T * n * (REVERSE_FLOPS_PER_PAIR + REVERSE_FLOPS_PER_SLOT * tw)
    rev_bytes_ms = rev_bytes / HBM_BYTES_PER_S * 1e3
    rev_flops_ms = rev_flops / FP32_FLOP_PER_S * 1e3
    reverse_bound_ms = max(rev_bytes_ms, rev_flops_ms)
    print(f"timing reverse_scan (B 1, W {T + net_t.depth}, n {n}, t_width {tw}): kernel "
          f"{reverse_ms:.3f} ms, plain {reverse_plain_ms:.3f} ms, bound {reverse_bound_ms:.4f} ms "
          f"({rev_bytes / 1e9:.3f} GB -> {rev_bytes_ms:.4f} ms, {rev_flops / 1e9:.3f} GFLOP -> "
          f"{rev_flops_ms:.4f} ms)")
    reverse_barrier_ms = time_barrier(f"reverse_scan (B 1, T {T})", net_t, 1, T, smi, dev, reverse=True)["ms"]

    del rev
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. bf16 parity on the small single ring and the small 3-band frame ----
    bf16_ring_err, bf16_band_err = bf16_parity(net_s, phys_s, dev)

    # ---- 11. bf16 on the regional basin, T = 240 h ----
    kan_b = new_kan(cfg, dev)
    bf16_against_fp32(cfg, kan_b, net_t, ch_t, gauges_t, batch[3], batch[4], f"regional (n {net_t.n})",
                      True, dev)
    regional16 = bf16_train(cfg, batch, 1, "regional", smi, dev)
    time_health(T_train, gauges_t.n_gauges, (T_train, net_t.n), net_t.level, net_t.depth,
                net_t.wf_inv.long(), False, "regional", smi, dev)
    recovery_reroute(cfg, batch, dev)
    ring16 = time_bf16_ring(cfg, kan_b, net_t, ch_t, batch[3], smi, dev)
    bf16_ring_err = max(bf16_ring_err, ring16["err"])
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    print(f"regional phases: {time.perf_counter() - t_regional:.1f}s")

    # ---- 6-9. the stacked band router ----
    t_stacked = time.perf_counter()
    band_wave_err, band_reverse_err = band_parity_small(dev)
    t0 = time.perf_counter()
    deep = make_basin(n_segments=DEEP_SEGMENTS, n_gauges=N_GAUGES, n_days=TRAIN_DAYS,
                      depth=DEEP_DEPTH, seed=0)
    print(f"continental basin: {DEEP_SEGMENTS} reaches, depth {DEEP_DEPTH}, forcing "
          f"{deep.q_prime.shape} ({time.perf_counter() - t0:.2f}s to generate)")
    served = serve_deep(cfg, deep, smi, dev)
    band_wave_err = max(band_wave_err, served["wave_err"])
    band_reverse_err = max(band_reverse_err, served["reverse_err"])
    deep_launches, deep_batch = train_deep(cfg, deep, served["entry"], served["kan"], smi, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 12. bf16 on the continental basin ----
    net_d = served["entry"].network
    bf16_against_fp32(cfg, served["kan"], net_d, served["entry"].channels, served["entry"].gauge_index,
                      deep_batch[3], deep_batch[4], f"continental (n {net_d.n}, {net_d.n_chunks} bands)",
                      False, dev)
    gc.collect()
    torch.cuda.empty_cache()
    deep16 = bf16_train(cfg, deep_batch, net_d.n_chunks, "continental", smi, dev)
    del deep_batch
    gc.collect()
    torch.cuda.empty_cache()
    time_health(TRAIN_DAYS * 24, N_GAUGES, (1, TRAIN_DAYS * 24, net_d.n_chunks * net_d.n_cap),
                net_d.orig_level, net_d.depth, net_d.out_map.long(), True, "continental", smi, dev)
    t0 = time.perf_counter()
    stacked_gradients(cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"stacked gradients: {time.perf_counter() - t0:.1f}s")
    band = time_bands(cfg, served["entry"], served["kan"], smi, dev)
    band16 = time_bf16_bands(cfg, served["entry"], served["kan"], smi, dev)
    bf16_band_err = max(bf16_band_err, band16["err"])
    gc.collect()
    torch.cuda.empty_cache()
    print(f"stacked phases: {time.perf_counter() - t_stacked:.1f}s")

    # ---- 13-15. the unrolled depth-chunked router ----
    t0 = time.perf_counter()
    ext_err, ext16_err, rev_ext_err = ext_parity_small(dev)
    chunked = serve_chunked(cfg, deep, served["entry"], served["kan"], smi, dev)
    ext_err = max(ext_err, chunked["err"])
    chunked_train = train_chunked(cfg, deep, served["entry"], chunked["net"], smi, dev)
    ext16 = time_ext_bf16(cfg, served["entry"], chunked["net"], served["kan"], smi, dev)
    ext16_err = max(ext16_err, ext16["err"])
    rev_ext = time_reverse_ext(chunked["net"], smi, dev)
    rev_ext_err = max(rev_ext_err, rev_ext["err"])
    del chunked["net"]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"chunked phases: {time.perf_counter() - t0:.1f}s")

    # ---- 16-17. engine numerics against the float64 step oracle; AD ----
    t0 = time.perf_counter()
    engine_numerics(smi, dev)
    ad_against_analytic(dev)
    print(f"numerics and AD phases: {time.perf_counter() - t0:.1f}s")

    # ---- 18. ddr train through the CLI ----
    t0 = time.perf_counter()
    ddr_train_launches = ddr_train(smi, dev)
    print(f"ddr train phase: {time.perf_counter() - t0:.1f}s")

    # ---- 19. ddr test, route, train-and-test and benchmark through the CLI ----
    t0 = time.perf_counter()
    ddr_eval_launches = ddr_eval(smi, dev)
    print(f"ddr test, route, train-and-test and benchmark phase: {time.perf_counter() - t0:.1f}s")

    def band_entry(name, source, replaces, launches, err, t):
        bytes_ms, flops_ms = t["bound"]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None, "ms_all_bands": t["all_ms"], "bound_ms_all_bands": t["all_bound_ms"],
            **({"barrier_floor_ms": t["barrier_ms"]} if "barrier_ms" in t else {}),
        }

    kernels = [{
        "name": "wave_scan",
        "route": "cuda",
        "source": "ddr_tpu_torch/csrc/wave_scan.cu",
        "replaces": "ddr_tpu/routing/pallas_kernel.py:193",
        "launches": (launches + train_launches["wave_scan"] + ddr_train_launches["wave_scan"]
                     + ddr_eval_launches["wave_scan"]),
        "ddr_train_launches": ddr_train_launches["wave_scan"],
        "ddr_eval_launches": ddr_eval_launches["wave_scan"],
        "ddr_eval_q_init_launches": ddr_eval_launches["q_init"],
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,
        "barrier_floor_ms": wave_barrier_ms,
    }, {
        "name": "reverse_scan",
        "route": "cuda",
        "source": "ddr_tpu_torch/csrc/reverse_scan.cu",
        "replaces": "ddr_tpu/routing/pallas_kernel.py:348",
        "launches": train_launches["reverse_scan"] + ddr_train_launches["reverse_scan"],
        "ddr_train_launches": ddr_train_launches["reverse_scan"],
        "max_abs_err": reverse_err,
        "ms": reverse_ms,
        "plain_ms": reverse_plain_ms,
        "bound_ms": reverse_bound_ms,
        "bound_by": "bytes" if rev_bytes_ms >= rev_flops_ms else "operations",
        "library_ms": None,
        "barrier_floor_ms": reverse_barrier_ms,
    },
        band_entry("wave_scan/band", "ddr_tpu_torch/csrc/wave_scan.cu",
                   "ddr_tpu/routing/pallas_kernel.py:193",
                   served["launches"] + deep_launches["wave_scan"], band_wave_err, band["wave"]),
        band_entry("reverse_scan/band", "ddr_tpu_torch/csrc/reverse_scan.cu",
                   "ddr_tpu/routing/pallas_kernel.py:348",
                   deep_launches["reverse_scan"], band_reverse_err, band["reverse"]),
        {
            "name": "wave_scan/bf16",
            "route": "cuda",
            "source": "ddr_tpu_torch/csrc/wave_scan.cu",
            "replaces": "ddr_tpu/routing/pallas_kernel.py:193",
            "launches": regional16["launches"],
            "max_abs_err": bf16_ring_err,
            "ms": ring16["ms"],
            "plain_ms": ring16["plain_ms"],
            "bound_ms": max(ring16["bound"]),
            "bound_by": "bytes" if ring16["bound"][0] >= ring16["bound"][1] else "operations",
            "library_ms": None,
            "fp32_ms_same_input": ring16["fp32_ms"],
        },
        {**band_entry("wave_scan/band-bf16", "ddr_tpu_torch/csrc/wave_scan.cu",
                      "ddr_tpu/routing/pallas_kernel.py:193", deep16["launches"], bf16_band_err, band16),
         "fp32_ms_same_input": band16["fp32_ms"], "fp32_ms_all_bands_same_input": band16["all_fp32_ms"]},
        band_entry("wave_scan/ext", "ddr_tpu_torch/csrc/wave_scan.cu",
                   "ddr_tpu/routing/pallas_kernel.py:193",
                   chunked["launches"] + chunked_train["launches"]["wave_scan"], ext_err, chunked),
        {**band_entry("wave_scan/ext-bf16", "ddr_tpu_torch/csrc/wave_scan.cu",
                      "ddr_tpu/routing/pallas_kernel.py:193", chunked_train["bf16_launches"], ext16_err, ext16),
         "fp32_ms_same_input": ext16["fp32_ms"], "fp32_ms_all_bands_same_input": ext16["all_fp32_ms"]},
        band_entry("reverse_scan/ext", "ddr_tpu_torch/csrc/reverse_scan.cu",
                   "ddr_tpu/routing/pallas_kernel.py:348", chunked_train["launches"]["reverse_scan"],
                   rev_ext_err, rev_ext),
    ]
    if old_log is not None:
        old_times(old_log, kernels)
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
