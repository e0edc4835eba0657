#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --old-kernels LOG   # also each kernel's time in an earlier run's LOG
    python3 chip_smoke.py --time-fp32   # only the fp32 forward kernel's times
    python3 chip_smoke.py --ddr-train   # only the build and phase 18 (ddr train)
    python3 chip_smoke.py --ddr-cli     # only the build and phases 18-19 (every ported command)
    python3 chip_smoke.py --ddr-serve   # only the build and phases 18 and 20 (ddr serve)
    python3 chip_smoke.py --ddr-loadtest  # only the build and phases 18 and 21 (loadtest, verify)
    python3 chip_smoke.py --ddr-merit   # only the build and phases 18 and 22 (the MERIT path, ΣQ')
    python3 chip_smoke.py --ddr-lynker  # only the build and phases 18 and 23 (the Lynker path)
    python3 chip_smoke.py --ddr-fleet   # only the build and phases 18 and 24 (the replica tier)
    python3 chip_smoke.py --ddr-obs     # only the build and phases 18 and 25 (metrics, obs, profile)
    python3 chip_smoke.py --ddr-chaos   # only the build and phases 18 and 26 (self-healing, ddr chaos)

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
20. ddr serve  the serve command's service (``scripts/serve.py::build_service``)
           at the regional size from phase 18's newest checkpoint, horizon
           72 h, batch 8, behind its HTTP front on port 0: warmup timed to
           ``/readyz`` 200; 8 client threads send 32 forecasts
           (``HttpForecastClient``; ``t0`` spread over the forcing window,
           gauge subsets, all three priority classes, supplied request ids,
           one full-width ``q_prime`` body); every HTTP answer held against
           the in-process service's (bit for bit, else the largest
           difference), two windows against the plain scan; a checkpoint of
           perturbed weights written into the watched ``saved_models/`` is
           hot-loaded (version 2, a new answer, equal to a fresh service's
           from that checkpoint), a degraded and a corrupt one are not;
           ``/metrics`` read against the launches (zeroed just before the
           service is built, read just after the scrape: one a batch, plus
           the warmup and the twin's observation route); then card against
           CPU at 4,096 reaches over HTTP (rtol 1e-6). Latency p50/p99 over
           HTTP with ``queue_s`` and ``execute_s``, the in-process batch,
           occupancy, the ``q_prime`` request's encode, parse and total
           time, the hot-reload time.
21. ddr loadtest, ddr verify  at the same width from phase 18's newest
           checkpoint: ``ddr loadtest`` in-process on the run config (an
           open loop of ``t0`` requests at 80/s for 10 s), then over HTTP
           against ``serve_http`` (20/s and 80/s for 10 s each, and 80/s for
           5 s under a priority mix), each with its p50/p95/p99, ``execute_s``
           apart from the wall, achieved rate, sheds by reason, occupancy and
           SLO slice, and ``/metrics`` read against the reports and the
           launches (launch counts zeroed just before each service is built,
           read just after the scrape); ensembles of E = 8 and 32 members
           (one ``wave_scan`` launch each, B = E): the launch equal to the
           plain scan on the same members and to each member's window served
           alone through ``forecast(q_prime=...)``, bit for bit, the time of
           one E-member launch beside E single launches (the route and the
           kernel alone), an E = 64 ensemble for the peak device memory, and
           the streaming CRPS of an ensemble against the offline reference
           (1e-9); then ``ddr verify --synthetic`` on the card (65,536
           reaches, 72 h), whose sharp arm must beat the degraded arm.
22. ddr merit  the MERIT real-data path on the port's own store builders,
           readers and ``merit`` dataset: ``examples/merit_basin`` copied to
           ``build/ddr_merit/`` and its five stores built there by
           ``ddr_tpu_torch.scripts.prepare_merit_example``; ``ddr train``
           on the example with ``device=cpu`` and on the card from one
           initial checkpoint (per-step losses held to rtol 1e-4), then
           ``ddr test`` and ``ddr route`` from the card's checkpoint on
           both (predictions and discharge held to 1e-5); then the
           regional width: a MERIT-format ``flowpaths.csv`` (COMID,
           NextDownID, up1-up4, lengthkm, slope) with the topology of
           ``make_basin(65536, depth=512, seed=0)``, whose 65 outlets are
           joined into one by a merge tree of fan-in at most four, 8 gauges
           (the outlet, so every batch's union is all 65,536 reaches, and 7
           large tributary basins), 400 days of daily inflow and
           observations drawn as the example's are; the stores built with
           the port's engine builders (timed), ``ddr train`` at
           ``experiment.batch_size=8`` with the launch counts zeroed just
           before and read just after (one ``wave_scan`` and one
           ``reverse_scan`` launch a step: there is no twin observation
           route), each step's routed reaches and host ms, the wall time,
           the peak device memory and the host ms of the streamflow store's
           whole-variable read (``HydroStore.select``); then ``ddr test`` at
           that width, one ``wave_scan`` launch a chunk, all but the first
           from the carried ``q_init``. Then the un-routed baseline: ``ddr
           summed-q-prime`` on the example with ``device=cpu`` and on the
           card (predictions held to 1e-6 relative) and on the regional
           table, each timed, and ``ddr benchmark`` with
           ``summed_q_prime: <its store>`` on both (the ΣQ' battery beside
           MC's and LTI's, both mass balances, one ``wave_scan`` launch a
           chunk at the regional width, over the config's first 92 days).
23. ddr lynker  the Lynker hydrofabric path: a hydrofabric GeoPackage
           (sqlite: ``flowpaths``, ``network`` with ``wb-``/``nex-`` ids and
           ``hl_uri`` gauges, ``flowpath-attributes-ml`` with ``Length_m``,
           ``So`` and ``TopWdth``, ``ChSlp``, ``MusX`` drawn from a seed)
           of 12 flowpaths and 2 gauges, its stores built by ``python -m
           ddr_tpu_torch.engine.lynker_cli ... --gages`` and its inflow keyed
           ``cat-{id}``; ``ddr train`` (2 steps), ``ddr test`` and ``ddr
           route`` on the example config with ``geodataset:
           lynker_hydrofabric``, on the CPU and the card (losses rtol 1e-4,
           predictions and discharge 1e-5); then the regional topology of
           phase 22 as a hydrofabric with 8 gauges and 400 days of inflow,
           its stores built by ``lynker_cli`` in-process with the host
           seconds of each part (table reads, matrix, attributes, collapse,
           gauge subsets), ``ddr train`` at batch 8 (2 steps over all 65,536
           reaches, one launch of each kernel a step) and ``ddr test`` in
           8-day chunks over 92 days, each step's and chunk's host ms, and both kernels on
           that network, per-reach ``x`` from ``MusX``, against their plain
           versions.
24. ddr fleet  the replica tier at the regional width (phase 20's config
           and phase 18's checkpoint, batch 8, 72 h): a subprocess
           ``ReplicaGroup`` of 2 ``ddr serve`` workers (each one's seconds to
           ``/readyz`` 200, its ``/v1/stats`` fleet slice, a CUDA device and
           the memory it reserved there in its boot log, the card's used
           memory risen by at least their sum); 32 forecasts through the
           router from 8 threads (every answer bit for bit the in-process service's from the same
           config, one held to the plain scan; dispatches, each replica's
           batches from ``/metrics``, latency through the router and direct);
           an E = 8 ensemble through ``HttpReplica`` against the same request
           direct; SIGKILL of replica 1 under load (seconds to ejection,
           rerouted requests, ``unroutable_errors`` 0, the federated scrape
           of replica 0 showing r1 down), ``restart_replica`` (seconds to
           readmission, dispatched again); ``python -m ddr_tpu_torch.cli
           fleet up`` with ``fleet status --url`` and SIGINT (exit 0, no worker
           left); ``ddr loadtest --synthetic --fleet 2`` at 80/s for 10 s
           (the group its main builds, driven as its main drives it, and the
           router's dispatch split) beside one service on the same basin; the
           canary controller on the card over the twin's truth on its mid-record window, margin 0.01
           (the same weights promoted; weights whose output bias drives the
           parameters to an end of their ranges, rolled back).
25. ddr obs  the observability plane: phase 18's regional ``ddr train`` in a
           subprocess with ``DDR_METRICS_DIR``, ``DDR_PROM_PORT=0`` and
           ``DDR_HEARTBEAT_EVERY=1``, its exporter (port from ``run_start``)
           scraped while it runs (``ddr_steps_total`` >= 1,
           ``ddr_heartbeats_total``), its log holding a heartbeat, a
           ``skill`` event per step and a ``drift`` per epoch, run_end the
           ``drift``, ``skill``, ``pipeline`` and ``sentinel`` rollups, its
           launches counted in the subprocess; a ``ddr serve`` of phase 20's
           config under a run log: ``POST /v1/profile?seconds=2`` answering
           202 while 8 requests are answered (a second POST 409,
           ``seconds=0`` 400), the capture naming ``wave_scan`` launches,
           ``/v1/stats``' sentinel slice, ``ddr obs federate --once`` with
           ``replica`` labels; ``ddr metrics summarize``, ``tail -n 5`` and
           ``trace --out`` on both logs (the summary's step count the log's,
           a trace slice per step), ``ddr obs bottleneck`` on the train log;
           ``ddr profile --synthetic --n 65536 --t-hours 72 --depth 512
           --reps 5 --trace`` (each program's ms per iteration,
           reach-timesteps/s and peak GB, one ``wave_scan`` launch a call of
           each program and one ``reverse_scan`` a call of the VJP and the
           step, both kernels named in the traces), and its forward route
           against the plain scan bit for bit.
26. ddr chaos  the self-healing ``ddr train`` at 65,536 reaches on the
           chaos drill's config (batch 1, four mini-batches an epoch): five
           ``ddr chaos`` drills at once, each in a process of its own whose
           ``ddr train`` and ``ddr serve`` subprocesses print their launch
           counts at exit, each required to report ``passed: true``:
           ``chaos train --kills 1,2`` (the seconds from each SIGKILL to the
           resumed run's first step, the loss and weight deltas against the
           golden run, the checkpoint each resume took); ``--signal term
           --kills 1`` (a ``preempt`` event, the resume from the ``-preempt``
           checkpoint); ``--nan-storm`` (one recovery a storm, the
           ``device.step`` storm's ``non-finite`` reason from the card's
           scan, one ``data_anomaly``, the weights within the drill's
           tolerance); ``chaos serve --synthetic --horizon 72 --rps 20
           --duration 10 --kill-after 3`` (seconds to ``/readyz`` 200, error
           and shed rates, attainment after the restart) and
           ``--kill-replica`` (ejection seconds, ``ddr_federate_up 0`` on the
           survivor, readmission). Meanwhile, in process through the CLI: a
           rollback to the pinned-good checkpoint with the learning rate
           halved (``DDR_RECOVERY_MAX_SKIPS=0``, ``nan@device.step=2``), a
           give-up (the rollback budget 0 too: a degraded ``-giveup``
           checkpoint, exit 3) and the bf16 ring's ``fp32-reroute``
           (``DDR_HEALTH_MAX_ULP_DRIFT=0``, outcome clean). Then phase 18's
           regional run with ``DDR_RECOVERY_ENABLED=1`` beside phase 18's
           own, and ``snapshot_state`` alone.
The script points Python's bytecode cache at ``build/pycache``
(``PYTHONPYCACHEPREFIX``) for itself and every process it starts: the card
machine's interpreter writes none beside its packages, so each ``ddr
train`` or ``ddr serve`` subprocess recompiled what it imported.
Phases 18, 19, 21, 22 and 23 run with ``DDR_METRICS_DIR`` set to a
directory per run, and print each run log's split: a ``ddr train`` run's
step phases (``summarize_phases``), the steps' loop wall and the share of
the run's wall left untimed; an evaluation run's chunk seconds against its
wall. Phase 21 then replays its ``ddr verify --synthetic`` run log with
``ddr verify <logdir>`` beside the live report.
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
# `ddr serve` (phase 20): 8 client threads send 32 forecasts over HTTP (one of
# them a full-width q_prime body); two windows are held against the plain
# scan; the checkpoint watcher polls every 500 ms; card against CPU at the
# parity width within rtol 1e-6 (the evaluation parity measured 2.8e-7).
DDR_SERVE_THREADS, DDR_SERVE_REQUESTS, DDR_SERVE_PLAIN_WINDOWS = 8, 32, 2
DDR_SERVE_POLL_MS, DDR_SERVE_PARITY_RTOL = "500", 1e-6
# `ddr loadtest` and `ddr verify` (phase 21): open loops of t0 requests (a
# full-width q_prime body measures the JSON parser, phase 20), 10 s at each
# rate and 5 s under the priority mix; ensembles of 8 and 32 members held bit
# for bit, one of 64 (the members' cap) for the peak memory; the streaming
# CRPS against the offline reference within 1e-9, as the JAX package requires
DDR_LOADTEST_SECONDS, DDR_LOADTEST_RATES, DDR_LOADTEST_INPROCESS_RATE = 10.0, (20.0, 80.0), 80.0
DDR_LOADTEST_MIX, DDR_LOADTEST_MIX_RATE, DDR_LOADTEST_MIX_SECONDS = "interactive=0.2,batch=0.5,bulk=0.3", 80.0, 5.0
DDR_ENSEMBLE_MEMBERS, DDR_ENSEMBLE_PEAK_MEMBERS, DDR_VERIFY_CRPS_TOL = (8, 32), 64, 1e-9
# The MERIT path (phase 22): the example (12 reaches, 2 gauges, 2 epochs of one
# step each), then the regional table: 8 gauges in one batch of 8, so each of
# the example config's 2 epochs is one step over all 65,536 reaches, and
# `ddr test` over the config's 182 days in 8-day chunks.
MERIT_EXAMPLE, MERIT_STEPS = "examples/merit_basin", 2
MERIT_GAUGES, MERIT_BATCH, MERIT_MAX_FAN_IN = 8, 8, 4
MERIT_SQKM_PER_REACH = 25.0  # the drainage area a gauge reports, per upstream reach
# The Lynker hydrofabric path (phase 23): the regional topology's 8 gauges in
# one batch of 8, as on the MERIT table; a flowpath's drainage area per
# upstream reach
LYNKER_GAUGES, LYNKER_SQKM_PER_REACH = 8, 25.0
# ddr summed-q-prime's predictions, the card's torch.nansum against the CPU's
SQP_RTOL = 1e-6
# the regional ddr benchmark with its ΣQ' store and the regional Lynker ddr
# test cover the config's first 92 days (12 chunks of up to 8 days), not its 182
REGIONAL_SHORT_WINDOW = ("experiment.end_time=1981/12/31",)
# The replica tier (phase 24): a group of 2 `ddr serve` workers on the card,
# 32 forecasts through the router from 8 threads, the prober every 250 ms;
# the canary on the twin's mid-record 72 h window (over the first days its
# gauges sit flat on their hotstart flow, where NSE is undefined), every
# request on that window so both arms are scored on the same hours, decided
# after 2 observations an arm, at weight 0.5 and an NSE margin of 0.01: there
# the whole parameter space scores within 0.05 of the truth at the twin's
# gauges (the stable arm 0.9981, a saturated KAN 0.9497-0.9682 on the H100),
# so the default margin of 0.05 would pass any candidate. Its regressed
# candidate is the first of these shifts of the KAN's output bias (which
# drive the learned parameters to an end of their ranges) whose median NSE
# falls twice the margin below the stable arm's; random weight noise moves
# the NSE less, in either direction
DDR_FLEET_REPLICAS, DDR_FLEET_THREADS, DDR_FLEET_REQUESTS, DDR_FLEET_PROBE_S = 2, 8, 32, 0.25
DDR_CANARY_MIN_OBS, DDR_CANARY_WEIGHT, DDR_CANARY_MARGIN = 2, 0.5, 0.01
DDR_CANARY_BIAS_SHIFTS, DDR_CANARY_MAX_REQUESTS = (-50.0, 50.0, -5.0, 5.0), 40


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

    def run(name, *overrides, log_name=None):
        log = TrainLog()
        logger.addHandler(log)
        logs = root / "logs" / (log_name or name)
        os.environ["DDR_METRICS_DIR"] = str(logs)
        t0 = time.perf_counter()
        try:
            code = cli.main(["train", DDR_TRAIN_CONFIG, *overrides, f"params.save_path={root / name}"])
            torch.cuda.synchronize()
        finally:
            os.environ.pop("DDR_METRICS_DIR", None)
            logger.removeHandler(log)
        wall = time.perf_counter() - t0
        losses = [loss for *_, loss, _, _ in log.steps]
        if code != 0 or not np.all(np.isfinite(losses)):
            fail(f"ddr train {name}: exit {code}, losses {losses}")
        ms = ", ".join(f"{step_ms:.1f}" for *_, step_ms, _ in log.steps)
        engines = sorted({engine for *_, engine in log.steps})
        print(f"ddr train {name}: {len(log.steps)} steps {[(e, b) for e, b, *_ in log.steps]}, "
              f"losses {losses}, step host ms [{ms}], engine {engines}, run wall {wall:.2f} s on {smi}")
        run_log_split(logs, "train", smi)
        return log, wall

    import os

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
    resumed, _ = run("regional", *full_size, "experiment.epochs=3", f"experiment.checkpoint={saved}",
                     log_name="regional-resume")
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
    import os

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
        logs = root / "logs" / name
        os.environ["DDR_METRICS_DIR"] = str(logs)
        t0 = time.perf_counter()
        try:
            code = cli.main([command, DDR_TRAIN_CONFIG, *overrides, f"params.save_path={root / name}"])
            torch.cuda.synchronize()
        finally:
            os.environ.pop("DDR_METRICS_DIR", None)
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
        for cmd in ("test", "route", "train-and-test"):
            if (logs / f"run_log.{cmd}.jsonl").exists():
                run_log_split(logs, cmd, smi)
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


class ReloadLog(logging.Handler):
    """The checkpoint watcher's own timing of each hot-reload it applied."""

    TOOK = re.compile(r"hot-reload of '\S+' from (\S+) took (\S+)s")

    def __init__(self):
        super().__init__()
        self.reloads = []

    def emit(self, record):
        if m := self.TOOK.match(record.getMessage()):
            self.reloads.append((m[1], float(m[2])))


def scrape(url: str) -> dict:
    """``GET /metrics`` -> ``{"name{labels}": value}``."""
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def metric_sum(metrics: dict, name: str, *labels: str) -> float:
    """The sum of ``name``'s series whose labels hold every one of ``labels``."""
    return sum(v for k, v in metrics.items()
               if k.split("{")[0] == name and all(lab in k for lab in labels))


def percentiles(values) -> str:
    import numpy as np

    return f"p50 {np.percentile(values, 50) * 1e3:.2f} ms p99 {np.percentile(values, 99) * 1e3:.2f} ms"


def ddr_serve(smi, dev) -> int:
    """Phase 20: ``ddr serve`` at the regional width (see the module
    docstring), from phase 18's newest checkpoint. Returns the phase's
    ``wave_scan`` launches, counted from just before the service is built to
    just after ``/metrics`` is read."""
    import os
    import threading
    import urllib.request

    import numpy as np
    import torch

    from ddr_tpu_torch.observability.registry import MetricsRegistry, set_registry
    from ddr_tpu_torch.routing.mc import route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts.common import build_kan, kan_arch, parse_cli
    from ddr_tpu_torch.scripts.serve import build_service
    from ddr_tpu_torch.serving.client import HttpForecastClient, q_prime_json
    from ddr_tpu_torch.serving.config import PRIORITIES, ServeConfig
    from ddr_tpu_torch.serving.http_api import MAX_BODY_BYTES, serve_http
    from ddr_tpu_torch.serving.service import ForecastService
    from ddr_tpu_torch.training import latest_checkpoint, load_state, save_state

    here = Path(__file__).resolve().parent / "build"
    root = here / "ddr_serve"
    shutil.rmtree(root, ignore_errors=True)
    regional = latest_checkpoint(here / "ddr_train" / "regional" / "saved_models")
    small = latest_checkpoint(here / "ddr_train" / "parity-card" / "saved_models")
    if regional is None or small is None:
        fail("ddr serve: phase 18 left no checkpoints")
    full_size = (f"synthetic_segments={N_SEGMENTS}", f"synthetic_depth={DEPTH}")
    os.environ["DDR_SERVE_RELOAD_POLL_MS"] = DDR_SERVE_POLL_MS
    reload_log = ReloadLog()
    logging.getLogger("ddr_tpu_torch.serving.registry").addHandler(reload_log)
    set_registry(MetricsRegistry(const_labels={"host": 0}))  # this service's counts alone
    cfg = parse_cli([DDR_TRAIN_CONFIG, *full_size, f"params.save_path={root / 'regional'}",
                     f"experiment.checkpoint={regional}"], mode="testing")
    serve_cfg = ServeConfig.from_env(max_batch=MAX_BATCH, horizon_hours=HORIZON, deadline_s=600.0)
    served = 0  # answers the service gave, over HTTP and in-process

    # ---- 1. start the server: build, then warm up behind /readyz ----
    wave_scan_tm.launches = 0
    t0 = time.perf_counter()
    svc = build_service(cfg, serve_cfg, warmup=False)
    build_s = time.perf_counter() - t0
    observe_launches = wave_scan_tm.launches  # the twin's observation route
    server = serve_http(svc, port=0)
    client = HttpForecastClient(server.url, timeout=900)
    try:
        states = set()
        warm = threading.Thread(target=svc.warmup)
        t0 = time.perf_counter()
        warm.start()
        while True:
            code, body = client._get("/readyz")
            if code == 200:
                break
            states.add(body.get("status"))
            if not warm.is_alive() and svc.warmup_error is not None:
                fail(f"ddr serve: warmup failed: {svc.warmup_error}")
            time.sleep(0.01)
        warmup_s = time.perf_counter() - t0
        warm.join()
        warm_launches = wave_scan_tm.launches - observe_launches
        entry = svc.networks()["default"]
        forcing = entry.forcing
        print(f"ddr serve: service built in {build_s:.2f} s ({entry.n_segments} reaches, depth "
              f"{entry.network.depth}, {entry.engine}, forcing {forcing.shape}), warmup {warmup_s:.3f} s "
              f"from start to /readyz 200 (states seen before: {sorted(states)}), launches: observation "
              f"{observe_launches}, warmup {warm_launches}, on {smi}")
        if warm_launches != 1 or observe_launches != 1:
            fail(f"ddr serve: {observe_launches} observation and {warm_launches} warmup launches, want 1 and 1")

        # ---- 2. traffic: 8 client threads, 32 forecasts, one full-width q_prime ----
        n_windows = len(forcing) - HORIZON + 1
        starts = np.linspace(0, n_windows - 1, DDR_SERVE_REQUESTS - 1).astype(int)
        requests = []
        for i, t in enumerate(starts):
            requests.append({"t0": int(t), "gauges": [[0, 2], [1, 3], None][i % 3],
                             "priority": PRIORITIES[i % 3],
                             "request_id": f"p20-{i}" if i % 2 == 0 else None})
        q_t0 = int(starts[len(starts) // 2]) + 5
        qp = (forcing[q_t0 : q_t0 + HORIZON] * np.float32(1.25)).astype(np.float32)
        results: dict[int, tuple] = {}
        q_stats = {}

        def post_q_prime():
            t_enc = time.perf_counter()
            body = ('{"network": "default", "model": "default", "priority": "bulk", "q_prime": '
                    + q_prime_json(qp) + "}").encode()
            q_stats["encode_s"], q_stats["body"] = time.perf_counter() - t_enc, body
            req = urllib.request.Request(server.url + "/v1/forecast", data=body, method="POST",
                                         headers={"Content-Type": "application/json",
                                                  "X-DDR-Request-Id": "p20-q_prime"})
            t_send = time.perf_counter()
            with urllib.request.urlopen(req, timeout=900) as resp:
                out = json.loads(resp.read())
            q_stats["total_s"] = time.perf_counter() - t_send
            out["runoff"] = np.asarray(out["runoff"], np.float32)
            return out

        go = threading.Barrier(DDR_SERVE_THREADS)

        def worker(k):
            go.wait()
            for i in range(k, DDR_SERVE_REQUESTS, DDR_SERVE_THREADS):
                t_req = time.perf_counter()
                if i == len(requests):
                    ans = post_q_prime()
                else:
                    ans = client.forecast("default", **requests[i])
                results[i] = (ans, time.perf_counter() - t_req)

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(DDR_SERVE_THREADS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        traffic_s = time.perf_counter() - t0
        if len(results) != DDR_SERVE_REQUESTS:
            fail(f"ddr serve: {len(results)} of {DDR_SERVE_REQUESTS} requests answered")
        served += len(results)
        answers = [results[i][0] for i in range(DDR_SERVE_REQUESTS)]
        walls = [results[i][1] for i in range(DDR_SERVE_REQUESTS)]
        for i, a in enumerate(answers[:-1]):
            want = requests[i]["request_id"]
            if (want is not None and a["request_id"] != want) or a["version"] != 1:
                fail(f"ddr serve: request {i} answered id {a['request_id']} version {a['version']}")
        batches = {}
        for a in answers:
            batches[(a["execute_s"], a["device_ms"])] = a["batch_size"]
        sizes = sorted(batches.values(), reverse=True)
        print(f"ddr serve traffic: {DDR_SERVE_REQUESTS} requests from {DDR_SERVE_THREADS} threads in "
              f"{traffic_s:.2f} s, {len(batches)} batches of sizes {sizes} (occupancy mean "
              f"{np.mean(sizes) / MAX_BATCH:.3f}), on {smi}")
        print(f"ddr serve HTTP latency, all 32: {percentiles(walls)}; the 31 t0 requests: "
              f"{percentiles(walls[:-1])}; queue_s {percentiles([a['queue_s'] for a in answers])}; "
              f"execute_s {percentiles([a['execute_s'] for a in answers])}; batch device ms "
              f"{sorted(round(k[1], 3) for k in batches if k[1] is not None)}, on {smi}")
        t_parse = time.perf_counter()  # what the server's handler does with the body
        parsed = np.asarray(json.loads(q_stats["body"])["q_prime"], dtype=np.float32)
        parse_s = time.perf_counter() - t_parse
        if not np.array_equal(parsed, qp):
            fail("ddr serve: the q_prime body does not parse back to its float32 values")
        qa = answers[-1]
        print(f"ddr serve q_prime request ({HORIZON} x {entry.n_segments} floats, {len(q_stats['body']) / 1e6:.2f} MB "
              f"of JSON, limit {MAX_BODY_BYTES / 1e6:.2f} MB): client encode {q_stats['encode_s']:.3f} s, "
              f"send to answer {q_stats['total_s']:.3f} s (queue_s {qa['queue_s']:.3f}, execute_s "
              f"{qa['execute_s']:.3f}), host parse of the same body {parse_s:.3f} s, on {smi}")

        # ---- 3. answers: HTTP against in-process, then two windows against the plain scan ----
        worst = 0.0
        inproc_exec, inproc_dev = [], []
        for i, a in enumerate(answers):
            kw = {"q_prime": qp} if i == len(requests) else {"t0": requests[i]["t0"],
                                                           "gauges": requests[i]["gauges"]}
            ref = svc.forecast(network="default", timeout=900, **kw)
            served += 1
            inproc_exec.append(ref["execute_s"])
            inproc_dev.append(ref["device_ms"])
            diff = float(np.abs(ref["runoff"].astype(np.float64) - a["runoff"]).max())
            worst = max(worst, diff)
            if diff:
                compare(torch.as_tensor(ref["runoff"]), torch.as_tensor(a["runoff"]),
                        f"ddr serve HTTP request {i} against in-process")
        print(f"ddr serve: HTTP answers against in-process, largest difference {worst!r} "
              f"({'bit for bit' if worst == 0 else 'not bit for bit: a batch of other rows'}); "
              f"in-process batch (1 live row of {MAX_BATCH}) host ms {percentiles(inproc_exec)}, "
              f"device ms median {np.median([d for d in inproc_dev if d is not None] or [np.nan]):.3f}, on {smi}")
        # the same in-process path with every row of the slot live, as phases 3 and 7 serve
        full = {}
        for _ in range(2):
            for f in [svc.submit("default", t0=int(t)) for t in starts[:MAX_BATCH]]:
                a = f.result(timeout=900)
                full[(a["execute_s"], a["device_ms"])] = a["batch_size"]
            served += MAX_BATCH
        print(f"ddr serve: in-process batches of {sorted(full.values())} live rows: host ms "
              f"{[round(k[0] * 1e3, 3) for k in full]}, device ms "
              f"{[None if k[1] is None else round(k[1], 3) for k in full]}, on {smi}")
        p = cfg.params
        for w in (int(starts[0]), int(starts[len(starts) // 3])):
            got = svc.forecast(network="default", t0=w, timeout=900)
            served += 1
            with torch.no_grad():
                kan = svc.registry.get("default").kan
                phys = denormalize_spatial_parameters(kan(entry.attrs), p.parameter_ranges,
                                                      p.log_space_parameters, p.defaults, entry.n_segments)
                q = torch.as_tensor(forcing[w : w + HORIZON], device=dev)
                if entry.flow_scale is not None:
                    q = q * entry.flow_scale
                expect = route(entry.network, entry.channels, phys, q, gauges=entry.gauge_index,
                               bounds=svc.bounds, kernel="reference", device=dev).runoff
            compare(expect.cpu(), torch.as_tensor(got["runoff"]),
                    f"ddr serve t0={w} against the plain scan (wave_scan_tm_reference)")
        # where a served batch's time goes, by operation
        profile_batch(svc, "default", starts[:MAX_BATCH])
        served += MAX_BATCH

        # ---- 4. hot-reload: perturbed weights, then a degraded and a corrupt checkpoint ----
        arch = kan_arch(cfg)
        params = load_state(regional, expected_arch=arch)["params"]
        rng = np.random.default_rng(20)
        perturbed = {k: (v * (1 + 0.05 * rng.standard_normal(v.shape))).astype(v.dtype)
                     if np.issubdtype(v.dtype, np.floating) else v for k, v in params.items()}
        saved = root / "regional" / "saved_models"
        t_hot = int(starts[len(starts) // 4])
        before = client.forecast("default", t0=t_hot)
        t0 = time.perf_counter()
        path2 = save_state(saved, cfg.name, 3, 0, perturbed, None, arch=arch, healthy=True)
        while client._get("/v1/models")[1]["models"]["default"]["version"] != 2:
            if time.perf_counter() - t0 > 60:
                fail("ddr serve: the watcher did not load the new checkpoint within 60 s")
            time.sleep(0.01)
        reload_s = time.perf_counter() - t0
        after = client.forecast("default", t0=t_hot)
        served += 2
        if after["version"] != 2 or np.array_equal(after["runoff"], before["runoff"]):
            fail(f"ddr serve: after the reload version {after['version']}, answer unchanged")
        save_state(saved, cfg.name, 4, 0, perturbed, None, arch=arch, healthy=False)
        corrupt = save_state(saved, cfg.name, 5, 0, perturbed, None, arch=arch, healthy=True)
        data = bytearray(corrupt.read_bytes())
        data[len(data) // 2] ^= 0xFF
        corrupt.write_bytes(bytes(data))
        time.sleep(4 * int(DDR_SERVE_POLL_MS) / 1e3)
        models = client._get("/v1/models")[1]["models"]["default"]
        if models["version"] != 2 or models["source"] != str(path2) or corrupt.exists():
            fail(f"ddr serve: after a degraded and a corrupt checkpoint: {models}, corrupt blob "
                 f"still in place {corrupt.exists()}")
        print(f"ddr serve hot-reload: version 2 answered {reload_s:.3f} s after the checkpoint was "
              f"written (poll {DDR_SERVE_POLL_MS} ms; the watcher's load and swap {reload_log.reloads}); a "
              f"degraded and a corrupt checkpoint were not loaded (the corrupt one quarantined), on {smi}")

        # ---- 5. /metrics against the launches ----
        metrics = scrape(server.url)
        launches = wave_scan_tm.launches
        ok = metric_sum(metrics, "ddr_requests_total", 'status="ok"')
        batches_total = metric_sum(metrics, "ddr_batches_total")
        values = {
            "ddr_requests_total{status=ok}": ok, "ddr_batches_total": batches_total,
            "ddr_hot_reloads_total": metric_sum(metrics, "ddr_hot_reloads_total"),
            "ddr_health_status": metric_sum(metrics, "ddr_health_status"),
            "ddr_model_version": metric_sum(metrics, "ddr_model_version"),
        }
        print(f"ddr serve /metrics: {values}; wave_scan launches {launches} (observation "
              f"{observe_launches}, warmup {warm_launches}); {served} answers served")
        if (ok != served or batches_total != launches - observe_launches - warm_launches
                or values["ddr_hot_reloads_total"] != 1 or values["ddr_health_status"] != 1
                or values["ddr_model_version"] != 2):
            fail(f"ddr serve: /metrics {values} against {served} answers and {launches} launches")
        check_watchdog(svc, int(batches_total), "ddr serve")
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        logging.getLogger("ddr_tpu_torch.serving.registry").removeHandler(reload_log)
        del os.environ["DDR_SERVE_RELOAD_POLL_MS"]

    # ---- the reloaded answer against a fresh service from the same checkpoint ----
    # (outside the counted run: a fresh service on the same built network)
    set_registry(MetricsRegistry(const_labels={"host": 0}))
    fresh = ForecastService(cfg, ServeConfig(max_batch=MAX_BATCH, horizon_hours=HORIZON, deadline_s=600.0,
                                             reload_poll_s=0.0), device=dev)
    try:
        fresh.register_network("default", entry.rd, forcing=forcing)
        kan = build_kan(cfg)
        kan.load_state_dict({k: torch.as_tensor(v) for k, v in load_state(path2, expected_arch=arch)["params"].items()})
        fresh.register_model("default", kan)
        fresh.warmup()
        ref = fresh.forecast(network="default", t0=t_hot, timeout=900)
    finally:
        fresh.close()
    diff = float(np.abs(ref["runoff"].astype(np.float64) - after["runoff"]).max())
    print(f"ddr serve: the reloaded answer against a fresh service from {path2.name}: largest "
          f"difference {diff!r}")
    if diff:
        compare(torch.as_tensor(ref["runoff"]), torch.as_tensor(after["runoff"]),
                "ddr serve reloaded against fresh")

    # ---- 6. card against CPU at the parity width, over HTTP ----
    outs = {}
    for device in ("cpu", "cuda"):
        set_registry(MetricsRegistry(const_labels={"host": 0}))
        small_cfg = parse_cli([DDR_TRAIN_CONFIG, *DDR_TRAIN_PARITY, *DDR_TEST_PARITY_WINDOW, f"device={device}",
                               f"params.save_path={root / ('parity-' + device)}",
                               f"experiment.checkpoint={small}"], mode="testing")
        small_svc = build_service(small_cfg, ServeConfig(max_batch=MAX_BATCH, horizon_hours=HORIZON,
                                                         deadline_s=600.0), watch=False)
        small_server = serve_http(small_svc, port=0)
        try:
            c = HttpForecastClient(small_server.url, timeout=900)
            n_win = len(small_svc.networks()["default"].forcing) - HORIZON + 1
            outs[device] = [c.forecast("default", t0=int(t), gauges=[[0, 2], None][i % 2])["runoff"]
                            for i, t in enumerate(np.linspace(0, n_win - 1, MAX_BATCH).astype(int))]
        finally:
            small_server.shutdown()
            small_server.server_close()
            small_svc.close()
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        compare(torch.as_tensor(a), torch.as_tensor(b), f"ddr serve 4,096 reaches request {i}, card against CPU",
                rtol=DDR_SERVE_PARITY_RTOL)
    set_registry(None)
    return launches


def run_command(main, argv, label) -> dict:
    """A command's ``main(argv)`` in-process with its standard output kept
    apart; fails unless it exits 0. Returns the JSON record it prints last."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(argv)
    lines = out.getvalue().strip().splitlines()
    if code != 0 or not lines:
        fail(f"{label}: exit {code}, output {lines[-3:]}")
    return json.loads(lines[-1])


def loadtest_line(label, report, launches, smi) -> str:
    """One line of a load-test report: latency, execute_s apart from it,
    rates, drops, occupancy and the SLO slice."""
    return (f"ddr loadtest {label}: {report['requests']} requests in {report['wall_s']} s, offered "
            f"{report['offered_rps']}/s, served {report['throughput_rps']}/s; latency p50/p95/p99 "
            f"{report['p50_ms']}/{report['p95_ms']}/{report['p99_ms']} ms, queue_s "
            f"{report['queue_p50_ms']}/{report['queue_p95_ms']}/{report['queue_p99_ms']} ms, execute_s "
            f"{report['execute_p50_ms']}/{report['execute_p95_ms']}/{report['execute_p99_ms']} ms; ok "
            f"{report['ok']}, rejected {report['rejected']}, sheds {report['sheds_by_reason']}, errors "
            f"{report['errors']}; mean batch {report['mean_batch_size']} (occupancy "
            f"{report['mean_batch_occupancy']}); SLO attainment {report['slo_attainment']} (target "
            f"{report['slo_target']}), burn {report['slo_burn_rates']}"
            + (f"; by class {report['by_priority']}" if "by_priority" in report else "")
            + f"; wave_scan launches {launches}, on {smi}")


def ddr_loadtest(smi, dev) -> int:
    """Phase 21: ``ddr loadtest`` and ``ddr verify`` at the regional width
    (see the module docstring), from phase 18's newest checkpoint. Returns
    the phase's main-path ``wave_scan`` launches (the load tests, the
    ensembles and ``ddr verify``; not those made to compare or time)."""
    import os

    import numpy as np
    import torch

    from ddr_tpu_torch.fleet.config import FleetConfig
    from ddr_tpu_torch.fleet.ensemble import member_windows, perturbation_seed
    from ddr_tpu_torch.observability.registry import MetricsRegistry, set_registry
    from ddr_tpu_torch.observability.verification import ForecastLedger, VerifyConfig, crps_ensemble
    from ddr_tpu_torch.routing.mc import reach_physics, route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts import loadtest, verify
    from ddr_tpu_torch.scripts.common import parse_cli
    from ddr_tpu_torch.scripts.serve import build_service
    from ddr_tpu_torch.serving.config import ServeConfig
    from ddr_tpu_torch.serving.http_api import serve_http
    from ddr_tpu_torch.training import latest_checkpoint

    here = Path(__file__).resolve().parent / "build"
    root = here / "ddr_loadtest"
    shutil.rmtree(root, ignore_errors=True)
    regional = latest_checkpoint(here / "ddr_train" / "regional" / "saved_models")
    if regional is None:
        fail("ddr loadtest: phase 18 left no checkpoint")
    config_argv = [DDR_TRAIN_CONFIG, f"synthetic_segments={N_SEGMENTS}", f"synthetic_depth={DEPTH}",
                   f"params.save_path={root / 'regional'}", f"experiment.checkpoint={regional}"]
    torch.cuda.reset_peak_memory_stats()
    main_launches = 0

    # ---- 1. ddr loadtest in-process, on the run config ----
    set_registry(MetricsRegistry(const_labels={"host": 0}))
    wave_scan_tm.launches = 0
    os.environ["DDR_METRICS_DIR"] = str(root / "logs" / "inprocess")
    report = run_command(loadtest.main, [
        *config_argv, "--rps", str(DDR_LOADTEST_INPROCESS_RATE), "--duration", str(DDR_LOADTEST_SECONDS),
        "--out", str(root), "--label", "inprocess"], "ddr loadtest in-process")
    launches = wave_scan_tm.launches
    run_log_split(root / "logs" / "inprocess", "loadtest", smi)
    main_launches += launches
    print(loadtest_line(f"in-process {DDR_LOADTEST_INPROCESS_RATE:g}/s", report, launches, smi))
    # the observation route, the warmup, the priming request's batch and the run's batches
    batches = report["ok"] / report["mean_batch_size"]
    if (report["errors"] or report["ok"] < 1 or report["device"] != torch.cuda.get_device_name(dev)
            or abs(launches - 3 - batches) > 0.5):
        fail(f"ddr loadtest in-process: {report['errors']} errors, {report['ok']} ok on {report['device']}, "
             f"{launches} launches for ~{batches:.2f} batches")

    # ---- 2. ddr loadtest over HTTP, then /metrics against the reports ----
    set_registry(MetricsRegistry(const_labels={"host": 0}))
    wave_scan_tm.launches = 0
    cfg = parse_cli(config_argv, mode="testing")
    svc = build_service(cfg, ServeConfig.from_env(max_batch=MAX_BATCH, horizon_hours=HORIZON), watch=False)
    base = wave_scan_tm.launches  # the observation route and the warmup
    server = serve_http(svc, port=0)
    try:
        entry = svc.networks()["default"]
        span = len(entry.forcing) - HORIZON + 1
        runs = [(f"HTTP {rate:g}/s", ["--rps", str(rate), "--duration", str(DDR_LOADTEST_SECONDS)])
                for rate in DDR_LOADTEST_RATES]
        runs.append((f"HTTP {DDR_LOADTEST_MIX_RATE:g}/s {DDR_LOADTEST_MIX}",
                     ["--rps", str(DDR_LOADTEST_MIX_RATE), "--duration", str(DDR_LOADTEST_MIX_SECONDS),
                      "--priority-mix", DDR_LOADTEST_MIX]))
        reports = []
        for i, (label, extra) in enumerate(runs):
            before = wave_scan_tm.launches
            os.environ["DDR_METRICS_DIR"] = str(root / "logs" / f"http-{i}")
            report = run_command(loadtest.main, ["--url", server.url, "--t0-span", str(span), *extra,
                                                 "--out", str(root), "--label", f"http-{i}"],
                                 f"ddr loadtest {label}")
            run_log_split(root / "logs" / f"http-{i}", "loadtest", smi)
            print(loadtest_line(label, report, wave_scan_tm.launches - before, smi))
            if report["errors"] or report["ok"] < 1:
                fail(f"ddr loadtest {label}: {report['errors']} errors, {report['ok']} ok")
            reports.append(report)
        os.environ.pop("DDR_METRICS_DIR", None)
        metrics = scrape(server.url)
        launches = wave_scan_tm.launches
        main_launches += launches
        stats = svc.stats()
        ok = metric_sum(metrics, "ddr_requests_total", 'status="ok"')
        batches_total = metric_sum(metrics, "ddr_batches_total")
        sheds = metric_sum(metrics, "ddr_sheds_total")
        # each run's unmeasured priming request is served too
        want_ok = sum(r["ok"] for r in reports) + len(reports)
        want_sheds = sum(r["shed"] + r["rejected"] for r in reports)
        print(f"ddr loadtest /metrics: requests ok {ok} (reports {want_ok}), batches {batches_total} "
              f"(launches {launches} less {base} for the observation route and warmup; /v1/stats "
              f"{stats['queue']['batches']}), sheds {sheds} (reports {want_sheds}); SLO "
              f"{json.dumps(stats['slo'])}")
        if (ok != want_ok or sheds != want_sheds or batches_total != launches - base
                or stats["queue"]["batches"] != batches_total or base != 2):
            fail(f"ddr loadtest: /metrics ok {ok} sheds {sheds} batches {batches_total} against reports "
                 f"{want_ok}, {want_sheds} and {launches} - {base} launches")
        check_watchdog(svc, int(batches_total), "ddr loadtest")

        # ---- 3. ensembles: one launch of E members ----
        p = cfg.params
        sigma = FleetConfig.from_env().ensemble_sigma
        kan = svc.registry.get("default").kan
        with torch.no_grad():
            phys_params = denormalize_spatial_parameters(kan(entry.attrs), p.parameter_ranges,
                                                         p.log_space_parameters, p.defaults, entry.n_segments)
        phys = reach_physics(entry.network, entry.channels, phys_params, svc.bounds)
        for E in (*DDR_ENSEMBLE_MEMBERS, DDR_ENSEMBLE_PEAK_MEMBERS):
            t0w, rid = (E * 37) % span, f"p21-ens-{E}"
            torch.cuda.reset_peak_memory_stats()
            before = wave_scan_tm.launches
            t_host = time.perf_counter()
            ans = svc.ensemble_forecast(network="default", t0=t0w, members=E, request_id=rid,
                                        return_members=E != DDR_ENSEMBLE_PEAK_MEMBERS)
            host_s = time.perf_counter() - t_host
            n_launch = wave_scan_tm.launches - before
            main_launches += n_launch
            peak = torch.cuda.max_memory_allocated() / 1e9
            if (n_launch != 1 or not np.isfinite(ans["runoff"]).all() or ans["ensemble_nonfinite_members"]
                    or ans["runoff"].shape != (3, HORIZON, entry.n_outputs)):
                fail(f"ddr ensemble E={E}: {n_launch} launches, bands {ans['runoff'].shape}, "
                     f"{ans['ensemble_nonfinite_members']} non-finite members")
            print(f"ddr ensemble E={E}: one wave_scan launch, forecast {host_s * 1e3:.3f} ms host (execute_s "
                  f"{ans['execute_s']}), worst gauges {ans['worst']['gauges']}, peak device memory "
                  f"{peak:.3f} GB, on {smi}")
            if E == DDR_ENSEMBLE_PEAK_MEMBERS:
                continue
            with torch.no_grad():
                windows = member_windows(torch.as_tensor(entry.forcing[t0w : t0w + HORIZON], device=dev),
                                         perturbation_seed(rid, 0), E, sigma)
                qe = windows * entry.flow_scale if entry.flow_scale is not None else windows
                kw = dict(gauges=entry.gauge_index, bounds=svc.bounds, device=dev)
                launch = route(entry.network, entry.channels, phys_params, qe, **kw).runoff
                plain = route(entry.network, entry.channels, phys_params, qe, kernel="reference", **kw).runoff
            if not np.array_equal(ans["member_runoff"], launch.cpu().numpy()):
                fail(f"ddr ensemble E={E}: the service's members differ from the same launch")
            if not torch.equal(launch, plain):
                compare(plain.cpu(), launch.cpu(), f"ddr ensemble E={E} against the plain scan")
                fail(f"ddr ensemble E={E}: the launch is not the plain scan bit for bit")
            worst = 0.0
            for m in range(E):
                alone = svc.forecast(network="default", q_prime=windows[m].cpu().numpy(), timeout=900)["runoff"]
                worst = max(worst, float(np.abs(alone.astype(np.float64) - ans["member_runoff"][m]).max()))
            if worst:
                fail(f"ddr ensemble E={E}: a member served alone differs by {worst!r}")
            # time: one E-member route against E routes of one member, and the kernel alone
            with torch.no_grad():
                singles = [qe[m : m + 1].contiguous() for m in range(E)]
                route_ms = cuda_ms(lambda: route(entry.network, entry.channels, phys_params, qe, **kw), 5)
                single_ms = cuda_ms(lambda: [route(entry.network, entry.channels, phys_params, s, **kw)
                                             for s in singles], 3)
                qk, _ = scan_case(entry.network, phys, E, HORIZON, 21, False, dev)
                qk1 = [qk[m : m + 1].contiguous() for m in range(E)]
                kernel_ms = cuda_ms(lambda: wave_scan_tm(qk, entry.network, phys, None), 10)
                kernel1_ms = cuda_ms(lambda: [wave_scan_tm(x, entry.network, phys, None) for x in qk1], 3)
            print(f"ddr ensemble E={E}: equal bit for bit to the plain scan and to each member served alone "
                  f"(a batch of {MAX_BATCH} rows, 7 of them pad); one E-member route {route_ms:.3f} ms against {E} one-member routes "
                  f"{single_ms:.3f} ms; the kernel alone: one launch at B {E} {kernel_ms:.3f} ms against {E} "
                  f"launches at B 1 {kernel1_ms:.3f} ms, on {smi}")
            if E == DDR_ENSEMBLE_MEMBERS[0]:
                # the streaming CRPS of this ensemble against the offline reference
                truth = svc.forecast(network="default", t0=t0w, timeout=900)["runoff"]
                ledger = ForecastLedger(VerifyConfig(), registry=MetricsRegistry())
                gids = [str(g) for g in range(truth.shape[1])]
                ledger.record_forecast("default", "default", rid, t0w, ans["valid_times"] if "valid_times" in ans
                                       else [t0w + 1 + i for i in range(HORIZON)], gids, ans["member_runoff"])
                join = ledger.observe("default", {g: [(t0w + 1 + i, float(truth[i, int(g)])) for i in range(HORIZON)]
                                                  for g in gids})
                sums = ledger.scorer._bin_sums.sum(axis=0)
                ref = float(np.mean(crps_ensemble(ans["member_runoff"].reshape(E, -1).astype(np.float64),
                                                  truth.reshape(-1).astype(np.float64))))
                diff = abs(sums[1] / sums[0] - ref)
                print(f"ddr verify streaming CRPS {float(sums[1] / sums[0])!r} against the offline reference {ref!r}: "
                      f"|difference| {diff:.3e} over {join['matched']} samples (limit {DDR_VERIFY_CRPS_TOL:g})")
                if join["matched"] != HORIZON * truth.shape[1] or diff > DDR_VERIFY_CRPS_TOL:
                    fail(f"ddr verify: streaming CRPS off the offline reference by {diff}")
        del qe, windows, launch, plain, qk
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4. ddr verify --synthetic on the card ----
    set_registry(MetricsRegistry(const_labels={"host": 0}))
    wave_scan_tm.launches = 0
    t0 = time.perf_counter()
    os.environ["DDR_METRICS_DIR"] = str(root / "logs" / "verify")
    try:
        report = run_command(verify.main, ["--synthetic", "--n", str(N_SEGMENTS), "--horizon", str(HORIZON),
                                           "--members", "8", "--requests", "6", "--out", str(root), "--label",
                                           "p21"], "ddr verify --synthetic")
    finally:
        os.environ.pop("DDR_METRICS_DIR", None)
    launches = wave_scan_tm.launches
    main_launches += launches
    print(f"ddr verify --synthetic ({N_SEGMENTS} reaches, {HORIZON} h, 6 ensembles of 8): CRPS sharp "
          f"{report['crps']} against degraded {report['crps_degraded']}, {report['matched_samples']} samples, "
          f"Brier {report['brier']}, spread-skill {report['spread_skill']}, launches during the join "
          f"{report['kernel_launches_during_join']}, wave_scan launches {launches}, {time.perf_counter() - t0:.2f} s, "
          f"on {smi}")
    if (not report["ordering_ok"] or report["device"] != torch.cuda.get_device_name(dev)
            or launches != 1 + 6 + 6):  # warmup, 6 truths and 6 ensembles (t0 windows 0..5)
        fail(f"ddr verify: ordering {report['ordering_ok']} on {report['device']}, {launches} launches")
    run_log_split(root / "logs" / "verify", "verify", smi)
    # ddr verify <logdir>: the run log's verify events, replayed
    replay = run_command(verify.main, [str(root / "logs" / "verify"), "--out", str(root), "--label", "p21-replay"],
                         "ddr verify <logdir>")
    print(f"ddr verify <logdir> (replay of the run log): CRPS {replay['crps']}, {replay['matched_samples']} samples, "
          f"Brier {replay['brier']}, spread-skill {replay['spread_skill']}, {replay['files']} file(s); beside the live "
          f"report above: CRPS sharp {report['crps']}, degraded {report['crps_degraded']}, "
          f"{report['matched_samples']} samples")
    if replay["files"] != 1 or not replay["matched_samples"] or replay["crps"] is None:
        fail(f"ddr verify <logdir>: {replay}")
    set_registry(None)
    print(f"ddr loadtest phase: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB since the last "
          f"reset (the E = {DDR_ENSEMBLE_PEAK_MEMBERS} ensemble above has its own)")
    return main_launches


def merit_overrides(data: Path, gages: Path, save: Path) -> list[str]:
    """A MERIT config's stores, gauge table and run directory as absolute paths."""
    return [f"data_sources.attributes={data / 'attributes.zarr'}",
            f"data_sources.conus_adjacency={data / 'merit_conus_adjacency.zarr'}",
            f"data_sources.gages_adjacency={data / 'merit_gages_adjacency.zarr'}",
            f"data_sources.streamflow={data / 'streamflow.zarr'}",
            f"data_sources.observations={data / 'observations.zarr'}",
            f"data_sources.gages={gages}", f"data_sources.statistics={save / 'stats'}",
            f"params.save_path={save}"]


def regional_topology() -> dict:
    """The topology of ``make_basin(N_SEGMENTS, depth=DEPTH, seed=0)`` with
    its outlets (every reach of the last level) joined into the one with the
    most upstream reaches by a breadth-first merge tree in which no reach
    takes more than ``MERIT_MAX_FAN_IN`` upstream reaches (no reach of the
    generated topology has more): each reach's upstream list ``ups`` and
    downstream ``down`` (-1 at the outlet), its upstream reach count
    ``area``, the outlet ``main`` and the other former outlets ``rest``
    (largest first), and the basin's routing data (lengths, slopes)."""
    import numpy as np

    from ddr_tpu_torch.geodatazoo.synthetic import make_basin
    from ddr_tpu_torch.routing.network import compute_levels

    rd = make_basin(N_SEGMENTS, n_gauges=N_GAUGES, n_days=2, depth=DEPTH, seed=0).routing_data
    n, rows, cols = N_SEGMENTS, rd.adjacency_rows, rd.adjacency_cols
    fan_in_before = int(np.bincount(rows, minlength=n).max())
    if fan_in_before > MERIT_MAX_FAN_IN:
        fail(f"regional topology: the generated topology has fan-in {fan_in_before} > {MERIT_MAX_FAN_IN}")
    down = np.full(n, -1)
    down[cols] = rows
    level = compute_levels(rows, cols, n)
    area = np.ones(n, dtype=np.int64)  # upstream reaches, the reach included
    for i in np.argsort(level, kind="stable"):
        if down[i] >= 0:
            area[down[i]] += area[i]
    outlets = np.flatnonzero(down < 0)
    outlets = outlets[np.argsort(-area[outlets], kind="stable")]
    main, rest = int(outlets[0]), [int(o) for o in outlets[1:]]
    ups: list[list[int]] = [[] for _ in range(n)]
    for r, c in zip(rows.tolist(), cols.tolist()):
        ups[r].append(c)
    receivers, k = [main], 0
    for o in rest:
        while len(ups[receivers[k]]) >= MERIT_MAX_FAN_IN:
            k += 1
        ups[receivers[k]].append(o)
        down[o] = receivers[k]
        receivers.append(o)
    new_rows = np.asarray([r for r in range(n) for _ in ups[r]])
    new_cols = np.asarray([c for r in range(n) for c in ups[r]])
    return {"rd": rd, "n": n, "ups": ups, "down": down, "area": area, "main": main, "rest": rest,
            "outlets": len(outlets), "depth": int(compute_levels(new_rows, new_cols, n).max()),
            "fan_in": int(np.bincount(new_rows, minlength=n).max())}


def regional_merit_table(root: Path) -> dict:
    """Write ``root/flowpaths.csv`` and ``root/gages.csv``: the regional
    topology (:func:`regional_topology`) as a MERIT table. Gauges: the
    outlet, and the other former outlets with the most upstream reaches."""
    import csv

    import numpy as np

    topo = regional_topology()
    rd, n, ups, down, area, main, rest = (topo[k] for k in ("rd", "n", "ups", "down", "area", "main", "rest"))
    comid = 71_000_001 + np.random.default_rng(0).permutation(n)  # ids not in topological order
    with (root / "flowpaths.csv").open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["COMID", "NextDownID", "up1", "up2", "up3", "up4", "lengthkm", "slope"])
        for i in range(n):
            u = [int(comid[j]) for j in ups[i]] + [0] * (MERIT_MAX_FAN_IN - len(ups[i]))
            w.writerow([int(comid[i]), int(comid[down[i]]) if down[i] >= 0 else 0, *u,
                        f"{rd.length[i] / 1000.0:.6f}", f"{rd.slope[i]:.8f}"])
    gauges = [main] + rest[: MERIT_GAUGES - 1]
    with (root / "gages.csv").open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["STAID", "STANAME", "DRAIN_SQKM", "LAT_GAGE", "LNG_GAGE", "COMID", "DA_VALID"])
        for k, g in enumerate(gauges):
            # STAIDs with a leading zero: the CSV reader must keep them as padded text
            w.writerow([f"0{9100000 + k}", "outlet" if k == 0 else f"tributary {k}",
                        f"{MERIT_SQKM_PER_REACH * area[g]:.1f}" if k else f"{MERIT_SQKM_PER_REACH * n:.1f}",
                        40.0, -75.0, int(comid[g]), True])
    return {"n": n, "outlets": topo["outlets"], "depth": topo["depth"], "fan_in": topo["fan_in"],
            "gauge_reaches": [n] + [int(area[g]) for g in gauges[1:]]}


def ddr_merit(smi, dev) -> dict:
    """Phase 22: the MERIT real-data path (see the module docstring).
    Returns the launch counts of its card runs."""
    import os

    import numpy as np
    import torch

    from ddr_tpu_torch import cli
    from ddr_tpu_torch.engine.merit import build_gauge_adjacencies, build_merit_adjacency, read_flowpaths
    from ddr_tpu_torch.geodatazoo.dataclasses import MERITGauge, validate_gages
    from ddr_tpu_torch.geodatazoo.merit import Merit
    from ddr_tpu_torch.io import zarrlite
    from ddr_tpu_torch.io.readers import StreamflowReader
    from ddr_tpu_torch.io.stores import write_attribute_store, write_hydro_store
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts import prepare_merit_example as prep
    from ddr_tpu_torch.scripts import train as train_script
    from ddr_tpu_torch.scripts.common import build_kan, kan_arch
    from ddr_tpu_torch.training import latest_checkpoint, save_state
    from ddr_tpu_torch.validation.configs import load_config

    here = Path(__file__).resolve().parent
    root = here / "build" / "ddr_merit"
    shutil.rmtree(root, ignore_errors=True)
    example = root / "example"
    shutil.copytree(here / MERIT_EXAMPLE, example, ignore=shutil.ignore_patterns("data", "output"))
    t0 = time.perf_counter()
    prep.prepare(example)
    print(f"ddr merit example: stores {sorted(p.name for p in (example / 'data').iterdir())} built in "
          f"{time.perf_counter() - t0:.2f} s")
    config = str(example / "config.yaml")
    loggers = [logging.getLogger(name) for name in (
        train_script.__name__, "ddr_tpu_torch.scripts.common", "ddr_tpu_torch.scripts.router",
        "ddr_tpu_torch.geodatazoo.base")]
    for logger in loggers:
        logger.setLevel(logging.INFO)

    class MeritLog(logging.Handler):
        """Train steps, evaluation chunks and each batch's routed reaches."""

        SHAPE = re.compile(r"Created adjacency matrix of shape: \((\d+), \d+\)")

        def __init__(self):
            super().__init__()
            self.train, self.eval, self.shapes = TrainLog(), EvalLog(), []

        def emit(self, record):
            self.train.emit(record)
            self.eval.emit(record)
            if m := self.SHAPE.match(record.getMessage()):
                self.shapes.append(int(m[1]))

    def run(command, data, gages, name, *extra):
        log = MeritLog()
        for logger in loggers:
            logger.addHandler(log)
        os.environ["DDR_METRICS_DIR"] = str(root / "logs" / name)
        t0 = time.perf_counter()
        try:
            code = cli.main([command, config, *merit_overrides(data, gages, root / name), *extra])
            torch.cuda.synchronize()
        finally:
            os.environ.pop("DDR_METRICS_DIR", None)
            for logger in loggers:
                logger.removeHandler(log)
        wall = time.perf_counter() - t0
        if code != 0:
            fail(f"ddr merit {command} {name}: exit {code}")
        return log, wall

    def stored(name, zarr, array):
        out = zarrlite.open_group(root / name / zarr)[array][:]
        if out.size == 0 or not np.isfinite(out).all():
            fail(f"ddr merit {name}/{zarr}: {array} {out.shape} is empty or not finite")
        return torch.as_tensor(out)

    # ---- the example: CPU against the card from one initial checkpoint ----
    data, gages = example / "data", example / "gages.csv"
    init_cfg = load_config(config, merit_overrides(data, gages, root / "init"), save_config=False)
    init = save_state(root / "init", init_cfg.name, 1, 0, build_kan(init_cfg, device="cpu").state_dict(), None,
                      arch=kan_arch(init_cfg))
    launches = {"wave_scan": 0, "reverse_scan": 0}
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    steps = {}
    for device in ("cpu", "cuda"):
        log, wall = run("train", data, gages, f"example-train-{device}", f"device={device}",
                        f"experiment.checkpoint={init}")
        steps[device] = log.train.steps
        print(f"ddr merit example train {device}: steps {[(e, b) for e, b, *_ in log.train.steps]}, losses "
              f"{[s[2] for s in log.train.steps]}, step host ms {[s[3] for s in log.train.steps]}, engine "
              f"{sorted({s[4] for s in log.train.steps})}, routed reaches {log.shapes}, run wall {wall:.2f} s on {smi}")
    if ([s[:2] for s in steps["cpu"]] != [s[:2] for s in steps["cuda"]] or len(steps["cuda"]) != MERIT_STEPS
            or not np.all(np.isfinite([s[2] for s in steps["cuda"]]))):
        fail(f"ddr merit example train: the CPU ran {steps['cpu']}, the card {steps['cuda']}")
    for (epoch, mb, ref, *_), (*_, got, _, _) in zip(steps["cpu"], steps["cuda"]):
        rel = abs(got - ref) / abs(ref)
        print(f"ddr merit example train parity epoch {epoch} mini-batch {mb}: card {got!r} cpu {ref!r} rel {rel:.3e}")
        if rel > DDR_TRAIN_RTOL:
            fail(f"ddr merit example train: epoch {epoch} mini-batch {mb} loss rel {rel:.3e} > {DDR_TRAIN_RTOL}")
    card_ckpt = latest_checkpoint(root / "example-train-cuda" / "saved_models")
    if card_ckpt is None:
        fail("ddr merit example train: the card run left no checkpoint")
    for command, zarr, array in (("test", "model_test.zarr", "predictions"), ("route", "chrout.zarr", "discharge")):
        out = {}
        for device in ("cpu", "cuda"):
            log, wall = run(command, data, gages, f"example-{command}-{device}", f"device={device}",
                            f"experiment.checkpoint={card_ckpt}")
            out[device] = stored(f"example-{command}-{device}", zarr, array)
            print(f"ddr merit example {command} {device}: {len(log.eval.chunks)} chunks, {zarr} {array} "
                  f"{tuple(out[device].shape)}, run wall {wall:.2f} s")
        compare(out["cpu"], out["cuda"], f"ddr merit example {command}, card against CPU")
    # the un-routed baseline: ddr summed-q-prime on the CPU and the card, then ddr benchmark reading it
    sqp = {}
    for device in ("cpu", "cuda"):
        sqp[device] = summed_q_prime(root, config, merit_overrides(data, gages, root / f"example-sqp-{device}"),
                                     f"example {device}", f"device={device}")
    rel = float(np.max(np.abs(sqp["cuda"] - sqp["cpu"]) / np.abs(sqp["cpu"])))
    print(f"ddr summed-q-prime example: predictions {sqp['cuda'].shape}, card against CPU max rel {rel:.3e} "
          f"(limit {SQP_RTOL:g})")
    if rel > SQP_RTOL:
        fail(f"ddr summed-q-prime example: card against CPU max rel {rel:.3e} > {SQP_RTOL}")
    sqp_benchmark(root, config, merit_overrides(data, gages, root / "example-bench"),
                  root / "example-sqp-cuda" / "summed_q_prime.zarr", "example", smi, "mode=testing",
                  f"experiment.checkpoint={card_ckpt}")
    launches["wave_scan"] += wave_scan_tm.launches
    launches["reverse_scan"] += reverse_scan_tm.launches

    # ---- the regional width: a MERIT-format table of 65,536 reaches ----
    regional = root / "regional"
    rdata = regional / "data"
    rdata.mkdir(parents=True)
    t0 = time.perf_counter()
    table = regional_merit_table(regional)
    t_table = time.perf_counter() - t0
    t0 = time.perf_counter()
    fp = read_flowpaths(regional / "flowpaths.csv")
    build_merit_adjacency(fp, rdata / "merit_conus_adjacency.zarr")
    t_conus = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_gauge_adjacencies(fp, rdata / "merit_conus_adjacency.zarr",
                            validate_gages(regional / "gages.csv", gauge_type=MERITGauge),
                            rdata / "merit_gages_adjacency.zarr")
    t_gauges = time.perf_counter() - t0
    t0 = time.perf_counter()
    comids = fp["COMID"].tolist()
    rng = np.random.default_rng(7)
    write_attribute_store(rdata / "attributes.zarr", comids, {
        name: rng.normal(loc=5.0, scale=2.0, size=len(comids)).astype(np.float32) for name in prep.ATTRS})
    qr = prep.lateral_inflows(rng, len(comids))
    write_hydro_store(rdata / "streamflow.zarr", comids, prep.START_DATE, "D", {"Qr": qr},
                      units={"Qr": "m3 s-1"})
    pos = {c: i for i, c in enumerate(comids)}
    subsets = zarrlite.open_group(rdata / "merit_gages_adjacency.zarr")
    staids = sorted(subsets.keys())
    obs = np.stack([qr[[pos[int(c)] for c in subsets[g]["order"].read()]].sum(axis=0) * rng.uniform(0.9, 1.1)
                    for g in staids]).astype(np.float32)
    write_hydro_store(rdata / "observations.zarr", staids, prep.START_DATE, "D", {"streamflow": obs},
                      id_dim="gage_id", units={"streamflow": "m3 s-1"})
    t_forcing = time.perf_counter() - t0
    sizes = [len(subsets[g]["order"].read()) for g in staids]
    print(f"ddr merit regional table: {table['n']} reaches, {table['outlets']} outlets joined into one, depth "
          f"{table['depth']} (make_basin's {DEPTH}), fan-in at most {table['fan_in']}, gauges {staids} over "
          f"{sizes} reaches; built in {t_table:.2f} s (table) + {t_conus:.2f} s (conus adjacency) + "
          f"{t_gauges:.2f} s (8 gauge subsets) + {t_forcing:.2f} s (attributes, {qr.shape} inflow, "
          f"observations) on the host")
    if sizes[0] != N_SEGMENTS or len(staids) != MERIT_GAUGES:
        fail(f"ddr merit regional: gauge subsets {dict(zip(staids, sizes))}")

    torch.cuda.reset_peak_memory_stats()
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    gages = regional / "gages.csv"
    log, wall = run("train", rdata, gages, "regional-train", f"experiment.batch_size={MERIT_BATCH}")
    train_launches = {"wave_scan": wave_scan_tm.launches, "reverse_scan": reverse_scan_tm.launches}
    n_steps = len(log.train.steps)
    print(f"ddr merit regional train: {n_steps} steps {[(e, b) for e, b, *_ in log.train.steps]}, routed reaches "
          f"per step {log.shapes}, losses {[s[2] for s in log.train.steps]}, step host ms "
          f"{[s[3] for s in log.train.steps]}, engine {sorted({s[4] for s in log.train.steps})}, launches "
          f"{train_launches}, run wall {wall:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {smi}")
    if (n_steps != MERIT_STEPS or log.shapes != [N_SEGMENTS] * n_steps
            or not np.all(np.isfinite([s[2] for s in log.train.steps]))
            or train_launches != {"wave_scan": n_steps, "reverse_scan": n_steps}):
        fail(f"ddr merit regional train: {n_steps} steps over {log.shapes} reaches, launches {train_launches}")
    run_log_split(root / "logs" / "regional-train", "train", smi)

    # the streamflow reader's whole-variable read, alone and within one batch's forcing
    cfg = load_config(config, [*merit_overrides(rdata, gages, root / "regional-select"), "mode=training",
                               f"experiment.batch_size={MERIT_BATCH}"], save_config=False)
    dataset = Merit(cfg)
    batch = dataset.collate_fn([dataset[i] for i in range(len(dataset))])
    reader = StreamflowReader(cfg)
    rows = np.arange(len(batch.divide_ids))
    days = batch.dates.numerical_time_range - reader.store.time_offset_days
    select_ms, forward_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        reader.store.select("Qr", rows, days)
        select_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        q = reader(routing_dataclass=batch)
        forward_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"ddr merit regional forcing: HydroStore.select of {len(rows)} x {len(days)} from Qr {qr.shape} "
          f"({qr.nbytes / 1e6:.1f} MB read whole) host ms {[round(t, 1) for t in select_ms]}, the batch's "
          f"StreamflowReader {q.shape} host ms {[round(t, 1) for t in forward_ms]}")

    ckpt = latest_checkpoint(root / "regional-train" / "saved_models")
    wave_scan_tm.launches = wave_scan_tm.q_init_launches = reverse_scan_tm.launches = 0
    log, wall = run("test", rdata, gages, "regional-test", f"experiment.batch_size={MERIT_BATCH}",
                    f"experiment.checkpoint={ckpt}")
    chunks = len(log.eval.chunks)
    test_launches = {"wave_scan": wave_scan_tm.launches, "q_init": wave_scan_tm.q_init_launches,
                     "reverse_scan": reverse_scan_tm.launches}
    ms = [c[1] for c in log.eval.chunks]
    preds = stored("regional-test", "model_test.zarr", "predictions")
    print(f"ddr merit regional test: {chunks} chunks of {sorted({c[2] for c in log.eval.chunks})} h over "
          f"{log.shapes[:1]} reaches, launches {test_launches}, chunk host ms median {np.median(ms):.2f} min "
          f"{min(ms):.2f} max {max(ms):.2f}, predictions {tuple(preds.shape)}, run wall {wall:.2f} s on {smi}")
    if chunks < 2 or test_launches != {"wave_scan": chunks, "q_init": chunks - 1, "reverse_scan": 0}:
        fail(f"ddr merit regional test: {chunks} chunks, launches {test_launches}")
    run_log_split(root / "logs" / "regional-test", "test", smi)
    if tuple(preds.shape) != (MERIT_GAUGES, 180):
        fail(f"ddr merit regional test: predictions {tuple(preds.shape)}")
    launches["wave_scan"] += train_launches["wave_scan"] + test_launches["wave_scan"]
    launches["reverse_scan"] += train_launches["reverse_scan"]

    regional_sqp = summed_q_prime(root, config, merit_overrides(rdata, gages, root / "regional-sqp"), "regional")
    if regional_sqp.shape != (MERIT_GAUGES, 182):
        fail(f"ddr summed-q-prime regional: predictions {regional_sqp.shape}")
    wave_scan_tm.launches = wave_scan_tm.q_init_launches = 0
    chunks = sqp_benchmark(root, config, merit_overrides(rdata, gages, root / "regional-bench"),
                           root / "regional-sqp" / "summed_q_prime.zarr", "regional", smi, "mode=testing",
                           *REGIONAL_SHORT_WINDOW, f"experiment.batch_size={MERIT_BATCH}",
                           f"experiment.checkpoint={ckpt}")
    if (wave_scan_tm.launches, wave_scan_tm.q_init_launches) != (chunks, chunks - 1):
        fail(f"ddr benchmark regional: {chunks} chunks, launches {wave_scan_tm.launches}/"
             f"{wave_scan_tm.q_init_launches}")
    launches["wave_scan"] += wave_scan_tm.launches
    return launches


def summed_q_prime(root: Path, config: str, overrides: list[str], label: str, *extra: str):
    """``ddr summed-q-prime`` through the port's CLI, timed; returns its
    stored daily predictions ``(G, D)``."""
    import numpy as np

    from ddr_tpu_torch import cli
    from ddr_tpu_torch.io import zarrlite

    save = Path(next(o for o in overrides if o.startswith("params.save_path=")).split("=", 1)[1])
    t0 = time.perf_counter()
    code = cli.main(["summed-q-prime", config, *overrides, *extra])
    wall = time.perf_counter() - t0
    if code != 0:
        fail(f"ddr summed-q-prime {label}: exit {code}")
    group = zarrlite.open_group(save / "summed_q_prime.zarr")
    preds = group["predictions"][:]
    summary = json.loads((save / "summed_q_prime_summary.json").read_text())
    if preds.size == 0 or not np.isfinite(preds).all():
        fail(f"ddr summed-q-prime {label}: predictions {preds.shape} empty or not finite")
    print(f"ddr summed-q-prime {label}: gauges {group.attrs['gage_ids']}, predictions {preds.shape}, NSE median "
          f"{summary['nse']['median']:.4f}, KGE median {summary['kge']['median']:.4f}, eval_q_prime through the "
          f"CLI {wall:.3f} s of wall")
    return preds


def sqp_benchmark(root: Path, config: str, overrides: list[str], store: Path, label: str, smi: str,
                  *extra: str) -> int:
    """``ddr benchmark`` with ``summed_q_prime: store`` through the port's
    CLI on the card: prints the ΣQ' battery beside MC's and LTI's and the
    two mass balances; returns the evaluation's chunk count."""
    import numpy as np

    from ddr_tpu_torch import cli
    from ddr_tpu_torch.benchmarks import benchmark as bench

    captured, lines = {}, []

    class MassLog(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("Mass balance") or msg.startswith("Summed Q'"):
                lines.append(msg)

    original = bench.benchmark
    bench.benchmark = lambda cfg: captured.setdefault("results", original(cfg))
    logger, handler, chunks = logging.getLogger(bench.__name__), MassLog(), EvalLog()
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    common = logging.getLogger("ddr_tpu_torch.scripts.common")
    common.addHandler(chunks)
    t0 = time.perf_counter()
    try:
        code = cli.main(["benchmark", config, *overrides, f"summed_q_prime={store}", *extra])
    finally:
        bench.benchmark = original
        logger.removeHandler(handler)
        common.removeHandler(chunks)
    wall = time.perf_counter() - t0
    results = captured.get("results", {})
    if code != 0 or sorted(results) != ["lti", "mc", "summed_q_prime"] or len(lines) != 3:
        fail(f"ddr benchmark {label} with a ΣQ' store: exit {code}, batteries {sorted(results)}, log {lines}")
    battery = {name: {m: round(float(np.nanmedian(getattr(r, m))), 4) for m in ("nse", "kge", "pbias")}
               for name, r in results.items()}
    print(f"ddr benchmark {label} with its ΣQ' store: medians {json.dumps(battery)}; {'; '.join(lines)}; "
          f"{len(chunks.chunks)} chunks, run wall {wall:.2f} s on {smi}")
    return len(chunks.chunks)


def write_hydrofabric(root: Path, down, length_m, slope, gauges: dict, seed: int) -> dict:
    """Write ``root/hydrofabric.gpkg`` (sqlite, as a Lynker hydrofabric v2.2
    GeoPackage lays it out) for the reaches of ``down`` (each reach's
    downstream reach, -1 at an outlet) and ``root/gages.csv`` for
    ``gauges`` (STAID -> reach). Waterbody ids are ``wb-{id}`` with ids in no
    topological order; every flowpath drains into the nexus ``nex-{id}`` of
    its downstream waterbody, an outlet into a terminal nexus whose ``toid``
    is NULL. ``flowpath-attributes-ml`` holds ``Length_m`` and ``So`` from
    the arguments and ``TopWdth``, ``ChSlp`` and ``MusX`` drawn from
    ``seed``. Returns the waterbody ids and each reach's upstream reach count."""
    import csv
    import sqlite3

    import numpy as np

    rng = np.random.default_rng(seed)
    n = len(down)
    ids = 2_000_001 + rng.permutation(n)
    area = np.ones(n, dtype=np.int64)
    order = []  # upstream before downstream
    indeg = np.bincount(down[down >= 0], minlength=n)
    ready = list(np.flatnonzero(indeg == 0))
    while ready:
        i = ready.pop()
        order.append(i)
        if down[i] >= 0:
            area[down[i]] += area[i]
            indeg[down[i]] -= 1
            if indeg[down[i]] == 0:
                ready.append(down[i])
    if len(order) != n:
        fail("hydrofabric: the topology has a cycle")
    hl = {reach: staid for staid, reach in gauges.items()}
    toid = [f"nex-{ids[down[i]]}" if down[i] >= 0 else f"nex-{9_000_000 + i}" for i in range(n)]
    flowpaths = [(f"wb-{ids[i]}", toid[i], float(LYNKER_SQKM_PER_REACH * area[i])) for i in range(n)]
    receivers = sorted(set(int(d) for d in down if d >= 0))
    network = [(f"wb-{ids[i]}", toid[i], f"gages-{hl[i]}" if i in hl else None) for i in range(n)]
    network += [(f"nex-{ids[r]}", f"wb-{ids[r]}", None) for r in receivers]
    network += [(f"nex-{9_000_000 + i}", None, None) for i in range(n) if down[i] < 0]
    attrs = [(f"wb-{ids[i]}", float(length_m[i]), float(slope[i]), float(rng.uniform(3.0, 60.0)),
              float(rng.uniform(0.5, 4.0)), float(rng.uniform(0.1, 0.45))) for i in range(n)]
    path = root / "hydrofabric.gpkg"
    with sqlite3.connect(path) as conn:
        conn.execute('CREATE TABLE flowpaths ("id" TEXT, "toid" TEXT, "tot_drainage_areasqkm" REAL)')
        conn.executemany("INSERT INTO flowpaths VALUES (?, ?, ?)", flowpaths)
        conn.execute('CREATE TABLE network ("id" TEXT, "toid" TEXT, "hl_uri" TEXT)')
        conn.executemany("INSERT INTO network VALUES (?, ?, ?)", network)
        conn.execute('CREATE TABLE "flowpath-attributes-ml" ("id" TEXT, "Length_m" REAL, "So" REAL, '
                     '"TopWdth" REAL, "ChSlp" REAL, "MusX" REAL)')
        conn.executemany('INSERT INTO "flowpath-attributes-ml" VALUES (?, ?, ?, ?, ?, ?)', attrs)
    with (root / "gages.csv").open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["STAID", "STANAME", "DRAIN_SQKM", "LAT_GAGE", "LNG_GAGE"])
        for staid, reach in gauges.items():
            w.writerow([staid, f"gauge {staid}", f"{LYNKER_SQKM_PER_REACH * area[reach]:.1f}", 40.0, -75.0])
    return {"ids": ids, "area": area}


def lynker_overrides(data: Path, gages: Path, save: Path) -> list[str]:
    """The MERIT example config turned into a Lynker run: the geodataset, the
    stores ``lynker_cli`` and :func:`lynker_forcing` wrote under ``data``, no
    drainage-area filter (the gauge table has no ABS_DIFF), and the run
    directory."""
    return ["geodataset=lynker_hydrofabric", "experiment.max_area_diff_sqkm=null",
            f"data_sources.attributes={data / 'attributes.zarr'}",
            f"data_sources.conus_adjacency={data / 'hydrofabric_v2.2_conus_adjacency.zarr'}",
            f"data_sources.gages_adjacency={data / 'hydrofabric_v2.2_gages_conus_adjacency.zarr'}",
            f"data_sources.streamflow={data / 'streamflow.zarr'}",
            f"data_sources.observations={data / 'observations.zarr'}",
            f"data_sources.gages={gages}", f"data_sources.statistics={save / 'stats'}",
            f"params.save_path={save}"]


def lynker_forcing(data: Path, ids, seed: int) -> tuple:
    """The attribute, streamflow and observation stores of a Lynker basin
    under ``data``, keyed ``cat-{id}``: the MERIT example's 8 attributes and
    400 days of daily inflow drawn as it draws them, and each gauge's
    observations the inflow summed over its subset, with noise. Returns the
    inflow's shape and each gauge's subset size."""
    import numpy as np

    from ddr_tpu_torch.io import zarrlite
    from ddr_tpu_torch.io.stores import write_attribute_store, write_hydro_store
    from ddr_tpu_torch.scripts import prepare_merit_example as prep

    rng = np.random.default_rng(seed)
    cats = [f"cat-{i}" for i in ids]
    write_attribute_store(data / "attributes.zarr", cats, {
        name: rng.normal(loc=5.0, scale=2.0, size=len(cats)).astype(np.float32) for name in prep.ATTRS})
    qr = prep.lateral_inflows(rng, len(cats))
    write_hydro_store(data / "streamflow.zarr", cats, prep.START_DATE, "D", {"Qr": qr}, units={"Qr": "m3 s-1"})
    pos = {int(i): k for k, i in enumerate(ids)}
    subsets = zarrlite.open_group(data / "hydrofabric_v2.2_gages_conus_adjacency.zarr")
    staids = sorted(subsets.keys())
    members = [[pos[int(w)] for w in subsets[g]["order"].read()] for g in staids]
    obs = np.stack([qr[m].sum(axis=0) * rng.uniform(0.9, 1.1) for m in members]).astype(np.float32)
    write_hydro_store(data / "observations.zarr", staids, prep.START_DATE, "D", {"streamflow": obs},
                      id_dim="gage_id", units={"streamflow": "m3 s-1"})
    return qr.shape, dict(zip(staids, (len(m) for m in members)))


def build_lynker_stores(gpkg: Path, data: Path, gages: Path) -> dict:
    """``python -m ddr_tpu_torch.engine.lynker_cli gpkg --path data --gages
    gages`` in-process, with the host seconds of each part of the build: the
    table reads, the matrix (the wb->nex->wb assembly and its topological
    sort), the flowpath attributes, the wb->nex->wb collapse of the gauge
    subsets and the subsets themselves."""
    from ddr_tpu_torch.engine import lynker, lynker_cli

    seconds: dict[str, float] = {}

    def timed_call(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    patched = [(lynker, "read_gpkg_table"), (lynker_cli, "read_gpkg_table"), (lynker, "create_matrix"),
               (lynker, "write_flowpath_attributes"), (lynker, "preprocess_river_network"),
               (lynker_cli, "build_gauge_adjacencies")]
    names = {"read_gpkg_table": "table read", "create_matrix": "matrix",
             "write_flowpath_attributes": "attributes", "preprocess_river_network": "collapse",
             "build_gauge_adjacencies": "gauge subsets"}
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr in patched]
    for mod, attr, fn in originals:
        setattr(mod, attr, timed_call(names[attr], fn))
    t0 = time.perf_counter()
    try:
        code = lynker_cli.main([str(gpkg), "--path", str(data), "--gages", str(gages)])
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    seconds["total"] = time.perf_counter() - t0
    if code != 0:
        fail(f"lynker_cli {gpkg}: exit {code}")
    # the gauge subsets' time includes their collapse; the attributes' includes their table reads
    seconds["gauge subsets"] -= seconds.get("collapse", 0.0)
    return {k: round(v, 3) for k, v in seconds.items()}


def run_log_split(log_dir: Path, cmd: str, smi: str) -> dict | None:
    """The wall-clock split of one command's run log
    (``run_log.<cmd>.jsonl``): its steps' phases (``summarize_phases``) and
    the steps' loop wall against the run's, or its evaluation chunks'
    seconds against the run's; prints it and returns it."""
    from ddr_tpu_torch.observability.phases import summarize_phases

    path = log_dir / f"run_log.{cmd}.jsonl"
    if not path.exists():
        fail(f"{cmd}: no run log at {path}")
    events = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    if events[0]["event"] != "run_start" or events[-1]["event"] != "run_end" or events[-1]["status"] != "ok":
        fail(f"{path}: run log from {events[0]['event']} to {events[-1]['event']} "
             f"({events[-1].get('status')})")
    wall = float(events[-1]["duration_s"])
    steps = [e for e in events if e["event"] == "step"]
    chunks = [e for e in events if e["event"] == "eval"]
    out = {"wall_s": wall, "events": events[-1]["summary"]["events"]}
    if steps:
        split = summarize_phases(steps)
        loop = sum(float(e["loop_s"]) for e in steps)
        main = {k: split[k]["seconds"] for k in ("device_step", "eval", "checkpoint") if k in split}
        ahead = {k: split[k]["seconds"] for k in ("data_load", "host_prep") if k in split}
        in_loop = loop - sum(main.values())
        out.update(loop_s=loop, main=main, ahead=ahead, untimed_s=wall - loop + in_loop)
        print(f"run log {cmd} ({path.parent.name}): wall {wall:.3f} s; {len(steps)} steps' loop {loop:.3f} s "
              f"({100 * loop / wall:.1f}%): main thread {json.dumps({k: round(v, 3) for k, v in main.items()})}, "
              f"{in_loop:.3f} s of the loop waiting on the prefetch pool or untimed; prefetch thread "
              f"(overlapping) {json.dumps({k: round(v, 3) for k, v in ahead.items()})}; outside the loop "
              f"{wall - loop:.3f} s ({100 * (wall - loop) / wall:.1f}%: config, dataset, KAN, the run's "
              f"end); untimed in all {100 * out['untimed_s'] / wall:.1f}% of wall; busy share "
              f"{split.get('_overlap', {}).get('busy_frac')} on {smi}")
    elif chunks:
        timed = sum(float(e["seconds"]) for e in chunks)
        out.update(chunks_s=timed, untimed_s=wall - timed)
        print(f"run log {cmd} ({path.parent.name}): wall {wall:.3f} s; {len(chunks)} chunks' eval events "
              f"{timed:.3f} s ({100 * timed / wall:.1f}%), untimed {wall - timed:.3f} s "
              f"({100 * (wall - timed) / wall:.1f}%: the inflow read before each chunk, the dataset, the KAN, "
              f"the store writes) on {smi}")
    else:
        print(f"run log {cmd} ({path.parent.name}): wall {wall:.3f} s, events {out['events']}")
    return out


def ddr_lynker(smi, dev) -> dict:
    """Phase 23: the Lynker hydrofabric path (see the module docstring).
    Returns the launch counts of its card runs (the parity launches apart)."""
    import os

    import numpy as np
    import torch

    from ddr_tpu_torch import cli
    from ddr_tpu_torch.geodatazoo.lynker import LynkerHydrofabric
    from ddr_tpu_torch.io import zarrlite
    from ddr_tpu_torch.routing.mc import Bounds, reach_physics
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, prepare_batch
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm, reverse_scan_tm_reference
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm, wave_scan_tm_reference
    from ddr_tpu_torch.scripts import train as train_script
    from ddr_tpu_torch.scripts.common import build_kan, kan_arch, load_kan
    from ddr_tpu_torch.training import latest_checkpoint, save_state
    from ddr_tpu_torch.validation.configs import load_config

    here = Path(__file__).resolve().parent
    root = here / "build" / "ddr_lynker"
    shutil.rmtree(root, ignore_errors=True)
    config = str(here / MERIT_EXAMPLE / "config.yaml")
    loggers = [logging.getLogger(name) for name in (
        train_script.__name__, "ddr_tpu_torch.scripts.common", "ddr_tpu_torch.scripts.router")]
    for logger in loggers:
        logger.setLevel(logging.INFO)

    def run(command, data, name, *extra):
        log = TrainLog(), EvalLog()
        for logger in loggers:
            for h in log:
                logger.addHandler(h)
        os.environ["DDR_METRICS_DIR"] = str(root / "logs" / name)
        t0 = time.perf_counter()
        try:
            code = cli.main([command, config, *lynker_overrides(data, data.parent / "gages.csv", root / name),
                             *extra])
            torch.cuda.synchronize()
        finally:
            os.environ.pop("DDR_METRICS_DIR", None)
            for logger in loggers:
                for h in log:
                    logger.removeHandler(h)
        wall = time.perf_counter() - t0
        if code != 0:
            fail(f"ddr lynker {command} {name}: exit {code}")
        return log[0], log[1], wall

    def stored(name, zarr, array):
        out = zarrlite.open_group(root / name / zarr)[array][:]
        if out.size == 0 or not np.isfinite(out).all():
            fail(f"ddr lynker {name}/{zarr}: {array} {out.shape} is empty or not finite")
        return torch.as_tensor(out)

    # ---- the small basin: 12 flowpaths, 2 gauges, CPU against the card ----
    small = root / "small"
    (small / "data").mkdir(parents=True)
    down = np.asarray([2, 2, 4, 4, 8, 7, 7, 8, 10, 10, -1, 9])
    rng = np.random.default_rng(3)
    fab = write_hydrofabric(small, down, rng.uniform(800.0, 4000.0, len(down)), rng.uniform(1e-3, 0.02, len(down)),
                            {"01300004": 4, "01300010": 10}, seed=5)
    proc = subprocess.run([sys.executable, "-m", "ddr_tpu_torch.engine.lynker_cli", str(small / "hydrofabric.gpkg"),
                           "--path", str(small / "data"), "--gages", str(small / "gages.csv")],
                          capture_output=True, text=True, timeout=300, cwd=here)
    if proc.returncode != 0:
        fail(f"python -m ddr_tpu_torch.engine.lynker_cli: exit {proc.returncode}: {proc.stderr[-2000:]}")
    shape, sizes = lynker_forcing(small / "data", fab["ids"], seed=6)
    init_cfg = load_config(config, lynker_overrides(small / "data", small / "gages.csv", root / "init"),
                           save_config=False)
    init = save_state(root / "init", init_cfg.name, 1, 0, build_kan(init_cfg, device="cpu").state_dict(), None,
                      arch=kan_arch(init_cfg))
    launches = {"wave_scan": 0, "reverse_scan": 0}
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    steps = {}
    for device in ("cpu", "cuda"):
        train_log, _, wall = run("train", small / "data", f"small-train-{device}", f"device={device}",
                                 f"experiment.checkpoint={init}")
        steps[device] = train_log.steps
        print(f"ddr lynker small train {device}: gauge subsets {sizes}, steps "
              f"{[(e, b) for e, b, *_ in train_log.steps]}, losses {[s[2] for s in train_log.steps]}, step host "
              f"ms {[s[3] for s in train_log.steps]}, engine {sorted({s[4] for s in train_log.steps})}, run wall "
              f"{wall:.2f} s on {smi}")
    if ([s[:2] for s in steps["cpu"]] != [s[:2] for s in steps["cuda"]] or len(steps["cuda"]) != MERIT_STEPS
            or not np.all(np.isfinite([s[2] for s in steps["cuda"]]))):
        fail(f"ddr lynker small train: the CPU ran {steps['cpu']}, the card {steps['cuda']}")
    for (epoch, mb, ref, *_), (*_, got, _, _) in zip(steps["cpu"], steps["cuda"]):
        rel = abs(got - ref) / abs(ref)
        print(f"ddr lynker small train parity epoch {epoch} mini-batch {mb}: card {got!r} cpu {ref!r} rel {rel:.3e}")
        if rel > DDR_TRAIN_RTOL:
            fail(f"ddr lynker small train: epoch {epoch} mini-batch {mb} loss rel {rel:.3e} > {DDR_TRAIN_RTOL}")
    card_ckpt = latest_checkpoint(root / "small-train-cuda" / "saved_models")
    for command, zarr, array in (("test", "model_test.zarr", "predictions"), ("route", "chrout.zarr", "discharge")):
        out = {}
        for device in ("cpu", "cuda"):
            _, eval_log, wall = run(command, small / "data", f"small-{command}-{device}", f"device={device}",
                                    f"experiment.checkpoint={card_ckpt}")
            out[device] = stored(f"small-{command}-{device}", zarr, array)
            print(f"ddr lynker small {command} {device}: {len(eval_log.chunks)} chunks, {zarr} {array} "
                  f"{tuple(out[device].shape)}, run wall {wall:.2f} s")
        compare(out["cpu"], out["cuda"], f"ddr lynker small {command}, card against CPU")
    launches["wave_scan"] += wave_scan_tm.launches
    launches["reverse_scan"] += reverse_scan_tm.launches

    # ---- the regional width: make_basin's topology as a hydrofabric ----
    regional = root / "regional"
    (regional / "data").mkdir(parents=True)
    t0 = time.perf_counter()
    topo = regional_topology()
    gauges = [topo["main"]] + topo["rest"][: LYNKER_GAUGES - 1]
    fab = write_hydrofabric(regional, topo["down"], topo["rd"].length, topo["rd"].slope,
                            {f"0{9200000 + k}": g for k, g in enumerate(gauges)}, seed=8)
    t_gpkg = time.perf_counter() - t0
    split = build_lynker_stores(regional / "hydrofabric.gpkg", regional / "data", regional / "gages.csv")
    t0 = time.perf_counter()
    shape, sizes = lynker_forcing(regional / "data", fab["ids"], seed=9)
    t_forcing = time.perf_counter() - t0
    conus = zarrlite.open_group(regional / "data" / "hydrofabric_v2.2_conus_adjacency.zarr")
    x_store = conus["muskingum_x"].read()
    print(f"ddr lynker regional hydrofabric: {topo['n']} flowpaths ({topo['outlets']} outlets joined into one, "
          f"depth {topo['depth']}), gauges {sizes}; GeoPackage written in {t_gpkg:.2f} s; lynker_cli build "
          f"{json.dumps(split)} s; attributes, {shape} inflow and observations {t_forcing:.2f} s, on the host; "
          f"MusX {len(np.unique(x_store))} distinct values in [{x_store.min():.3f}, {x_store.max():.3f}]")
    if (sorted(sizes.values())[-1] != N_SEGMENTS or len(sizes) != LYNKER_GAUGES
            or int(conus.attrs["shape"][0]) != N_SEGMENTS):
        fail(f"ddr lynker regional: conus {conus.attrs['shape']}, gauge subsets {sizes}")

    torch.cuda.reset_peak_memory_stats()
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    train_log, _, wall = run("train", regional / "data", "regional-train", f"experiment.batch_size={LYNKER_GAUGES}")
    train_launches = {"wave_scan": wave_scan_tm.launches, "reverse_scan": reverse_scan_tm.launches}
    n_steps = len(train_log.steps)
    print(f"ddr lynker regional train: {n_steps} steps {[(e, b) for e, b, *_ in train_log.steps]}, losses "
          f"{[s[2] for s in train_log.steps]}, step host ms {[s[3] for s in train_log.steps]}, engine "
          f"{sorted({s[4] for s in train_log.steps})}, launches {train_launches}, run wall {wall:.2f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {smi}")
    if (n_steps != MERIT_STEPS or not np.all(np.isfinite([s[2] for s in train_log.steps]))
            or train_launches != {"wave_scan": n_steps, "reverse_scan": n_steps}):
        fail(f"ddr lynker regional train: {n_steps} steps, launches {train_launches}")
    run_log_split(root / "logs" / "regional-train", "train", smi)

    ckpt = latest_checkpoint(root / "regional-train" / "saved_models")
    wave_scan_tm.launches = wave_scan_tm.q_init_launches = reverse_scan_tm.launches = 0
    _, eval_log, wall = run("test", regional / "data", "regional-test", *REGIONAL_SHORT_WINDOW,
                            f"experiment.batch_size={LYNKER_GAUGES}", f"experiment.checkpoint={ckpt}")
    chunks = len(eval_log.chunks)
    test_launches = {"wave_scan": wave_scan_tm.launches, "q_init": wave_scan_tm.q_init_launches,
                     "reverse_scan": reverse_scan_tm.launches}
    ms = [c[1] for c in eval_log.chunks]
    preds = stored("regional-test", "model_test.zarr", "predictions")
    print(f"ddr lynker regional test: {chunks} chunks of {sorted({c[2] for c in eval_log.chunks})} h, launches "
          f"{test_launches}, chunk host ms median {np.median(ms):.2f} min {min(ms):.2f} max {max(ms):.2f}, "
          f"predictions {tuple(preds.shape)}, run wall {wall:.2f} s on {smi}")
    if chunks < 2 or test_launches != {"wave_scan": chunks, "q_init": chunks - 1, "reverse_scan": 0}:
        fail(f"ddr lynker regional test: {chunks} chunks, launches {test_launches}")
    run_log_split(root / "logs" / "regional-test", "test", smi)
    launches["wave_scan"] += train_launches["wave_scan"] + test_launches["wave_scan"]
    launches["reverse_scan"] += train_launches["reverse_scan"]

    # ---- both kernels on the Lynker network, per-reach x from MusX, against their plain versions ----
    cfg = load_config(config, [*lynker_overrides(regional / "data", regional / "gages.csv", root / "parity"),
                               "mode=training", f"experiment.batch_size={LYNKER_GAUGES}"], save_config=False)
    dataset = LynkerHydrofabric(cfg)
    rd = dataset.collate_fn([dataset[i] for i in range(len(dataset))])
    p = cfg.params
    net, ch, _ = prepare_batch(rd, p.attribute_minimums["slope"], device=dev)
    cfg.experiment.checkpoint = ckpt
    kan = load_kan(cfg, purpose="the kernels' parity")
    with torch.no_grad():
        params = denormalize_spatial_parameters(kan(torch.as_tensor(rd.normalized_spatial_attributes, device=dev)),
                                                p.parameter_ranges, p.log_space_parameters, p.defaults, net.n)
        phys = reach_physics(net, ch, params, Bounds.from_config(p.attribute_minimums))
        x_live = len(torch.unique(ch.x_storage))
        T = len(rd.dates.batch_hourly_time_range)
        errs = {}
        for label, with_init in (("hotstart", False), ("q_init", True)):
            q, qi = scan_case(net, phys, 1, T, 31, with_init, dev)
            raw = wave_scan_tm(q, net, phys, qi)
            torch.cuda.synchronize()
            errs[f"wave_scan/{label}"] = compare(wave_scan_tm_reference(q, net, phys, qi), raw,
                                                 f"wave_scan on the Lynker network ({label}, T {T})")
        rev = reverse_inputs(net, 1, T, 37, dev)
        lam = reverse_scan_tm(*rev, net)
        torch.cuda.synchronize()
        errs["reverse_scan"] = compare(reverse_scan_tm_reference(*rev, net), lam,
                                       f"reverse_scan on the Lynker network (T {T})")
    print(f"ddr lynker kernels: n {net.n}, depth {net.depth}, {x_live} distinct per-reach x from MusX, "
          f"max abs err {json.dumps({k: float(v) for k, v in errs.items()})}")
    if x_live < net.n // 2:
        fail(f"ddr lynker: only {x_live} distinct Muskingum x over {net.n} reaches")
    launches["err"] = errs
    return launches


def fleet_workers(routers: set[str]) -> list[int]:
    """Pids of the ``ddr_tpu_torch.cli serve`` workers launched by one of
    ``routers`` (each worker's ``DDR_FLEET_ROUTER``, ``local:<pid of the
    process that launched it>``): this phase's own, never another run's."""
    wanted = {f"DDR_FLEET_ROUTER={r}".encode() for r in routers}
    pids = []
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit():
            continue
        try:
            argv = (proc / "cmdline").read_bytes().split(b"\0")
            env = (proc / "environ").read_bytes().split(b"\0")
        except OSError:
            continue
        if b"ddr_tpu_torch.cli" in argv and b"serve" in argv and wanted.intersection(env):
            pids.append(int(proc.name))
    return pids


def card_memory_used_mib() -> int:
    """``nvidia-smi --query-gpu=memory.used``: the card's memory in use, MiB."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return int(out.strip().splitlines()[0])


def ddr_fleet(smi, dev) -> int:
    """Phase 24: the replica tier at the regional width (see the module
    docstring), from phase 18's newest checkpoint. Returns the phase's
    main-path ``wave_scan`` launches in this process (``ddr loadtest
    --fleet``'s and the canary's; not the reference service's nor the
    one-service load test's, which are there to compare); the workers'
    batches are read from their ``/metrics`` and printed apart."""
    import contextlib
    import io
    import os
    import signal
    import threading
    import urllib.request

    import numpy as np
    import torch

    from ddr_tpu_torch.fleet.canary import CanaryController
    from ddr_tpu_torch.fleet.config import FleetConfig
    from ddr_tpu_torch.fleet.group import ReplicaGroup
    from ddr_tpu_torch.observability.registry import MetricsRegistry, set_registry
    from ddr_tpu_torch.routing.mc import route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts import fleet, loadtest
    from ddr_tpu_torch.scripts.common import build_kan, kan_arch, parse_cli
    from ddr_tpu_torch.scripts.serve import build_service
    from ddr_tpu_torch.serving.client import HttpForecastClient
    from ddr_tpu_torch.serving.config import PRIORITIES, ServeConfig
    from ddr_tpu_torch.training import latest_checkpoint, load_state

    here = Path(__file__).resolve().parent / "build"
    root = here / "ddr_fleet"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    regional = latest_checkpoint(here / "ddr_train" / "regional" / "saved_models")
    if regional is None:
        fail("ddr fleet: phase 18 left no checkpoint")
    width = [DDR_TRAIN_CONFIG, f"synthetic_segments={N_SEGMENTS}", f"synthetic_depth={DEPTH}",
             f"experiment.checkpoint={regional}"]
    serve_env = {"DDR_SERVE_MAX_BATCH": str(MAX_BATCH), "DDR_SERVE_HORIZON_HOURS": str(HORIZON),
                 "DDR_SERVE_DEADLINE_MS": "600000"}
    main_launches = 0
    group = None
    cli_proc = None
    svc = None
    routers = {f"local:{os.getpid()}"}  # whoever launched a worker of this phase
    try:
        # ---- 1. boot a subprocess group of 2 `ddr serve` workers ----
        group = ReplicaGroup(
            FleetConfig.from_env(replicas=DDR_FLEET_REPLICAS, mode="subprocess", group="p24",
                                 probe_s=DDR_FLEET_PROBE_S),
            serve_args=[*width, f"params.save_path={root / 'group'}"], workdir=root / "group",
            boot_timeout=600.0, client_timeout=600.0, extra_env=serve_env)
        ready_s: dict[int, float] = {}
        booting = threading.Event()

        def watch_ready(t_start):  # each worker's seconds from launch to /readyz 200
            while booting.is_set() and len(ready_s) < DDR_FLEET_REPLICAS:
                for i, port in list(group._ports.items()):
                    if i in ready_s:
                        continue
                    try:
                        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
                            if r.status == 200:
                                ready_s[i] = time.perf_counter() - t_start
                    except OSError:
                        pass
                time.sleep(0.05)

        used_before = card_memory_used_mib()
        booting.set()
        t0 = time.perf_counter()
        watcher = threading.Thread(target=watch_ready, args=(t0,), daemon=True)
        watcher.start()
        group.boot()
        boot_s = time.perf_counter() - t0
        booting.clear()
        watcher.join(10)
        # nvidia-smi on the card's machine shows every process as pid 1 of
        # another namespace, so a worker's own share of the card is read from
        # its boot log (the card it serves on, what it reserved there), and
        # the card's used memory must have risen by at least their sum
        used_after = card_memory_used_mib()
        print(f"ddr fleet boot: {DDR_FLEET_REPLICAS} subprocess workers ready in {boot_s:.2f} s; seconds from "
              f"launch to /readyz 200 by replica {dict(sorted(ready_s.items()))}; worker pids {group.pids()}; card "
              f"memory used {used_before} MiB before the boot, {used_after} MiB after, on {smi}")
        router = group.router
        urls = [r.url for r in group.replicas]
        reserved_gb = 0.0
        for i, replica in enumerate(group.replicas):
            stats = replica.stats()
            log_text = (root / "group" / f"replica_{i}_boot1.out").read_text()
            seen = re.search(r"serving on (cuda\S* \([^)]*\)), (\S+) GB of device memory reserved", log_text)
            print(f"ddr fleet replica {i} ({urls[i]}): /v1/stats fleet {stats['fleet']}; boot log: serving on "
                  f"{seen[1] if seen else None}, {seen[2] if seen else None} GB reserved")
            want = {"group": "p24", "replica": i, "router": f"local:{os.getpid()}"}
            if stats["fleet"] != want or seen is None or float(seen[2]) <= 0:
                fail(f"ddr fleet: replica {i} fleet {stats['fleet']} (want {want}), boot log device {seen}")
            reserved_gb += float(seen[2])
        if (used_after - used_before) * 2**20 < reserved_gb * 1e9:
            fail(f"ddr fleet: the card's used memory rose {used_after - used_before} MiB over the boot, less than "
                 f"the {reserved_gb:.3f} GB its workers report reserved")

        # ---- 2. traffic: 32 forecasts through the router from 8 threads, then the same direct ----
        set_registry(MetricsRegistry(const_labels={"host": 0}))
        cfg = parse_cli([*width, f"params.save_path={root / 'reference'}"], mode="testing")
        svc = build_service(cfg, ServeConfig(max_batch=MAX_BATCH, horizon_hours=HORIZON, deadline_s=600.0),
                            watch=False)
        entry = svc.networks()["default"]
        n_windows = len(entry.forcing) - HORIZON + 1
        starts = np.linspace(0, n_windows - 1, DDR_FLEET_REQUESTS).astype(int)
        requests = [{"t0": int(t), "gauges": [[0, 2], [1, 3], None][i % 3], "priority": PRIORITIES[i % 3],
                     "request_id": f"p24-{i}"} for i, t in enumerate(starts)]

        def fan_out(send):
            results = {}
            go = threading.Barrier(DDR_FLEET_THREADS)

            def worker(k):
                go.wait()
                for i in range(k, len(requests), DDR_FLEET_THREADS):
                    t_req = time.perf_counter()
                    results[i] = (send(requests[i]), time.perf_counter() - t_req)

            threads = [threading.Thread(target=worker, args=(k,)) for k in range(DDR_FLEET_THREADS)]
            t_all = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            if len(results) != len(requests):
                fail(f"ddr fleet: {len(results)} of {len(requests)} requests answered")
            return [results[i] for i in range(len(requests))], time.perf_counter() - t_all

        routed, routed_s = fan_out(lambda r: group.forecast(network="default", **r))
        direct_client = HttpForecastClient(urls[0], timeout=600)
        direct, direct_s = fan_out(lambda r: direct_client.forecast("default", **r))
        status = router.status()
        worst = 0.0
        for i, ((a, _), (d, _)) in enumerate(zip(routed, direct)):
            ref = svc.forecast(network="default", timeout=600, t0=requests[i]["t0"], gauges=requests[i]["gauges"])
            for label, got in (("routed", a), ("direct", d)):
                if got["request_id"] != requests[i]["request_id"] or not np.array_equal(got["runoff"], ref["runoff"]):
                    fail(f"ddr fleet: {label} request {i} differs from the in-process service by "
                         f"{float(np.abs(got['runoff'] - ref['runoff']).max())!r}")
                worst = max(worst, float(np.abs(got["runoff"].astype(np.float64) - ref["runoff"]).max()))
        p = cfg.params
        mid = len(starts) // 2
        w, mid_gauges = int(starts[mid]), requests[mid]["gauges"]
        with torch.no_grad():
            kan = svc.registry.get("default").kan
            phys_params = denormalize_spatial_parameters(kan(entry.attrs), p.parameter_ranges,
                                                         p.log_space_parameters, p.defaults, entry.n_segments)
            q = torch.as_tensor(entry.forcing[w : w + HORIZON], device=dev)
            q = q * entry.flow_scale if entry.flow_scale is not None else q
            expect = route(entry.network, entry.channels, phys_params, q, gauges=entry.gauge_index,
                           bounds=svc.bounds, kernel="reference", device=dev).runoff
        expect = expect if mid_gauges is None else expect[:, mid_gauges]
        compare(expect.cpu(), torch.as_tensor(routed[mid][0]["runoff"]),
                f"ddr fleet routed t0={w} against the plain scan (wave_scan_tm_reference)")
        dispatched = {r["name"]: r["dispatched"] for r in status["replicas"]}
        batches = {}
        for i, url in enumerate(urls):
            m = scrape(url)
            batches[f"p24-r{i}"] = metric_sum(m, "ddr_batches_total")
        print(f"ddr fleet traffic: {len(requests)} requests from {DDR_FLEET_THREADS} threads through the router "
              f"in {routed_s:.2f} s, dispatched {dispatched}; each replica's batches from /metrics (its "
              f"wave_scan launches past the observation route and warmup) {batches}; every answer equal bit for "
              f"bit to the in-process service (largest difference {worst!r}), one held to the plain scan, on {smi}")
        print(f"ddr fleet latency: through the router {percentiles([s for _, s in routed])} ({routed_s:.2f} s for "
              f"all); the same requests direct to replica 0 {percentiles([s for _, s in direct])} ({direct_s:.2f} s)")
        if min(dispatched.values()) < 1 or status["unroutable_errors"]:
            fail(f"ddr fleet: dispatched {dispatched}, unroutable {status['unroutable_errors']}")

        # ---- 3. one E = 8 ensemble through HttpReplica, and the same request direct ----
        ens_kw = {"t0": int(starts[3]), "members": DDR_ENSEMBLE_MEMBERS[0], "percentiles": [10, 50, 90], "seed": 3}
        ens = group.ensemble(network="default", request_id="p24-ens", **ens_kw)
        ens_direct = HttpForecastClient(urls[1], timeout=600).forecast(
            "default", t0=ens_kw["t0"], request_id="p24-ens",
            ensemble={"members": ens_kw["members"], "percentiles": ens_kw["percentiles"], "seed": ens_kw["seed"]})
        if ens["members"] != 8 or ens["runoff"].shape != (3, HORIZON, entry.n_outputs) or not (
                np.array_equal(ens["runoff"], ens_direct["runoff"]) and np.array_equal(ens["mean"], ens_direct["mean"])):
            fail(f"ddr fleet: the routed ensemble {ens['runoff'].shape} differs from the same request direct")
        print(f"ddr fleet ensemble: E = 8 through HttpReplica equal bit for bit to the same request sent direct to "
              f"replica 1 (bands {ens['runoff'].shape}, execute_s {ens['execute_s']})")

        # ---- 4. SIGKILL replica 1 under load; ejection, reroute, federation, readmission ----
        before = {r["name"]: r["dispatched"] for r in router.status()["replicas"]}
        stop = threading.Event()
        answered, errors = [], []

        def load(k):
            i = k
            while not stop.is_set():
                r = requests[i % len(requests)]
                try:
                    group.forecast(network="default", t0=r["t0"], gauges=r["gauges"])
                    answered.append(i)
                except Exception as e:  # counted: the phase fails on any
                    errors.append(repr(e))
                i += DDR_FLEET_THREADS

        threads = [threading.Thread(target=load, args=(k,)) for k in range(DDR_FLEET_THREADS)]
        for th in threads:
            th.start()
        time.sleep(1.0)
        t_kill = time.perf_counter()
        group.kill_replica(1)
        while not router.status()["replicas"][1]["ejected"]:
            if time.perf_counter() - t_kill > 60:
                fail("ddr fleet: replica 1 not ejected within 60 s of its SIGKILL")
            time.sleep(0.005)
        eject_s = time.perf_counter() - t_kill
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(600)
        status = router.status()
        after = {r["name"]: r["dispatched"] for r in status["replicas"]}
        attempts = sum(after.values()) - sum(before.values())
        rerouted = attempts - len(answered) - len(errors)
        fed = urllib.request.urlopen(urls[0] + "/metrics?federated=1", timeout=60).read().decode()
        up = {label: int(v) for label, v in re.findall(r'^ddr_federate_up\{replica="([^"]+)"\} (\d)', fed, re.M)}
        print(f"ddr fleet kill: replica 1 SIGKILLed under {DDR_FLEET_THREADS} sending threads, ejected "
              f"{eject_s:.3f} s later; {len(answered)} requests answered during the drill, {rerouted} rerouted, "
              f"{len(errors)} errors, unroutable_errors {status['unroutable_errors']}; federated scrape of replica "
              f"0: ddr_federate_up {up}")
        if errors or status["unroutable_errors"] or up != {"p24-r0": 1, "p24-r1": 0, "self": 1}:
            fail(f"ddr fleet kill: errors {errors[:3]}, unroutable {status['unroutable_errors']}, up {up}")
        t_restart = time.perf_counter()
        group.restart_replica(1)
        while "p24-r1" not in router.healthy():
            if time.perf_counter() - t_restart > 600:
                fail("ddr fleet: replica 1 not readmitted within 600 s of its restart")
            time.sleep(0.05)
        readmit_s = time.perf_counter() - t_restart
        r1_before = router.status()["replicas"][1]["dispatched"]
        fan_out(lambda r: group.forecast(network="default", **r))
        r1_after = router.status()["replicas"][1]["dispatched"]
        print(f"ddr fleet restart: replica 1 readmitted {readmit_s:.2f} s after restart_replica; dispatched "
              f"{r1_after - r1_before} of the next {len(requests)} requests")
        if r1_after <= r1_before:
            fail("ddr fleet: the readmitted replica was not dispatched again")
        batches = {f"p24-r{i}": metric_sum(scrape(url), "ddr_batches_total") for i, url in enumerate(urls)}
        print(f"ddr fleet: each replica's batches at the end (replica 1 counts since its restart): {batches}")
        group.close()
        group = None

        # ---- 5. `ddr fleet up` through the CLI, `fleet status`, SIGINT ----
        env = {**os.environ, **serve_env, "DDR_FLEET_PROBE_MS": str(int(DDR_FLEET_PROBE_S * 1e3))}
        up_log = root / "cli" / "fleet_up.log"
        up_log.parent.mkdir(parents=True)
        t0 = time.perf_counter()
        with up_log.open("w") as fh:
            cli_proc = subprocess.Popen(
                [sys.executable, "-m", "ddr_tpu_torch.cli", "fleet", "up", *width,
                 f"params.save_path={root / 'cli' / 'run'}", "--replicas", str(DDR_FLEET_REPLICAS), "--group",
                 "p24cli", "--out", str(root / "cli")], stdout=fh, stderr=subprocess.STDOUT, env=env,
                cwd=Path(__file__).resolve().parent)
        routers.add(f"local:{cli_proc.pid}")
        while "federation: DDR_FEDERATE_REPLICAS=" not in up_log.read_text():
            if cli_proc.poll() is not None or time.perf_counter() - t0 > 600:
                fail(f"ddr fleet up: no replica table (rc {cli_proc.poll()}): {up_log.read_text()[-2000:]}")
            time.sleep(0.1)
        table = [line for line in up_log.read_text().splitlines() if "p24cli-r" in line and " up " in line]
        cli_urls = [line.split()[-1] for line in table]
        print(f"ddr fleet up: the replica table {time.perf_counter() - t0:.2f} s after launch:")
        print("\n".join(table))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = fleet.main(["status", "--url", cli_urls[-1]])
        print(f"ddr fleet status --url {cli_urls[-1]}: exit {code}: {out.getvalue().strip()}")
        if code != 0 or "group 'p24cli' replica 1" not in out.getvalue() or len(cli_urls) != DDR_FLEET_REPLICAS:
            fail(f"ddr fleet status: exit {code}, {out.getvalue()!r}, table {table}")
        cli_proc.send_signal(signal.SIGINT)
        code = cli_proc.wait(timeout=120)
        cli_proc = None
        left = fleet_workers(routers)
        print(f"ddr fleet up: SIGINT -> exit {code}, serve workers left {left}")
        if code != 0 or left:
            fail(f"ddr fleet up: exit {code}, workers left {left}: {up_log.read_text()[-2000:]}")

        # ---- 6. ddr loadtest --fleet 2 in-process, beside one service on the same basin ----
        # the one service through `ddr loadtest`'s main; the group through the
        # calls its main makes for --fleet, so that its router can be read
        argv = ["--synthetic", "--n", str(N_SEGMENTS), "--horizon", str(HORIZON), "--rps",
                str(DDR_LOADTEST_INPROCESS_RATE), "--duration", str(DDR_LOADTEST_SECONDS), "--out",
                str(root / "loadtest")]
        reports = {}
        set_registry(MetricsRegistry(const_labels={"host": 0}))
        wave_scan_tm.launches = 0
        reports["single"] = run_command(loadtest.main, [*argv, "--label", "single"], "ddr loadtest --synthetic")
        print(loadtest_line(f"--synthetic (one service) {DDR_LOADTEST_INPROCESS_RATE:g}/s", reports["single"],
                            wave_scan_tm.launches, smi))
        set_registry(MetricsRegistry(const_labels={"host": 0}))
        args = loadtest.build_parser().parse_args([*argv, "--fleet", str(DDR_FLEET_REPLICAS)])
        lt_group = loadtest.fleet_group(args, [], root / "loadtest")
        try:
            lt_group.boot()
            wave_scan_tm.launches = 0
            reports["fleet"] = loadtest.run_loadtest(
                loadtest.FleetDriver(lt_group, t0_span=args.t0_span, seed=args.seed), args,
                lt_group.replicas[0].service)
            n_launch = wave_scan_tm.launches
            split = {r["name"]: r["dispatched"] for r in lt_group.router.status()["replicas"]}
        finally:
            lt_group.close()
        main_launches += n_launch
        fleet_report = reports["fleet"]
        print(loadtest_line(f"--synthetic --fleet {DDR_FLEET_REPLICAS} {DDR_LOADTEST_INPROCESS_RATE:g}/s",
                            fleet_report, n_launch, smi))
        print(f"ddr loadtest --fleet {DDR_FLEET_REPLICAS}: achieved {fleet_report['throughput_rps']}/s against one "
              f"service's {reports['single']['throughput_rps']}/s at {DDR_LOADTEST_INPROCESS_RATE:g}/s offered; "
              f"p50/p95/p99 {fleet_report['p50_ms']}/{fleet_report['p95_ms']}/{fleet_report['p99_ms']} ms against "
              f"{reports['single']['p50_ms']}/{reports['single']['p95_ms']}/{reports['single']['p99_ms']}; sheds "
              f"{fleet_report['shed']} and {reports['single']['shed']}; per-replica dispatches {split}")
        if (fleet_report["errors"] or fleet_report["ok"] < 1 or fleet_report["target"] != f"fleet:{DDR_FLEET_REPLICAS}"
                or fleet_report["device"] != torch.cuda.get_device_name(dev) or len(split) != DDR_FLEET_REPLICAS
                or min(split.values()) < 1 or main_launches < 1):
            fail(f"ddr loadtest --fleet: {fleet_report['errors']} errors, {fleet_report['ok']} ok on "
                 f"{fleet_report['device']}, split {split}, {main_launches} wave_scan launches")

        # ---- 7. the canary controller on the card: a same-weights and a perturbed candidate ----
        set_registry(MetricsRegistry(const_labels={"host": 0}))
        arch = kan_arch(cfg)
        params = load_state(regional, expected_arch=arch)["params"]
        twin = cfg.geodataset.get_dataset_class(cfg, device=dev).basin  # the served twin, its truth included
        true_params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in twin.true_params.items()}
        t_win = n_windows // 2
        with torch.no_grad():
            q = torch.as_tensor(entry.forcing[t_win : t_win + HORIZON], device=dev)
            q = q * entry.flow_scale if entry.flow_scale is not None else q
            truth = route(entry.network, entry.channels, true_params, q, gauges=entry.gauge_index,
                          bounds=svc.bounds, device=dev).runoff.cpu().numpy().astype(np.float64)

        def median_nse(model):  # what the skill tracker computes over this window
            pred = svc.forecast(network="default", model=model, t0=t_win, timeout=600)["runoff"].astype(np.float64)
            sst = ((truth - truth.mean(0)) ** 2).sum(0)
            nse = 1 - ((pred - truth) ** 2).sum(0)[sst > 0] / sst[sst > 0]
            if not nse.size:
                fail(f"ddr fleet canary: every gauge is flat over the window at t0 {t_win}")
            return float(np.median(nse))  # over the gauges with a defined NSE, as the tracker

        def register(name, shift):
            kan = build_kan(cfg)
            kan.load_state_dict({k: torch.as_tensor(np.asarray(v) + (shift if k == "output.bias" else 0.0))
                                 for k, v in params.items()})
            svc.register_model(name, kan, arch=arch)

        register("candidate", 0.0)
        stable_nse = median_nse("default")
        fleet_cfg = FleetConfig.from_env(canary_weight=DDR_CANARY_WEIGHT, canary_min_obs=DDR_CANARY_MIN_OBS,
                                         canary_margin=DDR_CANARY_MARGIN)
        margin = fleet_cfg.canary_margin
        chosen = None
        for shift in DDR_CANARY_BIAS_SHIFTS:  # the first far enough below the stable arm
            register(f"bias{shift:+g}", shift)
            worse_nse = median_nse(f"bias{shift:+g}")
            print(f"ddr fleet canary: output bias {shift:+g}: median NSE {worse_nse:.4f} against the stable arm's "
                  f"{stable_nse:.4f} over the twin's truth at t0 {t_win} (margin {margin:g})")
            if worse_nse < stable_nse - 2 * margin:
                chosen = f"bias{shift:+g}"
                break
        if chosen is None:
            fail("ddr fleet canary: no output-bias shift fell below the stable arm by twice the margin")
        for candidate, want in (("candidate", "promoted"), (chosen, "rolled-back")):
            ctl = CanaryController(svc, candidate=candidate, fleet_cfg=fleet_cfg)
            before = wave_scan_tm.launches
            i = 0
            while ctl.state not in ("promoted", "rolled-back") and i < DDR_CANARY_MAX_REQUESTS:
                ctl.handle(network="default", t0=t_win, observations=truth, request_id=f"p24-canary-{candidate}-{i}",
                           timeout=600)
                i += 1
            main_launches += wave_scan_tm.launches - before
            st = ctl.status()
            print(f"ddr fleet canary {candidate!r}: {i} requests -> {ctl.state}; transitions "
                  f"{[(t['state_from'], t['state_to'], t['reason'], t['candidate_nse'], t['stable_nse']) for t in st['transitions']]}; "
                  f"arms {json.dumps({a: {k: e[k] for k in ('observations', 'samples', 'nse_median')} for a, e in st['arms'].items()})}")
            if ctl.state != want:
                fail(f"ddr fleet canary {candidate!r}: ended {ctl.state}, want {want}")
        check_watchdog(svc, svc.stats()["queue"]["batches"], "ddr fleet reference service")
    finally:
        if group is not None:
            group.close()
        if cli_proc is not None and cli_proc.poll() is None:
            cli_proc.send_signal(signal.SIGINT)
            try:
                cli_proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                cli_proc.kill()
                cli_proc.wait()
        for pid in fleet_workers(routers):  # none of this phase's workers outlives it, whatever failed
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        if svc is not None:
            svc.close()
        set_registry(None)
    return main_launches


# `ddr metrics`, `ddr obs`, `ddr profile` and POST /v1/profile (phase 25): the
# instrumented `ddr train` is phase 18's regional run in a subprocess, whose
# exporter is scraped while it lives; `ddr profile` at the regional shape
# over 72 h, 5 timed iterations a program; a 2 s capture of a `ddr serve`
# (phase 20's config) while 8 requests are answered.
DDR_OBS_REQUESTS, DDR_OBS_CAPTURE_S, DDR_OBS_REPS = 8, 2, 5
KERNEL_NAMES = {"wave_scan": "wave_scan_tm_kernel", "reverse_scan": "reverse_scan_tm_kernel"}


def trace_names(path: Path) -> set:
    """The event names of one Chrome trace file."""
    return {str(e.get("name")) for e in json.loads(path.read_text()).get("traceEvents", [])}


def trace_breakdown(path: Path, reps: int) -> str:
    """Where one profiled program's iterations spend the card's time, from
    its Chrome trace: kernel-busy ms an iteration, the ``ddr::`` ranges on
    the card's timeline and the five costliest kernels, each in ms an
    iteration."""
    from collections import Counter

    kernels, ranges = Counter(), Counter()
    for e in json.loads(path.read_text()).get("traceEvents", []):
        if e.get("cat") == "kernel":
            kernels[str(e.get("name"))] += float(e.get("dur", 0.0))
        elif e.get("cat") == "gpu_user_annotation" and str(e.get("name")).startswith("ddr::"):
            ranges[str(e.get("name"))] += float(e.get("dur", 0.0))
    busy = sum(kernels.values()) / 1e3 / reps
    top = ", ".join(f"{n[:48]} {d / 1e3 / reps:.3f}" for n, d in kernels.most_common(5))
    rng = ", ".join(f"{n} {d / 1e3 / reps:.3f}" for n, d in sorted(ranges.items()))
    return f"kernel-busy {busy:.3f} ms/iter; ddr:: ranges [{rng}]; top kernels [{top}]"


def cli_stdout(main, argv) -> tuple[int, str]:
    """``main(argv)``'s exit code and what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


def ddr_obs(smi, dev) -> dict:
    """Phase 25: the observability plane on the card (see the module
    docstring): the instrumented ``ddr train`` in a subprocess with its
    exporter scraped while it runs, ``ddr metrics`` and ``ddr obs`` on its
    log and a server's, ``ddr profile`` at the regional shape, ``POST
    /v1/profile`` on a serving ``ddr serve``, ``ddr obs federate --once``.
    Returns the phase's launch counts of each kernel."""
    import os
    import threading
    import urllib.request

    import numpy as np
    import torch

    from ddr_tpu_torch import cli
    from ddr_tpu_torch.observability import metrics_cli, obs_cli
    from ddr_tpu_torch.observability.events import run_telemetry
    from ddr_tpu_torch.observability.registry import MetricsRegistry, set_registry
    from ddr_tpu_torch.routing.mc import Bounds, route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, prepare_batch
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts import profile as profile_script
    from ddr_tpu_torch.scripts.common import build_kan, parse_cli
    from ddr_tpu_torch.scripts.serve import build_service
    from ddr_tpu_torch.serving.client import HttpForecastClient
    from ddr_tpu_torch.serving.config import ServeConfig
    from ddr_tpu_torch.serving.http_api import serve_http
    from ddr_tpu_torch.training import latest_checkpoint

    here = Path(__file__).resolve().parent
    root = here / "build" / "ddr_obs"
    shutil.rmtree(root, ignore_errors=True)
    regional = latest_checkpoint(here / "build" / "ddr_train" / "regional" / "saved_models")
    if regional is None:
        fail("ddr obs: phase 18 left no checkpoint")
    full_size = (f"synthetic_segments={N_SEGMENTS}", f"synthetic_depth={DEPTH}")
    launches = {"wave_scan": 0, "reverse_scan": 0}

    # ---- 1. the instrumented ddr train in a subprocess, its exporter scraped live ----
    train_logs = root / "train_logs"
    env = dict(os.environ, DDR_METRICS_DIR=str(train_logs), DDR_PROM_PORT="0", DDR_HEARTBEAT_EVERY="1",
               PYTHONPATH=str(here) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    counting = ("import json, sys; from ddr_tpu_torch import cli; "
                "from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm; "
                "from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm; "
                "code = cli.main(sys.argv[1:]); "
                "print('LAUNCHES ' + json.dumps({'wave_scan': wave_scan_tm.launches, "
                "'reverse_scan': reverse_scan_tm.launches})); sys.exit(code)")
    argv = [sys.executable, "-c", counting, "train", DDR_TRAIN_CONFIG, *full_size,
            f"params.save_path={root / 'train'}"]
    log_path = train_logs / "run_log.train.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out_lines: list[str] = []
    reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout), daemon=True)
    reader.start()
    port, live = None, None
    try:
        while proc.poll() is None:
            if port is None and log_path.exists():
                for line in log_path.read_text().splitlines():
                    if '"run_start"' in line:
                        port = json.loads(line).get("prom_port")
            if port is not None:
                try:
                    m = scrape(f"http://127.0.0.1:{port}")
                except OSError:
                    m = None
                if m and metric_sum(m, "ddr_steps_total") >= 1 and metric_sum(m, "ddr_heartbeats_total") >= 1:
                    live = m
                    break
            time.sleep(0.02)
        code = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=60)
    wall = time.perf_counter() - t0
    if code != 0:
        fail(f"ddr obs: ddr train exited {code}:\n" + "".join(out_lines[-40:]))
    if live is None:
        fail(f"ddr obs: the train run's exporter (prom_port {port}) showed no step and heartbeat while it ran")
    counted = [json.loads(line.split(" ", 1)[1]) for line in out_lines if line.startswith("LAUNCHES ")]
    if not counted:
        fail("ddr obs: the train subprocess printed no launch counts")
    train_launches = counted[-1]
    events = [json.loads(line) for line in log_path.read_text().splitlines() if line.strip()]
    kinds = [e["event"] for e in events]
    steps, beats = kinds.count("step"), kinds.count("heartbeat")
    skills, drifts = kinds.count("skill"), kinds.count("drift")
    end = events[-1]
    epochs = len({e["epoch"] for e in events if e["event"] == "step"})
    print(f"ddr obs train: wall {wall:.2f} s (subprocess), exporter on port {port} scraped live: "
          f"ddr_steps_total {metric_sum(live, 'ddr_steps_total'):g}, ddr_heartbeats_total "
          f"{metric_sum(live, 'ddr_heartbeats_total'):g}, ddr_prefetch_depth "
          f"{metric_sum(live, 'ddr_prefetch_depth'):g}; log: {steps} steps, "
          f"{beats} heartbeats, {skills} skill, {drifts} drift over {epochs} epochs; launches {train_launches}, "
          f"on {smi}")
    if (steps != DDR_TRAIN_STEPS or beats != steps or skills != steps or drifts != epochs
            or train_launches != {"wave_scan": steps + 1, "reverse_scan": steps}):
        fail(f"ddr obs train: {steps} steps, {beats} heartbeats, {skills} skill, {drifts} drift, "
             f"launches {train_launches}")
    missing = {"drift", "skill", "pipeline", "sentinel"} - set(end.get("summary", {}))
    if end["event"] != "run_end" or end["status"] != "ok" or missing:
        fail(f"ddr obs train: run_end {end['event']} {end.get('status')}, rollups missing {missing}")
    print(f"ddr obs train run_end: pipeline verdict {end['summary']['pipeline'].get('verdict')}, skill "
          f"median NSE {end['summary']['skill'].get('nse', {}).get('median')}, drift "
          f"observations {end['summary']['drift']['observations']}, sentinel episodes "
          f"{end['summary']['sentinel']['episodes']}")
    for k in launches:
        launches[k] += train_launches[k]

    # ---- 2. a ddr serve: POST /v1/profile while 8 requests are answered; federation ----
    serve_logs = root / "serve_logs"
    os.environ["DDR_METRICS_DIR"] = str(serve_logs)
    set_registry(MetricsRegistry(const_labels={"host": 0}))
    cfg = parse_cli([DDR_TRAIN_CONFIG, *full_size, f"params.save_path={root / 'serve'}",
                     f"experiment.checkpoint={regional}"], mode="testing")
    serve_cfg = ServeConfig.from_env(max_batch=MAX_BATCH, horizon_hours=HORIZON, deadline_s=600.0)
    wave_scan_tm.launches = 0
    try:
        with run_telemetry(cfg, "serve"):
            svc = build_service(cfg, serve_cfg, watch=False)
            server = serve_http(svc, port=0)
            client = HttpForecastClient(server.url, timeout=900)
            try:
                def post(path):
                    req = urllib.request.Request(server.url + path, data=b"{}", method="POST",
                                                 headers={"Content-Type": "application/json"})
                    try:
                        with urllib.request.urlopen(req, timeout=60) as resp:
                            return resp.status, json.loads(resp.read())
                    except urllib.error.HTTPError as e:
                        return e.code, json.loads(e.read())

                n_windows = len(svc.networks()["default"].forcing) - HORIZON + 1
                starts = np.linspace(0, n_windows - 1, DDR_OBS_REQUESTS).astype(int)
                capture_launches = wave_scan_tm.launches
                first = post(f"/v1/profile?seconds={DDR_OBS_CAPTURE_S}")
                t_cap = time.perf_counter()
                second = post(f"/v1/profile?seconds={DDR_OBS_CAPTURE_S}")
                zero = post("/v1/profile?seconds=0")
                answers = [None] * DDR_OBS_REQUESTS

                def ask(i):
                    answers[i] = client.forecast("default", t0=int(starts[i]))

                threads = [threading.Thread(target=ask, args=(i,)) for i in range(DDR_OBS_REQUESTS)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                in_capture = time.perf_counter() - t_cap
                capture_launches = wave_scan_tm.launches - capture_launches
                print(f"ddr obs POST /v1/profile?seconds={DDR_OBS_CAPTURE_S}: {first[0]} {first[1]}; a second "
                      f"during the capture {second[0]} ({second[1].get('error')}); seconds=0 {zero[0]}; "
                      f"{DDR_OBS_REQUESTS} requests answered {in_capture:.2f} s into the capture with "
                      f"{capture_launches} wave_scan launches, on {smi}")
                if first[0] != 202 or second[0] != 409 or zero[0] != 400 or None in answers:
                    fail(f"ddr obs profile: answers {first[0]}, {second[0]}, {zero[0]}, "
                         f"{sum(a is not None for a in answers)} forecasts")
                if in_capture >= DDR_OBS_CAPTURE_S:
                    fail(f"ddr obs profile: the requests took {in_capture:.2f} s, past the "
                         f"{DDR_OBS_CAPTURE_S} s capture")
                trace_dir = Path(first[1]["trace_dir"])
                deadline = time.monotonic() + 120
                traces = []
                while not traces and time.monotonic() < deadline:
                    time.sleep(0.25)
                    traces = sorted(trace_dir.glob("capture_*.json"))
                if not traces:
                    fail(f"ddr obs profile: no capture written under {trace_dir}")
                names = trace_names(traces[-1])
                kernels_seen = sorted(k for k, v in KERNEL_NAMES.items() if any(v in n for n in names))
                ranges = sorted(n for n in names if n.startswith("ddr::"))
                n_wave = sum(1 for e in json.loads(traces[-1].read_text())["traceEvents"]
                             if KERNEL_NAMES["wave_scan"] in str(e.get("name")) and e.get("cat") == "kernel")
                print(f"ddr obs capture {traces[-1].name}: {traces[-1].stat().st_size / 1e6:.2f} MB, "
                      f"{n_wave} {KERNEL_NAMES['wave_scan']} launches (kernel slices), ddr:: ranges "
                      f"{ranges or 'none (torch.profiler records CPU ranges on its own thread only)'}")
                if "wave_scan" not in kernels_seen or n_wave < 1:
                    fail(f"ddr obs profile: the capture names no {KERNEL_NAMES['wave_scan']} launch")
                stats = client._get("/v1/stats")[1]
                if stats.get("sentinel") is None:
                    fail("ddr obs: /v1/stats has no sentinel slice")
                print(f"ddr obs /v1/stats sentinel: scope {stats['sentinel']['scope']}, signals "
                      f"{sorted(stats['sentinel']['signals'])}, episodes {stats['sentinel']['episodes']}")
                code, fed = cli_stdout(obs_cli.main, ["federate", "--once", "--replicas", f"r0={server.url}"])
                if code != 0 or 'replica="r0"' not in fed or "ddr_requests_total" not in fed:
                    fail(f"ddr obs federate --once: exit {code}, {len(fed)} bytes without replica labels")
                print(f"ddr obs federate --once: {len(fed.splitlines())} lines, "
                      f"{fed.count('replica=' + chr(34) + 'r0' + chr(34))} series of replica r0")
            finally:
                server.shutdown()
                server.server_close()
                svc.close()
    finally:
        os.environ.pop("DDR_METRICS_DIR", None)
    launches["wave_scan"] += wave_scan_tm.launches

    # ---- 3. ddr metrics and ddr obs bottleneck on both logs ----
    for label, path, cmd in (("train", log_path, "train"), ("serve", serve_logs / "run_log.serve.jsonl", "serve")):
        evs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
        n_steps = sum(e["event"] == "step" for e in evs)
        code, text = cli_stdout(cli.main, ["metrics", "summarize", str(path)])
        m = re.search(r"^steps\s*:\s*(\d+)", text, re.M)
        if code != 0 or (n_steps and (m is None or int(m[1]) != n_steps)):
            fail(f"ddr metrics summarize {label}: exit {code}, steps {m and m[1]} against {n_steps}")
        code_t, tail = cli_stdout(cli.main, ["metrics", "tail", str(path), "-n", "5"])
        out = root / f"{label}.trace.json"
        code_p, _ = cli_stdout(cli.main, ["metrics", "trace", str(path), "--out", str(out)])
        slices = [e for e in json.loads(out.read_text())["traceEvents"] if e.get("ph") == "X"]
        step_slices = [e for e in slices if str(e.get("name")).startswith("step")]
        if code_t != 0 or len(tail.strip().splitlines()) != 5 or code_p != 0 or len(step_slices) < n_steps:
            fail(f"ddr metrics {label}: tail exit {code_t} ({len(tail.splitlines())} lines), trace exit "
                 f"{code_p} ({len(step_slices)} step slices for {n_steps} steps)")
        print(f"ddr metrics {label}: summarize {len(text.splitlines())} lines ({n_steps} steps), tail -n 5 "
              f"ok, trace {len(slices)} slices ({len(step_slices)} steps)")
    code, verdict = cli_stdout(cli.main, ["obs", "bottleneck", str(log_path)])
    if code != 0 or "verdict" not in verdict:
        fail(f"ddr obs bottleneck: exit {code}: {verdict}")
    print("ddr obs bottleneck (train): " + " | ".join(line.strip() for line in verdict.splitlines() if line.strip()))

    # ---- 4. ddr profile at the regional shape, then its forward route against the plain scan ----
    prof_dir = root / "profile"
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    t0 = time.perf_counter()
    code, md = cli_stdout(cli.main, ["profile", "--synthetic", "--n", str(N_SEGMENTS), "--t-hours", str(HORIZON),
                                     "--depth", str(DEPTH), "--reps", str(DDR_OBS_REPS), "--trace",
                                     "--out", str(prof_dir)])
    prof_s = time.perf_counter() - t0
    prof_launches = {"wave_scan": wave_scan_tm.launches, "reverse_scan": reverse_scan_tm.launches}
    if code != 0:
        fail(f"ddr profile: exit {code}")
    report = json.loads((prof_dir / "profile_report.json").read_text())
    runs = 1 + DDR_OBS_REPS  # the warm call and the timed iterations
    want = {"wave_scan": 3 * runs + 1, "reverse_scan": 2 * runs}  # +1: the twin's observation route
    print(f"ddr profile: {prof_s:.2f} s, kernel {report['kernel']}, device {report['device']}, n {report['n']}, "
          f"T {report['t_hours']} h, depth {report['depth']}, launches {prof_launches} (want {want}), on {smi}")
    if report["kernel"] != "cuda" or prof_launches != want:
        fail(f"ddr profile: kernel {report['kernel']}, launches {prof_launches}, want {want}")
    for name in profile_script.PROGRAMS:
        rec = report["programs"][name]
        peak = rec["card"]["peak_bytes"]
        print(f"ddr profile {name}: {rec['seconds_per_iter'] * 1e3:.3f} ms/iter, "
              f"{rec['reach_timesteps_per_sec']:,.0f} reach-timesteps/s, first call "
              f"{rec['card']['compile_seconds']:.3f} s, peak {peak / 1e9:.3f} GB, on {smi}")
        print(f"ddr profile {name} trace: "
              f"{trace_breakdown(prof_dir / 'profile_trace' / name / 'trace.json', DDR_OBS_REPS)}, on {smi}")
        names = trace_names(prof_dir / "profile_trace" / name / "trace.json")
        need = ["wave_scan"] + (["reverse_scan"] if name != "forward-route" else [])
        absent = [k for k in need if not any(KERNEL_NAMES[k] in n for n in names)]
        if absent or not np.isfinite(rec["seconds_per_iter"]) or peak is None:
            fail(f"ddr profile {name}: trace lacks {absent}, report {rec}")
    launches["wave_scan"] += prof_launches["wave_scan"]
    launches["reverse_scan"] += prof_launches["reverse_scan"]
    cfg_p, rd, q, *_ = profile_script._synthetic_problem(N_SEGMENTS, HORIZON, DEPTH, "cuda")
    p = cfg_p.params
    net, ch, gauges = prepare_batch(rd, p.attribute_minimums["slope"], device=dev)
    with torch.no_grad():
        attrs = torch.as_tensor(rd.normalized_spatial_attributes, device=dev)
        spatial = denormalize_spatial_parameters(build_kan(cfg_p, device=dev)(attrs), p.parameter_ranges,
                                                 p.log_space_parameters, p.defaults, net.n)
        q_t = torch.as_tensor(q, device=dev)
        b = Bounds.from_config(p.attribute_minimums)
        # per reach: the scan's output, kernel against plain version; at the
        # gauges an index_add_ of several reaches, whose CUDA atomics may sum
        # in any order, so held to RTOL
        got = route(net, ch, spatial, q_t, bounds=b, device=dev).runoff
        ref = route(net, ch, spatial, q_t, bounds=b, kernel="reference", device=dev).runoff
        g_got = route(net, ch, spatial, q_t, gauges=gauges, bounds=b, device=dev).runoff
        g_ref = route(net, ch, spatial, q_t, gauges=gauges, bounds=b, kernel="reference", device=dev).runoff
    diff = float((got.double() - ref.double()).abs().max())
    print(f"ddr profile forward route against the plain scan: max abs diff {diff!r} over {tuple(got.shape)} "
          f"reach-hours (bit for bit {diff == 0.0})")
    if diff != 0.0:
        fail(f"ddr profile: the forward route differs from the plain scan by {diff}")
    compare(g_ref.cpu(), g_got.cpu(), "ddr profile forward route at the gauges against the plain scan")
    return launches


# The self-healing `ddr train` and `ddr chaos` (phase 26): the drills at the
# regional width, all five at once, each `ddr chaos` in a process of its own
# (its run recorder is process-wide), while the in-process ladder drills run
# the chaos drill's config (batch 1, four mini-batches an epoch) through the
# CLI; each drill's own --timeout and --boot-timeout bound its subprocesses.
CHAOS_SEGMENTS, CHAOS_TIMEOUT, CHAOS_BOOT_TIMEOUT, CHAOS_WALL_S = 65536, 600, 300, 1200
# a drill's process patches `chaos._launch` so that each `ddr train` or
# `ddr serve` it starts prints its launch counts at exit (one SIGKILLed
# prints none), then runs `chaos.main` on its arguments
COUNTING = ("import atexit, json, sys; from ddr_tpu_torch import cli; "
            "from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm; "
            "from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm; "
            "atexit.register(lambda: print('LAUNCHES ' + json.dumps({'wave_scan': wave_scan_tm.launches, "
            "'reverse_scan': reverse_scan_tm.launches}), flush=True)); sys.exit(cli.main(sys.argv[1:]))")
DRILL = ("import subprocess, sys; from ddr_tpu_torch.scripts import chaos; counting = sys.argv[1]\n"
         "def launch(args, env, log_path):\n"
         "    with log_path.open('ab') as fh:\n"
         "        return subprocess.Popen([sys.executable, '-c', counting, *args], stdout=fh, "
         "stderr=subprocess.STDOUT, env=env)\n"
         "chaos._launch = launch\n"
         "sys.exit(chaos.main(sys.argv[2:]))")


def start_drill(root: Path, label: str, argv: list[str]) -> tuple:
    """One ``ddr chaos`` drill in a process of its own, started now."""
    cmd = [sys.executable, "-c", DRILL, COUNTING, *argv, "--label", label, "--out", str(root)]
    log = (root / f"drill_{label}.log").open("wb")
    return label, argv, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, time.time()


def finish_drill(root: Path, drill: tuple, deadline: float, smi: str) -> tuple[dict, dict]:
    """Wait for a started drill (killing it at the phase's deadline) and
    fail unless it exited 0 with ``passed: true``. Returns the report and
    the launches its subprocesses printed."""
    label, argv, proc, log, t0 = drill
    try:
        code = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    path = root / f"CHAOS_{label}.json"
    report = json.loads(path.read_text()) if path.exists() else {}
    wall = (path.stat().st_mtime if path.exists() else time.time()) - t0  # until its record was written
    if code != 0 or report.get("passed") is not True:
        tail = (root / f"drill_{label}.log").read_text(errors="replace").splitlines()[-30:]
        fail(f"ddr chaos {' '.join(argv)}: exit {code}, report {report}\n" + "\n".join(tail))
    counts = {"wave_scan": 0, "reverse_scan": 0}
    for out in root.glob(f"chaos_*_{label}/*.out"):
        for line in out.read_text(errors="replace").splitlines():
            if line.startswith("LAUNCHES "):
                for k, v in json.loads(line.split(" ", 1)[1]).items():
                    counts[k] += v
    print(f"ddr chaos {' '.join(argv)}: passed, {wall:.1f} s from its start to its end (the five drills "
          f"run at once), launches in its subprocesses that exited {counts}, on {smi}")
    return report, counts


def chaos_events(run_dir: Path, kind: str) -> list[dict]:
    path = run_dir / "run_log.train.jsonl"
    return [e for e in (json.loads(line) for line in path.read_text().splitlines() if line.strip())
            if e["event"] == kind]


def ladder_run(root: Path, name: str, env: dict, spec: str | None, smi: str) -> tuple:
    """``ddr train`` in this process through the CLI on the chaos drill's
    config, with ``env`` set and the fault plan ``spec`` installed; returns
    (exit code, run log events, the run's launches)."""
    import os

    import torch

    from ddr_tpu_torch import cli
    from ddr_tpu_torch.observability import faults
    from ddr_tpu_torch.routing.reverse_kernel import reverse_scan_tm
    from ddr_tpu_torch.routing.wave_kernel import wave_scan_tm
    from ddr_tpu_torch.scripts.chaos import _train_cfg_dict, _yaml_text

    class One:
        segments, epochs = CHAOS_SEGMENTS, 1

    run = root / name
    cfg = root / f"{name}.yaml"
    cfg.write_text(_yaml_text(_train_cfg_dict(run, None, One)))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    faults.configure(spec)
    wave_scan_tm.launches = reverse_scan_tm.launches = 0
    t0 = time.perf_counter()
    try:
        code = cli.main(["train", str(cfg)])
        torch.cuda.synchronize()
    finally:
        faults.configure(None)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    launches = {"wave_scan": wave_scan_tm.launches, "reverse_scan": reverse_scan_tm.launches}
    events = [json.loads(line) for line in (run / "run_log.train.jsonl").read_text().splitlines() if line.strip()]
    steps = [(e["epoch"], e["batch"], e["loss"], e.get("recovered")) for e in events if e["event"] == "step"]
    recs = [{k: e.get(k) for k in ("stage", "reasons", "batch", "outcome", "checkpoint", "lr_backoff") if k in e}
            for e in events if e["event"] == "recovery"]
    print(f"ladder {name}: exit {code}, steps {steps}, recovery {recs}, launches {launches}, run wall {wall:.2f} s "
          f"on {smi}")
    return code, events, launches


def ddr_chaos(smi, dev) -> dict:
    """Phase 26: the self-healing ``ddr train`` and ``ddr chaos`` on the card
    (see the module docstring). Returns the phase's launch counts."""
    import os
    import statistics

    import torch

    from ddr_tpu_torch import cli, training
    from ddr_tpu_torch.scripts import train as train_script
    from ddr_tpu_torch.validation.configs import Config, KanConfig

    here = Path(__file__).resolve().parent
    root = here / "build" / "ddr_chaos"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.cuda.empty_cache()  # the drills' processes share the card with what earlier phases cached
    launches = {"wave_scan": 0, "reverse_scan": 0}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    seg = ["--segments", str(CHAOS_SEGMENTS)]
    train_t = ["--timeout", str(CHAOS_TIMEOUT)]
    serve_t = ["--boot-timeout", str(CHAOS_BOOT_TIMEOUT)]
    deadline = time.perf_counter() + CHAOS_WALL_S
    drills = [start_drill(root, label, argv) for label, argv in (
        ("kill", ["train", *seg, "--kills", "1,2", *train_t]),
        ("term", ["train", *seg, "--signal", "term", "--kills", "1", *train_t]),
        ("storm", ["train", *seg, "--nan-storm", *train_t]),
        ("serve", ["serve", "--synthetic", *seg, "--horizon", "72", "--rps", "20", "--duration", "10",
                   "--kill-after", "3", *serve_t]),
        ("fleet", ["serve", "--synthetic", *seg, "--kill-replica", *serve_t]),
    )]
    try:
        # ---- 1. rollback and give-up, in process while the drills run ----
        on = {"DDR_RECOVERY_ENABLED": "1", "DDR_RECOVERY_MAX_SKIPS": "0"}
        code, events, counts = ladder_run(root, "rollback", on, "nan@device.step=2:n=1", smi)
        add(counts)
        rb = [e for e in events if e["event"] == "recovery"]
        last = training.load_state(training.latest_checkpoint(root / "rollback" / "saved_models"))
        lrs = [g["lr"] for g in last["opt_state"]["param_groups"]]
        if code != 0 or [e["stage"] for e in rb] != ["rollback"] or rb[0]["lr_backoff"] != 0.5 or lrs != [0.005]:
            fail(f"ladder rollback: exit {code}, recoveries {rb}, last checkpoint's learning rates {lrs}")
        print(f"ladder rollback: to {rb[0]['checkpoint']} (the pinned-good checkpoint), learning rate 0.01 -> "
              f"{lrs[0]}, on {smi}")
        code, events, counts = ladder_run(root, "giveup", {**on, "DDR_RECOVERY_MAX_ROLLBACKS": "0"},
                                          "nan@device.step=2:n=1", smi)
        add(counts)
        giveup = list((root / "giveup" / "saved_models").glob("_chaos-giveup_epoch_*_mb_*.pkl"))
        manifest = json.loads(giveup[0].with_name(giveup[0].name + ".manifest.json").read_text()) if giveup else {}
        stages = [e["stage"] for e in events if e["event"] == "recovery"]
        if code != 3 or stages != ["give-up"] or manifest.get("degraded") is not True:
            fail(f"ladder give-up: exit {code}, stages {stages}, checkpoints {giveup}, manifest {manifest}")
        print(f"ladder give-up: main returned {code}, {giveup[0].name} saved with degraded {manifest['degraded']}, "
              f"run_end status {events[-1]['status']}, on {smi}")

        # ---- 2. the bf16 reroute: the watchdog's own drift knob set to trip ----
        code, events, counts = ladder_run(root, "reroute", {
            "DDR_RECOVERY_ENABLED": "1", "DDR_TRAIN_DTYPE": "bf16", "DDR_HEALTH_MAX_ULP_DRIFT": "0",
            "DDR_RECOVERY_MAX_REROUTES": "8"}, None, smi)
        add(counts)
        rr = [e for e in events if e["event"] == "recovery"]
        drift = [round(e.get("ulp_drift"), 3) for e in events if e["event"] == "health"]
        if code != 0 or not rr or {(e["stage"], e["outcome"]) for e in rr} != {("fp32-reroute", "clean")}:
            fail(f"ladder bf16 reroute: exit {code}, recoveries {rr}")
        print(f"ladder bf16 reroute: {len(rr)} fp32-reroute, all clean; the bf16 steps' ulp drift {drift} "
              f"(DDR_HEALTH_MAX_ULP_DRIFT=0), launches {counts} (bf16 and fp32 twin), on {smi}")

        # ---- 3. the drills: kills, preemption, the nan storm, a server, a group ----
        reports = {}
        for drill in drills:
            reports[drill[0]], counts = finish_drill(root, drill, deadline, smi)
            add(counts)
    finally:
        for _, _, proc, log, _ in drills:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()

    report = reports["kill"]
    if launches["wave_scan"] < 1 or launches["reverse_scan"] < 1:
        fail(f"ddr chaos: no kernel launch counted: {launches}")
    golden = chaos_events(root / "chaos_train_kill" / "golden", "run_start")[0]
    print(f"ddr chaos train (kill): kills {report['kills']}, seconds from each kill to the resumed run's first "
          f"step {report['recoveries_s']} (the attempt killed again paced {report['pace_ms']} ms a step), resumed "
          f"from {report['resumed_from']}, loss delta {report['loss_delta']}, params delta "
          f"{report['params_max_abs_delta']} (tolerance {report['tolerance']}), {report['steps_chaos']}/"
          f"{report['steps_golden']} steps; the golden run on device {golden.get('device')!r}, on {smi}")
    report = reports["term"]
    if report["preempt_events"] != 1 or not report["resumed_from"] or "-preempt_" not in report["resumed_from"][0]:
        fail(f"ddr chaos train --signal term: preempt events {report['preempt_events']}, resumed from "
             f"{report['resumed_from']}")
    print(f"ddr chaos train (term): 1 preempt event, resumed from {report['resumed_from'][0]} "
          f"{report['recoveries_s'][0]} s after the SIGTERM, loss delta {report['loss_delta']}, params delta "
          f"{report['params_max_abs_delta']}, on {smi}")
    report = reports["storm"]
    storm = root / "chaos_train_storm" / "chaos"
    reasons = [e["reasons"] for e in chaos_events(storm, "recovery")]
    if (report["recovery_events"] != report["fault_events"] or report["data_anomalies"] != 1
            or len(reasons) != 3 or "non-finite" not in reasons[1]):
        fail(f"ddr chaos train --nan-storm: {report['fault_events']} faults, {report['recovery_events']} "
             f"recoveries {reasons}, {report['data_anomalies']} data anomalies")
    health = chaos_events(storm, "health")
    print(f"ddr chaos train (nan storm): {report['fault_events']} storms -> recoveries {report['recovery_stages']} "
          f"with reasons {reasons}, the device.step storm's health event nonfinite "
          f"{health[0].get('nonfinite') if health else None}, {report['data_anomalies']} data anomaly, params "
          f"delta {report['params_max_abs_delta']} (tolerance {report['tolerance']}), final loss "
          f"{report['final_loss']}, compile events {report['compile_events_golden']}/"
          f"{report['compile_events_chaos']} (the port writes none), on {smi}")
    report = reports["serve"]
    print(f"ddr chaos serve: {report['recovery_s']} s from the SIGKILL to /readyz 200, error rate "
          f"{report['error_rate']}, shed rate {report['shed_rate']}, {report['requests']} requests, attainment after "
          f"the restart {report['post_restart_attainment']} over {report['post_restart_requests']}, on {smi}")
    report = reports["fleet"]
    print(f"ddr chaos serve --kill-replica: ejected in {report['eject_s']} s, the survivor's federated scrape "
          f"{report['federate_up']}, readmitted {report['recovery_s']} s after the kill, error rate "
          f"{report['error_rate']}, dispatched {report['dispatched']}, attainment after the restart "
          f"{report['post_restart_attainment']}, on {smi}")

    # ---- 4. the pre-step snapshot's cost: phase 18's regional run with it, beside phase 18's own ----
    def loop_ms(run_log: Path) -> tuple[list, list]:
        steps = chaos_events(run_log, "step")
        return [round(e["seconds"] * 1e3, 3) for e in steps], [round(e["loop_s"] * 1e3, 3) for e in steps]

    logger = logging.getLogger(train_script.__name__)
    logger.setLevel(logging.INFO)
    run = root / "snapshot-on"
    os.environ["DDR_RECOVERY_ENABLED"] = "1"
    try:
        code = cli.main(["train", DDR_TRAIN_CONFIG, f"synthetic_segments={N_SEGMENTS}", f"synthetic_depth={DEPTH}",
                         f"params.save_path={run}"])
        torch.cuda.synchronize()
    finally:
        os.environ.pop("DDR_RECOVERY_ENABLED", None)
    with_it = loop_ms(run)
    without = loop_ms(here / "build" / "ddr_train" / "logs" / "regional")
    if code != 0 or len(with_it[0]) != DDR_TRAIN_STEPS:
        fail(f"snapshot cost: exit {code}, {len(with_it[0])} steps")
    print(f"snapshot cost: phase 18's regional run, step host ms {without[0]} and loop ms {without[1]} without "
          f"DDR_RECOVERY_ENABLED, {with_it[0]} and {with_it[1]} with it, on {smi}")
    # the snapshot alone: the regional KAN and its Adam state, cloned on the card
    kan = new_kan(Config(kan=KanConfig(input_var_names=[f"a{i}" for i in range(10)])), dev)
    opt = training.make_optimizer(kan.parameters(), 0.01)
    sum(v.sum() for v in kan(torch.randn(8, 10, device=dev)).values()).backward()
    opt.step()
    times = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        training.snapshot_state(kan, opt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n_bytes = sum(p.numel() * p.element_size() for p in kan.parameters()) * 3
    print(f"snapshot_state alone: median {statistics.median(times[1:]):.4f} ms (min {min(times[1:]):.4f}) for "
          f"{n_bytes} bytes of KAN weights and Adam moments, on {smi}")
    print(f"ddr chaos phase launches {launches} (drill subprocesses that exited, and the in-process runs) on {smi}")
    return launches


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


T_START = time.perf_counter()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / "ddr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (ddr_tpu_torch/ not beside the "
              "script)", file=sys.stderr)
        return 2
    # the card machine's interpreter writes no bytecode cache beside its
    # packages, so every process recompiled what it imported (~7 s of each
    # `ddr train` or `ddr serve` a phase starts): the cache goes under build/
    # for this process and its children
    import os

    pycache = str(Path(__file__).resolve().parent / "build" / "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = pycache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.dont_write_bytecode = False
    if sys.argv[1:] == ["--time-fp32"]:
        return time_fp32_only()
    only_ddr_train = sys.argv[1:] == ["--ddr-train"]
    only_ddr_cli = sys.argv[1:] == ["--ddr-cli"]
    only_ddr_serve = sys.argv[1:] == ["--ddr-serve"]
    only_ddr_loadtest = sys.argv[1:] == ["--ddr-loadtest"]
    only_ddr_merit = sys.argv[1:] == ["--ddr-merit"]
    only_ddr_lynker = sys.argv[1:] == ["--ddr-lynker"]
    only_ddr_fleet = sys.argv[1:] == ["--ddr-fleet"]
    only_ddr_obs = sys.argv[1:] == ["--ddr-obs"]
    only_ddr_chaos = sys.argv[1:] == ["--ddr-chaos"]
    only = (only_ddr_train or only_ddr_cli or only_ddr_serve or only_ddr_loadtest or only_ddr_merit
            or only_ddr_lynker or only_ddr_fleet or only_ddr_obs or only_ddr_chaos)
    old_log = None
    if len(sys.argv) == 3 and sys.argv[1] == "--old-kernels":
        old_log = sys.argv[2]
    elif sys.argv[1:] and not only:
        print("usage: chip_smoke.py [--time-fp32 | --ddr-train | --ddr-cli | --ddr-serve | --ddr-loadtest | "
              "--ddr-merit | --ddr-lynker | --ddr-fleet | --ddr-obs | --ddr-chaos | --old-kernels LOG]",
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
    if only:
        t0 = time.perf_counter()
        ddr_train(smi, dev)
        print(f"ddr train phase: {time.perf_counter() - t0:.1f}s")
        if only_ddr_cli:
            t0 = time.perf_counter()
            ddr_eval(smi, dev)
            print(f"ddr test, route, train-and-test and benchmark phase: {time.perf_counter() - t0:.1f}s")
        if only_ddr_serve:
            t0 = time.perf_counter()
            ddr_serve(smi, dev)
            print(f"ddr serve phase: {time.perf_counter() - t0:.1f}s")
        if only_ddr_loadtest:
            t0 = time.perf_counter()
            ddr_loadtest(smi, dev)
            print(f"ddr loadtest and verify phase: {time.perf_counter() - t0:.1f}s")
        if only_ddr_merit:
            t0 = time.perf_counter()
            ddr_merit(smi, dev)
            print(f"ddr merit phase: {time.perf_counter() - t0:.1f}s")
        if only_ddr_lynker:
            t0 = time.perf_counter()
            ddr_lynker(smi, dev)
            print(f"ddr lynker phase: {time.perf_counter() - t0:.1f}s")
        if only_ddr_fleet:
            t0 = time.perf_counter()
            ddr_fleet(smi, dev)
            print(f"ddr fleet phase: {time.perf_counter() - t0:.1f}s")
        if only_ddr_obs:
            t0 = time.perf_counter()
            ddr_obs(smi, dev)
            print(f"ddr obs phase: {time.perf_counter() - t0:.1f}s on {smi}")
        if only_ddr_chaos:
            t0 = time.perf_counter()
            ddr_chaos(smi, dev)
            print(f"ddr chaos phase: {time.perf_counter() - t0:.1f}s on {smi}")
        print(f"whole script: {time.perf_counter() - T_START:.1f}s on {smi}")
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

    # ---- 20. ddr serve: the HTTP front, the registry's hot-reload, the metrics ----
    t0 = time.perf_counter()
    ddr_serve_launches = ddr_serve(smi, dev)
    print(f"ddr serve phase: {time.perf_counter() - t0:.1f}s")

    # ---- 21. ddr loadtest and ddr verify: SLOs, the client, ensembles, the ledger ----
    t0 = time.perf_counter()
    ddr_loadtest_launches = ddr_loadtest(smi, dev)
    print(f"ddr loadtest and verify phase: {time.perf_counter() - t0:.1f}s")

    # ---- 22. the MERIT real-data path: store builders, readers, the merit dataset ----
    t0 = time.perf_counter()
    ddr_merit_launches = ddr_merit(smi, dev)
    print(f"ddr merit phase: {time.perf_counter() - t0:.1f}s")

    # ---- 23. the Lynker hydrofabric path: its builders, lynker_cli, the dataset ----
    t0 = time.perf_counter()
    ddr_lynker_launches = ddr_lynker(smi, dev)
    max_abs = max(max_abs, *(ddr_lynker_launches["err"][k] for k in ("wave_scan/hotstart", "wave_scan/q_init")))
    reverse_err = max(reverse_err, ddr_lynker_launches["err"]["reverse_scan"])
    print(f"ddr lynker phase: {time.perf_counter() - t0:.1f}s")

    # ---- 24. the replica tier: ddr fleet, the router, federation, the canary ----
    t0 = time.perf_counter()
    ddr_fleet_launches = ddr_fleet(smi, dev)
    print(f"ddr fleet phase: {time.perf_counter() - t0:.1f}s")

    # ---- 25. the observability plane: heartbeats, the exporter, ddr metrics, obs, profile ----
    t0 = time.perf_counter()
    ddr_obs_launches = ddr_obs(smi, dev)
    print(f"ddr obs phase: {time.perf_counter() - t0:.1f}s on {smi}")

    # ---- 26. the self-healing ddr train and ddr chaos: kills, preemption, storms, the ladder ----
    t0 = time.perf_counter()
    ddr_chaos_launches = ddr_chaos(smi, dev)
    print(f"ddr chaos phase: {time.perf_counter() - t0:.1f}s on {smi}")
    print(f"whole script: {time.perf_counter() - T_START:.1f}s on {smi}")

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
                     + ddr_eval_launches["wave_scan"] + ddr_serve_launches + ddr_loadtest_launches
                     + ddr_merit_launches["wave_scan"] + ddr_lynker_launches["wave_scan"] + ddr_fleet_launches
                     + ddr_obs_launches["wave_scan"] + ddr_chaos_launches["wave_scan"]),
        "ddr_train_launches": ddr_train_launches["wave_scan"],
        "ddr_eval_launches": ddr_eval_launches["wave_scan"],
        "ddr_serve_launches": ddr_serve_launches,
        "ddr_loadtest_launches": ddr_loadtest_launches,
        "ddr_merit_launches": ddr_merit_launches["wave_scan"],
        "ddr_lynker_launches": ddr_lynker_launches["wave_scan"],
        "ddr_fleet_launches": ddr_fleet_launches,
        "ddr_obs_launches": ddr_obs_launches["wave_scan"],
        "ddr_chaos_launches": ddr_chaos_launches["wave_scan"],
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
        "launches": (train_launches["reverse_scan"] + ddr_train_launches["reverse_scan"]
                     + ddr_merit_launches["reverse_scan"] + ddr_lynker_launches["reverse_scan"]
                     + ddr_obs_launches["reverse_scan"] + ddr_chaos_launches["reverse_scan"]),
        "ddr_train_launches": ddr_train_launches["reverse_scan"],
        "ddr_merit_launches": ddr_merit_launches["reverse_scan"],
        "ddr_lynker_launches": ddr_lynker_launches["reverse_scan"],
        "ddr_obs_launches": ddr_obs_launches["reverse_scan"],
        "ddr_chaos_launches": ddr_chaos_launches["reverse_scan"],
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
