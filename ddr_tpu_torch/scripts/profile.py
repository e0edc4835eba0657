"""``ddr profile`` on the port: per-program timing of the routing stack, the
port of ``ddr_tpu/scripts/profile.py``.

Builds the three programs a training deployment runs, for a config's first
batch or a synthetic shape: the forward route (spatial parameters and inflow
-> gauge runoff, one ``wave_scan`` launch a single-ring network), the full
VJP (the value of the gauge loss ``runoff.mean()`` and its analytic gradient
with respect to the spatial parameters: one ``wave_scan`` and one
``reverse_scan`` launch) and the complete train step (KAN -> route -> daily
masked L1 -> analytic backward -> clip + Adam). Each runs once warm, then
``--reps`` iterations are queued and timed with CUDA events and one
synchronisation (the JAX command queues its iterations and blocks once); the
report gives seconds per iteration, reach-timesteps per second and the
program's card (:class:`~ddr_tpu_torch.observability.costs.ProgramCard`:
the peak device memory of its first call, that call's wall as
``compile_seconds``, and None for XLA's analyses, which torch has no
counterpart for). It writes ``profile_report.json`` and
``profile_report.md`` with the JAX command's keys, and one ``program_card``
event a program to ``run_log.profile.jsonl`` beside them.

Usage::

    python -m ddr_tpu_torch.cli profile --synthetic [--n 2048] [--t-hours 48] [--depth D] [device=cpu]
    python -m ddr_tpu_torch.cli profile config.yaml [a.b=c ...] [--reps 5] [--out DIR] [--trace]

``--out`` defaults to ``DDR_METRICS_DIR``, else the current directory.
``--trace`` runs the timed iterations alone under ``torch.profiler`` (one
Chrome trace a program under ``<out>/profile_trace/<program>/``).
``--kernel pallas`` (the default) runs the hand-written CUDA scans, and the
report says ``kernel: "cuda"``; ``--kernel xla`` is refused, the plain scans
being for tests. Runs on the card unless the config or an override says
``device=cpu`` (then the scans' plain versions run, and the report says
``kernel: "reference"``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = ["PROGRAMS", "main", "profile_programs", "render_markdown", "run_profile"]

#: The programs a report always covers, in render order.
PROGRAMS = ("forward-route", "full-vjp", "train-step")


def _synthetic_problem(n: int, t_hours: int, depth: int | None, device: str):
    """``(cfg, rd, q_prime, obs_daily, obs_mask)`` on the synthetic twin, as
    the JAX command builds it: ``t_hours`` rounded up to whole days and at
    least 48 (the tau-trimmed daily loss needs a day past the trim), the
    basin observed through ``route`` on ``device``."""
    from ddr_tpu_torch.geodatazoo.synthetic import make_basin, observe
    from ddr_tpu_torch.validation.configs import Config

    t = max(48, -(-t_hours // 24) * 24)
    if t != t_hours:
        log.info(f"t-hours {t_hours} -> {t} (whole days >= 48 for the train step)")
    n_days = t // 24
    cfg = Config.from_dict({
        "name": "profile",
        "geodataset": "synthetic",
        "mode": "training",
        "device": device,
        "kan": {"input_var_names": [f"a{i}" for i in range(10)]},
        "experiment": {"start_time": "1981/10/01", "end_time": "1981/10/08", "rho": n_days, "warmup": 1},
        "params": {"save_path": "/tmp"},
    })
    basin = observe(
        make_basin(n_segments=n, n_gauges=min(64, max(4, n // 32)), n_days=n_days, seed=0, depth=depth),
        cfg, device=device,
    )
    obs = np.asarray(basin.obs_daily, dtype=np.float32)
    return (cfg, basin.routing_data, np.asarray(basin.q_prime[:t], dtype=np.float32), obs,
            np.ones_like(obs, dtype=bool))


def _config_problem(cfg):
    """The first training batch of a configured dataset."""
    from ddr_tpu_torch.geodatazoo.loader import DataLoader
    from ddr_tpu_torch.scripts.common import daily_observation_targets, get_flow_fn

    dataset = cfg.geodataset.get_dataset_class(cfg, device=cfg.device)
    flow = get_flow_fn(cfg, dataset)
    loader = DataLoader(dataset, batch_size=cfg.experiment.batch_size, shuffle=False)
    rd = next(iter(loader))
    q_prime = np.asarray(flow(routing_dataclass=rd), dtype=np.float32)
    if rd.flow_scale is not None:
        q_prime = q_prime * np.asarray(rd.flow_scale, dtype=np.float32)[None, :]
    obs_daily, obs_mask = daily_observation_targets(rd)
    return rd, q_prime, obs_daily, obs_mask


def _spec(t: torch.Tensor) -> str:
    """``f32[48,2048]``: the JAX cards' input spelling."""
    name = str(t.dtype).removeprefix("torch.")
    short = name.replace("float", "f").replace("uint", "u").replace("int", "i").replace("bool", "pred")
    return f"{short}[{','.join(str(d) for d in t.shape)}]"


def _first_call(call: Callable[[], Any], dev: torch.device) -> tuple[Any, float, int | None]:
    """The program's first (warm) call: its output, wall seconds and peak
    allocated device bytes (None on the CPU)."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = call()
    if cuda:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else None
    return out, seconds, peak


def _time_program(call: Callable[[], Any], reps: int, dev: torch.device) -> float:
    """Mean seconds an iteration: all ``reps`` queued between two CUDA
    events and one synchronisation on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    return (time.perf_counter() - t0) / reps


def _profiled(call: Callable[[], Any], reps: int, dev: torch.device, trace_dir: str | None) -> float:
    """:func:`_time_program`, under ``torch.profiler`` when ``trace_dir`` is given."""
    if trace_dir is None:
        return _time_program(call, reps, dev)
    from ddr_tpu_torch.observability.spans import trace

    with trace(trace_dir):
        return _time_program(call, reps, dev)


def profile_programs(
    cfg, rd, q_prime, obs_daily, obs_mask, reps: int = 5, trace_dir: str | None = None,
    kernel: str | None = None, dtype: str = "fp32", kan: torch.nn.Module | None = None,
) -> dict[str, dict[str, Any]]:
    """Card and time the three programs for one batch on ``cfg.device``.

    Returns ``{program: {"card": ProgramCard, "seconds_per_iter": s,
    "reach_timesteps_per_sec": r, "outputs": ...}}``; ``outputs`` are the
    warm call's results (the forward route's runoff; the VJP's value and
    gradients by parameter; the train step's loss and daily runoff), for
    holding the programs against a reference. ``kernel`` is ``"pallas"`` or
    None (the hand-written scans); ``kan`` replaces the config's fresh KAN.
    ``trace_dir`` profiles the timed iterations alone, one directory a
    program under it.
    """
    from ddr_tpu_torch.device import resolve_device
    from ddr_tpu_torch.observability.costs import COLLECTIVE_OPS, ProgramCard
    from ddr_tpu_torch.observability.spans import span
    from ddr_tpu_torch.routing.mc import Bounds, route
    from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, engine_label, prepare_batch
    from ddr_tpu_torch.routing.wave_kernel import validate_dtype
    from ddr_tpu_torch.scripts.common import build_kan
    from ddr_tpu_torch.training import make_batch_train_step, make_optimizer

    dev = resolve_device(cfg.device)
    label = resolve_kernel(kernel) if dev.type == "cuda" else "reference"
    validate_dtype(dtype)
    p = cfg.params
    bounds = Bounds.from_config(p.attribute_minimums)
    network, channels, gauges = prepare_batch(rd, p.attribute_minimums["slope"], device=dev)
    engine = engine_label(network)
    n, t_hours = int(rd.n_segments), int(q_prime.shape[0])
    attrs = torch.as_tensor(rd.normalized_spatial_attributes, device=dev)
    kan = build_kan(cfg, device=dev) if kan is None else kan.to(dev)
    with torch.no_grad():
        spatial = denormalize_spatial_parameters(kan(attrs), p.parameter_ranges, p.log_space_parameters,
                                                 p.defaults, n)
    spatial = {k: v.detach().contiguous() for k, v in spatial.items()}
    q_t = torch.as_tensor(q_prime, device=dev)
    obs_t, mask_t = torch.as_tensor(obs_daily, device=dev), torch.as_tensor(obs_mask, device=dev)
    platform = "gpu" if dev.type == "cuda" else "cpu"
    out: dict[str, dict[str, Any]] = {}

    def _card(name: str, inputs: list[torch.Tensor], seconds: float, peak: int | None) -> ProgramCard:
        return ProgramCard(
            name=name, engine=engine, platform=platform, kernel=label, compute_dtype=dtype,
            peak_bytes=peak, collectives={op: 0 for op in COLLECTIVE_OPS},
            input_specs=tuple(_spec(t) for t in inputs), donated=tuple(False for _ in inputs),
            compile_seconds=round(seconds, 4),
        )

    def _trace(name: str) -> str | None:
        return None if trace_dir is None else str(Path(trace_dir) / name)

    # 1. forward route: spatial parameters + inflow -> gauge runoff
    def fwd():
        with torch.no_grad():
            return route(network, channels, spatial, q_t, gauges=gauges, bounds=bounds, device=dev,
                         dtype=dtype).runoff

    with span("profile/forward-route"):
        runoff, first_s, peak = _first_call(fwd, dev)
        secs = _profiled(fwd, reps, dev, _trace("forward-route"))
    out["forward-route"] = {"card": _card("forward-route", [*spatial.values(), q_t], first_s, peak),
                            "seconds_per_iter": secs, "outputs": runoff}

    # 2. full VJP: the gauge loss and its gradient through the analytic adjoint
    def vjp():
        leaves = {k: v.clone().requires_grad_(True) for k, v in spatial.items()}
        value = route(network, channels, leaves, q_t, gauges=gauges, bounds=bounds, device=dev,
                      dtype=dtype).runoff.mean()
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
        return value.detach(), {k: (torch.zeros_like(v) if g is None else g)
                                for (k, v), g in zip(leaves.items(), grads)}

    with span("profile/full-vjp"):
        vjp_out, first_s, peak = _first_call(vjp, dev)
        secs = _profiled(vjp, reps, dev, _trace("full-vjp"))
    out["full-vjp"] = {"card": _card("full-vjp", list(spatial.values()), first_s, peak),
                       "seconds_per_iter": secs, "outputs": vjp_out}

    # 3. the complete train step, the `ddr train` path (the KAN and Adam
    # update in place, so every iteration steps on from the last)
    optimizer = make_optimizer(kan.parameters(), 1e-3)
    step = make_batch_train_step(kan, bounds, p.parameter_ranges, p.log_space_parameters, p.defaults,
                                 tau=p.tau, warmup=cfg.experiment.warmup, optimizer=optimizer, device=dev,
                                 dtype=dtype)

    def train_step():
        return step(network, channels, gauges, attrs, q_t, obs_t, mask_t)

    with span("profile/train-step"):
        step_out, first_s, peak = _first_call(train_step, dev)
        secs = _profiled(train_step, reps, dev, _trace("train-step"))
    params = [t.detach() for t in kan.parameters()]
    out["train-step"] = {"card": _card("train-step", [*params, attrs, q_t, obs_t, mask_t], first_s, peak),
                         "seconds_per_iter": secs, "outputs": step_out}

    for rec in out.values():
        rec["reach_timesteps_per_sec"] = round(n * t_hours / rec["seconds_per_iter"], 1)
        rec["seconds_per_iter"] = round(rec["seconds_per_iter"], 6)
    return out


def resolve_kernel(kernel: str | None) -> str:
    """``"pallas"`` or None -> ``"cuda"`` (the hand-written scans; their
    plain versions run for CPU tensors, as every wrapper does). ``"xla"``,
    the JAX package's plain scan, is refused: the port's plain versions are
    for tests."""
    if kernel in (None, "pallas", "cuda"):
        return "cuda"
    if kernel == "xla":
        raise ValueError("--kernel xla: the port routes through its hand-written CUDA scans; their plain "
                         "versions are for tests (use --kernel pallas, or leave --kernel out)")
    raise ValueError(f"unknown kernel {kernel!r} (want pallas)")


def _fmt_num(v: float | None, scale: float = 1.0, suffix: str = "") -> str:
    if v is None:
        return "-"
    return f"{v / scale:,.3g}{suffix}"


def render_markdown(report: dict[str, Any]) -> str:
    """The report's human half: one row a program, the JAX command's columns."""
    lines = [
        "# ddr profile report",
        "",
        f"- device: `{report['device']}`  shapes: N={report['n']} "
        f"T={report['t_hours']}h depth={report['depth']}  reps={report['reps']}",
        "",
        "| program | engine | GFLOPs | GB accessed | FLOPs/byte | peak MB | "
        "collectives | compile s | ms/iter | GFLOP/s |"
        + (" % peak |" if report.get("peak_flops") else ""),
        "|---|---|---|---|---|---|---|---|---|---|" + ("---|" if report.get("peak_flops") else ""),
    ]
    for name in PROGRAMS:
        rec = report["programs"].get(name)
        if rec is None:
            continue
        c = rec["card"]
        achieved = rec.get("achieved_flops_per_sec")
        row = (
            f"| {name} | {c.get('engine') or '-'} | {_fmt_num(c.get('flops'), 1e9)} "
            f"| {_fmt_num(c.get('bytes_accessed'), 2**30)} "
            f"| {_fmt_num(c.get('arithmetic_intensity'))} "
            f"| {_fmt_num(c.get('peak_bytes'), 2**20)} "
            f"| {c.get('n_collectives', 0)} "
            f"| {_fmt_num(c.get('compile_seconds'))} "
            f"| {_fmt_num(rec['seconds_per_iter'], 1e-3)} "
            f"| {_fmt_num(achieved, 1e9)} |"
        )
        if report.get("peak_flops"):
            row += f" {100 * achieved / report['peak_flops']:.1f}% |" if achieved else " - |"
        lines.append(row)
    lines += [
        "",
        "Reading guide: `compile s` is each program's first (warm) call, `peak MB` the device memory it "
        "allocated at its peak (torch.cuda; none on the CPU), `ms/iter` the mean of the timed iterations. "
        "The FLOP and byte columns are XLA's cost analysis in the JAX package and have no torch "
        "counterpart here.",
        "",
    ]
    return "\n".join(lines) + "\n"


def run_profile(
    cfg, rd, q_prime, obs_daily, obs_mask, reps: int, out_dir: Path, trace_dir: Path | None = None,
    peak_flops: float | None = None, depth: int | None = None, kernel: str | None = None,
    dtype: str = "fp32", kan: torch.nn.Module | None = None,
) -> dict[str, Any]:
    """Profile one batch's programs, emit their cards as events, and write
    ``profile_report.json`` and ``profile_report.md`` under ``out_dir``.
    Returns the report (the programs' ``outputs`` are left out of it)."""
    from ddr_tpu_torch.device import resolve_device
    from ddr_tpu_torch.observability.costs import emit_program_card

    dev = resolve_device(cfg.device)
    programs = profile_programs(cfg, rd, q_prime, obs_daily, obs_mask, reps,
                                trace_dir=None if trace_dir is None else str(trace_dir),
                                kernel=kernel, dtype=dtype, kan=kan)
    report: dict[str, Any] = {
        "device": "gpu" if dev.type == "cuda" else "cpu",
        "n": int(rd.n_segments),
        "t_hours": int(q_prime.shape[0]),
        "depth": depth,
        "reps": int(reps),
        "kernel": resolve_kernel(kernel) if dev.type == "cuda" else "reference",
        "compute_dtype": dtype,
        "peak_flops": peak_flops,
        "programs": {},
    }
    for name, rec in programs.items():
        card = rec["card"]
        emit_program_card(card)
        achieved = card.achieved_flops(rec["seconds_per_iter"])
        report["programs"][name] = {
            "card": card.to_dict(),
            "seconds_per_iter": rec["seconds_per_iter"],
            "reach_timesteps_per_sec": rec["reach_timesteps_per_sec"],
            "achieved_flops_per_sec": None if achieved is None else round(achieved, 1),
            "pct_of_peak": round(100 * achieved / peak_flops, 2) if achieved and peak_flops else None,
        }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_report.json").write_text(json.dumps(report, indent=2))
    (out_dir / "profile_report.md").write_text(render_markdown(report))
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="ddr profile",
        description="Time the forward route, full VJP and train step for a config's first batch or a "
        "synthetic shape (program cards + timed iterations -> JSON/markdown report).",
    )
    parser.add_argument("config", nargs="*",
                        help="optional config.yaml plus a.b=c overrides (with --synthetic, only device=)")
    parser.add_argument("--synthetic", action="store_true",
                        help="profile the synthetic generator instead of a config")
    parser.add_argument("--n", type=int, default=2048, help="synthetic reach count (default 2048)")
    parser.add_argument("--t-hours", type=int, default=48,
                        help="synthetic window, hourly steps (default 48; rounded up to whole days, "
                        "minimum 48)")
    parser.add_argument("--depth", type=int, default=None,
                        help="synthetic longest-path depth (default: shallow generator)")
    parser.add_argument("--reps", type=int, default=5, help="timed iterations per program (default 5)")
    parser.add_argument("--out", default=None, help="report directory (default: DDR_METRICS_DIR or .)")
    parser.add_argument("--trace", action="store_true",
                        help="run the timed iterations under torch.profiler (under <out>/profile_trace)")
    parser.add_argument("--peak-flops", type=float, default=None,
                        help="device peak FLOP/s, adds a %%-of-peak column")
    parser.add_argument("--kernel", choices=("pallas", "xla"), default=None,
                        help="the routing scans: pallas (default) runs the hand-written CUDA kernels; "
                        "xla is refused")
    parser.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                        help="routing compute dtype (bf16: the bf16 ring)")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:  # argparse exits for --help (0) and usage errors (2)
        return int(e.code or 0)
    resolve_kernel(args.kernel)  # refuse --kernel xla before any work

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from ddr_tpu_torch.observability.events import run_telemetry
    from ddr_tpu_torch.scripts.common import parse_cli, split_config_argv

    path, overrides = split_config_argv(args.config)
    if args.synthetic or path is None:
        device = "cuda"
        for ov in overrides:
            key, _, value = ov.partition("=")
            if key != "device":
                raise ValueError(f"--synthetic takes only a device= override, got {ov!r}")
            device = value
        cfg, rd, q_prime, obs_daily, obs_mask = _synthetic_problem(args.n, args.t_hours, args.depth, device)
    else:
        cfg = parse_cli([path, *overrides], mode="training")
        rd, q_prime, obs_daily, obs_mask = _config_problem(cfg)
    out_dir = Path(args.out or os.environ.get("DDR_METRICS_DIR") or ".")
    # the run log (program_card events) lands beside the report
    with run_telemetry(cfg, "profile", base_dir=out_dir, n=int(rd.n_segments)):
        report = run_profile(cfg, rd, q_prime, obs_daily, obs_mask, reps=max(1, args.reps), out_dir=out_dir,
                             trace_dir=(out_dir / "profile_trace") if args.trace else None,
                             peak_flops=args.peak_flops, depth=args.depth, kernel=args.kernel,
                             dtype=args.dtype)
    print(render_markdown(report), end="")
    log.info(f"profile report written to {out_dir / 'profile_report.json'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
