"""``ddr train`` on the port: the KAN + routing training loop of
``ddr_tpu/scripts/train.py`` on the torch batch train step.

The loop takes the JAX loop's default path: resume from a checkpoint file or
a ``saved_models/`` directory, the per-epoch learning rates, gauge batches
from the seeded :class:`~ddr_tpu_torch.geodatazoo.loader.DataLoader`
prepared ahead by :func:`~ddr_tpu_torch.geodatazoo.loader.prefetch`
(``prepare_batch`` and the device upload, with single-ring batches' inflow
permuted into wavefront order on the host), the train step (KAN -> route on
the wave-scan kernels -> daily masked L1 -> analytic adjoint on the
reverse-scan kernel -> clip + Adam), per-batch metrics, the health watchdog,
and a checkpoint after every mini-batch through the background writer.
``DDR_TRAIN_DTYPE=bf16`` trains on the bf16 ring.

Each step logs one line, ``epoch E mini-batch B: loss=L (R reach-timesteps/s,
S ms, ENGINE)``, where S is the host time of the step up to its
synchronised loss. ``main`` records the run in ``run_log.train.jsonl``
(``DDR_METRICS_DIR``, else the save path): one ``step`` event a step with
its wall-clock split (:class:`~ddr_tpu_torch.observability.phases.PhaseTimer`:
``data_load`` and ``host_prep`` on the prefetch thread, ``device_step``,
``eval``, ``checkpoint``) and the loop's own wall ``loop_s``. As in the JAX
loop, with a run log the health watchdog checks every step, a
:class:`~ddr_tpu_torch.observability.skill.SkillTracker` scores every batch
(one ``skill`` event), a
:class:`~ddr_tpu_torch.observability.drift.DriftTracker` summarises the
denormalized KAN fields once an epoch (one ``drift`` event), and run_end
carries their rollups; the performance sentinel
(:class:`~ddr_tpu_torch.observability.sentinel.Sentinel`, ``DDR_SENTINEL_*``)
watches every step's phases and each heartbeat's gap and rolls the steps
into run_end's ``pipeline`` verdict; a ``heartbeat`` event (with the prefetch
pool's depth) follows the first step and every ``DDR_HEARTBEAT_EVERY``-th
(default 25, 0: none). All of it runs on host copies after the step's own
synchronisation, outside the timed brackets. The port has no XLA compile
cache, so it writes no ``compile`` or ``program_card`` events. The JAX
loop's optional subsystems that the port does not have yet raise
``NotImplementedError`` naming their ROADMAP item when their variable asks
for them; the validation plots, which need matplotlib, are named in one log
line at the start.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geodatazoo.loader import DataLoader, PrefetchStats, prefetch
from ddr_tpu_torch.observability.drift import DriftTracker
from ddr_tpu_torch.observability.events import emit_heartbeat, get_recorder, run_telemetry
from ddr_tpu_torch.observability.health import HealthConfig, HealthWatchdog
from ddr_tpu_torch.observability.phases import PhaseTimer
from ddr_tpu_torch.observability.recovery import RecoveryConfig
from ddr_tpu_torch.observability.sentinel import Sentinel, SentinelConfig
from ddr_tpu_torch.observability.skill import SkillConfig, SkillTracker
from ddr_tpu_torch.observability.spans import span, trace
from ddr_tpu_torch.observability.throughput import Throughput
from ddr_tpu_torch.observability.trace import run_trace_seed, step_context
from ddr_tpu_torch.routing.mc import Bounds
from ddr_tpu_torch.routing.model import (
    denormalize_spatial_parameters,
    engine_label,
    prepare_batch,
    single_ring_wavefront,
)
from ddr_tpu_torch.scripts.common import (
    build_kan,
    daily_observation_targets,
    get_flow_fn,
    kan_arch,
    parse_cli,
    timed,
)
from ddr_tpu_torch.scripts_utils import resolve_learning_rate
from ddr_tpu_torch.training import (
    AsyncCheckpointWriter,
    async_checkpoint_from_env,
    load_latest_state,
    load_state,
    make_batch_train_step,
    make_optimizer,
    prune_checkpoints_from_env,
    restore_optimizer,
    save_state,
    set_learning_rate,
)
from ddr_tpu_torch.validation.configs import Config
from ddr_tpu_torch.validation.metrics import Metrics
from ddr_tpu_torch.validation.utils import log_metrics

log = logging.getLogger(__name__)

__all__ = ["main", "train"]

#: Logged once at the start of every run.
TELEMETRY_ABSENT = "not in this port, so off in this run: the validation plots (they need matplotlib)"


def _refuse_unported_switches() -> None:
    """Raise for every optional subsystem of the JAX loop that the
    environment asks for and the port does not have."""
    if RecoveryConfig.from_env().enabled:
        raise NotImplementedError(
            "DDR_RECOVERY_ENABLED: the train loop's recovery ladder (its skip, rollback and "
            "give-up stages), the pinned-good checkpoint marker and the preemption save are not "
            "ported yet (ROADMAP A.6)"
        )
    policy = (os.environ.get("DDR_DATA_VALIDATE", "off") or "off").strip().lower() or "off"
    if policy in ("warn", "quarantine"):
        raise NotImplementedError(
            f"DDR_DATA_VALIDATE={policy}: the ForcingValidator is not ported yet (ROADMAP A.6)"
        )
    if policy != "off":
        raise ValueError(f"bad DDR_DATA_VALIDATE={policy!r} (want one of off, warn, quarantine)")
    if os.environ.get("DDR_FAULTS"):
        raise NotImplementedError("DDR_FAULTS: fault injection is not ported yet (ROADMAP A.6)")
    fmt = os.environ.get("DDR_CKPT_FORMAT", "pickle").strip().lower()
    if fmt == "orbax":
        raise NotImplementedError(
            "DDR_CKPT_FORMAT=orbax is the JAX package's directory checkpoint; the port writes "
            "pickle checkpoints only (ROADMAP A.6)"
        )
    if fmt != "pickle":
        log.warning(f"ignoring malformed DDR_CKPT_FORMAT={fmt!r} (want pickle)")


def _heartbeat_every() -> int:
    """``DDR_HEARTBEAT_EVERY`` -> steps between heartbeats (default 25, 0:
    none; a malformed value warns and keeps the default)."""
    raw = os.environ.get("DDR_HEARTBEAT_EVERY", "25")
    try:
        return int(raw or 0)
    except ValueError:
        log.warning(f"ignoring malformed DDR_HEARTBEAT_EVERY={raw!r} (want an integer)")
        return 25


def _train_dtype() -> str:
    dtype = (os.environ.get("DDR_TRAIN_DTYPE", "fp32") or "fp32").strip().lower()
    if dtype not in ("fp32", "bf16"):
        log.warning(f"ignoring unknown DDR_TRAIN_DTYPE={dtype!r} (want fp32|bf16)")
        dtype = "fp32"
    return dtype


def train(cfg: Config, dataset=None, max_batches: int | None = None):
    """Run the training loop on ``cfg.device`` (``"cuda"`` unless the config
    says ``"cpu"``); returns ``(kan, optimizer)``. ``dataset`` defaults to
    the one ``cfg.geodataset`` names; ``max_batches`` stops after that many
    executed steps."""
    _refuse_unported_switches()
    dev = resolve_device(cfg.device)
    log.info(TELEMETRY_ABSENT)
    dataset = dataset or cfg.geodataset.get_dataset_class(cfg, device=dev)
    flow = get_flow_fn(cfg, dataset)
    kan = build_kan(cfg, device=dev)
    arch = kan_arch(cfg)

    rng = np.random.default_rng(cfg.seed)
    loader = DataLoader(
        dataset,
        batch_size=cfg.experiment.batch_size,
        shuffle=cfg.experiment.shuffle,
        rng=rng,
        drop_last=True,
    )

    start_epoch, start_mini_batch, blob = 1, 0, None
    ckpt = Path(cfg.experiment.checkpoint) if cfg.experiment.checkpoint else None
    if ckpt is not None and ckpt.is_dir():
        # a saved_models/ directory: resume from its newest checkpoint that
        # verifies and loads (corrupt blobs are quarantined on the way)
        found = load_latest_state(ckpt, expected_arch=arch)
        if found is None:
            log.warning(f"no loadable checkpoint under {ckpt}; starting fresh")
        blob, ckpt = found or (None, None)
    if ckpt is not None:
        if blob is None:
            blob = load_state(ckpt, expected_arch=arch)
        kan.load_state_dict({k: torch.as_tensor(v) for k, v in blob["params"].items()})
        start_epoch = blob["epoch"]
        start_mini_batch = 0 if blob["mini_batch"] == 0 else blob["mini_batch"] + 1
        if blob.get("rng_state"):
            loader.set_state(blob["rng_state"])
        log.info(f"Resuming from {ckpt} at epoch {start_epoch}")
    else:
        log.info("Creating new spatial model")

    optimizer = make_optimizer(kan.parameters(), resolve_learning_rate(cfg.experiment.learning_rate,
                                                                      start_epoch))
    if blob and blob.get("opt_state") is not None:
        restore_optimizer(optimizer, blob["opt_state"])

    health_cfg = HealthConfig.from_env()
    rec = get_recorder()
    health_on = health_cfg.enabled and rec is not None
    watchdog = HealthWatchdog(health_cfg) if health_on else None
    # skill per batch and parameter drift per epoch, on host copies the loop
    # already holds after the step's synchronisation
    skill_cfg = SkillConfig.from_env()
    skill = SkillTracker(skill_cfg) if (skill_cfg.enabled and rec is not None) else None
    drift = (DriftTracker(cfg.params.parameter_ranges, config=health_cfg, watchdog=watchdog)
             if rec is not None else None)
    try:
        sentinel_cfg = SentinelConfig.from_env()
    except ValueError as e:
        log.warning(f"ignoring malformed DDR_SENTINEL_* config: {e}")
        sentinel_cfg = SentinelConfig(enabled=False)
    sentinel = Sentinel(sentinel_cfg, scope="train") if sentinel_cfg.enabled else None
    prefetch_stats = PrefetchStats()
    heartbeat_every = _heartbeat_every()
    step = make_batch_train_step(
        kan,
        Bounds.from_config(cfg.params.attribute_minimums),
        cfg.params.parameter_ranges,
        cfg.params.log_space_parameters,
        cfg.params.defaults,
        tau=cfg.params.tau,
        warmup=cfg.experiment.warmup,
        optimizer=optimizer,
        device=dev,
        dtype=_train_dtype(),
        collect_health=health_on,
        health_bands=health_cfg.bands if health_on else 0,
        health_topk=health_cfg.top_k,
        q_prime_wf_permuted=True,  # _prepare permutes single-ring batches on the host
    )

    slope_min = cfg.params.attribute_minimums["slope"]
    ckpt_dir = Path(cfg.params.save_path) / "saved_models"
    n_done = 0
    throughput = Throughput(label="train")
    phase_timer = PhaseTimer()
    trace_seed = run_trace_seed(cfg)
    ckpt_writer = (AsyncCheckpointWriter(phase_timer=phase_timer, prune_dir=ckpt_dir)
                   if async_checkpoint_from_env() else None)

    def _healthy() -> bool | None:
        # the watchdog's verdict when the save is requested; None without one
        return (not watchdog.degraded) if watchdog is not None else None

    try:
        for epoch in range(start_epoch, cfg.experiment.epochs + 1):
            if epoch in cfg.experiment.learning_rate:
                log.info(f"Setting learning rate: {cfg.experiment.learning_rate[epoch]}")
                set_learning_rate(optimizer, cfg.experiment.learning_rate[epoch])

            def _batches(epoch=epoch):
                for i, rd in enumerate(loader):
                    if epoch == start_epoch and i < start_mini_batch:
                        log.info(f"Skipping mini-batch {i}. Resuming at {start_mini_batch}")
                        continue
                    yield i, rd

            def _prepare(item):
                # batch-local and independent of the training state: runs ahead
                # in the prefetch pool, hiding table builds and uploads; its
                # phases ride the batch's own dict, never the main thread's
                i, rd = item
                phase_s: dict[str, float] = {}
                ctx = step_context(trace_seed, f"{epoch}:{i}")
                with phase_timer.phase("data_load", into=phase_s, ctx=ctx):
                    q_prime = np.asarray(flow(routing_dataclass=rd), dtype=np.float32)
                    if rd.flow_scale is not None:
                        q_prime = q_prime * np.asarray(rd.flow_scale, dtype=np.float32)[None, :]
                    obs_daily, obs_mask = daily_observation_targets(rd)
                with phase_timer.phase("host_prep", into=phase_s, ctx=ctx):
                    network, channels, gauges = prepare_batch(rd, slope_min, device=dev)
                    if single_ring_wavefront(network):
                        q_prime = np.ascontiguousarray(q_prime[:, network.wf_perm.cpu().numpy()])
                    payload = (
                        torch.as_tensor(q_prime, device=dev), network, channels, gauges,
                        torch.as_tensor(rd.normalized_spatial_attributes, device=dev),
                        torch.as_tensor(obs_daily, device=dev), torch.as_tensor(obs_mask, device=dev),
                    )
                return i, rd, payload, obs_daily, obs_mask, phase_s

            batches = prefetch(_batches(), _prepare, ahead=cfg.experiment.prefetch_ahead,
                               stats=prefetch_stats)
            # each iteration's whole wall lands on its step event as loop_s
            loop_t0 = time.perf_counter()
            for i, rd, payload, obs_daily, obs_mask, phase_s in batches:
                step_ctx = step_context(trace_seed, f"{epoch}:{i}")
                if ckpt_writer is not None:
                    ckpt_writer.trace_ctx = step_ctx
                q_prime, network, channels, gauges, attrs, obs_t, mask_t = payload
                n_timesteps = q_prime.shape[0]
                with throughput.batch(rd.n_segments, n_timesteps), phase_timer.phase(
                    "device_step", into=phase_s, ctx=step_ctx
                ):
                    with span("step-single", parent=step_ctx):
                        out = step(network, channels, gauges, attrs, q_prime, obs_t, mask_t)
                    loss = float(out[0])  # synchronises: the time covers the whole step
                daily = out[1].cpu().numpy()  # (D-2, G)
                if watchdog is not None:
                    watchdog.observe(out[2], epoch=epoch, batch=i)
                if skill is not None:
                    # per-gauge NSE/KGE/percent-bias over the post-warmup days
                    # the loss scores: one `skill` event a batch
                    try:
                        w0 = cfg.experiment.warmup
                        if w0 < daily.shape[0]:
                            skill.observe(np.where(np.isfinite(daily), daily, np.nan)[w0:],
                                          np.where(obs_mask, obs_daily, np.nan)[w0:],
                                          rd.observations.gage_ids, epoch=epoch, batch=i)
                    except Exception:
                        log.exception("skill tracking failed")  # never the loop
                log.info(
                    f"epoch {epoch} mini-batch {i}: loss={loss:.9g} ({throughput.last_rate:,.0f} "
                    f"reach-timesteps/s, {throughput.last_seconds * 1e3:.3f} ms, "
                    f"{engine_label(network)})"
                )
                # the step event survives a raising metrics or checkpoint section:
                # the step completed and updated the weights
                try:
                    with phase_timer.phase("eval", into=phase_s, ctx=step_ctx):
                        target = np.where(obs_mask, obs_daily, np.nan)
                        log_metrics(Metrics(pred=daily.T, target=target.T),
                                    header=f"epoch {epoch} mini-batch {i}")
                    with phase_timer.phase("checkpoint", into=phase_s, ctx=step_ctx):
                        saver = ckpt_writer.save if ckpt_writer is not None else save_state
                        saver(ckpt_dir, cfg.name, epoch, i, kan, optimizer, rng_state=loader.state(),
                              arch=arch, healthy=_healthy())
                        if ckpt_writer is None:
                            prune_checkpoints_from_env(ckpt_dir)
                finally:
                    loop_now = time.perf_counter()
                    loop_s = round(loop_now - loop_t0, 6)
                    loop_t0 = loop_now
                    if rec is not None:
                        rec.emit(
                            "step",
                            epoch=epoch,
                            batch=i,
                            loss=loss,
                            n_reaches=int(rd.n_segments),
                            n_timesteps=int(n_timesteps),
                            seconds=round(throughput.last_seconds, 6),
                            reach_timesteps_per_sec=round(throughput.last_rate, 1),
                            engine="single",
                            phases=dict(phase_s),
                            loop_s=loop_s,
                            **(step_ctx.ids() if step_ctx is not None else {}),
                        )
                    if sentinel is not None:
                        try:
                            sentinel.observe_step(n_done + 1, phases=phase_s, loop_s=loop_s,
                                                  seconds=throughput.last_seconds, rate=throughput.last_rate)
                        except Exception:
                            log.exception("sentinel observe failed")  # never the loop
                n_done += 1
                # liveness: the first executed step beats, then every heartbeat_every-th
                if heartbeat_every and (n_done == 1 or n_done % heartbeat_every == 0):
                    depth = prefetch_stats.depth()
                    emit_heartbeat(rec, epoch=epoch, batch=i, step=n_done,
                                   **({"prefetch_depth": depth} if depth is not None else {}))
                    if sentinel is not None:
                        try:
                            sentinel.observe_heartbeat(step=n_done)
                        except Exception:
                            log.exception("sentinel heartbeat observe failed")
                if max_batches is not None and n_done >= max_batches:
                    return kan, optimizer
            if drift is not None and n_done > 0:
                # the epoch's parameter fields: one KAN forward on the last
                # batch's attributes, denormalized to physical space
                try:
                    with torch.no_grad():
                        fields = denormalize_spatial_parameters(
                            kan(attrs), cfg.params.parameter_ranges, cfg.params.log_space_parameters,
                            cfg.params.defaults, int(attrs.shape[0]))
                    drift.observe({k: np.atleast_1d(v.cpu().numpy()) for k, v in fields.items()},
                                  epoch=epoch)
                except Exception:
                    log.exception("parameter drift tracking failed")  # never the loop
        return kan, optimizer
    finally:
        if ckpt_writer is not None:
            # every enqueued snapshot is on disk before train() returns
            try:
                ckpt_writer.close()
            except RuntimeError:
                log.exception("async checkpoint writer failed at close")
        if watchdog is not None:
            log.info(f"health: {watchdog.status()}")
        throughput.log_summary()
        if rec is not None:
            rec.merge_summary("throughput", {"reach_timesteps_per_sec": round(throughput.rate, 1),
                                             "batches": throughput.batches})
            rec.merge_summary("phases", phase_timer.summary())
            if watchdog is not None:
                rec.merge_summary("health", watchdog.status())
            if skill is not None:
                rec.merge_summary("skill", skill.status())
            if drift is not None:
                rec.merge_summary("drift", drift.status())
            if sentinel is not None:
                # the run's pipeline verdict and the detectors, which `ddr
                # metrics summarize` and `ddr obs bottleneck` read
                rec.merge_summary("pipeline", sentinel.pipeline_summary())
                rec.merge_summary("sentinel", sentinel.status())


def main(argv: list[str] | None = None) -> int:
    """``[config.yaml] [a.b=c ...]``: validate the config in training mode and train."""
    cfg = parse_cli(argv, mode="training")
    # the interrupt is caught outside run_telemetry, so the run log says "interrupted"
    try:
        with timed("training"), run_telemetry(cfg, "train"), trace():
            train(cfg)
    except KeyboardInterrupt:
        log.info("Keyboard interrupt received")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
