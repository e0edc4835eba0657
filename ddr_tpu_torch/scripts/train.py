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
cache, so it writes no ``compile`` or ``program_card`` events.

The self-healing switches are the JAX loop's:

- ``DDR_RECOVERY_ENABLED=1`` (with a watchdog, so with a run log) turns each
  violating step into one stage of the recovery ladder
  (:class:`~ddr_tpu_torch.observability.recovery.RecoverySupervisor`): the
  loop clones the KAN's and the optimizer's state before every step; a
  bf16-only violation re-runs the batch on the fp32 twin step from that
  snapshot (``DDR_TRAIN_DTYPE=bf16``), a skip restores it, a rollback loads
  the pinned-good checkpoint and backs off the learning rate, and a give-up
  saves ``<name>-giveup`` (degraded) and raises
  :class:`~ddr_tpu_torch.observability.recovery.RecoveryGiveUp`, on which
  ``main`` returns 3. A step event carries ``recovered`` with the stage, and
  a skipped or rolled-back step is neither scored nor checkpointed;
- ``DDR_DATA_VALIDATE=warn|quarantine`` scans every forcing batch on the
  prefetch thread (:class:`~ddr_tpu_torch.observability.recovery.ForcingValidator`);
  the main thread emits the ``data_anomaly`` event, and a quarantined batch
  never reaches the card (a ladder ``skip`` when recovery is on);
- ``DDR_FAULTS`` arms the ``data.load``, ``data.forcings``, ``device.step``
  and ``device.grads`` fault sites (:mod:`~ddr_tpu_torch.observability.faults`);
- SIGTERM or a first SIGINT (:class:`~ddr_tpu_torch.observability.preempt.PreemptionHandler`)
  finishes the step in flight, drains the prefetch pool and the checkpoint
  writer, saves ``<name>-preempt`` and emits a ``preempt`` event.

run_end carries the ``recovery`` and ``data_validate`` rollups. The JAX
package's directory checkpoints (``DDR_CKPT_FORMAT=orbax``) hold sharded
state and raise ``NotImplementedError`` naming ROADMAP A.13; the validation
plots, which need matplotlib, are named in one log line at the start.
"""

from __future__ import annotations

import dataclasses
import hashlib
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
from ddr_tpu_torch.observability.faults import fault_site
from ddr_tpu_torch.observability.health import HealthConfig, HealthWatchdog
from ddr_tpu_torch.observability.phases import PhaseTimer
from ddr_tpu_torch.observability.preempt import PreemptionHandler
from ddr_tpu_torch.observability.recovery import (
    ForcingValidator,
    RecoveryConfig,
    RecoveryGiveUp,
    RecoverySupervisor,
)
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
    pinned_good_checkpoint,
    prune_checkpoints_from_env,
    restore_optimizer,
    restore_snapshot,
    save_state,
    set_learning_rate,
    snapshot_state,
)
from ddr_tpu_torch.validation.configs import Config
from ddr_tpu_torch.validation.metrics import Metrics
from ddr_tpu_torch.validation.utils import log_metrics

log = logging.getLogger(__name__)

__all__ = ["main", "train"]

#: Logged once at the start of every run.
TELEMETRY_ABSENT = "not in this port, so off in this run: the validation plots (they need matplotlib)"


def _refuse_unported_switches() -> None:
    """Raise for the JAX loop's directory checkpoints, which the port does
    not write."""
    fmt = os.environ.get("DDR_CKPT_FORMAT", "pickle").strip().lower()
    if fmt == "orbax":
        raise NotImplementedError(
            "DDR_CKPT_FORMAT=orbax is the JAX package's directory checkpoint of sharded state; the "
            "port writes pickle checkpoints only until it has sharded state (ROADMAP A.13)"
        )
    if fmt != "pickle":
        log.warning(f"ignoring malformed DDR_CKPT_FORMAT={fmt!r} (want pickle)")


def _device_descriptor(dev: torch.device) -> dict:
    """The one card (or the CPU) the loop runs on, in the keys of the JAX
    loop's mesh descriptor, for the ``preempt`` event."""
    index = dev.index if dev.index is not None else (torch.cuda.current_device() if dev.type == "cuda" else 0)
    return {
        "axes": ["device"],
        "shape": [1],
        "n_devices": 1,
        "process_count": 1,
        "platform": dev.type,
        "topology": hashlib.sha256(f"{dev.type}:{index}".encode()).hexdigest()[:12],
    }


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
    # the recovery ladder acts on the watchdog's reasons, so it needs one
    recovery_cfg = RecoveryConfig.from_env()
    supervisor = RecoverySupervisor(recovery_cfg) if (recovery_cfg.enabled and watchdog is not None) else None
    # the host-side scan of every forcing batch; warn-and-train needs no ladder
    validator = ForcingValidator()
    if not validator.enabled:
        validator = None
    try:
        sentinel_cfg = SentinelConfig.from_env()
    except ValueError as e:
        log.warning(f"ignoring malformed DDR_SENTINEL_* config: {e}")
        sentinel_cfg = SentinelConfig(enabled=False)
    sentinel = Sentinel(sentinel_cfg, scope="train") if sentinel_cfg.enabled else None
    prefetch_stats = PrefetchStats()
    heartbeat_every = _heartbeat_every()
    train_dtype = _train_dtype()
    step_args = (kan, Bounds.from_config(cfg.params.attribute_minimums), cfg.params.parameter_ranges,
                 cfg.params.log_space_parameters, cfg.params.defaults)
    step_kwargs = dict(
        tau=cfg.params.tau,
        warmup=cfg.experiment.warmup,
        optimizer=optimizer,
        device=dev,
        collect_health=health_on,
        health_bands=health_cfg.bands if health_on else 0,
        health_topk=health_cfg.top_k,
        q_prime_wf_permuted=True,  # _prepare permutes single-ring batches on the host
    )
    step = make_batch_train_step(*step_args, dtype=train_dtype, **step_kwargs)
    # the ladder's first stage re-runs a bf16-only violation in fp32: the same
    # step on the same KAN and optimizer, built only for bf16 runs with recovery
    step_fp32 = (make_batch_train_step(*step_args, dtype="fp32", **step_kwargs)
                 if train_dtype == "bf16" and supervisor is not None else None)

    slope_min = cfg.params.attribute_minimums["slope"]
    ckpt_dir = Path(cfg.params.save_path) / "saved_models"
    n_done = 0
    throughput = Throughput(label="train")
    phase_timer = PhaseTimer()
    trace_seed = run_trace_seed(cfg)
    # fault sites resolve once: None (DDR_FAULTS unset) costs one `if` a step
    inject_data_load = fault_site("data.load")
    inject_data_forcings = fault_site("data.forcings")
    inject_device_step = fault_site("device.step")
    inject_device_grads = fault_site("device.grads")
    ckpt_writer = (AsyncCheckpointWriter(phase_timer=phase_timer, prune_dir=ckpt_dir)
                   if async_checkpoint_from_env() else None)
    # SIGTERM or a first SIGINT: finish the step in flight, save once, leave
    preempt = PreemptionHandler()
    preempt.__enter__()

    def _healthy() -> bool | None:
        # the watchdog's verdict when the save is requested; None without one
        return (not watchdog.degraded) if watchdog is not None else None

    def _preempt_save(epoch: int, batch: int) -> None:
        if ckpt_writer is not None:
            ckpt_writer.drain()
        path = save_state(ckpt_dir, f"{cfg.name}-preempt", epoch, batch, kan, optimizer,
                          rng_state=loader.state(), arch=arch, healthy=_healthy())
        log.warning(f"preemption ({preempt.reason}): emergency checkpoint {path}")
        if rec is not None:
            rec.emit("preempt", reason=preempt.reason, epoch=epoch, batch=batch, step=n_done,
                     mesh=_device_descriptor(dev))

    def _giveup_save(epoch: int, batch: int) -> None:
        # the last stage: the preemption's drain-then-save under <name>-giveup,
        # degraded, so never a rollback target and never hot-loaded by a server
        if ckpt_writer is not None:
            ckpt_writer.drain()
        path = save_state(ckpt_dir, f"{cfg.name}-giveup", epoch, batch, kan, optimizer,
                          rng_state=loader.state(), arch=arch, healthy=False)
        log.error(f"recovery budgets exhausted: emergency checkpoint {path}")

    def _recover(reasons, backup, batch_args, loss, daily, epoch, batch):
        """One ladder pass for a violating step -> ``(loss, daily, stage)``,
        the KAN and the optimizer left in the stage's state. ``decide`` only
        reads; the executed stage is committed with ``record``, so a violating
        fp32 re-run walks on down with ``fp32_available=False``. Raises
        :class:`RecoveryGiveUp` after the give-up save."""
        stage = supervisor.decide(reasons, fp32_available=step_fp32 is not None,
                                  rollback_available=pinned_good_checkpoint(ckpt_dir) is not None)
        if stage == "fp32-reroute":
            # the same batch on the fp32 twin from the pre-step state; the
            # snapshot stays intact for a skip should fp32 violate too
            restore_snapshot(kan, optimizer, backup)
            loss2, daily2, health2 = step_fp32(*batch_args)
            loss2 = float(loss2)
            reroute_reasons = watchdog.check(health2)
            supervisor.record("fp32-reroute", reasons, epoch=epoch, batch=batch,
                              outcome="clean" if not reroute_reasons else "violated")
            if not reroute_reasons:
                watchdog.reset_streaks()
                return loss2, daily2.cpu().numpy(), "fp32-reroute"
            reasons = reroute_reasons
            stage = supervisor.decide(reasons, fp32_available=False,
                                      rollback_available=pinned_good_checkpoint(ckpt_dir) is not None)
        if stage == "skip":
            # the bad update never happened: the snapshot predates the step
            supervisor.record("skip", reasons, epoch=epoch, batch=batch, step=n_done)
            restore_snapshot(kan, optimizer, backup)
            watchdog.reset_streaks()
            return loss, daily, "skip"
        if stage == "rollback":
            pinned = pinned_good_checkpoint(ckpt_dir)
            try:
                blob = load_state(pinned, expected_arch=arch)
                kan.load_state_dict({k: torch.as_tensor(v) for k, v in blob["params"].items()})
                restore_optimizer(optimizer, blob["opt_state"])
                backoff = supervisor.config.lr_backoff
                if backoff < 1.0:
                    cur = float(optimizer.param_groups[0]["lr"])
                    set_learning_rate(optimizer, cur * backoff)
                    log.warning(f"rollback LR backoff: {cur:g} -> {cur * backoff:g}")
                supervisor.record("rollback", reasons, epoch=epoch, batch=batch, checkpoint=pinned.name,
                                  lr_backoff=backoff)
                watchdog.reset_streaks()
                # no loader rewind: the state goes back, the stream goes on
                return loss, daily, "rollback"
            except Exception:  # noqa: BLE001 - an unloadable target means give-up
                log.exception(f"rollback checkpoint {pinned} unloadable; giving up")
        supervisor.record("give-up", reasons, epoch=epoch, batch=batch)
        _giveup_save(epoch, batch)
        raise RecoveryGiveUp(f"recovery budgets exhausted at epoch {epoch} mini-batch {batch} "
                             f"({', '.join(reasons)})")

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
                anomaly = None
                ctx = step_context(trace_seed, f"{epoch}:{i}")
                with phase_timer.phase("data_load", into=phase_s, ctx=ctx):
                    if inject_data_load is not None:
                        inject_data_load(epoch=epoch, batch=i)
                    q_prime = np.asarray(flow(routing_dataclass=rd), dtype=np.float32)
                    if rd.flow_scale is not None:
                        q_prime = q_prime * np.asarray(rd.flow_scale, dtype=np.float32)[None, :]
                    if inject_data_forcings is not None:
                        # poisoned before the scan: the validator must catch it
                        q_prime = inject_data_forcings(q_prime, epoch=epoch, batch=i)
                    if validator is not None:
                        # the scan here; the verdict and its event on the main thread
                        anomaly = validator.scan(q_prime, epoch=epoch, batch=i)
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
                return i, rd, payload, obs_daily, obs_mask, anomaly, phase_s

            batches = prefetch(_batches(), _prepare, ahead=cfg.experiment.prefetch_ahead,
                               stats=prefetch_stats)
            # each iteration's whole wall lands on its step event as loop_s
            loop_t0 = time.perf_counter()
            for i, rd, payload, obs_daily, obs_mask, anomaly, phase_s in batches:
                step_ctx = step_context(trace_seed, f"{epoch}:{i}")
                if ckpt_writer is not None:
                    ckpt_writer.trace_ctx = step_ctx
                if anomaly is not None and validator.note(anomaly) == "quarantine":
                    # the bad tile never reaches the card; with the ladder on, the
                    # drop is a bounded skip, and a spent budget a give-up
                    if supervisor is not None:
                        if supervisor.decide(["data-anomaly"]) == "give-up":
                            supervisor.record("give-up", ["data-anomaly"], epoch=epoch, batch=i)
                            _giveup_save(epoch, i)
                            raise RecoveryGiveUp(f"skip budget exhausted on quarantined forcings at "
                                                 f"epoch {epoch} mini-batch {i}")
                        supervisor.record("skip", ["data-anomaly"], epoch=epoch, batch=i, source="data_load")
                    else:
                        log.warning(f"epoch {epoch} mini-batch {i}: forcings quarantined "
                                    "(DDR_DATA_VALIDATE=quarantine); batch dropped")
                    continue
                q_prime, network, channels, gauges, attrs, obs_t, mask_t = payload
                n_timesteps = q_prime.shape[0]
                # the pre-step snapshot the ladder restores: the step updates the
                # KAN and the Adam moments in place
                backup = snapshot_state(kan, optimizer) if supervisor is not None else None
                hstats = None
                with throughput.batch(rd.n_segments, n_timesteps), phase_timer.phase(
                    "device_step", into=phase_s, ctx=step_ctx
                ):
                    if inject_device_step is not None:
                        # `step` is the 0-based index of the step about to run; a
                        # nan poisons the uploaded inflow after validation, so the
                        # card routes non-finite inflow
                        if inject_device_step.wants_array:
                            q0 = q_prime.cpu().numpy()
                            q1 = inject_device_step(q0, step=n_done, epoch=epoch, batch=i)
                            if q1 is not q0:
                                q_prime = torch.as_tensor(q1, device=dev)
                        else:
                            inject_device_step(step=n_done, epoch=epoch, batch=i)
                    batch_args = (network, channels, gauges, attrs, q_prime, obs_t, mask_t)
                    with span("step-single", parent=step_ctx):
                        out = step(*batch_args)
                    loss = float(out[0])  # synchronises: the time covers the whole step
                    if health_on:
                        hstats = out[2]
                daily = out[1].cpu().numpy()  # (D-2, G)
                if inject_device_grads is not None and hstats is not None:
                    # the synchronised pre-clip norm, after the update applied: the
                    # optimizer took a bad gradient, which the snapshot unwinds
                    if inject_device_grads.wants_array:
                        g0 = np.asarray(hstats.grad_norm.cpu().numpy(), dtype=np.float32)
                        g1 = inject_device_grads(g0, step=n_done, epoch=epoch, batch=i)
                        if g1 is not g0:
                            hstats = dataclasses.replace(hstats, grad_norm=g1)
                    else:
                        inject_device_grads(step=n_done, epoch=epoch, batch=i)
                recovered = None
                reasons: list[str] = []
                if watchdog is not None and hstats is not None:
                    reasons = watchdog.observe(hstats, epoch=epoch, batch=i)
                if supervisor is not None and reasons and backup is not None:
                    loss, daily, recovered = _recover(reasons, backup, batch_args, loss, daily, epoch, i)
                step_good = recovered in (None, "fp32-reroute")
                if skill is not None and step_good:
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
                    # a skipped or rolled-back step has nothing to score or save
                    if step_good:
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
                            # the recovery event tells the story; this marker lets
                            # a reader of the steps drop recovered batches
                            **({"recovered": recovered} if recovered else {}),
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
                if preempt.requested:
                    # mini-batch i completed: stop the prefetch pool, drain the
                    # writer, save exactly this state once, leave
                    batches.close()
                    _preempt_save(epoch, i)
                    return kan, optimizer
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
        preempt.__exit__(None, None, None)
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
            if supervisor is not None:
                rec.merge_summary("recovery", supervisor.summary())
            if validator is not None:
                rec.merge_summary("data_validate", validator.summary())
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
    except RecoveryGiveUp as e:
        # the state is saved (the give-up stage saves before it raises); a code
        # of its own tells a launcher not to relaunch into the same poison
        log.error(f"self-healing gave up: {e}")
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
