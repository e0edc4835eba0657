"""Training machinery: the batch train step, its loss and its optimizer.

The port of ``ddr_tpu/training.py``'s ``make_batch_train_step`` and what it
runs: KAN forward, denormalization, ``route`` (whose backward is the analytic
reverse-wavefront adjoint), daily aggregation and the masked L1 loss, then
global-norm clipping and Adam with a mutable learning rate. The JAX step is
a pure function returning new parameters and optimizer state; this one
updates the module and the optimizer in place, the PyTorch idiom for the same
thing.

With ``collect_health`` the step also returns the numerical-health stats of
its route (:mod:`ddr_tpu_torch.observability.health`) with the pre-clip
global gradient norm, which the watchdog and the recovery supervisor read.

Checkpoints are the JAX package's pickle checkpoints in torch form: the
KAN's state dict and the Adam state dict with every tensor leaf saved as a
host numpy array, the loader's RNG state and the architecture fingerprint,
named ``_{name}_epoch_{E}_mb_{B}.pkl`` beside a ``.manifest.json`` that
records the blob's length and SHA-256. They are written to a temporary name
and renamed; a blob that fails its manifest is quarantined (renamed
``*.corrupt``). :class:`AsyncCheckpointWriter` takes the host snapshot on
the loop thread and writes on its own. A checkpoint saved while the watchdog
was healthy becomes the directory's pinned-good checkpoint
(``_pinned_good.json``, :func:`pinned_good_checkpoint`), the recovery
ladder's rollback target, which retention never deletes. The
``checkpoint.write`` fault site (:mod:`ddr_tpu_torch.observability.faults`)
fires between the temporary write and the rename.

Alignment: for a D-day window (``(D-1) * 24`` hourly steps) the tau trim
``13 + tau : -11 + tau`` leaves ``D - 2`` daily blocks, compared against
observation days ``1..D-2``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pickle
import queue
import re
import threading
import time
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.observability.faults import maybe_inject
from ddr_tpu_torch.routing.mc import Bounds, route
from ddr_tpu_torch.routing.model import denormalize_spatial_parameters, single_ring_wavefront

log = logging.getLogger(__name__)

__all__ = [
    "CHECKPOINT_FORMAT",
    "CHECKPOINT_VERSION",
    "AsyncCheckpointWriter",
    "async_checkpoint_from_env",
    "checkpoint_candidates",
    "checkpoint_degraded",
    "clip_by_global_norm",
    "daily_from_hourly",
    "latest_checkpoint",
    "load_latest_state",
    "load_state",
    "make_batch_loss",
    "make_batch_train_step",
    "make_optimizer",
    "make_train_step",
    "mark_pinned_good",
    "masked_l1_daily",
    "pinned_good_checkpoint",
    "prune_checkpoints",
    "prune_checkpoints_from_env",
    "quarantine_checkpoint",
    "restore_optimizer",
    "restore_snapshot",
    "save_state",
    "set_learning_rate",
    "snapshot_state",
    "verify_checkpoint",
]


def make_optimizer(params, learning_rate: float, clip_norm: float = 1.0) -> torch.optim.Adam:
    """Adam (beta 0.9/0.999, eps 1e-8, as ``optax.adam``) over ``params``,
    with the global-norm clip the train step applies before each update kept
    in the parameter group as ``"clip_norm"``."""
    return torch.optim.Adam(
        [{"params": list(params), "clip_norm": float(clip_norm)}],
        lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
    )


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every parameter group in place (the epoch
    schedule of ``experiment.learning_rate``)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip ``grads`` in place in ``optax.clip_by_global_norm``'s form: kept
    as they are when their global norm is below ``max_norm``, else scaled by
    ``max_norm / norm`` (``torch.nn.utils.clip_grad_norm_`` divides by ``norm
    + 1e-6`` and would not match). Returns the pre-clip global norm."""
    norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def daily_from_hourly(runoff_tg: torch.Tensor, tau: int) -> torch.Tensor:
    """``(T, G)`` hourly gauge flow -> ``(D-2, G)`` daily means after the tau
    trim (``T = (D-1) * 24`` for a D-day window)."""
    sliced = runoff_tg[(13 + tau) : (-11 + tau)]
    num_days = sliced.shape[0] // 24
    return sliced[: num_days * 24].reshape(num_days, 24, -1).mean(dim=1)


def masked_l1_daily(runoff_tg, obs_daily, obs_mask, tau: int, warmup: int):
    """THE training objective: daily means after the tau trim, warmup days
    masked out, masked mean L1. Returns ``(loss, daily)``."""
    daily = daily_from_hourly(runoff_tg, tau)  # (D-2, G)
    mask = obs_mask.clone()
    mask[:warmup] = False
    err = torch.where(mask, (daily - torch.where(mask, obs_daily, 0.0)).abs(), 0.0)
    return err.sum() / mask.sum().clamp_min(1), daily


def make_batch_loss(
    kan: torch.nn.Module,
    bounds: Bounds,
    parameter_ranges: dict[str, list[float]],
    log_space_parameters: list[str],
    defaults: dict[str, float],
    tau: int,
    warmup: int,
    kernel: str | None = None,
    device: str | torch.device = "cuda",
    dtype: str = "fp32",
    collect_health: bool = False,
    health_bands: int = 0,
    health_topk: int = 8,
    q_prime_wf_permuted: bool = False,
):
    """The train step's differentiable loss: ``loss_fn(network, channels,
    gauges, attrs, q_prime, obs_daily, obs_mask) -> (loss, daily)``, or
    ``(loss, daily, health)`` with ``collect_health``.

    ``attrs`` ``(N, A)`` are the z-scored KAN inputs, ``q_prime`` ``(T, N)``
    the hourly lateral inflow, ``obs_daily`` / ``obs_mask`` ``(D-2, G)`` the
    aligned daily observations and their validity. ``kernel``, ``dtype``,
    ``collect_health``, ``health_bands`` and ``health_topk`` are ``route``'s:
    ``kernel=None`` the CUDA scans on a card, ``"reference"`` their plain
    versions; ``dtype="bf16"`` the bf16 ring, whose health stats carry the
    ``overflow``/``ulp_drift`` counters. ``q_prime_wf_permuted`` declares
    that every batch whose network satisfies
    :func:`~ddr_tpu_torch.routing.model.single_ring_wavefront` arrives with
    ``q_prime``'s columns already permuted by ``network.wf_perm`` (on the
    host, as ``ddr train`` prepares them); other batches arrive in original
    order. Everything must lie on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)

    def loss_fn(network, channels, gauges, attrs, q_prime, obs_daily, obs_mask):
        with record_function("ddr::kan"):
            raw = kan(attrs)
            spatial = denormalize_spatial_parameters(
                raw, parameter_ranges, log_space_parameters, defaults, channels.length.shape[0]
            )
        result = route(network, channels, spatial, q_prime, gauges=gauges, bounds=bounds,
                       kernel=kernel, device=dev, dtype=dtype, collect_health=collect_health,
                       health_bands=health_bands, health_topk=health_topk,
                       q_prime_permuted=q_prime_wf_permuted and single_ring_wavefront(network))
        loss, daily = masked_l1_daily(result.runoff, obs_daily, obs_mask, tau, warmup)
        if collect_health:
            return loss, daily, result.health
        return loss, daily

    return loss_fn


def make_batch_train_step(
    kan: torch.nn.Module,
    bounds: Bounds,
    parameter_ranges: dict[str, list[float]],
    log_space_parameters: list[str],
    defaults: dict[str, float],
    tau: int,
    warmup: int,
    optimizer: torch.optim.Optimizer,
    kernel: str | None = None,
    device: str | torch.device = "cuda",
    dtype: str = "fp32",
    collect_health: bool = False,
    health_bands: int = 0,
    health_topk: int = 8,
    q_prime_wf_permuted: bool = False,
):
    """One training step on a batch whose network, channels and gauges are
    call-time arguments: ``step(network, channels, gauges, attrs, q_prime,
    obs_daily, obs_mask) -> (loss, daily)``, or ``(loss, daily, health)``
    with ``collect_health`` (see :func:`make_batch_loss`; ``health.grad_norm``
    is the pre-clip global norm, the raw explosion signal).

    Each call runs the loss and its backward, clips the gradients by their
    global norm (:func:`clip_by_global_norm` at the ``"clip_norm"`` of an
    optimizer from :func:`make_optimizer`) and takes one optimizer step:
    ``kan`` and ``optimizer`` are updated in place. ``loss`` and ``daily``
    come back detached."""
    loss_fn = make_batch_loss(kan, bounds, parameter_ranges, log_space_parameters, defaults,
                              tau, warmup, kernel=kernel, device=device, dtype=dtype,
                              collect_health=collect_health, health_bands=health_bands,
                              health_topk=health_topk, q_prime_wf_permuted=q_prime_wf_permuted)

    def step(network, channels, gauges, attrs, q_prime, obs_daily, obs_mask):
        optimizer.zero_grad(set_to_none=True)
        loss, daily, *health = loss_fn(network, channels, gauges, attrs, q_prime, obs_daily, obs_mask)
        loss.backward()
        with record_function("ddr::optimizer"):
            grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
            norm = clip_by_global_norm(grads, optimizer.param_groups[0]["clip_norm"])
            optimizer.step()
        if collect_health:
            return loss.detach(), daily.detach(), dataclasses.replace(health[0], grad_norm=norm)
        return loss.detach(), daily.detach()

    return step


def make_train_step(
    kan: torch.nn.Module,
    network,
    channels,
    gauges,
    bounds: Bounds,
    parameter_ranges: dict[str, list[float]],
    log_space_parameters: list[str],
    defaults: dict[str, float],
    tau: int,
    warmup: int,
    optimizer: torch.optim.Optimizer,
    kernel: str | None = None,
    device: str | torch.device = "cuda",
    dtype: str = "fp32",
    collect_health: bool = False,
    health_bands: int = 0,
    health_topk: int = 8,
):
    """The train step of one fixed network: ``step(attrs, q_prime, obs_daily,
    obs_mask)``, :func:`make_batch_train_step` with ``network``, ``channels``
    and ``gauges`` bound (``q_prime`` in original column order)."""
    step = make_batch_train_step(kan, bounds, parameter_ranges, log_space_parameters, defaults,
                                 tau, warmup, optimizer, kernel=kernel, device=device, dtype=dtype,
                                 collect_health=collect_health, health_bands=health_bands,
                                 health_topk=health_topk)

    def bound_step(attrs, q_prime, obs_daily, obs_mask):
        return step(network, channels, gauges, attrs, q_prime, obs_daily, obs_mask)

    return bound_step


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

#: The port's own marker: its leaves are torch state-dict entries, which the
#: JAX package's loaders must not take for flax trees (and the reverse).
CHECKPOINT_FORMAT = "ddr-tpu-torch-checkpoint"
CHECKPOINT_VERSION = 1
_CKPT_NAME = re.compile(r"_epoch_(\d+)_mb_(\d+)\.pkl$")


def _host_copy(tree: Any) -> Any:
    """``tree`` with every tensor leaf replaced by a host numpy array the
    caller owns outright: a copy taken now, after the work that wrote the
    tensor on its stream (``.to("cpu")`` waits for it), never a view of a
    buffer that the next step overwrites."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, Mapping):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _state_tree(obj: Any) -> Any:
    """A module's or an optimizer's state dict, a state dict as it is."""
    if obj is None:
        return None
    if isinstance(obj, (torch.nn.Module, torch.optim.Optimizer)):
        return obj.state_dict()
    return obj


def _tensor_tree(tree: Any) -> Any:
    """Inverse of :func:`_host_copy`: numpy leaves back to (CPU) tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, Mapping):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensor_tree(v) for v in tree)
    return tree


def restore_optimizer(optimizer: torch.optim.Optimizer, opt_state: dict) -> torch.optim.Optimizer:
    """Load a checkpoint's optimizer state (numpy leaves) into ``optimizer``;
    its tensors move to the parameters' device."""
    optimizer.load_state_dict(_tensor_tree(opt_state))
    return optimizer


def _clone_tree(tree: Any) -> Any:
    """``tree`` with every tensor leaf cloned on its own device."""
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, Mapping):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


def snapshot_state(kan: torch.nn.Module, optimizer: torch.optim.Optimizer) -> tuple[dict, dict]:
    """A copy of the KAN's and the optimizer's state, taken on their device:
    the pre-step snapshot that the recovery ladder restores. The step updates
    both in place, and ``optimizer.state_dict()`` hands out the live Adam
    moments, so every tensor is cloned."""
    return _clone_tree(kan.state_dict()), _clone_tree(optimizer.state_dict())


def restore_snapshot(kan: torch.nn.Module, optimizer: torch.optim.Optimizer, snapshot: tuple[dict, dict]) -> None:
    """Put a :func:`snapshot_state` back. The snapshot stays intact for a
    second restore: ``Optimizer.load_state_dict`` keeps tensors that already
    sit on the right device and dtype, so it is handed clones, never the
    snapshot's own tensors, which the next step would update in place."""
    params, opt_state = snapshot
    kan.load_state_dict(params)
    optimizer.load_state_dict(_clone_tree(opt_state))


def save_state(
    save_dir: str | Path,
    name: str,
    epoch: int,
    mini_batch: int,
    params: Any,
    opt_state: Any,
    rng_state: Any = None,
    arch: dict | None = None,
    healthy: bool | None = None,
) -> Path:
    """Write a mid-epoch resumable checkpoint ``_{name}_epoch_{E}_mb_{B}.pkl``.

    ``params`` is the KAN (or its state dict), ``opt_state`` the optimizer
    (or its state dict, or None); tensors are saved as host numpy arrays.
    ``rng_state`` is the loader's (:meth:`DataLoader.state`), ``arch`` the
    architecture fingerprint :func:`load_state` checks, ``healthy`` the
    watchdog's verdict at save time (recorded as ``degraded`` in blob and
    manifest; None without a watchdog; ``healthy=True`` refreshes the
    pinned-good marker once the blob is in place). The blob goes to a
    temporary name, its manifest is written, then the blob is renamed into
    place, so a reader never sees a half-written blob under the final
    name."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    path = save_dir / f"_{name}_epoch_{epoch}_mb_{mini_batch}.pkl"
    blob = {
        "format": CHECKPOINT_FORMAT,
        "version": CHECKPOINT_VERSION,
        "epoch": epoch,
        "mini_batch": mini_batch,
        "params": _host_copy(_state_tree(params)),
        "opt_state": _host_copy(_state_tree(opt_state)),
        "rng_state": rng_state,
        "arch": arch,
    }
    if healthy is not None:
        blob["degraded"] = not healthy
    data = pickle.dumps(blob)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    # the fault site between the temp write and the rename: a crash leaves the
    # torn-write .tmp, a corrupt flips bits under the manifest's digest
    mutated = maybe_inject("checkpoint.write", data=data, path=str(path), epoch=epoch,
                           mini_batch=mini_batch)
    if mutated is not data and mutated is not None:
        tmp.write_bytes(mutated)
    _write_manifest(path, data, degraded=None if healthy is None else not healthy)
    os.replace(tmp, path)
    if healthy:
        mark_pinned_good(save_dir, path)
    return path


def _manifest_path(path: Path) -> Path:
    """The per-checkpoint integrity sidecar: ``<blob>.manifest.json``."""
    return path.with_name(path.name + ".manifest.json")


def _write_manifest(path: Path, data: bytes, degraded: bool | None = None) -> Path:
    """Length and SHA-256 of the blob beside it (renamed into place)."""
    manifest = {
        "format": "ddr-tpu-ckpt-manifest",
        "version": 1,
        "sha256": hashlib.sha256(data).hexdigest(),
        "bytes": len(data),
    }
    if degraded is not None:
        manifest["degraded"] = bool(degraded)
    mpath = _manifest_path(path)
    tmp = mpath.with_name(mpath.name + ".tmp")
    tmp.write_text(json.dumps(manifest))
    os.replace(tmp, mpath)
    return mpath


def quarantine_checkpoint(path: str | Path, reason: str = "corrupt") -> Path:
    """Rename a bad blob and its manifest to ``*.corrupt``, so every scan
    stops considering it while the evidence stays on disk."""
    path = Path(path)
    target = path.with_name(path.name + ".corrupt")
    try:
        os.replace(path, target)
    except OSError:  # another loader quarantined it first
        return target
    mpath = _manifest_path(path)
    if mpath.exists():
        try:
            os.replace(mpath, mpath.with_name(mpath.name + ".corrupt"))
        except OSError:
            pass
    log.warning(f"quarantined checkpoint {path.name} -> {target.name} ({reason})")
    return target


def _verify_once(path: Path, data: bytes) -> str | None:
    """One manifest check -> the failure, or None (clean, or no manifest)."""
    mpath = _manifest_path(path)
    if not mpath.exists():
        return None
    try:
        manifest = json.loads(mpath.read_text())
    except (json.JSONDecodeError, OSError) as e:
        return f"corrupt checkpoint manifest {mpath}: {e}"
    if manifest.get("bytes") != len(data):
        return (f"corrupt checkpoint {path}: torn write — {len(data)} bytes on disk, "
                f"manifest records {manifest.get('bytes')}")
    if manifest.get("sha256") != hashlib.sha256(data).hexdigest():
        return f"corrupt checkpoint {path}: content checksum mismatch (bit-flip or partial overwrite)"
    return None


def verify_checkpoint(path: str | Path, data: bytes | None = None) -> bytes:
    """Check one blob against its manifest and return its bytes. Raises
    ``ValueError`` without quarantining. A first mismatch is read again after
    a short pause: a writer overwriting the same path renames blob and
    manifest one after the other, and a reader between the two renames must
    not call a valid checkpoint corrupt."""
    path = Path(path)
    if data is None:
        data = path.read_bytes()
    if _verify_once(path, data) is None:
        return data
    time.sleep(0.05)
    data = path.read_bytes()
    problem = _verify_once(path, data)
    if problem is not None:
        raise ValueError(problem)
    return data


def _validate_meta(blob: Any, path: Path, expected_arch: dict | None) -> dict:
    """Format, version, progress fields and architecture of a blob."""
    if not isinstance(blob, dict) or blob.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(
            f"{path} is not a checkpoint of the PyTorch port (format marker "
            f"{blob.get('format') if isinstance(blob, dict) else None!r}, want {CHECKPOINT_FORMAT!r})"
        )
    if blob.get("version") != CHECKPOINT_VERSION:
        raise ValueError(f"checkpoint {path} has version {blob.get('version')}, "
                         f"this build reads version {CHECKPOINT_VERSION}")
    missing = {"epoch", "mini_batch", "params", "opt_state"} - blob.keys()
    if missing:
        raise ValueError(f"checkpoint {path} missing fields: {sorted(missing)}")
    saved_arch = blob.get("arch")
    if expected_arch is not None and saved_arch is not None and saved_arch != expected_arch:
        diff = {
            key: (saved_arch.get(key), expected_arch.get(key))
            for key in set(saved_arch) | set(expected_arch)
            if saved_arch.get(key) != expected_arch.get(key)
        }
        raise ValueError(
            f"checkpoint {path} was trained under a different architecture; "
            f"mismatched fields (saved, expected): {diff}"
        )
    return blob


def load_state(path: str | Path, expected_arch: dict | None = None, quarantine: bool = True) -> dict:
    """Load and check a checkpoint blob: verified against its manifest first,
    a torn or bit-flipped blob is quarantined (``quarantine=False`` opts out)
    and raises ``ValueError``; a foreign, version-mismatched or (when both
    blob and caller state one) architecture-mismatched blob raises
    ``ValueError`` without quarantine: those files are valid, only wrong for
    this caller. ``params`` and ``opt_state`` come back as numpy leaves."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory checkpoint (the JAX package's orbax form, which holds "
            "sharded state); the port reads pickle checkpoints only (ROADMAP A.13)"
        )
    try:
        data = verify_checkpoint(path)
        blob = pickle.loads(data)
    except (pickle.UnpicklingError, EOFError, AttributeError, ValueError) as e:
        if quarantine and path.exists():
            quarantine_checkpoint(path, reason=str(e))
        if isinstance(e, ValueError):
            raise
        raise ValueError(f"corrupt checkpoint {path}: {e}") from e
    return _validate_meta(blob, path, expected_arch)


def _checkpoint_epoch_mb(path: Path) -> tuple[int, int] | None:
    """``_{name}_epoch_{E}_mb_{B}.pkl`` -> (E, B), or None off-pattern."""
    m = _CKPT_NAME.search(path.name)
    return (int(m.group(1)), int(m.group(2))) if m else None


def checkpoint_candidates(save_dir: str | Path) -> list[Path]:
    """Every complete checkpoint under ``save_dir``, newest first by the
    ``(epoch, mini_batch)`` parsed from its name, modification time breaking
    ties only. ``.tmp`` leftovers and ``.corrupt`` quarantines are none."""

    def _mtime(p: Path) -> float:
        try:
            return p.stat().st_mtime
        except OSError:  # renamed away meanwhile
            return float("-inf")

    def _order(p: Path) -> tuple:
        return (_checkpoint_epoch_mb(p) or (-1, -1), _mtime(p))

    pkls = [p for p in Path(save_dir).glob("_*_epoch_*_mb_*.pkl")
            if not p.name.endswith((".tmp", ".corrupt"))]
    return sorted(pkls, key=_order, reverse=True)


def checkpoint_degraded(path: str | Path) -> bool | None:
    """The watchdog's verdict recorded at save time, read from the manifest
    without unpickling the blob: True or False, or None when the checkpoint
    was saved without a watchdog or its manifest is unreadable (callers treat
    unknown as not degraded)."""
    try:
        meta = json.loads(_manifest_path(Path(path)).read_text())
    except (OSError, json.JSONDecodeError):
        return None
    flag = meta.get("degraded")
    return bool(flag) if flag is not None else None


def _pinned_good_path(save_dir: str | Path) -> Path:
    """The directory's pointer file: ``_pinned_good.json``."""
    return Path(save_dir) / "_pinned_good.json"


def mark_pinned_good(save_dir: str | Path, path: str | Path) -> Path:
    """Point the pinned-good marker at ``path`` (written to a temporary name
    and renamed, so the pointer is never seen half-written). The save
    functions call it, the writer thread's included, only for a checkpoint
    saved while the watchdog was healthy."""
    path = Path(path)
    em = _checkpoint_epoch_mb(path) or (-1, -1)
    pointer = {
        "format": "ddr-tpu-pinned-good",
        "version": 1,
        "path": path.name,  # relative to the directory, which may move
        "epoch": em[0],
        "mini_batch": em[1],
    }
    ppath = _pinned_good_path(save_dir)
    tmp = ppath.with_name(ppath.name + ".tmp")
    tmp.write_text(json.dumps(pointer))
    os.replace(tmp, ppath)
    return ppath


def pinned_good_checkpoint(save_dir: str | Path) -> Path | None:
    """The last checkpoint saved while the watchdog was healthy: the
    recovery ladder's rollback target. The ``_pinned_good.json`` pointer when
    its target still exists, else the newest candidate whose manifest does
    not record ``degraded: true`` (a checkpoint without a verdict counts as
    good); None when nothing qualifies."""
    save_dir = Path(save_dir)
    ppath = _pinned_good_path(save_dir)
    if ppath.exists():
        try:
            pointer = json.loads(ppath.read_text())
            target = save_dir / str(pointer.get("path", ""))
            if pointer.get("path") and target.exists():
                return target
            log.warning(f"pinned-good pointer names missing checkpoint {pointer.get('path')!r}; "
                        "falling back to a manifest scan")
        except (json.JSONDecodeError, OSError) as e:
            log.warning(f"unreadable pinned-good pointer {ppath}: {e}")
    for cand in checkpoint_candidates(save_dir):
        if checkpoint_degraded(cand) is not True:
            return cand
    return None


def latest_checkpoint(save_dir: str | Path) -> Path | None:
    """The newest complete checkpoint by (epoch, mini_batch), or None."""
    cands = checkpoint_candidates(save_dir)
    return cands[0] if cands else None


def load_latest_state(save_dir: str | Path, expected_arch: dict | None = None) -> tuple[dict, Path] | None:
    """The newest candidate under ``save_dir`` that verifies and loads, with
    its path; corrupt blobs are quarantined on the way and others that do not
    load are logged and skipped. None when nothing loads."""
    for path in checkpoint_candidates(save_dir):
        try:
            return load_state(path, expected_arch=expected_arch), path
        except (ValueError, OSError) as e:  # OSError: renamed away meanwhile
            log.warning(f"skipping unloadable checkpoint {path.name}: {e}")
    return None


def prune_checkpoints(save_dir: str | Path, keep_last: int, keep_every_epoch: bool = True) -> list[Path]:
    """Delete all but the newest ``keep_last`` checkpoints (``keep_last <= 0``
    keeps all); with ``keep_every_epoch`` the newest of every epoch stays
    too. Manifests go with their blobs; quarantines are never touched.
    The pinned-good checkpoint (:func:`pinned_good_checkpoint`, the
    rollback target) always stays. Returns the deleted paths."""
    if keep_last <= 0:
        return []
    cands = checkpoint_candidates(save_dir)
    keep = set(cands[:keep_last])
    pinned = pinned_good_checkpoint(save_dir)
    if pinned is not None:
        keep.add(pinned)
    if keep_every_epoch:
        best_per_epoch: dict[int, Path] = {}
        for p in cands:  # newest first: the first of each epoch wins
            em = _checkpoint_epoch_mb(p)
            if em is not None and em[0] not in best_per_epoch:
                best_per_epoch[em[0]] = p
        keep.update(best_per_epoch.values())
    deleted: list[Path] = []
    for p in cands:
        if p in keep:
            continue
        try:
            p.unlink()
            mpath = _manifest_path(p)
            if mpath.exists():
                mpath.unlink()
        except OSError as e:  # retention must never take the run down
            log.warning(f"could not prune checkpoint {p.name}: {e}")
            continue
        deleted.append(p)
    if deleted:
        log.info(f"pruned {len(deleted)} old checkpoints under {save_dir}")
    return deleted


def prune_checkpoints_from_env(save_dir: str | Path) -> list[Path]:
    """Apply ``DDR_CKPT_KEEP_LAST`` / ``DDR_CKPT_KEEP_EVERY_EPOCH`` (unset or
    0 keeps everything; a malformed value is ignored with a warning)."""
    raw = os.environ.get("DDR_CKPT_KEEP_LAST")
    if not raw:
        return []
    try:
        keep_last = int(raw)
    except ValueError:
        log.warning(f"ignoring malformed DDR_CKPT_KEEP_LAST={raw!r} (want an integer)")
        return []
    keep_epoch = os.environ.get("DDR_CKPT_KEEP_EVERY_EPOCH", "1").strip().lower() not in (
        "0", "false", "no", "off",
    )
    return prune_checkpoints(save_dir, keep_last, keep_every_epoch=keep_epoch)


def async_checkpoint_from_env() -> bool:
    """``DDR_CKPT_ASYNC``: the background writer, on unless
    ``0``/``false``/``no``/``off``."""
    return os.environ.get("DDR_CKPT_ASYNC", "1").strip().lower() not in ("0", "false", "no", "off")


class AsyncCheckpointWriter:
    """Background checkpoint writer: the loop takes a host snapshot and
    enqueues it; pickling, the manifest and the renames of
    :func:`save_state` run on one daemon thread, overlapping the next step.

    - :meth:`save` copies the state to host numpy ON THE CALLING THREAD
      before it returns (:func:`_host_copy`): the next step updates the
      parameters and optimizer state in place, so the writer never touches
      a live tensor.
    - At most one snapshot waits; a newer one replaces a waiting one that
      the writer has not started (the newest state is worth more).
    - A failed write is raised on the next :meth:`save` or :meth:`drain`.
    - :meth:`drain` blocks until every enqueued snapshot is on disk;
      :meth:`close` drains and stops the thread.
    - A snapshot saved with ``healthy=True`` refreshes the pinned-good
      marker on the writer thread, after its blob has landed.
    - With a ``phase_timer`` each write is its ``checkpoint_io`` phase, a
      child span of the step context the loop sets on :attr:`trace_ctx`
      before the save.
    """

    def __init__(self, phase_timer: Any = None, prune_dir: str | Path | None = None) -> None:
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._idle = threading.Event()
        self._idle.set()
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        self._pending = 0  # queued + in flight; the idle event mirrors _pending == 0
        self._phase_timer = phase_timer
        self._prune_dir = prune_dir
        self._closed = False
        # the current step's SpanContext, carried with the snapshot to the writer thread
        self.trace_ctx: Any = None
        self._thread = threading.Thread(target=self._run, name="ddr-ckpt-writer", daemon=True)
        self._thread.start()

    def _pending_add(self) -> None:
        with self._lock:
            self._pending += 1
            self._idle.clear()

    def _pending_done(self) -> None:
        with self._lock:
            self._pending -= 1
            if self._pending <= 0:
                self._idle.set()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            ctx = item.pop("_ctx", None)
            try:
                if self._phase_timer is not None:
                    with self._phase_timer.phase("checkpoint_io", ctx=ctx):
                        save_state(**item)
                else:
                    save_state(**item)
                if self._prune_dir is not None:
                    prune_checkpoints_from_env(self._prune_dir)
            except BaseException as e:  # noqa: BLE001 - raised on the next save/drain
                with self._lock:
                    self._error = e
                log.exception("async checkpoint write failed")
            finally:
                self._queue.task_done()
                self._pending_done()

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("previous async checkpoint write failed") from err

    def save(
        self,
        save_dir: str | Path,
        name: str,
        epoch: int,
        mini_batch: int,
        params: Any,
        opt_state: Any,
        rng_state: Any = None,
        arch: dict | None = None,
        healthy: bool | None = None,
    ) -> None:
        """Snapshot now, write later; :func:`save_state`'s arguments, with
        ``healthy`` judged by the caller at the time of the request."""
        self._raise_pending()
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        item = {
            "save_dir": save_dir,
            "name": name,
            "epoch": epoch,
            "mini_batch": mini_batch,
            "params": _host_copy(_state_tree(params)),
            "opt_state": _host_copy(_state_tree(opt_state)),
            "rng_state": _host_copy(rng_state),
            "arch": arch,
            "healthy": healthy,
        }
        if self.trace_ctx is not None:
            item["_ctx"] = self.trace_ctx
        self._pending_add()
        while True:
            try:
                self._queue.put_nowait(item)
                return
            except queue.Full:
                try:  # latest wins: drop the waiting snapshot, never the one being written
                    stale = self._queue.get_nowait()
                    self._queue.task_done()
                    self._pending_done()
                    log.info("async checkpoint writer behind: dropped queued snapshot "
                             f"epoch {stale['epoch']} mb {stale['mini_batch']}")
                except queue.Empty:
                    pass

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every enqueued snapshot is on disk (True) or the
        timeout passes (False); raises a pending write error."""
        ok = self._idle.wait(timeout)
        self._raise_pending()
        return ok

    def close(self, timeout: float | None = 60.0) -> None:
        """Drain, stop the writer thread and raise any write error. Honours
        ``timeout`` against a wedged writer: a snapshot still waiting behind
        a stalled write is dropped with a warning."""
        if self._closed:
            return
        self._closed = True
        if not self._idle.wait(timeout):
            log.warning("async checkpoint writer did not drain before close")
        while True:
            try:
                self._queue.put_nowait(None)
                break
            except queue.Full:
                try:
                    stale = self._queue.get_nowait()
                    self._queue.task_done()
                    self._pending_done()
                    log.warning("async checkpoint writer wedged: dropping queued snapshot "
                                f"epoch {stale['epoch']} mb {stale['mini_batch']}")
                except queue.Empty:
                    pass
        self._thread.join(timeout)
        self._raise_pending()
