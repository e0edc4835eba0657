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

Alignment: for a D-day window (``(D-1) * 24`` hourly steps) the tau trim
``13 + tau : -11 + tau`` leaves ``D - 2`` daily blocks, compared against
observation days ``1..D-2``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.routing.mc import Bounds, route
from ddr_tpu_torch.routing.model import denormalize_spatial_parameters

__all__ = [
    "clip_by_global_norm",
    "daily_from_hourly",
    "make_batch_loss",
    "make_batch_train_step",
    "make_optimizer",
    "masked_l1_daily",
    "set_learning_rate",
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
    ``overflow``/``ulp_drift`` counters. Everything must lie on ``device``
    (default ``"cuda"``)."""
    dev = resolve_device(device)

    def loss_fn(network, channels, gauges, attrs, q_prime, obs_daily, obs_mask):
        with record_function("ddr::kan"):
            raw = kan(attrs)
            spatial = denormalize_spatial_parameters(
                raw, parameter_ranges, log_space_parameters, defaults, channels.length.shape[0]
            )
        result = route(network, channels, spatial, q_prime, gauges=gauges, bounds=bounds,
                       kernel=kernel, device=dev, dtype=dtype, collect_health=collect_health,
                       health_bands=health_bands, health_topk=health_topk)
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
                              health_topk=health_topk)

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
