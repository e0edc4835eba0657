"""Small tensor utilities: the port's copy of ``ddr_tpu/io/functions.py``."""

from __future__ import annotations

import torch

__all__ = ["downsample"]


def downsample(data: torch.Tensor, rho: int) -> torch.Tensor:
    """Downsample hourly series ``(G, T)`` to ``rho`` bins by block mean.

    For ``T`` divisible by ``rho`` (the only case the pipeline produces: the
    trims always leave whole days) this is exactly the area interpolation
    the reference uses.
    """
    g, t = data.shape
    if t % rho != 0:
        raise ValueError(f"series length {t} not divisible into {rho} bins")
    return data.reshape(g, rho, t // rho).mean(dim=-1)
