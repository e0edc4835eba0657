"""Depth banding: the engine choice and the cross-band boundary contract.

The port's own copy of what ``ddr_tpu/routing/chunked.py`` shares with the
stacked band router (:mod:`ddr_tpu_torch.routing.stacked`): the per-band
ring-cell cap, the level-band packer, the boundary-buffer column layout and
its forwarding contract, and :func:`build_routing_network`, which picks the
engine a network routes on.

Every edge points from a lower level to a strictly higher one, so a band only
ever reads boundary series that earlier bands published: one forward pass
over the bands suffices, and the backward walks them in reverse.
"""

from __future__ import annotations

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geometry.trapezoidal import maximum
from ddr_tpu_torch.routing.network import build_network, compute_levels, single_ring_eligible

__all__ = [
    "CHUNK_CELL_BUDGET",
    "boundary_buffer_columns",
    "boundary_ext_series",
    "build_routing_network",
    "pack_level_bands",
]

# Per-band ring-cell memory cap: 2^26 cells = 256 MB of float32 ring.
CHUNK_CELL_BUDGET = 1 << 26


def boundary_buffer_columns(
    ext_src: np.ndarray, band_of_node: np.ndarray, n: int, n_bands: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The boundary-buffer column layout: unique external-edge sources
    ordered by publishing band. Returns ``(buf_src, col_of_src, b_starts)``:
    buffer column -> original source id; original id -> column (-1 if not a
    boundary source); and the per-band column ranges ``b_starts[b] :
    b_starts[b+1]``."""
    uniq_src = np.unique(ext_src)
    buf_order = np.argsort(band_of_node[uniq_src], kind="stable")
    buf_src = uniq_src[buf_order]
    col_of_src = np.full(n, -1, dtype=np.int64)
    col_of_src[buf_src] = np.arange(len(buf_src))
    b_starts = np.searchsorted(band_of_node[buf_src], np.arange(n_bands + 1))
    return buf_src, col_of_src, b_starts


def boundary_ext_series(
    bnd: torch.Tensor, e_cols: torch.Tensor, e_tgt: torch.Tensor, n_out: int, lb: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-band forwarding contract: from the raw boundary buffer
    ``bnd`` ``(B, T, n_boundary + 1)``, ``x_ext`` (raw same-timestep sums:
    downstream solves read raw predecessor values, as the in-band ring does)
    and ``s_ext`` (per-predecessor clamped previous-timestep sums; row 0
    clamps a zero predecessor, and the hotstart never reads it), both
    ``(B, T, n_out)``, added at the
    band-local targets ``e_tgt``. Out of place, so autograd carries the
    cotangents of both back to ``bnd``."""
    B, T, _ = bnd.shape
    gathered = bnd.index_select(2, e_cols)
    x_ext = bnd.new_zeros(B, T, n_out).index_add(2, e_tgt, gathered)
    prev = torch.cat([bnd.new_zeros(B, 1, gathered.shape[2]), gathered[:, :-1]], dim=1)
    s_ext = bnd.new_zeros(B, T, n_out).index_add(2, e_tgt, maximum(prev, lb))
    return x_ext, s_ext


def pack_level_bands(
    counts: np.ndarray, cell_budget: int, ring_cols_divisor: int = 1
) -> list[tuple[int, int]]:
    """Greedy packing of consecutive levels into ring-budgeted bands: each
    band ``(lo, hi)`` satisfies ``(span + 1) * (ceil(n_band /
    ring_cols_divisor) + 1) <= cell_budget``. A single over-wide level still
    forms its own band (its ring is only 2 rows)."""
    depth = len(counts) - 1
    bands: list[tuple[int, int]] = []
    s, acc = 0, 0
    for L in range(depth + 1):
        span = L - s + 1
        cols = -(-(acc + int(counts[L])) // ring_cols_divisor)  # ceil-div
        if L > s and (span + 1) * (cols + 1) > cell_budget:
            bands.append((s, L))
            s, acc = L, 0
        acc += int(counts[L])
    bands.append((s, depth + 1))
    return bands


def build_routing_network(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    cell_budget: int | None = None,
    device: str | torch.device = "cuda",
):
    """The network :func:`~ddr_tpu_torch.routing.mc.route` should run, as the
    JAX package picks it: the single-ring wavefront when its caps fit
    (:func:`~ddr_tpu_torch.routing.network.single_ring_eligible`), else the
    stacked band router's frame
    (:func:`~ddr_tpu_torch.routing.stacked.build_stacked_chunked`); a graph
    of depth 0 keeps the plain network. An explicit ``cell_budget`` asks
    for the unrolled depth-chunked router, which is not ported (ROADMAP
    A.7)."""
    from ddr_tpu_torch.routing.stacked import build_stacked_chunked

    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    level = compute_levels(rows, cols, n) if n else np.zeros(0, dtype=np.int32)
    depth = int(level.max()) if n else 0
    max_in = int(np.bincount(rows, minlength=n).max()) if rows.size else 0
    if depth > 0 and not single_ring_eligible(depth, max_in, n):
        if cell_budget is not None:
            raise NotImplementedError(
                "an explicit cell_budget selects the unrolled depth-chunked router, "
                "which is not ported (ROADMAP A.7); leave it None for the stacked "
                "band router"
            )
        return build_stacked_chunked(rows, cols, n, level=level, device=dev)
    return build_network(rows, cols, n, device=dev)
