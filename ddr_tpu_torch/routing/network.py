"""River-network topology: the solve schedules and wavefront tables on a torch device.

The port's own copy of ``ddr_tpu/routing/network.py``'s numpy builders
(longest-path levels, the step engine's level-scheduled solve tables, the
degree-bucketed wavefront gather tables, their transpose, the single-ring
eligibility rule), producing a :class:`RiverNetwork` whose tables are
int32/float32 tensors on one device.

An edge (src -> tgt) means reach ``src`` drains into reach ``tgt``; ``rows``
are targets and ``cols`` sources (the binsparse COO convention).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.nn import functional as F

from ddr_tpu_torch.device import resolve_device

__all__ = [
    "RiverNetwork",
    "build_network",
    "compute_levels",
    "level_schedule",
    "single_ring_eligible",
]

# Heuristic single-ring caps, as in the JAX builder: beyond them a network
# routes on the stacked band router (routing/stacked.py).
WAVEFRONT_MAX_IN_DEGREE = 64
WAVEFRONT_MAX_DEPTH = 1024
# Fused (level-contiguous gather) solve schedule limits: river networks have
# in-degree <= 4 and out-degree 1; the level loop runs once per level.
FUSED_MAX_IN_DEGREE = 8
FUSED_MAX_OUT_DEGREE = 4
FUSED_MAX_DEPTH = 512


@dataclasses.dataclass(frozen=True, eq=False)
class RiverNetwork:
    """Static river topology: the step engine's solve schedules and the
    wavefront tables.

    The step engine's triangular solve (:mod:`ddr_tpu_torch.routing.solver`)
    has two schedules. The *rectangle* (always built): edges grouped by
    target level into the ``(n_rows, width)`` tables ``lvl_src``/``lvl_tgt``
    (original order, oversized levels split into several rows, pads hold the
    sentinel ``n``). The *fused* one (``fused``): reaches permuted
    level-contiguously (``perm``/``inv_perm``, level ``L`` at ``level_starts[L]
    : level_starts[L + 1]``), predecessors and successors in the padded
    gather tables ``pred``/``down`` (permuted space, sentinel ``n``).
    ``edge_src``/``edge_tgt`` are the flat edge list.

    The wavefront tables exist when ``wavefront`` is set (empty otherwise).
    Node order ``wf_perm`` sorts reaches by (in-degree bucket, level, id);
    ``wf_inv`` is its inverse. Per node in wf order, ``wf_slot`` and
    ``wf_width`` give the node's run of predecessor slots in the flat
    bucket-concatenated gather table: slot ``k`` reads the ring at row
    distance ``wf_row[k] + 1`` waves back, column ``wf_col[k]`` (pad slots
    point at the always-zero sentinel column ``n``), and ``wf_mask[k]`` is 0
    for pad slots. ``wf_idx = wf_row * (n + 1) + wf_col`` is the JAX
    package's flat form of the same table.

    The transposed table serves the reverse scan of the analytic adjoint:
    node ``i`` (wf order) owns slots ``i * wf_t_width .. (i + 1) *
    wf_t_width - 1``, one per successor, and slot ``k`` reads the ring
    ``wf_t_row[k] + 1`` reverse waves back at column ``wf_t_col[k]`` (pad
    slots: the sentinel). ``wf_t_idx`` is its flat form.
    """

    n: int
    depth: int
    n_edges: int
    single_ring: bool
    edge_src: torch.Tensor  # (E,) int32, original order
    edge_tgt: torch.Tensor  # (E,) int32
    lvl_src: torch.Tensor  # (n_rows, width) int32, sentinel n
    lvl_tgt: torch.Tensor  # (n_rows, width) int32, sentinel n
    perm: torch.Tensor  # (n,) int32 level-contiguous order, empty unless fused
    inv_perm: torch.Tensor  # (n,) int32, empty unless fused
    pred: torch.Tensor  # (n, U) int32 predecessors, permuted space, sentinel n
    down: torch.Tensor  # (n, D) int32 successors, permuted space, sentinel n
    level_starts: tuple  # first permuted index of each level, and n
    fused: bool
    wavefront: bool
    level: torch.Tensor  # (n,) int32, original order
    level_p: torch.Tensor  # (n,) int32, wf order
    wf_perm: torch.Tensor  # (n,) int32
    wf_inv: torch.Tensor  # (n,) int32
    wf_idx: torch.Tensor  # (E_slots,) int32
    wf_row: torch.Tensor  # (E_slots,) int32, gap - 1
    wf_col: torch.Tensor  # (E_slots,) int32, predecessor wf column (n = sentinel)
    wf_mask: torch.Tensor  # (E_slots,) float32
    wf_slot: torch.Tensor  # (n,) int32, first slot of each node (wf order)
    wf_width: torch.Tensor  # (n,) int32, slot count of each node (wf order)
    wf_t_idx: torch.Tensor  # (n * wf_t_width,) int32, transposed table
    wf_t_row: torch.Tensor  # (n * wf_t_width,) int32, gap - 1
    wf_t_col: torch.Tensor  # (n * wf_t_width,) int32, successor wf column (n = sentinel)
    wf_buckets: tuple  # ((node_start, node_end, width), ...)
    wf_level_runs: tuple  # ((start, end, level), ...) in wf order
    wf_ring_rows: int  # max edge level-gap + 2
    wf_t_width: int

    @property
    def device(self) -> torch.device:
        return self.level.device

    def upstream_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``N @ x`` over the last axis, original order: the upstream sum of
        each reach, one ``index_add`` over the edge list."""
        return x.new_zeros(x.shape).index_add_(
            -1, self.edge_tgt.long(), x.index_select(-1, self.edge_src.long()))

    def upstream_sum_perm(self, x_perm: torch.Tensor) -> torch.Tensor:
        """``N @ x`` in the fused permuted space: one gather of the padded
        predecessor table (the sentinel reads an appended zero)."""
        return F.pad(x_perm, (0, 1))[..., self.pred.long()].sum(-1)


def _ranges(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Vectorized ``concatenate([arange(s, e) for s, e in zip(starts, ends)])``.

    All ranges must be non-empty.
    """
    counts = ends - starts
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    out[0] = starts[0]
    boundaries = np.cumsum(counts)[:-1]
    out[boundaries] = starts[1:] - ends[:-1] + 1
    return np.cumsum(out)


def compute_levels(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Longest-path level per node (headwaters = 0) by vectorized Kahn layering:
    each round peels every node whose upstream count has dropped to zero, and
    a node's round index is its longest-path level."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= n or cols.min() < 0 or cols.max() >= n):
        raise ValueError(f"edge indices out of range for n={n}")
    level = np.zeros(n, dtype=np.int32)
    assigned = np.zeros(n, dtype=bool)
    remaining = np.bincount(rows, minlength=n).astype(np.int64)

    order = np.argsort(cols, kind="stable")
    e_src = cols[order]
    e_tgt = rows[order]
    src_starts = np.searchsorted(e_src, np.arange(n + 1))

    frontier = np.flatnonzero(remaining == 0)
    lvl = 0
    n_done = 0
    while frontier.size:
        level[frontier] = lvl
        assigned[frontier] = True
        n_done += frontier.size
        starts = src_starts[frontier]
        ends = src_starts[frontier + 1]
        nz = ends > starts
        flat = _ranges(starts[nz], ends[nz])
        if flat.size == 0:
            break
        # only nodes decremented this round can become ready: O(E) in total
        np.subtract.at(remaining, e_tgt[flat], 1)
        cand = np.unique(e_tgt[flat])
        frontier = cand[(remaining[cand] == 0) & ~assigned[cand]]
        lvl += 1
    if n_done < n:
        raise ValueError(f"adjacency contains a cycle: {n - n_done} nodes unreachable")
    return level


def level_schedule(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    level: np.ndarray | None = None,
    e_cap: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Edges grouped by target level and padded to a ``(n_rows, width)``
    rectangle (pads hold the sentinel ``n``); returns ``(lvl_src, lvl_tgt,
    depth)``. A level with more than ``e_cap`` edges (default ``max(1024, 2 *
    mean)``) is split into several rows: its edges are independent, since
    every source sits at a lower level. Solvers size their loop by
    ``lvl_src.shape[0]``, which can exceed ``depth``."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if level is None:
        level = compute_levels(rows, cols, n)
    depth = int(level.max()) if n else 0
    if rows.size == 0 or depth == 0:
        return np.zeros((0, 1), dtype=np.int64), np.zeros((0, 1), dtype=np.int64), 0

    tgt_level = level[rows]  # every edge's target has level >= 1
    order = np.argsort(tgt_level, kind="stable")
    s_src, s_tgt = cols[order], rows[order]
    counts = np.bincount(tgt_level[order], minlength=depth + 1)[1:]  # levels 1..depth
    if e_cap is None:
        e_cap = max(1024, 2 * int(np.ceil(counts.sum() / depth)))
    chunks = np.maximum(1, -(-counts // e_cap))  # rows per level
    width = int(min(int(counts.max()), e_cap))
    row_base = np.concatenate([[0], np.cumsum(chunks)])
    n_rows = int(row_base[-1])

    lvl_src = np.full((n_rows, width), n, dtype=np.int64)
    lvl_tgt = np.full((n_rows, width), n, dtype=np.int64)
    pos_in_level = _ranges(np.zeros(depth, dtype=np.int64), counts.astype(np.int64))
    level_of_edge = np.repeat(np.arange(depth), counts)
    row_pos = row_base[level_of_edge] + pos_in_level // width
    col_pos = pos_in_level % width
    lvl_src[row_pos, col_pos] = s_src
    lvl_tgt[row_pos, col_pos] = s_tgt
    return lvl_src, lvl_tgt, depth


def _padded_adjacency_table(point: np.ndarray, neighbor: np.ndarray, n: int, width: int) -> np.ndarray:
    """``(n, max(width, 1))``: each node's neighbors, padded with the sentinel ``n``."""
    table = np.full((n, max(width, 1)), n, dtype=np.int64)
    order = np.argsort(point, kind="stable")
    pt, nb = point[order], neighbor[order]
    starts = np.searchsorted(pt, np.arange(n + 1))
    counts = starts[1:] - starts[:-1]
    col = np.arange(len(pt)) - starts[:-1].repeat(counts)
    table[pt, col] = nb
    return table


def single_ring_eligible(depth: int, max_in: int, n: int) -> bool:
    """Can the single-ring wavefront engine carry this topology? Heuristic
    depth/in-degree caps plus the hard int32 flat-ring-index limit
    ((gap-1)*(n+1)+col must not wrap)."""
    return (
        0 < depth <= WAVEFRONT_MAX_DEPTH
        and 0 < max_in <= WAVEFRONT_MAX_IN_DEGREE
        and (depth + 2) * (n + 1) < 2**31
    )


def _wavefront_tables(
    rows: np.ndarray, cols: np.ndarray, n: int, level: np.ndarray, in_deg: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, tuple, tuple]:
    """Degree-bucketed, level-run-ordered gather layout.

    Nodes are re-ordered by power-of-two in-degree bucket, then level; each
    bucket's slots are exactly its width, so the table holds at most
    ``2 * n_edges`` slots. Slot for edge p -> i is ``(gap - 1) * (n + 1) +
    inv[p]`` with ``gap = level[i] - level[p]``; pad slots point at the
    sentinel (ring row 0, column n). Returns ``(order, inv, wf_idx, wf_mask,
    buckets, level_runs)``.
    """
    # bucket b holds in-degrees (2^(b-2), 2^(b-1)] (width 2^(b-1)); bucket 0 = deg 0
    bucket_id = np.zeros(n, dtype=np.int64)
    nz = in_deg > 0
    bucket_id[nz] = 1 + np.ceil(np.log2(in_deg[nz])).astype(np.int64)
    bucket_id[in_deg == 1] = 1
    order = np.lexsort((np.arange(n), level, bucket_id))  # (bucket, level, node)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)

    bucket_sorted = bucket_id[order]
    level_sorted = level[order]
    change = np.flatnonzero(np.diff(level_sorted) != 0) + 1
    starts_r = np.concatenate([[0], change])
    ends_r = np.concatenate([change, [n]])
    level_runs = tuple(
        (int(s), int(e), int(level_sorted[s])) for s, e in zip(starts_r, ends_r)
    )

    e_order = np.argsort(rows, kind="stable")
    e_tgt, e_src = rows[e_order], cols[e_order]
    tgt_starts = np.searchsorted(e_tgt, np.arange(n + 1))

    idx_parts: list[np.ndarray] = []
    mask_parts: list[np.ndarray] = []
    buckets: list[tuple[int, int, int]] = []
    row_len = n + 1
    pos = int(np.searchsorted(bucket_sorted, 1))  # first node with in-degree >= 1
    while pos < n:
        b = int(bucket_sorted[pos])
        width = 1 << (b - 1)
        end = int(np.searchsorted(bucket_sorted, b + 1))
        cnt = end - pos
        tbl = np.full((cnt, width), row_len - 1, dtype=np.int64)  # sentinel: row 0, col n
        msk = np.zeros((cnt, width), dtype=np.float32)
        nodes = order[pos:end]
        starts, ends_ = tgt_starts[nodes], tgt_starts[nodes + 1]
        counts = ends_ - starts
        flat = _ranges(starts, ends_)
        row_pos = np.repeat(np.arange(cnt), counts)
        col_pos = np.arange(len(flat)) - np.repeat(np.cumsum(counts) - counts, counts)
        preds = e_src[flat]
        gaps = level[np.repeat(nodes, counts)] - level[preds]
        tbl[row_pos, col_pos] = (gaps - 1) * row_len + inv[preds]
        msk[row_pos, col_pos] = 1.0
        idx_parts.append(tbl.reshape(-1))
        mask_parts.append(msk.reshape(-1))
        buckets.append((pos, end, width))
        pos = end

    wf_idx = np.concatenate(idx_parts) if idx_parts else np.zeros(0, dtype=np.int64)
    wf_mask = np.concatenate(mask_parts) if mask_parts else np.zeros(0, dtype=np.float32)
    return order, inv, wf_idx, wf_mask, tuple(buckets), level_runs


def _transposed_wavefront_tables(
    rows: np.ndarray, cols: np.ndarray, n: int, level: np.ndarray, inv: np.ndarray
) -> tuple[np.ndarray, int]:
    """Successor (transposed-adjacency) gather table for the reverse scan of
    the analytic adjoint: node i's row (wf order) lists ``(gap - 1) * (n + 1) +
    inv[j]`` for each successor j, padded to a power-of-two width with the
    sentinel. Returns ``(flat (n * width,) table, width)``."""
    row_len = n + 1
    order_s = np.argsort(cols, kind="stable")
    s_src, s_tgt = cols[order_s], rows[order_s]
    src_starts = np.searchsorted(s_src, np.arange(n + 1))
    out_deg = src_starts[1:] - src_starts[:-1]
    max_out = int(out_deg.max()) if n and rows.size else 0
    width = 1 if max_out <= 1 else 1 << int(max_out - 1).bit_length()
    tbl = np.full((n, width), row_len - 1, dtype=np.int64)
    if rows.size:
        nzn = np.flatnonzero(out_deg)
        starts, ends_ = src_starts[nzn], src_starts[nzn + 1]
        counts = ends_ - starts
        flat = _ranges(starts, ends_)
        row_pos = np.repeat(inv[nzn], counts)
        col_pos = np.arange(len(flat)) - np.repeat(np.cumsum(counts) - counts, counts)
        succ = s_tgt[flat]
        gaps = level[succ] - level[np.repeat(nzn, counts)]
        tbl[row_pos, col_pos] = (gaps - 1) * row_len + inv[succ]
    return tbl.reshape(-1), width


def _node_slots(n: int, buckets: tuple) -> tuple[np.ndarray, np.ndarray]:
    """Per node in wf order, its ``(first slot, slot count)`` in the flat
    bucket-concatenated table (in-degree-0 nodes: count 0), so a kernel
    thread finds its predecessors without walking the buckets."""
    slot = np.zeros(n, dtype=np.int64)
    width = np.zeros(n, dtype=np.int64)
    off = 0
    for start, end, w in buckets:
        slot[start:end] = off + np.arange(end - start) * w
        width[start:end] = w
        off += (end - start) * w
    return slot, width


def build_network(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    fused: bool | None = None,
    wavefront: bool | None = None,
    level: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> RiverNetwork:
    """Build the solve schedules and the wavefront tables from a COO
    adjacency onto ``device``, by the JAX package's rules.

    ``fused=None`` builds the fused solve schedule where the network's
    depth and degrees fit its limits; ``True`` insists (and raises where
    they do not fit), ``False`` skips it. ``wavefront=None`` builds the
    wavefront tables where the single-ring caps fit
    (:func:`single_ring_eligible`); ``True`` builds them past the caps (a
    band of the depth-chunked router), still refusing flat ring indices that
    overflow int32; ``False`` skips them, so a deep network can be built for
    the step engine. ``single_ring`` records the caps' verdict either way.
    ``level`` passes a layering the caller already has.
    """
    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if level is None:
        level = compute_levels(rows, cols, n) if n else np.zeros(0, dtype=np.int32)
    lvl_src, lvl_tgt, depth = level_schedule(rows, cols, n, level=level)
    in_deg = np.bincount(rows, minlength=n) if rows.size else np.zeros(n, dtype=np.int64)
    out_deg = np.bincount(cols, minlength=n) if cols.size else np.zeros(n, dtype=np.int64)
    max_in = int(in_deg.max()) if n else 0
    max_out = int(out_deg.max()) if n else 0

    eligible = (depth <= FUSED_MAX_DEPTH and max_in <= FUSED_MAX_IN_DEGREE
                and max_out <= FUSED_MAX_OUT_DEGREE)
    if fused is None:
        fused = eligible
    elif fused and not eligible:
        raise ValueError(
            f"network exceeds fused-schedule limits (depth={depth}, in={max_in}, out={max_out})"
        )
    if fused:
        perm = np.lexsort((np.arange(n), level))  # level-major, stable within a level
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        counts = np.bincount(level, minlength=depth + 1)
        level_starts = tuple(np.concatenate([[0], np.cumsum(counts)]).tolist())
        pred = _padded_adjacency_table(inv[rows], inv[cols], n, max_in)
        down = _padded_adjacency_table(inv[cols], inv[rows], n, max_out)
    else:
        perm = inv = np.zeros(0, dtype=np.int64)
        pred = down = np.zeros((0, 1), dtype=np.int64)
        level_starts = ()

    single_ring = single_ring_eligible(depth, max_in, n)
    if wavefront is None:
        wavefront = single_ring
    elif wavefront and not (depth + 2) * (n + 1) < 2**31:
        raise ValueError(
            f"wavefront ring indices overflow int32 (depth={depth}, n={n}); "
            "build_routing_network gives such a network a band router"
        )
    if wavefront:
        wf_perm, wf_inv, wf_idx, wf_mask, buckets, runs = _wavefront_tables(
            rows, cols, n, level, in_deg
        )
        wf_t_idx, wf_t_width = _transposed_wavefront_tables(rows, cols, n, level, wf_inv)
        gap_max = int((level[rows] - level[cols]).max()) if rows.size else 0
        ring_rows = min(depth, gap_max) + 2
        slot, width = _node_slots(n, buckets)
        level_p = level[wf_perm]
    else:
        wf_perm = wf_inv = wf_idx = wf_t_idx = slot = width = level_p = np.zeros(0, dtype=np.int64)
        wf_mask = np.zeros(0, dtype=np.float32)
        buckets = runs = ()
        wf_t_width = ring_rows = 0
    row_len = n + 1
    wf_row = wf_idx // row_len
    wf_t_row = wf_t_idx // row_len

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

    return RiverNetwork(
        n=int(n),
        depth=depth,
        n_edges=int(rows.size),
        single_ring=single_ring,
        edge_src=i32(cols),
        edge_tgt=i32(rows),
        lvl_src=i32(lvl_src),
        lvl_tgt=i32(lvl_tgt),
        perm=i32(perm),
        inv_perm=i32(inv),
        pred=i32(pred),
        down=i32(down),
        level_starts=level_starts,
        fused=bool(fused),
        wavefront=bool(wavefront),
        level=i32(level),
        level_p=i32(level_p),
        wf_perm=i32(wf_perm),
        wf_inv=i32(wf_inv),
        wf_idx=i32(wf_idx),
        wf_row=i32(wf_row),
        wf_col=i32(wf_idx - wf_row * row_len),
        wf_mask=torch.as_tensor(np.asarray(wf_mask, dtype=np.float32), device=dev),
        wf_slot=i32(slot),
        wf_width=i32(width),
        wf_t_idx=i32(wf_t_idx),
        wf_t_row=i32(wf_t_row),
        wf_t_col=i32(wf_t_idx - wf_t_row * row_len),
        wf_buckets=buckets,
        wf_level_runs=runs,
        wf_ring_rows=int(ring_rows),
        wf_t_width=int(wf_t_width),
    )
