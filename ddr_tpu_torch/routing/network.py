"""River-network topology: the wavefront tables on a torch device.

The port's own copy of ``ddr_tpu/routing/network.py``'s numpy builders
(longest-path levels, the degree-bucketed wavefront gather tables, their
transpose, the single-ring eligibility rule), producing a
:class:`RiverNetwork` whose tables are int32/float32 tensors on one device.

An edge (src -> tgt) means reach ``src`` drains into reach ``tgt``; ``rows``
are targets and ``cols`` sources (the binsparse COO convention).

Only the wavefront schedule is built: the fused/step-engine fields of the JAX
network have no consumer in this port yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ddr_tpu_torch.device import resolve_device

__all__ = [
    "RiverNetwork",
    "build_network",
    "compute_levels",
    "single_ring_eligible",
]

# Heuristic single-ring caps, as in the JAX builder: beyond them a network
# routes on the stacked band router (routing/stacked.py).
WAVEFRONT_MAX_IN_DEGREE = 64
WAVEFRONT_MAX_DEPTH = 1024


@dataclasses.dataclass(frozen=True, eq=False)
class RiverNetwork:
    """Static river topology with the single-ring wavefront tables.

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
    device: str | torch.device = "cuda",
) -> RiverNetwork:
    """Build the wavefront tables from a COO adjacency onto ``device``.

    Tables are built whenever their flat int32 ring indices fit;
    ``single_ring`` records whether the single-ring engine may route the
    network (:func:`single_ring_eligible`, the JAX package's rule).
    """
    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    level = compute_levels(rows, cols, n) if n else np.zeros(0, dtype=np.int32)
    depth = int(level.max()) if n else 0
    in_deg = np.bincount(rows, minlength=n) if rows.size else np.zeros(n, dtype=np.int64)
    max_in = int(in_deg.max()) if n else 0
    if not (depth + 2) * (n + 1) < 2**31:
        raise ValueError(
            f"wavefront ring indices overflow int32 (depth={depth}, n={n}); "
            "build_routing_network gives such a network the stacked band router"
        )

    wf_perm, wf_inv, wf_idx, wf_mask, buckets, runs = _wavefront_tables(
        rows, cols, n, level, in_deg
    )
    wf_t_idx, wf_t_width = _transposed_wavefront_tables(rows, cols, n, level, wf_inv)
    gap_max = int((level[rows] - level[cols]).max()) if rows.size else 0
    ring_rows = min(depth, gap_max) + 2
    slot, width = _node_slots(n, buckets)
    row_len = n + 1
    wf_row = wf_idx // row_len
    wf_t_row = wf_t_idx // row_len

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

    return RiverNetwork(
        n=int(n),
        depth=depth,
        n_edges=int(rows.size),
        single_ring=single_ring_eligible(depth, max_in, n),
        level=i32(level),
        level_p=i32(level[wf_perm]),
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
