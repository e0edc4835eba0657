"""Depth banding: the unrolled depth-chunked router, the engine choice and
the cross-band boundary contract.

The port of ``ddr_tpu/routing/chunked.py``. What it shares with the stacked
band router (:mod:`ddr_tpu_torch.routing.stacked`): the per-band ring-cell
cap, the level-band packer, the boundary-buffer column layout and its
forwarding contract, and :func:`build_routing_network`, which picks the
engine a network routes on. What is its own: :class:`ChunkedNetwork`, whose
bands are each a :class:`~ddr_tpu_torch.routing.network.RiverNetwork` of
their own (band-local ids, forced wavefront tables, sized to the band
rather than padded to one frame), and :func:`route_chunked`, which routes
them one after another through
:func:`~ddr_tpu_torch.routing.wavefront.route_raw` with the
external rows ``x_ext``/``s_ext`` of earlier bands and unmasked raw sums:
on a card, one ``wave_scan`` launch a band forward and one ``reverse_scan``
launch a band backward. It is the ablation path an explicit ``cell_budget``
selects.

Every edge points from a lower level to a strictly higher one, so a band only
ever reads boundary series that earlier bands published: one forward pass
over the bands suffices, and the backward walks them in reverse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geometry.trapezoidal import maximum
from ddr_tpu_torch.routing.network import build_network, compute_levels, single_ring_eligible

__all__ = [
    "CHUNK_CELL_BUDGET",
    "ChunkedNetwork",
    "auto_cell_budget",
    "boundary_buffer_columns",
    "boundary_ext_series",
    "build_chunked_network",
    "build_routing_network",
    "pack_level_bands",
    "route_chunked",
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


def auto_cell_budget(
    n: int,
    depth: int,
    t_nominal: int = 240,
    max_bands: int = 64,
    ring_rows_cap: int | None = None,
    wave_fixed_s: float | None = None,
    ring_copy_bps: float | None = None,
) -> int:
    """The band ring budget the wave cost model finds fastest: it minimizes
    ``(C * t_nominal + depth) * (fixed + ring bytes / copy rate)`` over
    power-of-two band counts ``C`` (uniform level widths, ``rho = n /
    depth``), among the budgets within :data:`CHUNK_CELL_BUDGET`, and
    returns the chosen count's span-sized budget (``ring_rows_cap``,
    ``gap_max + 2``, prices the gap-sized ring). The constants default to
    the stacked router's H100 ones,
    :data:`~ddr_tpu_torch.routing.stacked.WAVE_FIXED_S` (5.5 us a wave) and
    :data:`~ddr_tpu_torch.routing.stacked.RING_COPY_BYTES_PER_S` (infinite:
    the CUDA ring is device memory the kernel writes in place, never a scan
    carry that is copied each wave). With them there is no copy term, so the
    cost only grows with ``C``: the model picks the fewest bands whose
    budget fits the memory cap, and the budget is set by that cap, not by
    speed."""
    from ddr_tpu_torch.routing import stacked

    cap = CHUNK_CELL_BUDGET
    if depth <= 0 or n <= 0:
        return cap
    wave_fixed_s = stacked.WAVE_FIXED_S if wave_fixed_s is None else wave_fixed_s
    ring_copy_bps = stacked.RING_COPY_BYTES_PER_S if ring_copy_bps is None else ring_copy_bps
    rho = max(1.0, n / depth)
    best_budget, best_cost = cap, float("inf")
    c = 1
    while c <= max_bands:
        span = max(1, -(-depth // c))
        rows = span + 1 if ring_rows_cap is None else min(span + 1, ring_rows_cap)
        ring_cells = rows * (int(span * rho) + 1)
        budget_cells = (span + 1) * (int(span * rho) + 1)
        if budget_cells <= cap:
            cost = (c * t_nominal + depth) * (wave_fixed_s + ring_cells * 4 / ring_copy_bps)
            if cost < best_cost:
                best_cost, best_budget = cost, budget_cells
        c *= 2
    return max(best_budget, 2)


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkedNetwork:
    """Depth-banded topology: one network per band and the cross-band
    wiring, with the JAX package's field names and contents.

    ``chunks[c]`` is band ``c``'s :class:`~ddr_tpu_torch.routing.network.RiverNetwork`
    over band-local ids, built with forced wavefront tables (its local depth
    is at most the band's span). Per band, ``gidx[c]`` ``(n_c,)`` is the
    original id of each band-wf slot (one gather takes any per-reach input
    straight into the band's working order), ``pub_idx[c]`` the band-wf
    columns whose raw series it publishes to the boundary buffer,
    ``ext_cols[c]``/``ext_tgt[c]`` the buffer column and the band-wf target
    of each external predecessor edge. ``out_inv`` ``(N,)`` restores the
    original column order from the bands' concatenated output; ``level``
    ``(N,)`` is every reach's longest-path level, original order. All int32
    on one device."""

    chunks: tuple
    gidx: tuple
    pub_idx: tuple
    ext_cols: tuple
    ext_tgt: tuple
    out_inv: torch.Tensor
    n: int
    depth: int
    n_edges: int
    n_boundary: int
    n_chunks: int
    level: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.out_inv.device


def build_chunked_network(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    cell_budget: int | None = None,
    level: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> ChunkedNetwork:
    """Band the level axis greedily (:func:`pack_level_bands`: ``(span + 1) *
    (n_band + 1) <= cell_budget``, a single over-wide level forming a band
    of its own) and build each band's network onto ``device``.
    ``cell_budget=None`` takes :func:`auto_cell_budget`. O(E) host work
    beyond the Kahn layering; the arrays equal the JAX builder's."""
    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if level is None:
        level = compute_levels(rows, cols, n)
    depth = int(level.max()) if n else 0
    counts = np.bincount(level, minlength=depth + 1)
    if cell_budget is None:
        gap_all = int((level[rows] - level[cols]).max()) if rows.size else 0
        cell_budget = auto_cell_budget(n, depth, ring_rows_cap=gap_all + 2)
    bands = pack_level_bands(counts, cell_budget)
    n_chunks = len(bands)

    band_of_level = np.empty(depth + 1, dtype=np.int64)
    for ci, (lo, hi) in enumerate(bands):
        band_of_level[lo:hi] = ci
    band_of_node = band_of_level[level]
    perm = np.argsort(band_of_node, kind="stable")  # chunked order: original ids
    pos = np.empty(n, dtype=np.int64)  # original id -> chunked position
    pos[perm] = np.arange(n)
    band_sizes = np.bincount(band_of_node, minlength=n_chunks)
    offsets = np.concatenate([[0], np.cumsum(band_sizes)])

    tgt_band = band_of_node[rows]
    is_ext = band_of_node[cols] != tgt_band  # levels rise along edges: src band <= tgt band
    ext_src_o, ext_tgt_o = cols[is_ext], rows[is_ext]
    buf_src, col_of_src, b_starts = boundary_buffer_columns(ext_src_o, band_of_node, n, n_chunks)

    loc_rows, loc_cols = rows[~is_ext], cols[~is_ext]
    loc_band = tgt_band[~is_ext]
    e_order = np.argsort(loc_band, kind="stable")
    e_starts = np.searchsorted(loc_band[e_order], np.arange(n_chunks + 1))
    x_order = np.argsort(tgt_band[is_ext], kind="stable")
    x_starts = np.searchsorted(tgt_band[is_ext][x_order], np.arange(n_chunks + 1))

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

    chunks, gidx, pub_idx, ext_cols, ext_tgt, out_parts = [], [], [], [], [], []
    for ci in range(n_chunks):
        off, n_c = int(offsets[ci]), int(band_sizes[ci])
        esl = e_order[e_starts[ci] : e_starts[ci + 1]]  # band-local id: pos - off
        net = build_network(pos[loc_rows[esl]] - off, pos[loc_cols[esl]] - off, n_c, fused=False,
                            wavefront=True, device=dev)
        chunks.append(net)
        wf_perm = net.wf_perm.cpu().numpy().astype(np.int64)
        wf_inv = net.wf_inv.cpu().numpy().astype(np.int64)
        g = perm[off + wf_perm]  # band-wf slot -> original id
        gidx.append(i32(g))
        out_parts.append(g)
        pub = buf_src[b_starts[ci] : b_starts[ci + 1]]  # original ids this band publishes
        pub_idx.append(i32(wf_inv[pos[pub] - off]))
        xsl = x_order[x_starts[ci] : x_starts[ci + 1]]
        ext_cols.append(i32(col_of_src[ext_src_o[xsl]]))
        ext_tgt.append(i32(wf_inv[pos[ext_tgt_o[xsl]] - off]))

    concat_g = np.concatenate(out_parts) if out_parts else np.zeros(0, np.int64)
    out_inv = np.empty(n, dtype=np.int64)
    out_inv[concat_g] = np.arange(n)
    return ChunkedNetwork(
        chunks=tuple(chunks), gidx=tuple(gidx), pub_idx=tuple(pub_idx), ext_cols=tuple(ext_cols),
        ext_tgt=tuple(ext_tgt), out_inv=i32(out_inv), n=int(n), depth=depth,
        n_edges=int(rows.size), n_boundary=int(len(buf_src)), n_chunks=n_chunks, level=i32(level),
    )


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
    (:func:`~ddr_tpu_torch.routing.stacked.build_stacked_chunked`), or, under
    an explicit ``cell_budget``, the unrolled :class:`ChunkedNetwork` with
    exactly that banding; a graph of depth 0 keeps the plain network (the
    step engine routes it)."""
    from ddr_tpu_torch.routing.stacked import build_stacked_chunked

    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    level = compute_levels(rows, cols, n) if n else np.zeros(0, dtype=np.int32)
    depth = int(level.max()) if n else 0
    max_in = int(np.bincount(rows, minlength=n).max()) if rows.size else 0
    if depth > 0 and not single_ring_eligible(depth, max_in, n):
        if cell_budget is not None:
            return build_chunked_network(rows, cols, n, cell_budget=cell_budget, level=level,
                                         device=dev)
        return build_stacked_chunked(rows, cols, n, level=level, device=dev)
    return build_network(rows, cols, n, level=level, device=dev)


def route_chunked(
    network: ChunkedNetwork,
    channels,
    spatial_params: dict,
    q_prime: torch.Tensor,
    q_init: torch.Tensor | None = None,
    gauges=None,
    bounds=None,
    dt: float = 3600.0,
    remat_physics: bool = True,
    adjoint: str = "analytic",
    kernel: str | None = None,
    dtype: str = "fp32",
    collect_reach_stats: bool = False,
):
    """Route ``(T, N)`` or ``(B, T, N)`` inflows band by band; the contract
    of :func:`~ddr_tpu_torch.routing.mc.route`, all inputs and outputs in
    original node order, ``kernel``/``dtype``/``adjoint``/``remat_physics``
    forwarded to every band's
    :func:`~ddr_tpu_torch.routing.wavefront.route_raw`, whatever
    the band's own ``single_ring`` flag says (a band may exceed the
    in-degree cap). ``collect_reach_stats=True`` adds the original-order
    :class:`~ddr_tpu_torch.observability.health.ReachStats` of the clamped
    full-domain solve.

    Each band gathers its reaches' operands, inflows and ``q_init`` straight
    into its wf order through ``gidx``, reads ``x_ext``/``s_ext`` from the
    boundary buffer of the raw series earlier bands published, routes, and
    appends its own published columns to the buffer. The loop is out of
    place, so autograd walks the bands in reverse and the cotangents of the
    published series flow upstream through ``x_ext``/``s_ext``."""
    from ddr_tpu_torch.routing.mc import Bounds, RouteResult
    from ddr_tpu_torch.routing.stacked import band_physics, frame_operands
    from ddr_tpu_torch.routing.wave_kernel import validate_dtype
    from ddr_tpu_torch.routing.wavefront import route_raw

    if kernel not in (None, "reference"):
        raise ValueError(f"unknown kernel {kernel!r} (use None or 'reference')")
    validate_dtype(dtype)
    if bounds is None:
        bounds = Bounds()
    single = q_prime.dim() == 2
    qp = (q_prime[None] if single else q_prime).float()
    B, T, N = qp.shape
    if N != network.n:
        raise ValueError(f"q_prime has {N} reaches, the network {network.n}")
    lb = bounds.discharge
    # every gidx is a real reach: the sentinel pad slot of the operands is never read
    ops = frame_operands(channels, spatial_params, N, qp.device)
    qi = None if q_init is None else q_init.float().expand(B, N)

    bnd = qp.new_zeros(B, T, 0)  # raw boundary series, one column per published source
    outs, finals = [], []
    for ci, net in enumerate(network.chunks):
        with record_function("ddr::band_inputs"):
            g = network.gidx[ci].long()
            physics = band_physics(ops, g, bounds, dt)
            qp_c = qp.index_select(2, g)
            qi_c = None if qi is None else qi.index_select(1, g)
            x_ext = s_ext = None
            if network.ext_cols[ci].numel():
                x_ext, s_ext = boundary_ext_series(bnd, network.ext_cols[ci].long(),
                                                   network.ext_tgt[ci].long(), net.n, lb)
        raw_c = route_raw(qp_c, qi_c, x_ext, s_ext, net, physics, kernel, False, dtype, adjoint,
                          remat_physics)
        runoff_c = maximum(raw_c, lb)
        outs.append(runoff_c)
        finals.append(runoff_c[:, -1])
        if network.pub_idx[ci].numel():
            with record_function("ddr::band_publish"):
                bnd = torch.cat([bnd, raw_c.index_select(2, network.pub_idx[ci].long())], dim=2)
        del qp_c, qi_c, x_ext, s_ext, raw_c

    out_inv = network.out_inv.long()
    final = torch.cat(finals, dim=-1)[..., out_inv]
    full = torch.cat(outs, dim=-1)  # (B, T, N), band-concatenated order
    del outs
    reach = None
    if collect_reach_stats:
        from ddr_tpu_torch.observability.health import compute_reach_stats

        reach = compute_reach_stats(full, qp, compute_dtype=dtype, runoff_inv=out_inv)
    if gauges is not None:
        runoff = dataclasses.replace(gauges, flat_idx=out_inv[gauges.flat_idx]).aggregate(full)
    else:
        runoff = full[..., out_inv]
    if single:
        runoff, final = runoff[0], final[0]
    return RouteResult(runoff=runoff, final_discharge=final, reach_stats=reach)
