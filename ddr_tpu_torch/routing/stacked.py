"""The stacked band router: deep networks as a loop over level bands.

The port of ``ddr_tpu/routing/stacked.py``. A network too deep or too wide
for the single-ring engine (:func:`~ddr_tpu_torch.routing.network.single_ring_eligible`)
has its level axis cut into bands, every band padded to one shared frame
(:class:`StackedChunked`, built on the host in O(E + C*K)):

* a unified slot layout: each band's nodes fill slots by in-degree-descending
  rank, so ``n_cap`` is the largest band and the per-slot gather width (the
  cross-band maximum of each rank's power-of-two degree bucket) is one
  non-increasing profile whose equal-width runs are the frame's buckets. The
  tail of that profile may have width 0: slots with no in-band predecessor
  in any band. Pad gather slots read the ring's zero sentinel column
  ``n_cap`` under mask 0, pad node slots (sentinels) take benign physics;
* one ring of ``ring_rows`` rows (the longest in-band level gap + 2);
* a boundary buffer ``(B, T, n_boundary + 1)`` that each band writes the raw
  series of its published sources into and reads its external predecessors
  from (:func:`~ddr_tpu_torch.routing.chunked.boundary_ext_series`).

Each band is one wave scan of ``T + span_max`` waves with external inflow
rows (``xe``/``se``) and masked raw sums (``mask_raw``) on the hand-written
forward kernel, differentiated by the analytic adjoint
(:class:`~ddr_tpu_torch.routing.wavefront.AnalyticRoute`) whose reverse scan
is the hand-written reverse kernel over the band's transposed tables. The
band loop is a Python loop of differentiable tensor ops, so autograd walks
the bands in reverse order and the cotangents of the published series flow
upstream through ``x_ext``/``s_ext``, as the JAX ``lax.scan`` carry does.

Semantics equal the single-ring engine's: ``output[0]`` is the clamped
hotstart solve, step t consumes ``q_prime[t-1]``, the clamp applies once per
timestep after the band-distributed solve.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.nn import functional as F
from torch.profiler import record_function

from ddr_tpu_torch.device import resolve_device
from ddr_tpu_torch.geometry.trapezoidal import maximum
from ddr_tpu_torch.routing.chunked import (
    CHUNK_CELL_BUDGET,
    boundary_buffer_columns,
    boundary_ext_series,
    pack_level_bands,
)
from ddr_tpu_torch.routing.network import _node_slots, compute_levels

__all__ = [
    "BandTables",
    "StackedChunked",
    "auto_band_count",
    "band_physics",
    "build_stacked_chunked",
    "frame_operands",
    "pack_level_bands_balanced",
    "route_stacked",
]

# The band-count cost model's constants for the H100 port. A wave costs a
# fixed time: the single-ring forward kernel's per-wave floor on the card,
# 3.284 ms over 584 waves at B 1 and 4.012 ms over 752 waves in a train step,
# 5.3-5.6 us, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6). The
# CUDA kernels never copy their ring (the JAX package prices a per-wave ring
# copy that XLA's scan carry pays), so the copy bandwidth is infinite and the
# model picks the fewest bands the CHUNK_CELL_BUDGET cap allows. Both are
# module constants so that a deployment (or a test) can set its own.
WAVE_FIXED_S = 5.5e-6
RING_COPY_BYTES_PER_S = math.inf


def auto_band_count(
    n: int,
    depth: int,
    t_nominal: int = 240,
    max_bands: int = 256,
    ring_rows_cap: int | None = None,
    wave_fixed_s: float | None = None,
    ring_copy_bps: float | None = None,
) -> int:
    """Band count minimizing ``(C * t_nominal + depth) * (fixed + ring
    bytes / copy rate)`` over powers of two up to ``max_bands``, among the
    counts whose span-sized ring fits :data:`CHUNK_CELL_BUDGET`.
    ``ring_rows_cap`` (``gap_max + 2`` when the caller has the layering)
    prices the gap-sized ring. The constants default to
    :data:`WAVE_FIXED_S` and :data:`RING_COPY_BYTES_PER_S`."""
    if depth <= 0 or n <= 0:
        return 1
    wave_fixed_s = WAVE_FIXED_S if wave_fixed_s is None else wave_fixed_s
    ring_copy_bps = RING_COPY_BYTES_PER_S if ring_copy_bps is None else ring_copy_bps
    best_c, best_cost = 1, float("inf")
    c = 1
    while c <= max_bands:
        span = max(1, -(-depth // c))
        nb = max(1, -(-n // c))
        rows = span + 1 if ring_rows_cap is None else min(span + 1, ring_rows_cap)
        ring = rows * (nb + 1)
        if (span + 1) * (nb + 1) <= CHUNK_CELL_BUDGET:
            waves = c * t_nominal + depth
            cost = waves * (wave_fixed_s + ring * 4 / ring_copy_bps)
            if cost < best_cost:
                best_cost, best_c = cost, c
        c *= 2
    return best_c


def pack_level_bands_balanced(
    counts: np.ndarray, target_span: int, target_nodes: int
) -> list[tuple[int, int]]:
    """Greedy banding bounded in both dimensions: cut when a band would
    exceed ``target_span`` levels or ``target_nodes`` nodes, so the frame's
    ``span_max`` and ``n_cap`` stay near the targets. A single over-wide
    level still forms its own band."""
    depth = len(counts) - 1
    bands: list[tuple[int, int]] = []
    s, acc = 0, 0
    for L in range(depth + 1):
        if L > s and (L - s >= target_span or acc + int(counts[L]) > target_nodes):
            bands.append((s, L))
            s, acc = L, 0
        acc += int(counts[L])
    bands.append((s, depth + 1))
    return bands


@dataclasses.dataclass(frozen=True, eq=False)
class BandTables:
    """One band of a :class:`StackedChunked` under the names the kernels and
    :class:`~ddr_tpu_torch.routing.wavefront.AnalyticRoute` read from a
    :class:`~ddr_tpu_torch.routing.network.RiverNetwork`: ``n`` is the
    frame's ``n_cap``, ``depth`` its ``span_max``, ``level_p`` the band-local
    levels (0 on sentinels), the gather and transposed tables the band's rows,
    ``wf_slot``/``wf_width``/``wf_buckets`` the frame's. ``frame`` lets the
    kernels range-check every band's tables once per frame, and ``index``
    (the band's place in it) keys the band's cached tables there."""

    n: int
    depth: int
    level_p: torch.Tensor
    wf_row: torch.Tensor
    wf_col: torch.Tensor
    wf_mask: torch.Tensor
    wf_slot: torch.Tensor
    wf_width: torch.Tensor
    wf_t_row: torch.Tensor
    wf_t_col: torch.Tensor
    wf_buckets: tuple
    wf_ring_rows: int
    wf_t_width: int
    frame: "StackedChunked"
    index: int


@dataclasses.dataclass(frozen=True, eq=False)
class StackedChunked:
    """The band-uniform stacked frame; per-band tensors have a leading band
    axis ``C``, all int32/float32 on one device, with the JAX package's field
    names and contents.

    Sentinels: node slots use ``n`` in ``gidx`` and level 0, boundary
    columns ``n_boundary`` (the buffer's scratch column, never read by a
    real slot), gather slots the ring's zero column ``n_cap``. The
    transposed tables hold ``t_width`` successor slots a node slot.
    ``wf_slot``/``wf_width`` (``(n_cap,)``, the port's addition) give each
    slot's run in the flat gather table, as ``RiverNetwork.wf_slot`` and
    ``wf_width`` do: width 0 where the frame's profile is 0.
    """

    gidx: torch.Tensor  # (C, n_cap) original node id per slot, sentinel n
    level: torch.Tensor  # (C, n_cap) band-local level per slot, 0 on sentinels
    wf_row: torch.Tensor  # (C, E_cap) ring row distance (gap - 1), 0 on pads
    wf_col: torch.Tensor  # (C, E_cap) ring column (source slot), n_cap on pads
    wf_mask: torch.Tensor  # (C, E_cap) 1.0 on real gather slots
    ext_cols: torch.Tensor  # (C, X_cap) boundary column of each external edge
    ext_tgt: torch.Tensor  # (C, X_cap) target slot, n_cap on pads
    pub_src: torch.Tensor  # (C, P_cap) published source slot, n_cap on pads
    pub_col: torch.Tensor  # (C, P_cap) boundary column to write, n_boundary on pads
    out_map: torch.Tensor  # (N,) flat c * n_cap + slot of each original node
    buckets: tuple  # ((slot_start, slot_end, width), ...), width may be 0
    n: int
    depth: int
    span_max: int
    n_cap: int
    n_edges: int
    n_boundary: int
    n_chunks: int
    t_row: torch.Tensor  # (C, n_cap * t_width) gap - 1 per successor slot
    t_col: torch.Tensor  # (C, n_cap * t_width) successor slot, n_cap on pads
    t_width: int
    ring_rows: int  # longest in-band level gap + 2
    orig_level: torch.Tensor  # (N,) longest-path level, original order
    wf_slot: torch.Tensor  # (n_cap,) first gather slot of each node slot
    wf_width: torch.Tensor  # (n_cap,) gather slot count of each node slot

    @property
    def device(self) -> torch.device:
        return self.gidx.device

    # the transposed tables under RiverNetwork's names, for the range check
    @property
    def wf_t_row(self) -> torch.Tensor:
        return self.t_row

    @property
    def wf_t_col(self) -> torch.Tensor:
        return self.t_col

    def band(self, c: int) -> BandTables:
        """Band ``c``'s tables as the kernels take them."""
        return BandTables(
            n=self.n_cap, depth=self.span_max, level_p=self.level[c],
            wf_row=self.wf_row[c], wf_col=self.wf_col[c], wf_mask=self.wf_mask[c],
            wf_slot=self.wf_slot, wf_width=self.wf_width,
            wf_t_row=self.t_row[c], wf_t_col=self.t_col[c],
            wf_buckets=self.buckets, wf_ring_rows=self.ring_rows, wf_t_width=self.t_width,
            frame=self, index=c,
        )


def build_stacked_chunked(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    cell_budget: int | None = None,
    level: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> StackedChunked:
    """Band the level axis and build the band-uniform frame onto ``device``:
    :func:`auto_band_count` and :func:`pack_level_bands_balanced` by
    default, :func:`~ddr_tpu_torch.routing.chunked.pack_level_bands` under
    an explicit ``cell_budget``. The arrays equal the JAX builder's for the
    same band count. O(E) host work beyond the Kahn layering."""
    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if level is None:
        level = compute_levels(rows, cols, n)
    depth = int(level.max()) if n else 0
    counts = np.bincount(level, minlength=depth + 1)
    # the whole graph's max edge level-gap prices the gap-sized ring
    gap_all = int((level[rows] - level[cols]).max()) if rows.size else 0
    if cell_budget is None:
        c_star = auto_band_count(n, depth, ring_rows_cap=gap_all + 2)
        bands = pack_level_bands_balanced(
            counts, max(1, -(-depth // c_star)), max(1, -(-n // c_star))
        )
    else:
        bands = pack_level_bands(counts, cell_budget)
    C = len(bands)
    band_lo = np.array([lo for lo, _ in bands], dtype=np.int64)
    span_max = max(hi - lo for lo, hi in bands)

    band_of_level = np.empty(depth + 1, dtype=np.int64)
    for ci, (lo, hi) in enumerate(bands):
        band_of_level[lo:hi] = ci
    band = band_of_level[level]

    tgt_band = band[rows]
    is_ext = band[cols] != tgt_band  # levels rise along edges: src band <= tgt band
    loc_rows, loc_cols = rows[~is_ext], cols[~is_ext]
    ext_src_o, ext_tgt_o = cols[is_ext], rows[is_ext]

    # --- degree-rank slot frame (in-band edges only) ---
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, loc_rows, 1)
    width_of = np.zeros(n, dtype=np.int64)
    nz = deg > 0
    width_of[nz] = 1 << np.ceil(np.log2(deg[nz])).astype(np.int64)
    width_of[deg == 1] = 1

    n_band = np.bincount(band, minlength=C) if n else np.zeros(C, dtype=np.int64)
    n_cap = int(n_band.max()) if C else 0
    order = np.lexsort((np.arange(n), level, -width_of, band))
    band_sorted = band[order]
    first = np.searchsorted(band_sorted, np.arange(C))
    rank = np.arange(n) - first[band_sorted]
    slot = np.empty(n, dtype=np.int64)
    slot[order] = rank

    wp = np.zeros(n_cap, dtype=np.int64)  # per-slot width profile (non-increasing)
    np.maximum.at(wp, rank, width_of[order])
    e_off = np.concatenate([[0], np.cumsum(wp)])
    e_cap = max(1, int(e_off[-1]))
    change = np.flatnonzero(np.diff(wp) != 0) + 1
    starts_r = np.concatenate([[0], change])
    ends_r = np.concatenate([change, [n_cap]])
    buckets = (
        tuple((int(s), int(e), int(wp[s])) for s, e in zip(starts_r, ends_r))
        if n_cap
        else ()
    )

    gidx = np.full((C, n_cap), n, dtype=np.int64)
    gidx[band, slot] = np.arange(n)
    level_s = np.zeros((C, n_cap), dtype=np.int64)
    level_s[band, slot] = level - band_lo[band]

    # --- in-band gather table in the unified frame ---
    row_len = n_cap + 1
    wf_row = np.zeros((C, e_cap), dtype=np.int64)
    wf_col = np.full((C, e_cap), n_cap, dtype=np.int64)  # ring sentinel column
    wf_mask = np.zeros((C, e_cap), dtype=np.float32)
    if loc_rows.size:
        ekey = band[loc_rows] * np.int64(n_cap) + slot[loc_rows]
        es = np.argsort(ekey, kind="stable")
        ek = ekey[es]
        seq = np.arange(len(ek)) - np.searchsorted(ek, ek)
        t_node = loc_rows[es]
        base = e_off[slot[t_node]]
        wf_row[band[t_node], base + seq] = level[t_node] - level[loc_cols[es]] - 1
        wf_col[band[t_node], base + seq] = slot[loc_cols[es]]
        wf_mask[band[t_node], base + seq] = 1.0

    # --- boundary buffer wiring (shared column layout) ---
    buf_src, col_of_src, b_starts = boundary_buffer_columns(ext_src_o, band, n, C)
    B_total = len(buf_src)
    p_cap = max(1, int(np.max(b_starts[1:] - b_starts[:-1])) if C else 1)
    pub_src = np.full((C, p_cap), n_cap, dtype=np.int64)
    pub_col = np.full((C, p_cap), B_total, dtype=np.int64)
    for ci in range(C):
        pub = buf_src[b_starts[ci] : b_starts[ci + 1]]
        pub_src[ci, : len(pub)] = slot[pub]
        pub_col[ci, : len(pub)] = np.arange(b_starts[ci], b_starts[ci + 1])

    x_cnt = np.bincount(band[ext_tgt_o], minlength=C) if ext_tgt_o.size else np.zeros(C, int)
    x_cap = max(1, int(x_cnt.max()) if C else 1)
    ext_cols = np.full((C, x_cap), B_total, dtype=np.int64)
    ext_tgt = np.full((C, x_cap), n_cap, dtype=np.int64)
    if ext_tgt_o.size:
        xb = band[ext_tgt_o]
        xs_ = np.argsort(xb, kind="stable")
        xseq = np.arange(len(xs_)) - np.searchsorted(xb[xs_], xb[xs_])
        ext_cols[xb[xs_], xseq] = col_of_src[ext_src_o[xs_]]
        ext_tgt[xb[xs_], xseq] = slot[ext_tgt_o[xs_]]

    # --- transposed (successor) tables for the reverse scan: per source
    # slot, its in-band successors at one width (max in-band out-degree,
    # rounded up to a power of two; dendritic rivers: 1) ---
    odeg = np.zeros(n, dtype=np.int64)
    np.add.at(odeg, loc_cols, 1)
    max_out = int(odeg.max()) if loc_cols.size else 0
    t_width = 1 if max_out <= 1 else 1 << int(max_out - 1).bit_length()
    t_row = np.zeros((C, n_cap * t_width), dtype=np.int64)
    t_col = np.full((C, n_cap * t_width), n_cap, dtype=np.int64)  # ring sentinel column
    if loc_cols.size:
        skey = band[loc_cols] * np.int64(n_cap) + slot[loc_cols]
        ss = np.argsort(skey, kind="stable")
        sk = skey[ss]
        sseq = np.arange(len(sk)) - np.searchsorted(sk, sk)
        s_node, tgt_node = loc_cols[ss], loc_rows[ss]
        t_row[band[s_node], slot[s_node] * t_width + sseq] = level[tgt_node] - level[s_node] - 1
        t_col[band[s_node], slot[s_node] * t_width + sseq] = slot[tgt_node]

    out_map = band * np.int64(n_cap) + slot
    gap_max = int((level[loc_rows] - level[loc_cols]).max()) if loc_rows.size else 0
    ring_rows = min(span_max, gap_max) + 2

    if (span_max + 2) * row_len >= 2**31:
        raise ValueError(
            f"stacked ring overflows int32 (span_max={span_max}, n_cap={n_cap}); "
            "lower the cell budget"
        )
    node_slot, node_width = _node_slots(n_cap, buckets)

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

    return StackedChunked(
        gidx=i32(gidx),
        level=i32(level_s),
        wf_row=i32(wf_row),
        wf_col=i32(wf_col),
        wf_mask=torch.as_tensor(wf_mask, device=dev),
        ext_cols=i32(ext_cols),
        ext_tgt=i32(ext_tgt),
        pub_src=i32(pub_src),
        pub_col=i32(pub_col),
        out_map=i32(out_map),
        buckets=buckets,
        n=int(n),
        depth=depth,
        span_max=int(span_max),
        n_cap=n_cap,
        n_edges=int(rows.size),
        n_boundary=int(B_total),
        n_chunks=C,
        t_row=i32(t_row),
        t_col=i32(t_col),
        t_width=int(t_width),
        ring_rows=int(ring_rows),
        orig_level=i32(level),
        wf_slot=i32(node_slot),
        wf_width=i32(node_width),
    )


def frame_operands(channels, spatial_params: dict, n: int, device) -> tuple[torch.Tensor, ...]:
    """The per-reach operands in :func:`~ddr_tpu_torch.routing.wave_kernel.reach_operands`
    order (n, p, q, slope, length, x_storage), each ``(n + 1,)`` with the
    sentinel slot's pad value at ``n``: 1 for n/p/q, slope and length, 0
    for x, as the JAX router pads them, so a sentinel's physics stays
    finite. Scalar parameters broadcast. Differentiable in every input."""

    def padded(a, pad: float) -> torch.Tensor:
        a = torch.as_tensor(a, dtype=torch.float32, device=device)
        if a.dim() == 0:
            a = a.expand(n)
        return torch.cat([a, a.new_full((1,), pad)])

    return (
        padded(spatial_params["n"], 1.0),
        padded(spatial_params["p_spatial"], 1.0),
        padded(spatial_params["q_spatial"], 1.0),
        padded(channels.slope, 1.0),
        padded(channels.length, 1.0),
        padded(channels.x_storage, 0.0),
    )


def band_physics(ops_pad: tuple, gidx_c: torch.Tensor, bounds, dt: float):
    """Band ``c``'s :class:`~ddr_tpu_torch.routing.wave_kernel.ReachPhysics`:
    the padded operands of :func:`frame_operands` gathered at its slots
    ``gidx_c`` (int64). The observed-geometry overrides do not enter the
    celerity, so the band's channel state carries none."""
    from ddr_tpu_torch.routing.mc import ChannelState
    from ddr_tpu_torch.routing.wave_kernel import ReachPhysics

    # index_select, not a[gidx_c]: its backward is one index_add, where the
    # advanced-indexing backward sorts (3.3 ms a band at the continental
    # shape, PERF.md)
    n_, p_, q_, slope, length, x = (a.index_select(0, gidx_c) for a in ops_pad)
    return ReachPhysics(
        n=n_, p_spatial=p_, q_spatial=q_,
        channels=ChannelState(length=length, slope=slope, x_storage=x),
        bounds=bounds, dt=float(dt),
    )


def route_stacked(
    network: StackedChunked,
    channels,
    spatial_params: dict[str, torch.Tensor],
    q_prime: torch.Tensor,
    q_init: torch.Tensor | None = None,
    gauges=None,
    bounds=None,
    dt: float = 3600.0,
    kernel: str | None = None,
    dtype: str = "fp32",
    collect_reach_stats: bool = False,
    adjoint: str = "analytic",
    remat_physics: bool = True,
):
    """Route ``(T, N)`` or ``(B, T, N)`` inflows band by band; the contract
    of :func:`~ddr_tpu_torch.routing.mc.route`, all inputs and outputs in
    original node order. ``kernel``, ``adjoint`` and ``remat_physics`` as
    there: ``None`` runs the hand-written scans (their plain versions on the
    CPU), ``"reference"`` the plain versions on any device. ``dtype="bf16"`` runs every band's forward scan
    on a bfloat16 ring, so the series a band publishes are the rounded raw
    values. ``collect_reach_stats=True`` adds the original-order
    :class:`~ddr_tpu_torch.observability.health.ReachStats` of the clamped
    per-slot solve as ``RouteResult.reach_stats`` (sentinel slots drop out
    of the ``out_map`` gather).

    Per band: the band's slots gather the per-reach operands, inflows and
    ``q_init`` (sentinel slots take length 1, slope 1, ``x`` 0, n/p/q 1 and
    zero inflow, as in the JAX router, so their physics stays finite; their
    values are never gathered, published or selected); the boundary buffer
    gives ``x_ext``/``s_ext``; :func:`~ddr_tpu_torch.routing.wavefront.route_raw`
    runs the band; the band publishes its boundary sources' raw series.
    """
    from ddr_tpu_torch.routing.mc import Bounds, RouteResult
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
    C, n_cap = network.n_chunks, network.n_cap
    dev = qp.device

    ops_pad = frame_operands(channels, spatial_params, N, dev)
    qp_pad = F.pad(qp, (0, 1))
    qi_pad = None if q_init is None else F.pad(q_init.float().expand(B, N), (0, 1))
    gidx = network.gidx.long()
    ext_cols, ext_tgt = network.ext_cols.long(), network.ext_tgt.long()
    pub_src, pub_col = network.pub_src.long(), network.pub_col.long()

    bnd = qp.new_zeros(B, T, network.n_boundary + 1)
    raws = []
    for c in range(C):
        with record_function("ddr::band_inputs"):
            g = gidx[c]
            physics = band_physics(ops_pad, g, bounds, dt)
            qp_c = qp_pad.index_select(2, g)
            qi_c = None if qi_pad is None else qi_pad.index_select(1, g)
            # pad edge slots read the scratch column (always 0) and add into
            # the dropped slot n_cap
            x_ext, s_ext = boundary_ext_series(bnd, ext_cols[c], ext_tgt[c], n_cap + 1, lb)
            x_ext, s_ext = x_ext[..., :n_cap], s_ext[..., :n_cap]
        raw = route_raw(qp_c, qi_c, x_ext, s_ext, network.band(c), physics, kernel, True, dtype,
                        adjoint, remat_physics)
        with record_function("ddr::band_publish"):
            # Pad slots all copy the always-zero pad column n_cap into the
            # scratch column n_boundary: their duplicate writes land only
            # there, all write 0, and no real slot reads that column, so the
            # result does not depend on which write lands last.
            raw_pad = F.pad(raw, (0, 1))
            bnd = bnd.index_copy(2, pub_col[c], raw_pad.index_select(2, pub_src[c]))
        raws.append(raw)
        del qp_c, qi_c, x_ext, s_ext, raw_pad

    flat = torch.cat(raws, dim=-1)  # (B, T, C * n_cap), column c * n_cap + slot
    del raws
    out_map = network.out_map.long()
    reach = None
    if collect_reach_stats:
        from ddr_tpu_torch.observability.health import compute_reach_stats

        reach = compute_reach_stats(maximum(flat.detach(), lb), qp, compute_dtype=dtype,
                                    runoff_inv=out_map)
    final = maximum(flat[:, -1].index_select(1, out_map), lb)
    if gauges is not None:
        # GaugeIndex.aggregate through out_map, clamping only the columns
        # the gauges read (the clamp is elementwise)
        sel = maximum(flat.index_select(2, out_map[gauges.flat_idx]), lb)
        runoff = sel.new_zeros(B, T, gauges.n_gauges).index_add(2, gauges.group_ids, sel)
    else:
        runoff = maximum(flat.index_select(2, out_map), lb)
    if single:
        runoff, final = runoff[0], final[0]
    return RouteResult(runoff=runoff, final_discharge=final, reach_stats=reach)
