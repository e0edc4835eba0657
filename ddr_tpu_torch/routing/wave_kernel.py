"""The forward wave scan: a hand-written CUDA kernel and its plain versions.

Counterpart of ``ddr_tpu/routing/pallas_kernel.py``'s ``fused_wave_scan``
in its three uses: the single-ring engine (no external rows,
``mask_raw=False``), a band of the stacked band router (external rows
``xe``/``se``, ``mask_raw=True``) and a band of the unrolled depth-chunked
router (a single ring with external rows, ``mask_raw=False``), each with
the history ring stored in
fp32 or, under ``compute_dtype="bf16"``, in bfloat16 (bf16-compute /
fp32-accumulate, ``pallas_kernel.py:49-65``: every ring read is upcast
before any arithmetic, every sum and the carried ``s`` stay fp32, and each
wave's ``y`` is rounded once, at the ring store; ``ys`` carries the rounded
values upcast). Per wave ``w = 1..W`` every reach
``i`` (wf or band-slot order) advances its in-flight timestep ``t = w - 1 -
level[i]``:

* ``q_prev = max(ring[(w-1) % R, i], lb)`` and the MC chain gives c1..c4;
* its predecessor slots are gathered from the rotating ring and reduced
  twice: raw (the same-timestep solve sum, each slot times its mask under
  ``mask_raw``) plus ``xe`` gives ``x_pred``, clamped and masked gives the
  next wave's inflow sum ``s``;
* ``y = c2*(s + se) + c3*q_prev + c4*max(q', lb) + c1*x_pred``, with the
  hotstart diagonal (``t == 0``: ``y = q' + x_pred``), the ``q_init``
  override and zeros outside ``0 <= t < T``;
* ``y`` goes to ring row ``w % R`` and to ``ys[w-1]``.

Two layouts of the same scan. The JAX package's is pre-skewed: ``qs``,
``xe``, ``se`` and ``ys`` are ``(B, W, n)`` rows in wave order
(:func:`wave_scan_reference`, the plain version, and
:func:`wave_scan_autograd`, the same with an out-of-place ring for
``adjoint="ad"``). The card's is time-major: :func:`wave_scan_tm` reads
``q'``, ``x_ext`` and ``s_ext`` ``(B, T, n)`` at each reach's in-flight
timestep and writes ``raw (B, T, n)``, visiting per wave only the reaches
in band, which :func:`active_runs` lists as a few contiguous ranges. It
launches ``csrc/wave_scan.cu`` for CUDA tensors and runs
:func:`wave_scan_tm_reference`, which walks the same ranges, only for CPU
tensors; ``wave_scan_tm.launches`` counts kernel launches. The pre-skewed
:func:`wave_scan` has no kernel: it takes CPU tensors only. The analytic
adjoint reads the same chain through :func:`physics_derivatives` and
:func:`physics_pullback`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ddr_tpu_torch.geometry.trapezoidal import maximum
from ddr_tpu_torch.routing.mc import Bounds, ChannelState, celerity, muskingum_coefficients
from ddr_tpu_torch.routing.network import RiverNetwork

__all__ = [
    "DTYPES",
    "ActiveRuns",
    "ReachPhysics",
    "active_runs",
    "check_ring_table",
    "physics_coefficients",
    "physics_derivatives",
    "physics_pullback",
    "reduce_gathered",
    "ring_dtype",
    "slot_sum",
    "table_owner",
    "validate_dtype",
    "wave_barrier",
    "wave_scan",
    "wave_scan_autograd",
    "wave_scan_reference",
    "wave_scan_tm",
    "wave_scan_tm_reference",
]

#: The compute-dtype axis: the ring's storage type (every sum is fp32).
DTYPES = ("fp32", "bf16")


def validate_dtype(dtype: str) -> str:
    if dtype not in DTYPES:
        raise ValueError(f"unknown routing dtype {dtype!r} (use 'fp32' or 'bf16')")
    return dtype


def ring_dtype(compute_dtype: str, acc_dtype: torch.dtype = torch.float32) -> torch.dtype:
    """Storage dtype of the history ring for a routing compute dtype."""
    return torch.bfloat16 if validate_dtype(compute_dtype) == "bf16" else acc_dtype


@dataclasses.dataclass(frozen=True)
class ReachPhysics:
    """The MC chain's operands, per reach in wf order: Manning ``n``,
    Leopold & Maddock ``p_spatial``/``q_spatial`` (``(n,)`` float32), the
    channel state, the bounds and the timestep."""

    n: torch.Tensor
    p_spatial: torch.Tensor
    q_spatial: torch.Tensor
    channels: ChannelState
    bounds: Bounds
    dt: float


def physics_coefficients(q_prev: torch.Tensor, phys: ReachPhysics):
    """c1..c4 at clamped discharge ``q_prev`` (``(..., n)``): trapezoidal
    velocity -> celerity -> Muskingum coefficients, the chain the kernel
    hard-codes."""
    c = celerity(q_prev, phys.n, phys.p_spatial, phys.q_spatial, phys.channels, phys.bounds)[0]
    return muskingum_coefficients(phys.channels.length, c, phys.channels.x_storage, phys.dt)


def reach_operands(phys: ReachPhysics) -> tuple[torch.Tensor, ...]:
    """The per-reach operands of the MC chain, in the order the kernels and
    the analytic adjoint take them: ``n, p_spatial, q_spatial, slope, length,
    x_storage``."""
    ch = phys.channels
    return (phys.n, phys.p_spatial, phys.q_spatial, ch.slope, ch.length, ch.x_storage)


def with_operands(phys: ReachPhysics, ops) -> ReachPhysics:
    """``phys`` with its :func:`reach_operands` replaced by ``ops``."""
    n, p, q, slope, length, x = ops
    channels = dataclasses.replace(phys.channels, slope=slope, length=length, x_storage=x)
    return dataclasses.replace(phys, n=n, p_spatial=p, q_spatial=q, channels=channels)


def physics_derivatives(q_prev: torch.Tensor, phys: ReachPhysics):
    """``(c1..c4), (d1..d4)`` at ``q_prev`` over any leading shape, with
    ``d_k = dc_k / dq_prev`` elementwise: one forward-mode pass with a ones
    tangent (the JAX backward's ``jax.linearize`` evaluated at ones). The
    per-reach operands are held constant."""
    consts = with_operands(phys, [t.detach() for t in reach_operands(phys)])
    return torch.func.jvp(
        lambda q: physics_coefficients(q, consts), (q_prev,), (torch.ones_like(q_prev),)
    )


def physics_pullback(q_prev: torch.Tensor, phys: ReachPhysics, c_bar, needs) -> list:
    """The pullback of cotangents ``c_bar = (c1_bar..c4_bar)`` (each shaped
    like ``q_prev``, ``(..., n)``) to the :func:`reach_operands`, summed over
    the leading axes: one list entry per operand, ``None`` where
    ``needs`` is false. Rebuilds the elementwise chain under autograd (the JAX
    backward's ``linear_transpose`` of its linearization)."""
    if not any(needs):
        return [None] * len(needs)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(need)) for t, need in zip(reach_operands(phys), needs)]
        cs = physics_coefficients(q_prev.detach(), with_operands(phys, leaves))
        wanted = [leaf for leaf, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(cs, wanted, c_bar, allow_unused=True))
    return [next(grads) if need else None for need in needs]


def slot_sum(blk: torch.Tensor) -> torch.Tensor:
    """``blk.sum(-1)`` added left to right, slot 0 first: the order in which
    the kernels sum a node's slots, so the plain versions round alike."""
    out = blk[..., 0]
    for k in range(1, blk.shape[-1]):
        out = out + blk[..., k]
    return out


def reduce_gathered(gathered, wf_mask, buckets, n_deg0, lb, clamped, mask_raw):
    """Per-node sums of the flat bucket-concatenated gather, ``(..., E) ->
    (..., n)``, in slot order (:func:`slot_sum`): raw (pad slots read the
    ring's zero sentinel, so no mask unless ``mask_raw``) or clamped
    (``max(v, lb) * mask``)."""
    lead = gathered.shape[:-1]
    parts = [gathered.new_zeros(lead + (n_deg0,))] if n_deg0 else []
    off = 0
    for node_start, node_end, width in buckets:
        cnt_nodes = node_end - node_start
        if width == 0:  # a band frame's tail: slots without in-band predecessors
            parts.append(gathered.new_zeros(lead + (cnt_nodes,)))
            continue
        cnt = cnt_nodes * width
        blk = gathered[..., off : off + cnt].reshape(lead + (cnt_nodes, width))
        msk = wf_mask[off : off + cnt].reshape(cnt_nodes, width)
        if clamped:
            blk = maximum(blk, lb) * msk
        elif mask_raw:
            blk = blk * msk
        parts.append(slot_sum(blk))
        off += cnt
    if not parts:
        return gathered.new_zeros(lead + (n_deg0,))
    return torch.cat(parts, dim=-1)


def _wave(prev_row, gathered, s_state, q_row, xe_row, se_row, t_node, T, q_init, phys, network,
          mask_raw, coefficients=physics_coefficients):
    """One wave of the scan over ``(B, n)``, from the previous wave's ring row
    ``prev_row`` and the gathered predecessor slots ``gathered`` ``(B, E)``
    (both upcast to fp32): returns ``(y, s_next)``, the raw solve values
    (zero outside ``0 <= t < T``) and the next wave's clamped inflow sums.
    ``coefficients`` evaluates the MC chain (a checkpointed one in the
    autograd scan)."""
    lb = phys.bounds.discharge
    buckets = network.wf_buckets
    n_deg0 = buckets[0][0] if buckets else network.n
    q_prev = maximum(prev_row, lb)
    c1, c2, c3, c4 = coefficients(q_prev, phys)
    x_pred = reduce_gathered(gathered, network.wf_mask, buckets, n_deg0, lb, False, mask_raw)
    s_next = reduce_gathered(gathered, network.wf_mask, buckets, n_deg0, lb, True, mask_raw)
    if xe_row is not None:
        x_pred = x_pred + xe_row
    s_in = s_state if se_row is None else s_state + se_row
    b_step = c2 * s_in + c3 * q_prev + c4 * maximum(q_row, lb)
    is_hot = t_node == 0
    b = torch.where(is_hot, q_row, b_step)
    c1_eff = torch.where(is_hot, torch.ones_like(c1), c1)
    y = b + c1_eff * x_pred
    if q_init is not None:
        y = torch.where(is_hot, maximum(q_init, lb), y)
    ok = (t_node >= 0) & (t_node <= T - 1)
    return torch.where(ok, y, torch.zeros_like(y)), s_next


def _ring_slots(network, R: int, h1: int) -> torch.Tensor:
    """Flat ring index ``rot * (n + 1) + col`` of every gather slot at a
    wave whose previous output row is ``h1``."""
    rot = h1 - network.wf_row.long()
    rot = torch.where(rot < 0, rot + R, rot)
    return rot * (network.n + 1) + network.wf_col.long()


def wave_scan_reference(
    qs: torch.Tensor,
    network: RiverNetwork,
    phys: ReachPhysics,
    q_init: torch.Tensor | None = None,
    *,
    T: int,
    xe: torch.Tensor | None = None,
    se: torch.Tensor | None = None,
    mask_raw: bool = False,
    compute_dtype: str = "fp32",
) -> torch.Tensor:
    """The plain PyTorch wave scan: a Python loop over waves, vectorized
    over ``(B, n)``. ``qs`` is the pre-skewed ``(B, W, n)`` inflow, ``q_init``
    ``(B, n)`` or None, ``xe``/``se`` the pre-skewed ``(B, W, n)`` external
    inflow rows or None; returns the raw per-wave solve values ``(B, W,
    n)``. ``network`` is a RiverNetwork or a band of a stacked frame.
    ``compute_dtype="bf16"`` stores the ring in bfloat16: ``.float()`` on
    every ring read, one ``.to(torch.bfloat16)`` at the store, and ``ys``
    set to the rounded value upcast (for fp32 both are no-ops)."""
    ring_dt = ring_dtype(compute_dtype, qs.dtype)
    B, W, n = qs.shape
    R = network.wf_ring_rows
    row_len = n + 1
    lvl = network.level_p.long()

    ring = qs.new_zeros(B, R * row_len, dtype=ring_dt)
    s_state = qs.new_zeros(B, n)
    ys = qs.new_empty(B, W, n)
    for w in range(1, W + 1):
        h1 = (w - 1) % R
        gathered = ring[:, _ring_slots(network, R, h1)].float()  # fp32 before any sum
        y, s_state = _wave(
            ring[:, h1 * row_len : h1 * row_len + n].float(), gathered, s_state, qs[:, w - 1],
            None if xe is None else xe[:, w - 1], None if se is None else se[:, w - 1],
            w - 1 - lvl, T, q_init, phys, network, mask_raw,
        )
        h = w % R
        y_store = y.to(ring_dt)  # the one rounding point
        ring[:, h * row_len : h * row_len + n] = y_store  # column n stays the zero sentinel
        ys[:, w - 1] = y_store.float()
    return ys


def wave_scan_tm_reference(
    qp: torch.Tensor,
    network: RiverNetwork,
    phys: ReachPhysics,
    q_init: torch.Tensor | None = None,
    *,
    x_ext: torch.Tensor | None = None,
    s_ext: torch.Tensor | None = None,
    mask_raw: bool = False,
    compute_dtype: str = "fp32",
) -> torch.Tensor:
    """The plain PyTorch time-major wave scan: ``q' (B, T, n) -> raw (B, T,
    n)``, with ``x_ext``/``s_ext`` ``(B, T, n)`` or None. Per wave it walks
    :func:`active_runs`: the reaches in band read ``q'[clip(t - 1, 0, T -
    2)]``, ``x_ext[t]`` and ``s_ext[t]`` at their timestep ``t`` and write
    ``raw[t]``, the ring and ``s``; no other reach writes anything, the
    kernel's ring policy. The wave itself is :func:`wave_scan_reference`'s,
    over all ``(B, n)``, so this equals ``wave_scan_reference`` between the
    skews bit for bit."""
    ring_dt = ring_dtype(compute_dtype, qp.dtype)
    B, T, n = qp.shape
    R = network.wf_ring_rows
    row_len = n + 1
    lvl = network.level_p.long()
    runs = active_runs(network, T)
    tq_max = max(T - 2, 0)

    def rows_at(a, idx, t):
        out = a.new_zeros(B, n)
        out[:, idx] = a[:, t, idx]
        return out

    ring = qp.new_zeros(B, R * row_len, dtype=ring_dt)
    s_state = qp.new_zeros(B, n)
    raw = qp.new_empty(B, T, n)
    for w in range(1, T + network.depth + 1):
        idx = runs.nodes(w)
        if idx.numel() == 0:
            continue
        t = w - 1 - lvl[idx]
        h1 = (w - 1) % R
        gathered = ring[:, _ring_slots(network, R, h1)].float()  # fp32 before any sum
        y, s_next = _wave(
            ring[:, h1 * row_len : h1 * row_len + n].float(), gathered, s_state,
            rows_at(qp, idx, (t - 1).clamp(0, tq_max)),
            None if x_ext is None else rows_at(x_ext, idx, t),
            None if s_ext is None else rows_at(s_ext, idx, t),
            w - 1 - lvl, T, q_init, phys, network, mask_raw,
        )
        y_store = y[:, idx].to(ring_dt)  # the one rounding point
        ring[:, (w % R) * row_len + idx] = y_store
        s_state[:, idx] = s_next[:, idx]
        raw[:, t, idx] = y_store.float()
    return raw


def wave_scan_autograd(
    qs: torch.Tensor,
    network: RiverNetwork,
    phys: ReachPhysics,
    q_init: torch.Tensor | None = None,
    *,
    T: int,
    xe: torch.Tensor | None = None,
    se: torch.Tensor | None = None,
    mask_raw: bool = False,
    compute_dtype: str = "fp32",
    remat_physics: bool = True,
) -> torch.Tensor:
    """:func:`wave_scan_reference` in a form autograd can differentiate
    (``adjoint="ad"``): the ring is a list of ``(B, n + 1)`` rows, each wave
    appends a new row instead of writing into the ring, and the gather reads
    their concatenation, so its forward equals the reference bit for bit.
    ``remat_physics`` checkpoints each wave's MC chain: the backward
    recomputes it from ``q_prev`` instead of storing its intermediates."""
    ring_dt = ring_dtype(compute_dtype, qs.dtype)
    B, W, n = qs.shape
    R = network.wf_ring_rows
    lvl = network.level_p.long()
    coefficients = physics_coefficients
    if remat_physics:
        def coefficients(q_prev, phys):
            return checkpoint(physics_coefficients, q_prev, phys, use_reentrant=False)

    ring = [qs.new_zeros(B, n + 1, dtype=ring_dt)] * R
    s_state = qs.new_zeros(B, n)
    ys = []
    for w in range(1, W + 1):
        h1 = (w - 1) % R
        gathered = torch.cat(ring, dim=1)[:, _ring_slots(network, R, h1)].float()
        y, s_state = _wave(
            ring[h1][:, :n].float(), gathered, s_state, qs[:, w - 1],
            None if xe is None else xe[:, w - 1], None if se is None else se[:, w - 1],
            w - 1 - lvl, T, q_init, phys, network, mask_raw, coefficients,
        )
        y_store = y.to(ring_dt)
        ring[w % R] = F.pad(y_store, (0, 1))
        ys.append(y_store.float())
    return torch.stack(ys, dim=1)


def check_ring_table(row: torch.Tensor, col: torch.Tensor, ring_rows: int, n: int, what: str) -> None:
    """The kernels load the ring without clipping (the TPU kernels' gathers
    clip), so every slot of a gather table must address a ring row in ``[0,
    R-2]`` (never the row being written) and a column in ``[0, n]``."""
    if ring_rows < 2:
        raise ValueError(f"wf_ring_rows must be >= 2, got {ring_rows}")
    if row.numel():
        row_lo, row_hi = int(row.min()), int(row.max())
        col_lo, col_hi = int(col.min()), int(col.max())
        if row_lo < 0 or row_hi >= ring_rows - 1 or col_lo < 0 or col_hi > n:
            raise ValueError(
                f"{what} out of range: rows [{row_lo}, {row_hi}] must lie in "
                f"[0, {ring_rows - 2}], columns [{col_lo}, {col_hi}] in [0, {n}]"
            )


def table_owner(tables):
    """What a range check covers: a band's whole frame (every band at once,
    each ``int(t.min())`` being a host sync) or the network itself."""
    frame = getattr(tables, "frame", None)
    return tables if frame is None else frame


def _check_tables(tables) -> None:
    """:func:`check_ring_table` on the gather table, once per network or
    band frame."""
    owner = table_owner(tables)
    if getattr(owner, "_kernel_tables_ok", False):
        return
    check_ring_table(owner.wf_row, owner.wf_col, tables.wf_ring_rows, tables.n, "gather table")
    object.__setattr__(owner, "_kernel_tables_ok", True)


@dataclasses.dataclass(frozen=True, eq=False)
class ActiveRuns:
    """The reaches in band at each wave of a scan, as a few contiguous
    ranges of the tables' node order: wave ``w`` (row ``w - 1``) holds
    ``starts[w-1, k] .. starts[w-1, k] + offsets[w-1, k+1] - offsets[w-1,
    k]`` for ``k < n_runs`` (empty ranges pad a row), and ``offsets[w-1,
    n_runs]`` reaches in all. ``table`` is ``[starts | offsets]`` ``(W,
    2 n_runs + 1)`` int32 on the tables' device, as the kernels read it;
    ``widest`` is the largest count of any wave."""

    starts: np.ndarray
    offsets: np.ndarray
    table: torch.Tensor
    n_runs: int
    widest: int

    def nodes(self, w: int) -> torch.Tensor:
        """The reaches in band at wave ``w``, ascending, on the tables' device."""
        lens = np.diff(self.offsets[w - 1])
        idx = np.concatenate([np.arange(s, s + n) for s, n in zip(self.starts[w - 1], lens) if n]
                             or [np.zeros(0, np.int64)])
        return torch.as_tensor(idx, dtype=torch.long, device=self.table.device)


def _run_table(key: np.ndarray, T: int, W: int) -> tuple[np.ndarray, np.ndarray]:
    """``(starts (W, K), offsets (W, K + 1))`` of the maximal ranges of
    consecutive nodes whose wave window ``key + 1 <= w <= key + T`` holds
    wave ``w``, for ``w = 1..W``. Nodes of one key value that sit together
    (a level run) enter and leave together, so the table is built over the
    runs: O(W x runs) host work."""
    n = key.shape[0]
    if n == 0:
        return np.zeros((W, 1), dtype=np.int64), np.zeros((W, 2), dtype=np.int64)
    change = np.flatnonzero(np.diff(key)) + 1
    run_s = np.concatenate([[0], change]).astype(np.int64)
    run_e = np.concatenate([change, [n]]).astype(np.int64)
    run_k = key[run_s]
    w = np.arange(1, W + 1)[:, None]
    act = (w > run_k) & (w <= run_k + T)  # (W, runs)
    edge = np.zeros((W, 1), dtype=bool)
    first = act & ~np.concatenate([edge, act[:, :-1]], axis=1)
    last = act & ~np.concatenate([act[:, 1:], edge], axis=1)
    fw, fc = np.nonzero(first)
    _, lc = np.nonzero(last)  # row-major, so the i-th last closes the i-th first
    per = np.bincount(fw, minlength=W)
    K = max(int(per.max()) if W else 0, 1)
    rank = np.arange(fw.size) - np.repeat(np.cumsum(per) - per, per)
    starts = np.zeros((W, K), dtype=np.int64)
    lens = np.zeros((W, K), dtype=np.int64)
    starts[fw, rank] = run_s[fc]
    lens[fw, rank] = run_e[lc] - run_s[fc]
    offsets = np.concatenate([np.zeros((W, 1), dtype=np.int64), np.cumsum(lens, axis=1)], axis=1)
    return starts, offsets


def _check_exact_skip(tables, levels: np.ndarray, reverse: bool) -> None:
    """The time-major scans write the ring only for reaches in band, which
    leaves a column's last in-band values behind after its reach leaves the
    band. That is exact only if every real slot reads its reach's own
    timestep (ring distance = level gap) and every other slot the zero
    sentinel column ``n``; raises otherwise."""
    n = tables.n
    if reverse:
        col = tables.wf_t_col.cpu().numpy().astype(np.int64)
        row = tables.wf_t_row.cpu().numpy().astype(np.int64)
        node = np.arange(col.size) // max(tables.wf_t_width, 1)
        real = col < n
        gap = levels[col[real]] - levels[node[real]]
        what = "transposed table"
    else:
        node = np.repeat(np.arange(n), tables.wf_width.cpu().numpy())
        col = tables.wf_col.cpu().numpy().astype(np.int64)[: node.size]
        row = tables.wf_row.cpu().numpy().astype(np.int64)[: node.size]
        real = tables.wf_mask.cpu().numpy()[: node.size] != 0
        if np.any(col[~real] != n):
            raise ValueError("gather table: a pad slot (mask 0) reads a column other than the "
                             f"zero sentinel {n}; the time-major scan needs pads on the sentinel")
        gap = levels[node[real]] - levels[col[real]]
        what = "gather table"
    if np.any(row[real] + 1 != gap):
        raise ValueError(f"{what}: a real slot's ring distance differs from its level gap; "
                         "the time-major scan needs each slot to read its reach's own timestep")


#: Entries a run-table row may hold: the kernels keep one a block thread
#: (``kThreads`` in ``csrc/wave_scan.cu`` and ``csrc/reverse_scan.cu``).
MAX_RUN_ENTRIES = 256


def _table_cache(tables) -> dict:
    """The kernels' host-built tables of a network or band frame, cached on it."""
    owner = table_owner(tables)
    cache = getattr(owner, "_kernel_tables", None)
    if cache is None:
        cache = {}
        object.__setattr__(owner, "_kernel_tables", cache)
    return cache


def active_runs(tables, T: int, reverse: bool = False) -> ActiveRuns:
    """The :class:`ActiveRuns` of a scan over ``T`` timesteps on ``tables``
    (a network or a band; ``W = T + depth`` waves): the forward scan's reach
    ``i`` is in band at waves ``level[i] + 1 .. level[i] + T``, the reverse
    scan's at ``depth - level[i] + 1 .. depth - level[i] + T``. Built on the
    host once per network or band, ``T`` and direction, with the table check
    the ring policy rests on (:func:`_check_exact_skip`), and cached on the
    network or band frame. Raises where a wave has more ranges than the
    kernels take (:data:`MAX_RUN_ENTRIES`)."""
    cache = _table_cache(tables)
    key = (getattr(tables, "index", None), int(T), bool(reverse))
    runs = cache.get(key)
    if runs is None:
        levels = tables.level_p.cpu().numpy().astype(np.int64)
        _check_exact_skip(tables, levels, reverse)
        starts, offsets = _run_table(tables.depth - levels if reverse else levels, T, T + tables.depth)
        if 2 * starts.shape[1] + 1 > MAX_RUN_ENTRIES:
            raise ValueError(f"{starts.shape[1]} in-band ranges in a wave: the kernels take at most "
                             f"{(MAX_RUN_ENTRIES - 1) // 2}")
        table = torch.as_tensor(np.concatenate([starts, offsets], axis=1).astype(np.int32),
                                device=tables.level_p.device)
        runs = ActiveRuns(starts=starts, offsets=offsets, table=table, n_runs=starts.shape[1],
                          widest=int(offsets[:, -1].max()) if offsets.size else 0)
        cache[key] = runs
    return runs


def bucket_table(tables) -> torch.Tensor:
    """The gather buckets as the forward kernel reads them: ``(nb, 4)``
    int32 rows ``(first node, end node, width, first slot)`` on the tables'
    device, so a node's slot run follows from its bucket (the layout of
    ``wf_slot``/``wf_width``). Cached on the network or band frame."""
    cache = _table_cache(tables)
    table = cache.get("buckets")
    if table is None:
        rows, base = [], 0
        for start, end, width in tables.wf_buckets:
            rows.append((start, end, width, base))
            base += (end - start) * width
        table = torch.as_tensor(np.asarray(rows or [(0, 0, 0, 0)], dtype=np.int32).reshape(-1, 4),
                                device=tables.level_p.device)
        cache["buckets"] = table
    return table


_ARGTYPES = (
    [ctypes.c_void_p] * 4  # qp, raw, ring, s
    + [ctypes.c_void_p] * 2  # xe, se (NULL = no external rows)
    + [ctypes.c_void_p] * 6  # runs, lvl, buckets, wf_row, wf_col, wf_mask
    + [ctypes.c_void_p] * 2  # q_init (NULL = hotstart), consts
    + [ctypes.c_void_p] * 6  # n, p, q, slope, length, x_storage
    + [ctypes.c_float] * 5  # depth_lb, bottom_width_lb, velocity_lb, discharge_lb, dt
    + [ctypes.c_int] * 7  # B, T, n, W, R, K, nb
    + [ctypes.c_longlong]  # max_pairs
    + [ctypes.c_int] * 3  # mask_raw, ring_bf16, device
    + [ctypes.c_void_p]  # stream
)


def _load_library():
    from ddr_tpu_torch.routing import _build

    lib = _build.load("wave_scan")
    if not getattr(lib, "_ddr_typed", False):
        lib.ddr_wave_scan_tm.argtypes = _ARGTYPES
        lib.ddr_wave_scan_tm.restype = ctypes.c_int
        lib.ddr_wave_barrier.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.ddr_wave_barrier.restype = ctypes.c_int
        lib.ddr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ddr_cuda_error_string.restype = ctypes.c_char_p
        lib._ddr_typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.ddr_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")


def wave_scan(
    qs: torch.Tensor,
    network: RiverNetwork,
    phys: ReachPhysics,
    q_init: torch.Tensor | None = None,
    *,
    T: int,
    xe: torch.Tensor | None = None,
    se: torch.Tensor | None = None,
    mask_raw: bool = False,
    compute_dtype: str = "fp32",
) -> torch.Tensor:
    """The pre-skewed forward wave scan ``(B, W, n) -> (B, W, n)`` of the JAX
    package's layout, for CPU tensors: :func:`wave_scan_reference`. The
    card's kernel is time-major (:func:`wave_scan_tm`), so any other device
    raises and ``wave_scan.launches`` stays 0."""
    validate_dtype(compute_dtype)
    if (xe is None) != (se is None):
        raise ValueError("pass both external rows xe and se, or neither")
    if qs.device.type != "cpu":
        raise ValueError(f"the pre-skewed wave_scan takes CPU tensors, got {qs.device}: "
                         "for CPU or CUDA tensors use the time-major wave_scan_tm")
    return wave_scan_reference(qs, network, phys, q_init, T=T, xe=xe, se=se, mask_raw=mask_raw,
                               compute_dtype=compute_dtype)


wave_scan.launches = 0


def wave_scan_tm(
    qp: torch.Tensor,
    network: RiverNetwork,
    phys: ReachPhysics,
    q_init: torch.Tensor | None = None,
    *,
    x_ext: torch.Tensor | None = None,
    s_ext: torch.Tensor | None = None,
    mask_raw: bool = False,
    compute_dtype: str = "fp32",
) -> torch.Tensor:
    """The time-major forward wave scan ``q' (B, T, n) -> raw (B, T, n)``:
    the CUDA kernel for CUDA tensors, :func:`wave_scan_tm_reference` for
    CPU tensors. ``network`` is a RiverNetwork or a band of a stacked frame
    (:meth:`~ddr_tpu_torch.routing.stacked.StackedChunked.band`);
    ``x_ext``/``s_ext`` are the external inflow series ``(B, T, n)`` or
    None. ``compute_dtype`` is the ring's storage (``"fp32"`` or
    ``"bf16"``); the inputs and ``raw`` are float32 either way.

    Per-reach operands are shared by the batch. Raises on anything the
    kernel does not take (other dtypes, shapes or devices, non-contiguous
    inputs, out-of-range tables, one of ``x_ext``/``s_ext`` without the
    other, an unknown compute dtype); never falls back."""
    ring_dt = ring_dtype(compute_dtype)
    if (x_ext is None) != (s_ext is None):
        raise ValueError("pass both external series x_ext and s_ext, or neither")
    if qp.device.type == "cpu":
        return wave_scan_tm_reference(qp, network, phys, q_init, x_ext=x_ext, s_ext=s_ext,
                                      mask_raw=mask_raw, compute_dtype=compute_dtype)
    if qp.device.type != "cuda":
        raise ValueError(f"wave_scan_tm takes CPU or CUDA tensors, got {qp.device}")
    if qp.dtype != torch.float32 or qp.dim() != 3:
        raise ValueError(f"q' must be (B, T, n) float32, got {tuple(qp.shape)} {qp.dtype}")
    B, T, n = qp.shape
    if n != network.n or T < 1:
        raise ValueError(f"q' {tuple(qp.shape)} does not match n={network.n}, T >= 1")
    dev = qp.device
    per_reach = list(reach_operands(phys))
    ext = [] if x_ext is None else [x_ext, s_ext]
    ints = [network.level_p, network.wf_row, network.wf_col]
    floats = [qp, *ext, network.wf_mask, *per_reach] + ([] if q_init is None else [q_init])
    for t in per_reach:
        if tuple(t.shape) != (n,):
            raise ValueError(f"per-reach operands must be ({n},), got {tuple(t.shape)}")
    if q_init is not None and tuple(q_init.shape) != (B, n):
        raise ValueError(f"q_init must be ({B}, {n}), got {tuple(q_init.shape)}")
    for t in ext:
        if tuple(t.shape) != (B, T, n):
            raise ValueError(f"external series must be ({B}, {T}, {n}), got {tuple(t.shape)}")
    for t in ints + floats:
        if t.device != dev:
            raise ValueError(f"wave_scan_tm operands must all lie on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("wave_scan_tm operands must be contiguous")
        if t.dtype != (torch.int32 if any(t is i for i in ints) else torch.float32):
            raise ValueError(f"wave_scan_tm operand has unsupported dtype {t.dtype}")
    _check_tables(network)
    runs = active_runs(network, T)
    buckets = bucket_table(network)
    R = network.wf_ring_rows

    lib = _load_library()
    raw = torch.empty_like(qp)  # every (b, t, i) is in band at exactly one wave
    ring = torch.zeros(B, R, n + 1, dtype=ring_dt, device=dev)
    s_state = torch.zeros(B, n, dtype=torch.float32, device=dev)
    consts = torch.empty(n, 12, dtype=torch.float32, device=dev)
    b = phys.bounds
    err = lib.ddr_wave_scan_tm(
        qp.data_ptr(), raw.data_ptr(), ring.data_ptr(), s_state.data_ptr(),
        None if x_ext is None else x_ext.data_ptr(), None if s_ext is None else s_ext.data_ptr(),
        runs.table.data_ptr(), network.level_p.data_ptr(), buckets.data_ptr(),
        network.wf_row.data_ptr(), network.wf_col.data_ptr(), network.wf_mask.data_ptr(),
        None if q_init is None else q_init.data_ptr(), consts.data_ptr(),
        *(t.data_ptr() for t in per_reach),
        b.depth, b.bottom_width, b.velocity, b.discharge, phys.dt,
        B, T, n, T + network.depth, R, runs.n_runs, buckets.shape[0], B * runs.widest,
        int(bool(mask_raw)), int(ring_dt == torch.bfloat16),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, err, "wave_scan_tm")
    wave_scan_tm.launches += 1
    wave_scan_tm.q_init_launches += q_init is not None
    return raw


wave_scan_tm.launches = 0
wave_scan_tm.q_init_launches = 0  # the launches that started from a carried discharge


def wave_barrier(waves: int, max_pairs: int, device: torch.device) -> int:
    """Launch ``waves`` grid barriers and nothing else, on the grid the fp32
    :func:`wave_scan_tm` takes when its widest wave holds ``max_pairs``
    pairs: the floor under a scan of that many waves. Returns the grid's
    block count. A measuring probe, not part of any route."""
    lib = _load_library()
    blocks = ctypes.c_int(0)
    dev = torch.device(device)
    err = lib.ddr_wave_barrier(int(waves), int(max_pairs),
                               dev.index if dev.index is not None else torch.cuda.current_device(),
                               torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(blocks))
    _raise_on(lib, err, "wave_barrier")
    return blocks.value
