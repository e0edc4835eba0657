"""The forward wave scan: a hand-written CUDA kernel and its plain version.

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

:func:`wave_scan` launches ``csrc/wave_scan.cu`` for CUDA tensors and runs
:func:`wave_scan_reference` only for CPU tensors. ``wave_scan.launches``
counts kernel launches. :func:`wave_scan_autograd` is the plain scan
again with an out-of-place ring, for ``adjoint="ad"``. The analytic adjoint reads the same chain through
:func:`physics_derivatives` and :func:`physics_pullback`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ddr_tpu_torch.geometry.trapezoidal import maximum
from ddr_tpu_torch.routing.mc import Bounds, ChannelState, celerity, muskingum_coefficients
from ddr_tpu_torch.routing.network import RiverNetwork

__all__ = [
    "DTYPES",
    "ReachPhysics",
    "check_ring_table",
    "physics_coefficients",
    "physics_derivatives",
    "physics_pullback",
    "reduce_gathered",
    "ring_dtype",
    "table_owner",
    "validate_dtype",
    "wave_scan",
    "wave_scan_autograd",
    "wave_scan_reference",
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


def reduce_gathered(gathered, wf_mask, buckets, n_deg0, lb, clamped, mask_raw):
    """Per-node sums of the flat bucket-concatenated gather, ``(..., E) ->
    (..., n)``: raw (pad slots read the ring's zero sentinel, so no mask
    unless ``mask_raw``) or clamped (``max(v, lb) * mask``)."""
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
        parts.append(blk.sum(dim=-1))
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


_ARGTYPES = (
    [ctypes.c_void_p] * 4  # qs, ys, ring, s
    + [ctypes.c_void_p] * 2  # xe, se (NULL = no external rows)
    + [ctypes.c_void_p] * 6  # lvl, slot, width, wf_row, wf_col, wf_mask
    + [ctypes.c_void_p]  # q_init (NULL = hotstart)
    + [ctypes.c_void_p] * 6  # n, p, q, slope, length, x_storage
    + [ctypes.c_float] * 5  # depth_lb, bottom_width_lb, velocity_lb, discharge_lb, dt
    + [ctypes.c_int] * 8  # B, T, n, W, R, mask_raw, ring_bf16, device
    + [ctypes.c_void_p]  # stream
)


def _load_library():
    from ddr_tpu_torch.routing import _build

    lib = _build.load("wave_scan")
    if not getattr(lib, "_ddr_typed", False):
        lib.ddr_wave_scan.argtypes = _ARGTYPES
        lib.ddr_wave_scan.restype = ctypes.c_int
        lib.ddr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ddr_cuda_error_string.restype = ctypes.c_char_p
        lib._ddr_typed = True
    return lib


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
    """The forward wave scan ``(B, W, n) -> (B, W, n)``: the CUDA kernel for
    CUDA tensors, :func:`wave_scan_reference` for CPU tensors. ``network``
    is a RiverNetwork or a band of a stacked frame
    (:meth:`~ddr_tpu_torch.routing.stacked.StackedChunked.band`).
    ``compute_dtype`` is the ring's storage (``"fp32"`` or ``"bf16"``); the
    inputs and ``ys`` are float32 either way.

    Per-reach operands are shared by the batch. Raises on anything the
    kernel does not take (other dtypes, shapes or devices, non-contiguous
    inputs, out-of-range tables, one of ``xe``/``se`` without the other, an
    unknown compute dtype); never falls back."""
    ring_dt = ring_dtype(compute_dtype)
    if (xe is None) != (se is None):
        raise ValueError("pass both external rows xe and se, or neither")
    if qs.device.type == "cpu":
        return wave_scan_reference(qs, network, phys, q_init, T=T, xe=xe, se=se, mask_raw=mask_raw,
                                   compute_dtype=compute_dtype)
    if qs.device.type != "cuda":
        raise ValueError(f"wave_scan takes CPU or CUDA tensors, got {qs.device}")
    if qs.dtype != torch.float32 or qs.dim() != 3:
        raise ValueError(f"qs must be (B, W, n) float32, got {tuple(qs.shape)} {qs.dtype}")
    B, W, n = qs.shape
    if n != network.n or W != T + network.depth or T < 1:
        raise ValueError(
            f"qs {tuple(qs.shape)} does not match n={network.n}, "
            f"W = T + depth = {T} + {network.depth}"
        )
    dev = qs.device
    per_reach = list(reach_operands(phys))
    ext = [] if xe is None else [xe, se]
    ints = [network.level_p, network.wf_slot, network.wf_width, network.wf_row, network.wf_col]
    floats = [qs, *ext, network.wf_mask, *per_reach] + ([] if q_init is None else [q_init])
    for t in per_reach:
        if tuple(t.shape) != (n,):
            raise ValueError(f"per-reach operands must be ({n},), got {tuple(t.shape)}")
    if q_init is not None and tuple(q_init.shape) != (B, n):
        raise ValueError(f"q_init must be ({B}, {n}), got {tuple(q_init.shape)}")
    for t in ext:
        if tuple(t.shape) != (B, W, n):
            raise ValueError(f"external rows must be ({B}, {W}, {n}), got {tuple(t.shape)}")
    for t in ints + floats:
        if t.device != dev:
            raise ValueError(f"wave_scan operands must all lie on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("wave_scan operands must be contiguous")
        if t.dtype != (torch.int32 if any(t is i for i in ints) else torch.float32):
            raise ValueError(f"wave_scan operand has unsupported dtype {t.dtype}")
    _check_tables(network)
    R = network.wf_ring_rows

    lib = _load_library()
    ys = torch.empty_like(qs)
    ring = torch.zeros(B, R, n + 1, dtype=ring_dt, device=dev)
    s_state = torch.zeros(B, n, dtype=torch.float32, device=dev)
    b = phys.bounds
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ddr_wave_scan(
        qs.data_ptr(), ys.data_ptr(), ring.data_ptr(), s_state.data_ptr(),
        None if xe is None else xe.data_ptr(), None if se is None else se.data_ptr(),
        *(t.data_ptr() for t in ints), network.wf_mask.data_ptr(),
        None if q_init is None else q_init.data_ptr(),
        *(t.data_ptr() for t in per_reach),
        b.depth, b.bottom_width, b.velocity, b.discharge, phys.dt,
        B, T, n, W, R, int(bool(mask_raw)), int(ring_dt == torch.bfloat16),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(
            f"wave_scan kernel launch failed: {lib.ddr_cuda_error_string(err).decode()} "
            f"(cudaError {err})"
        )
    wave_scan.launches += 1
    return ys


wave_scan.launches = 0
