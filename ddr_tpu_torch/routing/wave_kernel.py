"""The forward wave scan: a hand-written CUDA kernel and its plain version.

Counterpart of ``ddr_tpu/routing/pallas_kernel.py``'s ``fused_wave_scan``
(single-ring, fp32 ring, no external-inflow rows, ``mask_raw=False``: the
variant the serving path runs). Per wave ``w = 1..W`` every reach ``i`` (wf
order) advances its in-flight timestep ``t = w - 1 - level[i]``:

* ``q_prev = max(ring[(w-1) % R, i], lb)`` and the MC chain gives c1..c4;
* its predecessor slots are gathered from the rotating ring and reduced
  twice: raw (the same-timestep solve sum ``x_pred``) and clamped (the next
  wave's inflow sum ``s``);
* ``y = c2*s + c3*q_prev + c4*max(q', lb) + c1*x_pred``, with the hotstart
  diagonal (``t == 0``: ``y = q' + x_pred``), the ``q_init`` override and
  zeros outside ``0 <= t < T``;
* ``y`` goes to ring row ``w % R`` and to ``ys[w-1]``.

:func:`wave_scan` launches ``csrc/wave_scan.cu`` for CUDA tensors and runs
:func:`wave_scan_reference` only for CPU tensors. ``wave_scan.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ddr_tpu_torch.routing.mc import Bounds, ChannelState, celerity, muskingum_coefficients
from ddr_tpu_torch.routing.network import RiverNetwork

__all__ = [
    "ReachPhysics",
    "physics_coefficients",
    "reduce_gathered",
    "wave_scan",
    "wave_scan_reference",
]


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


def reduce_gathered(gathered, wf_mask, buckets, n_deg0, lb, clamped, mask_raw):
    """Per-node sums of the flat bucket-concatenated gather, ``(..., E) ->
    (..., n)``: raw (pad slots read the ring's zero sentinel, so no mask
    unless ``mask_raw``) or clamped (``max(v, lb) * mask``)."""
    lead = gathered.shape[:-1]
    parts = [gathered.new_zeros(lead + (n_deg0,))] if n_deg0 else []
    off = 0
    for node_start, node_end, width in buckets:
        cnt_nodes = node_end - node_start
        cnt = cnt_nodes * width
        blk = gathered[..., off : off + cnt].reshape(lead + (cnt_nodes, width))
        msk = wf_mask[off : off + cnt].reshape(cnt_nodes, width)
        if clamped:
            blk = torch.clamp_min(blk, lb) * msk
        elif mask_raw:
            blk = blk * msk
        parts.append(blk.sum(dim=-1))
        off += cnt
    if not parts:
        return gathered.new_zeros(lead + (n_deg0,))
    return torch.cat(parts, dim=-1)


def wave_scan_reference(
    qs: torch.Tensor,
    network: RiverNetwork,
    phys: ReachPhysics,
    q_init: torch.Tensor | None = None,
    *,
    T: int,
) -> torch.Tensor:
    """The plain PyTorch wave scan: a Python loop over waves, vectorized
    over ``(B, n)``. ``qs`` is the pre-skewed ``(B, W, n)`` inflow, ``q_init``
    ``(B, n)`` or None; returns the raw per-wave solve values ``(B, W, n)``."""
    B, W, n = qs.shape
    R = network.wf_ring_rows
    row_len = n + 1
    lb = phys.bounds.discharge
    buckets = network.wf_buckets
    n_deg0 = buckets[0][0] if buckets else n
    wf_row = network.wf_row.long()
    wf_col = network.wf_col.long()
    mask = network.wf_mask
    lvl = network.level_p.long()

    ring = qs.new_zeros(B, R * row_len)
    s_state = qs.new_zeros(B, n)
    ys = qs.new_empty(B, W, n)
    for w in range(1, W + 1):
        t_node = w - 1 - lvl
        h1 = (w - 1) % R
        q_prev = torch.clamp_min(ring[:, h1 * row_len : h1 * row_len + n], lb)
        c1, c2, c3, c4 = physics_coefficients(q_prev, phys)
        rot = h1 - wf_row
        rot = torch.where(rot < 0, rot + R, rot)
        gathered = ring[:, rot * row_len + wf_col]
        x_pred = reduce_gathered(gathered, mask, buckets, n_deg0, lb, False, False)
        s_next = reduce_gathered(gathered, mask, buckets, n_deg0, lb, True, False)

        q_row = qs[:, w - 1]
        b_step = c2 * s_state + c3 * q_prev + c4 * torch.clamp_min(q_row, lb)
        is_hot = t_node == 0
        b = torch.where(is_hot, q_row, b_step)
        c1_eff = torch.where(is_hot, torch.ones_like(c1), c1)
        y = b + c1_eff * x_pred
        if q_init is not None:
            y = torch.where(is_hot, torch.clamp_min(q_init, lb), y)
        ok = (t_node >= 0) & (t_node <= T - 1)
        y = torch.where(ok, y, torch.zeros_like(y))
        h = w % R
        ring[:, h * row_len : h * row_len + n] = y  # column n stays the zero sentinel
        ys[:, w - 1] = y
        s_state = s_next
    return ys


def _check_tables(network: RiverNetwork) -> None:
    """The kernel loads without clipping (the TPU kernel's gathers clip), so
    every slot must address a ring row in ``[0, R-2]`` (never the row being
    written) and a column in ``[0, n]``. Checked once per network."""
    if getattr(network, "_kernel_tables_ok", False):
        return
    R = network.wf_ring_rows
    if R < 2:
        raise ValueError(f"wf_ring_rows must be >= 2, got {R}")
    if network.wf_row.numel():
        row_lo, row_hi = int(network.wf_row.min()), int(network.wf_row.max())
        col_lo, col_hi = int(network.wf_col.min()), int(network.wf_col.max())
        if row_lo < 0 or row_hi >= R - 1 or col_lo < 0 or col_hi > network.n:
            raise ValueError(
                f"gather table out of range: rows [{row_lo}, {row_hi}] must lie in "
                f"[0, {R - 2}], columns [{col_lo}, {col_hi}] in [0, {network.n}]"
            )
    object.__setattr__(network, "_kernel_tables_ok", True)


_ARGTYPES = (
    [ctypes.c_void_p] * 4  # qs, ys, ring, s
    + [ctypes.c_void_p] * 6  # lvl, slot, width, wf_row, wf_col, wf_mask
    + [ctypes.c_void_p]  # q_init (NULL = hotstart)
    + [ctypes.c_void_p] * 6  # n, p, q, slope, length, x_storage
    + [ctypes.c_float] * 5  # depth_lb, bottom_width_lb, velocity_lb, discharge_lb, dt
    + [ctypes.c_int] * 6  # B, T, n, W, R, device
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
) -> torch.Tensor:
    """The forward wave scan ``(B, W, n) -> (B, W, n)``: the CUDA kernel for
    CUDA tensors, :func:`wave_scan_reference` for CPU tensors.

    Per-reach operands are shared by the batch. Raises on anything the
    kernel does not take (other dtypes, shapes or devices, non-contiguous
    inputs, out-of-range tables); never falls back."""
    if qs.device.type == "cpu":
        return wave_scan_reference(qs, network, phys, q_init, T=T)
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
    ch = phys.channels
    per_reach = [phys.n, phys.p_spatial, phys.q_spatial, ch.slope, ch.length, ch.x_storage]
    ints = [network.level_p, network.wf_slot, network.wf_width, network.wf_row, network.wf_col]
    floats = [qs, network.wf_mask, *per_reach] + ([] if q_init is None else [q_init])
    for t in per_reach:
        if tuple(t.shape) != (n,):
            raise ValueError(f"per-reach operands must be ({n},), got {tuple(t.shape)}")
    if q_init is not None and tuple(q_init.shape) != (B, n):
        raise ValueError(f"q_init must be ({B}, {n}), got {tuple(q_init.shape)}")
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
    ring = torch.zeros(B, R, n + 1, dtype=torch.float32, device=dev)
    s_state = torch.zeros(B, n, dtype=torch.float32, device=dev)
    b = phys.bounds
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ddr_wave_scan(
        qs.data_ptr(), ys.data_ptr(), ring.data_ptr(), s_state.data_ptr(),
        *(t.data_ptr() for t in ints), network.wf_mask.data_ptr(),
        None if q_init is None else q_init.data_ptr(),
        *(t.data_ptr() for t in per_reach),
        b.depth, b.bottom_width, b.velocity, b.discharge, phys.dt,
        B, T, n, W, R, dev.index if dev.index is not None else torch.cuda.current_device(),
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
