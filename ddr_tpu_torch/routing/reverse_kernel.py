"""The reverse wave scan of the analytic adjoint: a CUDA kernel and its plain version.

Counterpart of ``ddr_tpu/routing/pallas_kernel.py``'s ``fused_reverse_scan``.
The backward of the forward wave scan is a wavefront over the transposed
network in reverse time: node ``i`` handles timestep ``t = T - v + depth -
level[i]`` at reverse wave ``v = 1..W`` (``W = T + depth``). Per wave it
gathers its successors' ``lam`` from a rotating ring through the transposed
tables (``wf_t_row``, ``wf_t_col``, ``wf_t_width`` slots a node) and reads
one row of the reverse stream ``[gbar | ow | zce | duce]`` (the cotangent
seed, the own-channel push weight, and the per-successor-slot propagation
weights, built by :class:`~ddr_tpu_torch.routing.wavefront.AnalyticRoute`):

* ``zsum = sum_k zce[k] g_k`` and ``dusum = sum_k duce[k] g_k``;
* ``lam = gbar + gx + zsum`` and ``gx <- ow * lam + dusum``;
* ``lam`` goes to ring row ``v % R`` and to ``lams[v-1]``.

Pairs outside ``0 <= t <= T-1`` give ``lam = 0`` and leave ``gx``: for the
streams the backward builds (zero out of band, zero ``ow``/``duce`` at
``t = 0``) that is the JAX recurrence exactly, and it lets the kernel skip
their arithmetic. On a band frame the same holds slot by slot: a sentinel
slot (level 0, no edges, zero ``gbar``) keeps ``lam = 0`` in both, whatever
its pad physics puts in ``ow``.

:func:`reverse_scan` launches ``csrc/reverse_scan.cu`` for CUDA tensors and
runs :func:`reverse_scan_reference` only for CPU tensors.
``reverse_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ddr_tpu_torch.routing.network import RiverNetwork
from ddr_tpu_torch.routing.wave_kernel import check_ring_table, table_owner

__all__ = ["reverse_scan", "reverse_scan_reference"]


def _stream_width(n: int, t_width: int) -> int:
    return 2 * n + 2 * n * t_width


def reverse_scan_reference(rows_s: torch.Tensor, network: RiverNetwork, *, T: int) -> torch.Tensor:
    """The plain PyTorch reverse scan: a Python loop over waves, vectorized
    over ``(B, n)``. ``rows_s`` is the reverse stream ``(B, W, 2n + 2 n
    t_width)``; returns the per-wave ``lams (B, W, n)``. ``network`` is a
    RiverNetwork or a band of a stacked frame (``depth`` is then the frame's
    ``span_max`` and the levels band-local)."""
    B, W, _ = rows_s.shape
    n, tw = network.n, network.wf_t_width
    R = network.wf_ring_rows
    row_len = n + 1
    e_t = n * tw
    t_row = network.wf_t_row.long()
    t_col = network.wf_t_col.long()
    m = network.depth - network.level_p.long()

    ring = rows_s.new_zeros(B, R * row_len)
    gx = rows_s.new_zeros(B, n)
    lams = rows_s.new_empty(B, W, n)
    for v in range(1, W + 1):
        rows = rows_s[:, v - 1]
        h1 = (v - 1) % R
        rot = h1 - t_row
        rot = torch.where(rot < 0, rot + R, rot)
        g = ring[:, rot * row_len + t_col]  # successors' lam, emitted gap waves earlier
        zsum = (rows[:, 2 * n : 2 * n + e_t] * g).reshape(B, n, tw).sum(dim=-1)
        dusum = (rows[:, 2 * n + e_t :] * g).reshape(B, n, tw).sum(dim=-1)
        t = T - v + m
        ok = (t >= 0) & (t <= T - 1)
        lam = torch.where(ok, rows[:, :n] + gx + zsum, torch.zeros_like(zsum))
        gx = torch.where(ok, rows[:, n : 2 * n] * lam + dusum, gx)
        h = v % R
        ring[:, h * row_len : h * row_len + n] = lam  # column n stays the zero sentinel
        lams[:, v - 1] = lam
    return lams


def _check_tables(tables) -> None:
    """:func:`~ddr_tpu_torch.routing.wave_kernel.check_ring_table` on the
    transposed table, which must hold ``wf_t_width >= 1`` slots a node; once
    per network or band frame (every band at once)."""
    owner = table_owner(tables)
    if getattr(owner, "_reverse_tables_ok", False):
        return
    slots = owner.wf_t_row.shape[-1] if owner.wf_t_row.dim() else 0
    if tables.wf_t_width < 1 or slots != tables.n * tables.wf_t_width:
        raise ValueError(
            f"transposed tables hold {slots} slots, expected "
            f"n * wf_t_width = {tables.n} * {tables.wf_t_width} (>= 1 slot a node)"
        )
    check_ring_table(owner.wf_t_row, owner.wf_t_col, tables.wf_ring_rows, tables.n,
                     "transposed table")
    object.__setattr__(owner, "_reverse_tables_ok", True)


_ARGTYPES = (
    [ctypes.c_void_p] * 4  # rows, lams, ring, gx
    + [ctypes.c_void_p] * 3  # lvl, t_row, t_col
    + [ctypes.c_int] * 8  # B, T, n, W, R, depth, t_width, device
    + [ctypes.c_void_p]  # stream
)


def _load_library():
    from ddr_tpu_torch.routing import _build

    lib = _build.load("reverse_scan")
    if not getattr(lib, "_ddr_typed", False):
        lib.ddr_reverse_scan.argtypes = _ARGTYPES
        lib.ddr_reverse_scan.restype = ctypes.c_int
        lib.ddr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ddr_cuda_error_string.restype = ctypes.c_char_p
        lib._ddr_typed = True
    return lib


def reverse_scan(rows_s: torch.Tensor, network: RiverNetwork, *, T: int) -> torch.Tensor:
    """The reverse wave scan ``(B, W, 2n + 2 n t_width) -> (B, W, n)``: the
    CUDA kernel for CUDA tensors, :func:`reverse_scan_reference` for CPU
    tensors.

    Raises on anything the kernel does not take (other dtypes, shapes or
    devices, non-contiguous inputs, out-of-range tables); never falls back."""
    if rows_s.device.type == "cpu":
        return reverse_scan_reference(rows_s, network, T=T)
    if rows_s.device.type != "cuda":
        raise ValueError(f"reverse_scan takes CPU or CUDA tensors, got {rows_s.device}")
    n, tw = network.n, network.wf_t_width
    if rows_s.dtype != torch.float32 or rows_s.dim() != 3:
        raise ValueError(
            f"rows_s must be (B, W, width) float32, got {tuple(rows_s.shape)} {rows_s.dtype}"
        )
    B, W, width = rows_s.shape
    if W != T + network.depth or T < 1 or width != _stream_width(n, tw):
        raise ValueError(
            f"rows_s {tuple(rows_s.shape)} does not match W = T + depth = {T} + "
            f"{network.depth}, width 2n + 2n t_width = {_stream_width(n, tw)}"
        )
    dev = rows_s.device
    ints = [network.level_p, network.wf_t_row, network.wf_t_col]
    for t in [rows_s, *ints]:
        if t.device != dev:
            raise ValueError(f"reverse_scan operands must all lie on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("reverse_scan operands must be contiguous")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("reverse_scan tables must be int32")
    _check_tables(network)
    R = network.wf_ring_rows

    lib = _load_library()
    lams = torch.empty(B, W, n, dtype=torch.float32, device=dev)
    ring = torch.zeros(B, R, n + 1, dtype=torch.float32, device=dev)
    gx = torch.zeros(B, n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ddr_reverse_scan(
        rows_s.data_ptr(), lams.data_ptr(), ring.data_ptr(), gx.data_ptr(),
        *(t.data_ptr() for t in ints),
        B, T, n, W, R, network.depth, tw,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(
            f"reverse_scan kernel launch failed: {lib.ddr_cuda_error_string(err).decode()} "
            f"(cudaError {err})"
        )
    reverse_scan.launches += 1
    return lams


reverse_scan.launches = 0
