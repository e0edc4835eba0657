"""The reverse wave scan of the analytic adjoint: a CUDA kernel and its plain versions.

Counterpart of ``ddr_tpu/routing/pallas_kernel.py``'s ``fused_reverse_scan``.
The backward of the forward wave scan is a wavefront over the transposed
network in reverse time: node ``i`` handles timestep ``t = T - v + depth -
level[i]`` at reverse wave ``v = 1..W`` (``W = T + depth``). Per wave it
gathers its successors' ``lam`` from a rotating ring through the transposed
tables (``wf_t_row``, ``wf_t_col``, ``wf_t_width`` slots a node) and reads,
at its timestep, the cotangent seed ``gbar``, the own-channel push weight
``ow`` and the per-successor-slot propagation weights ``zce`` and ``duce``
(built by :class:`~ddr_tpu_torch.routing.wavefront.AnalyticRoute`):

* ``zsum = sum_k zce[k] g_k`` and ``dusum = sum_k duce[k] g_k``;
* ``lam = gbar + gx + zsum`` and ``gx <- ow * lam + dusum``;
* ``lam`` goes to ring row ``v % R`` and to the output at ``t``.

Two layouts of the same scan. The JAX package's streams one row a wave,
``[gbar | ow | zce | duce]`` ``(B, W, 2n + 2 n t_width)``, zero out of band,
and emits ``lams (B, W, n)`` (:func:`reverse_scan_reference`, the plain
version): pairs outside ``0 <= t <= T-1`` give ``lam = 0`` and leave ``gx``.
For the streams the backward builds that is the JAX recurrence exactly: on a
band frame a sentinel slot (level 0, no edges, zero ``gbar``) keeps ``lam =
0`` whatever its pad physics puts in ``ow``. The card's is time-major:
:func:`reverse_scan_tm` reads the four ``(B, T, .)`` arrays at each pair's
timestep and writes ``lam_all (B, T, n)``, visiting only the pairs in band
(:func:`~ddr_tpu_torch.routing.wave_kernel.active_runs`, built from
``depth - level``). It launches ``csrc/reverse_scan.cu`` for CUDA tensors and
runs :func:`reverse_scan_tm_reference`, which walks the same ranges, only for
CPU tensors; ``reverse_scan_tm.launches`` counts kernel launches. The
pre-skewed :func:`reverse_scan` has no kernel: it takes CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from ddr_tpu_torch.routing.network import RiverNetwork
from ddr_tpu_torch.routing.wave_kernel import (
    active_runs,
    check_ring_table,
    slot_sum,
    table_owner,
)

__all__ = ["reverse_scan", "reverse_scan_reference", "reverse_scan_tm", "reverse_scan_tm_reference"]


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
        zsum = slot_sum((rows[:, 2 * n : 2 * n + e_t] * g).reshape(B, n, tw))
        dusum = slot_sum((rows[:, 2 * n + e_t :] * g).reshape(B, n, tw))
        t = T - v + m
        ok = (t >= 0) & (t <= T - 1)
        lam = torch.where(ok, rows[:, :n] + gx + zsum, torch.zeros_like(zsum))
        gx = torch.where(ok, rows[:, n : 2 * n] * lam + dusum, gx)
        h = v % R
        ring[:, h * row_len : h * row_len + n] = lam  # column n stays the zero sentinel
        lams[:, v - 1] = lam
    return lams


def reverse_scan_tm_reference(gbar: torch.Tensor, ow: torch.Tensor, zce: torch.Tensor,
                              duce: torch.Tensor, network: RiverNetwork) -> torch.Tensor:
    """The plain PyTorch time-major reverse scan: ``gbar``, ``ow`` ``(B, T,
    n)`` and ``zce``, ``duce`` ``(B, T, n t_width)`` -> ``lam_all (B, T,
    n)``. Per reverse wave it walks
    :func:`~ddr_tpu_torch.routing.wave_kernel.active_runs` (reverse): the
    pairs in band read their inputs at their timestep and write ``lam_all``,
    the ring and ``gx``; no other pair writes anything, the kernel's ring
    policy. The wave itself is :func:`reverse_scan_reference`'s over all
    ``(B, n)``, so this equals it between the streams bit for bit."""
    B, T, n = gbar.shape
    tw = network.wf_t_width
    R = network.wf_ring_rows
    row_len = n + 1
    t_row = network.wf_t_row.long()
    t_col = network.wf_t_col.long()
    m = network.depth - network.level_p.long()
    runs = active_runs(network, T, reverse=True)
    slots = torch.arange(tw, device=gbar.device)

    def rows_at(a, idx, t):
        out = a.new_zeros(B, a.shape[-1])
        out[:, idx] = a[:, t, idx]
        return out

    ring = gbar.new_zeros(B, R * row_len)
    gx = gbar.new_zeros(B, n)
    lam_all = gbar.new_empty(B, T, n)
    for v in range(1, T + network.depth + 1):
        idx = runs.nodes(v)
        if idx.numel() == 0:
            continue
        t = T - v + m[idx]
        e_idx, e_t = (idx[:, None] * tw + slots).reshape(-1), t.repeat_interleave(tw)
        h1 = (v - 1) % R
        rot = h1 - t_row
        rot = torch.where(rot < 0, rot + R, rot)
        g = ring[:, rot * row_len + t_col]  # successors' lam, emitted gap waves earlier
        zsum = slot_sum((rows_at(zce, e_idx, e_t) * g).reshape(B, n, tw))
        dusum = slot_sum((rows_at(duce, e_idx, e_t) * g).reshape(B, n, tw))
        lam = rows_at(gbar, idx, t) + gx + zsum
        gx_next = rows_at(ow, idx, t) * lam + dusum
        ring[:, (v % R) * row_len + idx] = lam[:, idx]
        gx[:, idx] = gx_next[:, idx]
        lam_all[:, t, idx] = lam[:, idx]
    return lam_all


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
    [ctypes.c_void_p] * 7  # gbar, ow, zce, duce, lam, ring, gx
    + [ctypes.c_void_p] * 4  # runs, lvl, t_row, t_col
    + [ctypes.c_int] * 8  # B, T, n, W, R, K, depth, t_width
    + [ctypes.c_longlong]  # max_pairs
    + [ctypes.c_int]  # device
    + [ctypes.c_void_p]  # stream
)


def _load_library():
    from ddr_tpu_torch.routing import _build

    lib = _build.load("reverse_scan")
    if not getattr(lib, "_ddr_typed", False):
        lib.ddr_reverse_scan_tm.argtypes = _ARGTYPES
        lib.ddr_reverse_scan_tm.restype = ctypes.c_int
        lib.ddr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ddr_cuda_error_string.restype = ctypes.c_char_p
        lib._ddr_typed = True
    return lib


def reverse_scan(rows_s: torch.Tensor, network: RiverNetwork, *, T: int) -> torch.Tensor:
    """The pre-skewed reverse wave scan ``(B, W, 2n + 2 n t_width) -> (B, W,
    n)`` of the JAX package's layout, for CPU tensors:
    :func:`reverse_scan_reference`. The card's kernel is time-major
    (:func:`reverse_scan_tm`), so any other device raises and
    ``reverse_scan.launches`` stays 0."""
    if rows_s.device.type != "cpu":
        raise ValueError(f"the pre-skewed reverse_scan takes CPU tensors, got {rows_s.device}: "
                         "for CPU or CUDA tensors use the time-major reverse_scan_tm")
    return reverse_scan_reference(rows_s, network, T=T)


reverse_scan.launches = 0


def reverse_scan_tm(gbar: torch.Tensor, ow: torch.Tensor, zce: torch.Tensor, duce: torch.Tensor,
                    network: RiverNetwork) -> torch.Tensor:
    """The time-major reverse wave scan -> ``lam_all (B, T, n)``: the CUDA
    kernel for CUDA tensors, :func:`reverse_scan_tm_reference` for CPU
    tensors. ``gbar`` and ``ow`` are ``(B, T, n)``, ``zce`` and ``duce``
    ``(B, T, n t_width)``, all float32; ``network`` is a RiverNetwork or a
    band of a stacked frame.

    Raises on anything the kernel does not take (other dtypes, shapes or
    devices, non-contiguous inputs, out-of-range tables); never falls back."""
    if gbar.device.type == "cpu":
        return reverse_scan_tm_reference(gbar, ow, zce, duce, network)
    if gbar.device.type != "cuda":
        raise ValueError(f"reverse_scan_tm takes CPU or CUDA tensors, got {gbar.device}")
    n, tw = network.n, network.wf_t_width
    if gbar.dim() != 3 or gbar.shape[-1] != n or gbar.shape[1] < 1:
        raise ValueError(f"gbar {tuple(gbar.shape)} does not match (B, T >= 1, n={n})")
    B, T, _ = gbar.shape
    for name, a, width in (("gbar", gbar, n), ("ow", ow, n), ("zce", zce, n * tw), ("duce", duce, n * tw)):
        if tuple(a.shape) != (B, T, width) or a.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B}, {T}, {width}) float32, got {tuple(a.shape)} {a.dtype}")
    dev = gbar.device
    ints = [network.level_p, network.wf_t_row, network.wf_t_col]
    for t in [gbar, ow, zce, duce, *ints]:
        if t.device != dev:
            raise ValueError(f"reverse_scan_tm operands must all lie on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("reverse_scan_tm operands must be contiguous")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("reverse_scan_tm tables must be int32")
    _check_tables(network)
    runs = active_runs(network, T, reverse=True)
    R = network.wf_ring_rows

    lib = _load_library()
    lam_all = torch.empty(B, T, n, dtype=torch.float32, device=dev)  # each (b, t, i) once
    ring = torch.zeros(B, R, n + 1, dtype=torch.float32, device=dev)
    gx = torch.zeros(B, n, dtype=torch.float32, device=dev)
    err = lib.ddr_reverse_scan_tm(
        gbar.data_ptr(), ow.data_ptr(), zce.data_ptr(), duce.data_ptr(), lam_all.data_ptr(),
        ring.data_ptr(), gx.data_ptr(), runs.table.data_ptr(), *(t.data_ptr() for t in ints),
        B, T, n, T + network.depth, R, runs.n_runs, network.depth, tw, B * runs.widest,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"reverse_scan_tm kernel launch failed: {lib.ddr_cuda_error_string(err).decode()} "
            f"(cudaError {err})"
        )
    reverse_scan_tm.launches += 1
    return lam_all


reverse_scan_tm.launches = 0
