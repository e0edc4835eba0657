"""Lower-triangular sparse solve over the river DAG, with its own backward.

The port of ``ddr_tpu/routing/solver.py``: the step engine solves

    A x = b,   A = I - diag(c1) N

with ``N`` the strictly lower-triangular adjacency of the topologically
sorted network. Row i reads ``x_i = b_i + c1_i * sum_{j drains into i} x_j``,
so forward substitution is a downstream sweep, one longest-path level at a
time; the backward solves the transposed system ``A^T grad_b = grad_x`` (an
upstream sweep over the same schedule) and, since every stored
off-diagonal value is ``-c1[tgt]``, ``grad_c1 = grad_b * (N @ x)``.

Two schedules, as the network carries them
(:class:`~ddr_tpu_torch.routing.network.RiverNetwork`):

* the rectangle ``lvl_src``/``lvl_tgt``: each row gathers its sources and
  adds into its targets with ``index_add_`` (on CUDA its atomics may reorder
  a node's float sum);
* the fused schedule in level-contiguous permuted space: each level gathers
  its predecessors (``pred``) or successors (``down``) from a padded table
  and writes its own slice, no scatter.

JAX's out-of-range conventions (``mode="clip"``/``"fill"`` reads and
``mode="drop"`` writes at the sentinel ``n``) become one appended column
``n`` that reads 0 (``c1`` is 0 there too, so a pad row's contribution is 0
and lands in that column, which is cut off at the end). Everything works
over the last axis, so ``c1``/``b`` may carry leading batch axes; the dtype
is the inputs' (float32, float64 for the oracle, or complex for the LTI
comparator's frequency bins).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ddr_tpu_torch.routing.network import RiverNetwork

__all__ = ["SOLVE_DTYPES", "fused_solve", "solve_lower_triangular", "solve_transposed"]


def _pad(a: torch.Tensor) -> torch.Tensor:
    return F.pad(a, (0, 1))


def _sweep_down(c1: torch.Tensor, b: torch.Tensor, lvl_src: torch.Tensor,
                lvl_tgt: torch.Tensor) -> torch.Tensor:
    """Forward substitution over the rectangle, levels ascending."""
    x = _pad(b)
    c1e = _pad(c1).index_select(-1, lvl_tgt.reshape(-1)).reshape(c1.shape[:-1] + lvl_tgt.shape)
    for r in range(lvl_src.shape[0]):
        x.index_add_(-1, lvl_tgt[r], x.index_select(-1, lvl_src[r]) * c1e[..., r, :])
    return x[..., :-1]


def _sweep_up(c1: torch.Tensor, g: torch.Tensor, lvl_src: torch.Tensor,
              lvl_tgt: torch.Tensor) -> torch.Tensor:
    """The transposed solve ``A^T y = g`` over the rectangle, levels
    descending: ``y_j = g_j + sum_{i : j drains into i} c1_i y_i``; a
    target's ``y`` is final before it is pushed back to its sources."""
    y = _pad(g)
    c1p = _pad(c1)
    for r in range(lvl_src.shape[0] - 1, -1, -1):
        tgt = lvl_tgt[r]
        y.index_add_(-1, lvl_src[r], y.index_select(-1, tgt) * c1p.index_select(-1, tgt))
    return y[..., :-1]


class _RectangleSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c1, b, lvl_src, lvl_tgt, edge_src, edge_tgt):
        x = _sweep_down(c1, b, lvl_src, lvl_tgt)
        ctx.save_for_backward(c1, x, lvl_src, lvl_tgt, edge_src, edge_tgt)
        return x

    @staticmethod
    def backward(ctx, grad_x):
        c1, x, lvl_src, lvl_tgt, edge_src, edge_tgt = ctx.saved_tensors
        grad_b = _sweep_up(c1, grad_x.contiguous(), lvl_src, lvl_tgt)
        nx = x.new_zeros(x.shape).index_add_(-1, edge_tgt, x.index_select(-1, edge_src))
        return grad_b * nx, grad_b, None, None, None, None


def _fused_sweep_down(starts: tuple, c1: torch.Tensor, b: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Forward substitution in permuted space: ``x_i = b_i + c1_i * sum_p x_p``,
    one level slice at a time."""
    x = _pad(b)
    for lvl in range(1, len(starts) - 1):
        s, e = starts[lvl], starts[lvl + 1]
        contrib = x[..., pred[s:e]].sum(-1)
        x[..., s:e] = b[..., s:e] + c1[..., s:e] * contrib
    return x[..., :-1]


def _fused_sweep_up(starts: tuple, c1: torch.Tensor, g: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The transposed solve in permuted space, levels descending:
    ``y_j = g_j + sum_d c1_d y_d`` over the successors ``d`` (a gather)."""
    y = _pad(g)
    c1p = _pad(c1)
    for lvl in range(len(starts) - 3, -1, -1):  # the deepest level keeps y = g
        s, e = starts[lvl], starts[lvl + 1]
        d = down[s:e]
        y[..., s:e] = g[..., s:e] + (y[..., d] * c1p[..., d]).sum(-1)
    return y[..., :-1]


class _FusedSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, starts, c1, b, pred, down):
        x = _fused_sweep_down(starts, c1, b, pred)
        ctx.starts = starts
        ctx.save_for_backward(c1, x, pred, down)
        return x

    @staticmethod
    def backward(ctx, grad_x):
        c1, x, pred, down = ctx.saved_tensors
        grad_b = _fused_sweep_up(ctx.starts, c1, grad_x.contiguous(), down)
        nx = _pad(x)[..., pred].sum(-1)
        return None, grad_b * nx, grad_b, None, None


def fused_solve(starts: tuple, c1: torch.Tensor, b: torch.Tensor, pred: torch.Tensor,
                down: torch.Tensor) -> torch.Tensor:
    """Solve ``(I - diag(c1) N) x = b`` in the fused schedule's permuted
    space (``starts`` the level starts, ``pred``/``down`` the padded
    predecessor and successor tables); differentiable in ``c1`` and ``b``."""
    return _FusedSolve.apply(starts, c1, b, pred.long(), down.long())


#: The dtypes a solve takes: float32 (the step engine), float64 (the oracle),
#: complex64 and complex128 (one frequency bin a row, the LTI comparator).
SOLVE_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _check(network: RiverNetwork, c1: torch.Tensor, b: torch.Tensor) -> None:
    if c1.shape != b.shape or c1.shape[-1:] != (network.n,):
        raise ValueError(
            f"c1 {tuple(c1.shape)} and b {tuple(b.shape)} must have one shape (..., {network.n})"
        )
    if c1.dtype != b.dtype or c1.dtype not in SOLVE_DTYPES:
        raise ValueError(f"c1 {c1.dtype} and b {b.dtype} must share one dtype of {SOLVE_DTYPES}")


def solve_lower_triangular(network: RiverNetwork, c1: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(I - diag(c1) N) x = b`` (original order, over the last axis)
    on the network's fused schedule where it has one, else its rectangle.
    The backward stores only the solution and replays one transposed
    sweep."""
    _check(network, c1, b)
    if network.fused:
        perm, inv = network.perm.long(), network.inv_perm.long()
        x_p = fused_solve(network.level_starts, c1[..., perm], b[..., perm], network.pred, network.down)
        return x_p[..., inv]
    return _RectangleSolve.apply(c1, b, network.lvl_src.long(), network.lvl_tgt.long(),
                                 network.edge_src.long(), network.edge_tgt.long())


def solve_transposed(network: RiverNetwork, c1: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The transposed solve ``A^T y = g`` (original order), for tests and
    diagnostics."""
    _check(network, c1, g)
    with torch.no_grad():
        if network.fused:
            perm, inv = network.perm.long(), network.inv_perm.long()
            y_p = _fused_sweep_up(network.level_starts, c1[..., perm], g[..., perm], network.down.long())
            return y_p[..., inv]
        return _sweep_up(c1, g, network.lvl_src.long(), network.lvl_tgt.long())
