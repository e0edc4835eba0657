"""Graph preprocessing on numpy and ``heapq``: the port's copy of the
numpy path of ``ddr_tpu/engine/graph.py``.

Every function takes ``(src, dst)`` edge arrays, ``src`` draining into
``dst``, over nodes ``0..n-1``; mapping ids to indices is the caller's
concern. Ties are broken by the smallest node index, as in the JAX
package, so the topological order, and every store index built on it, is
the same in both.
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["topological_sort", "longest_path_levels", "cycle_nodes", "ancestors_mask"]


def _as_edges(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (
        np.ascontiguousarray(src, dtype=np.int64),
        np.ascontiguousarray(dst, dtype=np.int64),
    )


def topological_sort(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Topological order of all ``n`` nodes, the smallest ready index first.
    Raises ``ValueError`` when the graph has a cycle."""
    src, dst = _as_edges(src, dst)
    indeg = np.bincount(dst, minlength=n)
    succ: list[list[int]] = [[] for _ in range(n)]
    for s, d in zip(src.tolist(), dst.tolist()):
        succ[s].append(d)
    ready = [i for i in range(n) if indeg[i] == 0]
    heapq.heapify(ready)
    order = []
    while ready:
        u = heapq.heappop(ready)
        order.append(u)
        for v in succ[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                heapq.heappush(ready, v)
    if len(order) < n:
        raise ValueError(f"graph has a cycle: only {len(order)}/{n} nodes sortable")
    return np.asarray(order, dtype=np.int64)


def longest_path_levels(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Longest-path level per node (headwaters = 0); raises on cycles."""
    from ddr_tpu_torch.routing.network import compute_levels

    src, dst = _as_edges(src, dst)
    return compute_levels(dst, src, n)  # compute_levels takes (rows=down, cols=up)


def cycle_nodes(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Indices of the nodes left after peeling, again and again, every node
    with no in- or out-edge: the nodes on directed cycles (the removal set of
    the MERIT builder's cycle repair)."""
    src, dst = _as_edges(src, dst)
    indeg = np.bincount(dst, minlength=n)
    outdeg = np.bincount(src, minlength=n)
    alive = np.ones(n, dtype=bool)
    while True:
        peel = alive & ((indeg == 0) | (outdeg == 0))
        if not peel.any():
            break
        alive &= ~peel
        keep = alive[src] & alive[dst]
        indeg = np.bincount(dst[keep], minlength=n)
        outdeg = np.bincount(src[keep], minlength=n)
    return np.flatnonzero(alive)


def ancestors_mask(
    src: np.ndarray, dst: np.ndarray, n: int, targets: np.ndarray
) -> np.ndarray:
    """Boolean mask of every node with a path to any target, the targets
    included."""
    from ddr_tpu_torch.io.builders import upstream_closure

    src, dst = _as_edges(src, dst)
    out = np.zeros(n, dtype=bool)
    out[upstream_closure(dst, src, n, np.asarray(targets, dtype=np.int64))] = True
    return out
