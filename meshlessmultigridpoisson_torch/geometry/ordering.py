"""Point orderings: bandwidth-minimizing RCM and kd-tile orders.

Replaces the reference's Grid::rcm_order_points + BFS-based
(reverse_)cuthill_mckee_ordering (grid.cpp:713-776,
general_computation_functions.cpp:108-134 — the reference "RCM" is plain BFS
with no degree sorting and no disconnected-component restart; we use a real
RCM).  Ordering is what makes the TPU operator format work: after RCM, every
contiguous block of rows touches a narrow contiguous window of columns, so
the Pallas smoother can DMA one x-window per row-block and gather locally,
and the distributed partitioner gets small halos.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


def rcm_ordering(neighbors: np.ndarray, n: int | None = None) -> np.ndarray:
    """Reverse Cuthill-McKee permutation from a kNN table [N, k].

    Returns ``perm`` with new[i] = old[perm[i]] (same convention as the
    reference's ``order``, grid.cpp:750-755).  The adjacency is symmetrized
    (union of i->j and j->i), as bandwidth is a symmetric notion.
    """
    if n is None:
        n = neighbors.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), neighbors.shape[1])
    cols = neighbors.ravel().astype(np.int64)
    data = np.ones(rows.size, dtype=np.int8)
    adj = sp.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()
    adj = (adj + adj.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64)


def kd_tile_ordering(points: np.ndarray, leaf: int = 128) -> np.ndarray:
    """Recursive coordinate bisection into contiguous tiles of ``leaf`` points.

    Every aligned run of ``leaf`` indices is a spatially compact patch, so a
    stencil's columns fall into O(1) patches regardless of N — the invariant
    the patch-table TPU kernels (ops/kernels.py v2) rely on.  Splits halve
    point COUNTS (not extents) along the wider axis, so tiles stay balanced;
    DFS order keeps neighboring tiles mostly adjacent in index space.
    """
    n = points.shape[0]
    perm = np.empty(n, dtype=np.int64)
    out_pos = [0]

    def rec(idx: np.ndarray):
        if idx.size <= leaf:
            perm[out_pos[0] : out_pos[0] + idx.size] = idx
            out_pos[0] += idx.size
            return
        p = points[idx]
        ext = p.max(axis=0) - p.min(axis=0)
        ax = int(np.argmax(ext))
        # split at a leaf-multiple so tiles stay aligned to `leaf`
        ntiles_left = (idx.size // leaf + 1) // 2
        kth = min(max(ntiles_left * leaf, leaf), idx.size - 1)
        order = np.argpartition(p[:, ax], kth)
        rec(idx[order[:kth]])
        rec(idx[order[kth:]])

    rec(np.arange(n, dtype=np.int64))
    return perm
