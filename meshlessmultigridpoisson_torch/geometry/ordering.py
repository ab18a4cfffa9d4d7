"""Point orderings: bandwidth-minimizing RCM, Morton and kd-tile orders.

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


def _interleave_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of v so there are 2 zero bits between each."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def sfc_ordering(points: np.ndarray) -> np.ndarray:
    """Morton (Z-curve) ordering of 2D/3D points: spatial-locality order
    (each coordinate scaled to 20 bits over the cloud's extent, the bits
    interleaved, a stable sort of the keys)."""
    dim = points.shape[1]
    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-300)
    scaled = ((points - lo) / span * ((1 << 20) - 1)).astype(np.uint64)
    key = np.zeros(points.shape[0], dtype=np.uint64)
    for d in range(dim):
        key |= _interleave_bits(scaled[:, d]) << np.uint64(d)
    return np.argsort(key, kind="stable")


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


def tile_window_ordering(
    points: np.ndarray, neighbors: np.ndarray, prefer: str = "rcm"
) -> np.ndarray:
    """The ordering, RCM or Morton, whose widest 256-row block of the
    neighbor table ``neighbors`` [N, k] spans the fewest columns (the
    smaller max column window; ties go to ``prefer``)."""
    perms = {"rcm": rcm_ordering(neighbors), "sfc": sfc_ordering(points)}

    def max_window(perm: np.ndarray, block: int = 256) -> int:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        cols = inv[neighbors[perm]]  # [N, k] new column ids, rows in new order
        worst = 0
        for s in range(0, perm.size, block):
            blk = cols[s : s + block]
            worst = max(worst, int(blk.max() - blk.min()) + 1)
        return worst

    order = [prefer] + [k for k in perms if k != prefer] if prefer in perms else list(perms)
    scored = {k: max_window(perms[k]) for k in order}
    return perms[min(scored, key=scored.get)]
