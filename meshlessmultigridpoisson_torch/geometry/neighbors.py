"""k-nearest-neighbor search with the reference's stencil semantics.

The reference does a brute-force O(N) scan + max-heap per query
(Grid::kNearestNeighbors, grid.cpp:216-260) making assembly O(N^2).  Here we
use a KD-tree (scipy) — same result set, scalable — with the two reference
semantics preserved:

* the query point itself is ALWAYS in its own stencil (grid.cpp:254,
  "Have to include point itself in the stencil since otherwise diag would be
  zeros");
* for a NEUMANN boundary query point, all other boundary points are excluded
  from the candidate set (grid.cpp:236,244) so that boundary rows couple only
  to interior points (this is what makes bound_eval_neumann a parallel
  per-row solve and implicit condensation local).

Neighbors are returned sorted by distance ascending, self first — matching
the reference's sort_heap output order (grid.cpp:252), which matters because
weight-generation RHS kernels index position 0 as the self point
(grid.cpp:320,359,398: the i==0 / D>0 guards).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def knn(
    points: np.ndarray,
    k: int,
    boundary_mask: np.ndarray | None = None,
    neumann: bool = False,
) -> np.ndarray:
    """Neighbor table [N, k] int32 for every point of ``points``.

    With ``neumann=True`` and a ``boundary_mask``, boundary query points use
    the interior-only candidate set (plus themselves).
    """
    n = points.shape[0]
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    tree = cKDTree(points)
    _, idx = tree.query(points, k=k)
    idx = np.atleast_2d(idx).astype(np.int32)

    if neumann and boundary_mask is not None and boundary_mask.any():
        bidx = np.nonzero(boundary_mask)[0]
        interior = np.nonzero(~boundary_mask)[0]
        if interior.size < k - 1:
            raise ValueError("not enough interior points for Neumann stencils")
        itree = cKDTree(points[interior])
        _, iidx = itree.query(points[bidx], k=k - 1)
        iidx = np.atleast_2d(iidx)
        # self first (distance 0), then the k-1 nearest interior points
        idx[bidx, 0] = bidx
        idx[bidx, 1:] = interior[iidx].astype(np.int32)
    return idx


def knn_queries(
    points: np.ndarray, queries: np.ndarray, k: int
) -> np.ndarray:
    """Neighbor table [M, k] of ``queries`` against ``points``.

    Used for transfer-operator stencils (Grid::pointInterpWeights with
    neumann=false/pointBCFlag=false, grid.cpp:687-712): no exclusions; if a
    query coincides with a cloud point it is naturally nearest (distance 0).
    """
    tree = cKDTree(points)
    _, idx = tree.query(queries, k=k)
    return np.atleast_2d(idx).astype(np.int32)
