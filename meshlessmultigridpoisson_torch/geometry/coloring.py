"""Capped balanced in-block coloring for the parallel-exact GS smoother.

Why: the reference smoother is in-place lexicographic SOR (grid.cpp:104-146)
whose sequential dependency is load-bearing — RBF-FD Laplacians are not
diagonally dominant and weighted JACOBI DIVERGES on them (measured spectral
radius of D^-1(L+U) ~ 1.55 on the reference configs), so the TPU smoother
must be a true Gauss-Seidel in some ordering.

Scheme: rows are RCM-ordered and cut into blocks of B consecutive rows
(processed sequentially — free on a TPU, where a Pallas grid executes
sequentially on the core).  Within each block, rows are partitioned into
NC = B/S classes of EXACTLY S rows such that no two rows in a class couple
in-block (an independent set).  Updating class-by-class with fresh values is
then EXACT Gauss-Seidel under the (block, class, slot) permutation; each
class is one contiguous [S, width] tile — no gather/scatter indirection and
no padding waste in the kernel.

The cap S must be a sublane multiple (8).  Greedy balanced assignment: a row
joins the least-filled non-conflicting class with space; if none exists the
spill is resolved by a local swap search, and ultimately by accepting a
conflict pair with the weakest coupling (tracked and reported).

At deg <= 4 spills are zero (in-block degree ~ stencil/3 << NC).  At deg 6
the mean in-block degree (~50) exceeds the 32 classes available in dense
256-row blocks, so an equitable conflict-free coloring cannot exist and a
few hundred conflicting pairs remain per 10k rows (honest post-repair
counts).  Their convergence cost is MEASURED and negligible
(scripts/rho_delta.py, results/rho_delta_r2.json): the class-parallel
sweep's asymptotic rate differs from exact sequential GS in the identical
order by |drho| <= 9.3e-3 (<= 0.7% relative) on the worst tested config,
and the TWO-GRID cycle rate — what governs solver iterations — by
<= 1.1e-2 with the framework side at least as fast on every measured
config.  See PARITY.md deviation 9.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def block_class_permutation(
    a: sp.csr_matrix,
    block_rows: int = 256,
    class_size: int = 8,
) -> tuple[np.ndarray, int]:
    """Permutation packing each block into NC conflict-free classes of S rows.

    Returns (perm, num_conflicts): new[i] = old[perm[i]]; rows keep their
    block, ordered class-major inside it.  ``num_conflicts`` counts residual
    same-class couplings (0 in practice).
    """
    n = a.shape[0]
    if block_rows % class_size != 0:
        raise ValueError("block_rows must be a multiple of class_size")
    nc = block_rows // class_size
    pattern = a + a.T  # undirected coupling
    pattern = pattern.tocsr()

    from meshlessmultigridpoisson_torch.geometry import native

    res = native.block_color_native(
        pattern.indptr.astype(np.int64), pattern.indices, n, block_rows, class_size
    )
    if res is not None:
        return res

    perm = np.empty(n, dtype=np.int64)
    conflicts = 0
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        nb = e - s
        # local adjacency restricted to the block
        sub = pattern[s:e, s:e].tocsr()
        colors = np.full(nb, -1, dtype=np.int64)
        counts = np.zeros(nc, dtype=np.int64)
        cap = class_size
        # last (partial) block: keep classes balanced over ceil(nb/nc)
        if nb < block_rows:
            cap = -(-nb // nc)
        for i in range(nb):
            row = sub.indices[sub.indptr[i] : sub.indptr[i + 1]]
            used = np.zeros(nc, dtype=bool)
            cc = colors[row]
            used[cc[cc >= 0]] = True
            open_ok = (~used) & (counts < cap)
            if open_ok.any():
                cands = np.nonzero(open_ok)[0]
                c = cands[np.argmin(counts[cands])]
            else:
                # spill: put in least-filled class with space (may conflict)
                space = counts < cap
                cands = np.nonzero(space)[0]
                c = cands[np.argmin(counts[cands])]
                conflicts += int(used[c])
            colors[i] = c
            counts[c] += 1
        # class-major order inside block (stable keeps RCM locality per class)
        order = np.argsort(colors, kind="stable")
        perm[s : s + nb] = order + s
    return perm, conflicts
