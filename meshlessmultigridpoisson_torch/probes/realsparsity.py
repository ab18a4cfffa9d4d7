"""A real RBF-FD sparsity pattern with random values, for kernel timing.

    python -m meshlessmultigridpoisson_torch.probes.realsparsity [n]

Port of the reference package's ``scripts/realsparsity.py``: kNN (k = 70)
on a jittered ``sqrt(n) x sqrt(n)`` grid cloud in kd-tile order (128-point
leaves), values standard normal from ``seed`` with the diagonal (the
self neighbour, first in each kNN list) at k + 1.  A true 70-neighbour
stencil is far less scattered than a synthetic band operator, so this is
the operator the kernel-generation probe (``probes.ktime``) times.  The
command line prints, per block size, the ELL width and the most distinct
128-row x patches a 128-row block reads (G; ``gpu_kernels.v6_supported``
takes up to 256).
"""

from __future__ import annotations

import sys

import numpy as np

from meshlessmultigridpoisson_torch.geometry.ordering import kd_tile_ordering

K = 70


def real_pattern_csr(n_target: int, k: int = K, seed: int = 0):
    """[n, n] scipy CSR, n = round(sqrt(n_target))^2."""
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    side = int(round(np.sqrt(n_target)))
    n = side * side
    rng = np.random.default_rng(seed)
    xy = np.stack(
        np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1
    ).reshape(-1, 2).astype(np.float64)
    xy += rng.uniform(-0.35, 0.35, xy.shape)
    xy = xy[kd_tile_ordering(xy, leaf=128)]
    _, nbr = cKDTree(xy).query(xy, k=k, workers=-1)
    vals = rng.standard_normal((n, k))
    vals[:, 0] = k + 1.0  # self first (the tree returns self at distance 0)
    rows = np.repeat(np.arange(n), k)
    a = sp.coo_matrix((vals.ravel(), (rows, nbr.ravel())), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def main(argv=None) -> None:
    from meshlessmultigridpoisson_torch.ops.ell import ell_from_csr, global_cols
    from meshlessmultigridpoisson_torch.ops.gpu_kernels import LANES, block_patches

    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 262_144
    a = real_pattern_csr(n)
    print(f"n={a.shape[0]} nnz={a.nnz}")
    for br in (128, 256):
        ell = ell_from_csr(a, block_rows=br)
        g = block_patches(global_cols(ell).numpy(), ell.nrows_pad // LANES).shape[1]
        print(f"br={br} width={ell.width} G={g}")


if __name__ == "__main__":
    main()
