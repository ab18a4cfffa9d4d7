"""The reference program's fine RBF-FD system, assembled again, and the
relative residual of a solution on it.

From the benchmark's own cloud and boundary data (never from anything the
program made) this builds the fine level of the reference program's
Poisson problem (testing_functions.cpp:267-283, grid.cpp:520-685):

* PHS r^rbf_exp plus the fine degree's polynomial, k = floor(2.5 x terms)
  nearest neighbours (``stencil.py``);
* interior rows: the Laplacian; Dirichlet rows: x = g; Neumann rows: the
  stored normal's derivative = g, over interior-only neighbours;
* on Neumann problems the implicit condensation of the Neumann unknowns out
  of the interior rows (frozen from ``stencil/operators.py``'s
  ``_condense_neumann`` at commit 57ee902, grid.cpp:598-662), its pushdown
  of g into the right-hand side (grid.cpp:664-685), and the Lagrange
  border: a column of ones on the non-Neumann rows, the row summing the
  non-Neumann unknowns, a unit corner, right-hand side 0.

``relative_residual`` is the solve's stopping measure (multigrid.cpp:112-115):
(||b - A x - lag_col x_lag||_1 + |0 - lag_row.x - x_lag|) / ||b||_1, with
Dirichlet rows as identity rows and b = g there.  Everything is float64:
the assembly on the host (the weights' saddle solves on ``device``), the
residual on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from benchmark.reference.stencil import knn, weights


def poly_terms(deg: int, dim: int) -> int:
    return (deg + 1) * (deg + 2) // 2 if dim == 2 else (deg + 1) * (deg + 2) * (deg + 3) // 6


def stencil_size(deg: int, dim: int) -> int:
    return int(2.5 * poly_terms(deg, dim))  # grid.cpp:267


def condense_neumann(A: sp.csr_matrix, flags: np.ndarray, diag_guard: float = 0.25):
    """A' = A - S D^-1 B on the interior rows and C = S D^-1, where S holds
    the interior rows' Neumann columns and B the Neumann rows; an interior
    row whose condensed diagonal collapses below ``diag_guard`` of its own,
    or whose off-diagonal ratio grows past max(3x, 10), keeps its
    uncondensed form and no row of C.  The condensed rows lose their
    Neumann columns."""
    n = A.shape[0]
    interior, nmn = flags == 0, flags == 2
    D = A.diagonal()
    d_b = np.where(nmn, D, 1.0)
    S = A.multiply(interior[:, None]).multiply(nmn[None, :]).tocsr()
    C = S.multiply(1.0 / d_b[None, :]).tocsr()
    Bs = A.multiply(nmn[:, None]).multiply(1.0 / d_b[:, None]).tocsr()
    A2 = (A - (S @ Bs)).tocsr()
    A2.sum_duplicates()

    def row_ratio(M):
        d = M.diagonal()
        return (np.abs(M).sum(axis=1).A1 - np.abs(d)) / np.maximum(np.abs(d), 1e-300)

    bad = interior & ((np.abs(A2.diagonal()) < diag_guard * np.abs(D))
                      | (row_ratio(A2) > np.maximum(3.0 * row_ratio(A), 10.0)))
    if bad.any():
        keep = ~bad
        A2 = (A2.multiply(keep[:, None]).tocsr() + A.multiply(bad[:, None]).tocsr()).tocsr()
        A2.sum_duplicates()
        C = C.multiply(keep[:, None]).tocsr()
        C.eliminate_zeros()
        interior = interior & keep
    drop = interior[np.repeat(np.arange(n), np.diff(A2.indptr))] & nmn[A2.indices]
    A2.data[drop] = 0.0
    A2.eliminate_zeros()
    return A2, C


@dataclasses.dataclass
class ReferenceSystem:
    A: torch.Tensor  # sparse CSR [n, n] f64 (condensed on Neumann problems)
    C: sp.csr_matrix | None  # the pushdown C = S D^-1 (Neumann)
    dirichlet: torch.Tensor  # [n] bool
    neumann: np.ndarray  # [n] bool
    boundary: np.ndarray  # [n] bool
    g: np.ndarray  # [n] boundary data, 0 inside
    border: bool  # the Lagrange border (Neumann problems)

    def rhs(self, source: np.ndarray) -> np.ndarray:
        """b: the source inside, g on the boundary, g pushed down."""
        b = np.where(self.boundary, self.g, source)
        if self.C is not None:  # C's columns are the Neumann points'
            b = b - self.C @ b
        return b

    def relative_residual(self, x: torch.Tensor, x_lag: float, source: np.ndarray) -> float:
        """The solve's relative L1 residual of (x, x_lag) (x in the cloud's
        point order, on the system's device)."""
        dev = self.A.device
        b = torch.as_tensor(self.rhs(source), dtype=torch.float64, device=dev)
        x = x.to(device=dev, dtype=torch.float64)
        y = (self.A @ x[:, None])[:, 0]
        r_lag = 0.0
        if self.border:
            lag = torch.as_tensor(~self.neumann, dtype=torch.float64, device=dev)
            y = y + lag * x_lag
            r_lag = abs(float(-(x * lag).sum() - x_lag))
        y = torch.where(self.dirichlet, x, y)
        return (float((b - y).abs().sum()) + r_lag) / float(b.abs().sum())


def assemble(cloud, neumann: bool, g: np.ndarray, poly_deg: int, rbf_exp: int,
             device) -> ReferenceSystem:
    """The fine system of ``cloud`` (a benchmark ``Cloud``) with boundary
    data ``g`` on every boundary component, Dirichlet or (``neumann``)
    Neumann."""
    pts = cloud.points
    n, dim = pts.shape
    bmask = np.zeros(n, dtype=bool)
    for idx in cloud.boundaries:
        bmask[idx] = True
    flags = np.where(bmask, 2 if neumann else 1, 0)
    k = stencil_size(poly_deg, dim)
    nbr = knn(pts, k, bmask, neumann)
    w = np.zeros((n, k))
    rows = np.nonzero(flags == 0)[0]  # a Dirichlet row is x = g: no stencil
    w[rows] = weights(pts, nbr[rows], pts[rows], "laplace", poly_deg, rbf_exp, device)
    if neumann:
        bidx = np.nonzero(bmask)[0]
        w[bidx] = sum(cloud.normals[bidx, d:d + 1]
                      * weights(pts, nbr[bidx], pts[bidx], op, poly_deg, rbf_exp, device)
                      for d, op in enumerate(("dx", "dy", "dz")[:dim]))
    A = sp.coo_matrix((w.ravel(), (np.repeat(np.arange(n), k), nbr.ravel())),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    C = None
    if neumann:
        A, C = condense_neumann(A, flags)
    At = torch.sparse_csr_tensor(torch.from_numpy(A.indptr.astype(np.int64)),
                                 torch.from_numpy(A.indices.astype(np.int64)),
                                 torch.from_numpy(A.data), size=(n, n),
                                 dtype=torch.float64).to(device)
    return ReferenceSystem(A=At, C=C, dirichlet=torch.as_tensor(flags == 1, device=device),
                           neumann=flags == 2, boundary=bmask, g=g, border=neumann)
