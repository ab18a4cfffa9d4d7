"""Operator assembly: RBF-FD Laplacian + boundary machinery into windowed ELL.

Port of the reference package's ``stencil/operators.py`` (itself the host
redesign of Grid::build_laplacian / build_deriv_normal_bound /
modify_coeff_neumann / push_inhomog_to_rhs, grid.cpp:520-685):

* rows with bc flag != 2 get Laplacian stencil weights;
* Neumann rows get n.grad weights over interior-only stencils, the
  Lagrange border is kept out of the matrix (rank-1 lag_col/lag_row), and
  implicit mode condenses Neumann unknowns out of interior rows;
* the assembled matrix is padded to a multiple of ``block_rows`` and
  symmetrically permuted by the capped in-block coloring so the smoother's
  (block, class) sweep is exact Gauss-Seidel.  ``row_map`` maps logical
  cloud indices to permuted rows; every solver vector lives in permuted
  padded space.

Everything here runs on the host in f64 except the weight solves, which run
on ``device``; outputs are CPU tensors.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from meshlessmultigridpoisson_torch.config import GridConfig
from meshlessmultigridpoisson_torch.geometry.coloring import block_class_permutation
from meshlessmultigridpoisson_torch.geometry.neighbors import knn, knn_queries
from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud
from meshlessmultigridpoisson_torch.ops.ell import EllMatrix, ell_from_csr
from meshlessmultigridpoisson_torch.stencil.phs import batched_weights


@dataclasses.dataclass(frozen=True)
class CompactRows:
    """A small set of rows of a big operator, packed densely.

    ``rows`` holds target row indices in the big (permuted) row space;
    padding slots point past the end.  ``ell.diag`` holds the big matrix's
    diagonal at those rows.
    """

    rows: torch.Tensor  # [m_pad] int32
    ell: EllMatrix  # [m_pad, ncols]
    nrows: int  # true m


@dataclasses.dataclass(frozen=True)
class LevelOperator:
    """Everything the solve path needs for one grid level (host, f64).

    Vectors are padded to ``A.nrows_pad`` and live in (block, class)-permuted
    row space; ``row_map[i]`` is the permuted row of logical point i.
    ``omega_scale`` is a per-row multiplier on omega.
    """

    A: EllMatrix
    bound: CompactRows  # Neumann boundary rows (empty if pure Dirichlet)
    cond: CompactRows  # C = S D^-1 (empty unless implicit Neumann)
    lag_col: torch.Tensor  # [n_pad] 1.0 where the border column has a 1
    lag_row: torch.Tensor  # [n_pad] 1.0 where the border row has a 1
    omega_scale: torch.Tensor  # [n_pad]
    smooth_mask: torch.Tensor  # [n_pad] 1.0 at rows the smoother updates
    dirichlet_mask: torch.Tensor  # [n_pad]
    neumann_mask: torch.Tensor  # [n_pad]
    dirichlet_values: torch.Tensor  # [n_pad] g at Dirichlet rows else 0
    neumann_values: torch.Tensor  # [n_pad] g at Neumann rows else 0
    row_map: torch.Tensor  # [n] int32: logical -> permuted row
    has_lagrange: bool
    implicit: bool
    omega: float
    iters: int
    class_size: int
    n: int

    @property
    def n_pad(self) -> int:
        return self.A.nrows_pad

    def to_padded(self, v_logical: torch.Tensor) -> torch.Tensor:
        """Scatter a logical [n] vector into permuted padded space."""
        out = v_logical.new_zeros(self.n_pad)
        out[self.row_map.long().to(v_logical.device)] = v_logical
        return out

    def to_logical(self, v_padded: torch.Tensor) -> torch.Tensor:
        """Gather a permuted padded vector back to logical [n] order."""
        return v_padded[self.row_map.long().to(v_padded.device)]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _empty_compact(ncols: int, block_rows: int) -> CompactRows:
    ell = ell_from_csr(sp.csr_matrix((block_rows, ncols)), block_rows=block_rows)
    rows = torch.full((block_rows,), min(ncols + 1, 2**31 - 1), dtype=torch.int32)
    return CompactRows(rows=rows, ell=ell, nrows=0)


def _compact_from_rows(
    mat: sp.csr_matrix, row_idx: np.ndarray, block_rows: int
) -> CompactRows:
    """Pack rows ``row_idx`` of ``mat``; ``ell.diag`` = A[r, r] at those rows."""
    if row_idx.size == 0:
        return _empty_compact(mat.shape[1], block_rows)
    sub = mat[row_idx]
    ell = ell_from_csr(sub, block_rows=block_rows, ncols=mat.shape[1])
    m_pad = ell.nrows_pad
    sentinel = min(mat.shape[1] + 1, 2**31 - 1)
    rows = np.full(m_pad, sentinel, dtype=np.int64)
    rows[: row_idx.size] = row_idx
    dvec = np.ones(m_pad, dtype=mat.dtype)
    d_all = mat.diagonal()
    dvec[: row_idx.size] = np.where(d_all[row_idx] != 0.0, d_all[row_idx], 1.0)
    ell = dataclasses.replace(ell, diag=torch.from_numpy(dvec))
    return CompactRows(
        rows=torch.from_numpy(rows.astype(np.int32)), ell=ell, nrows=int(row_idx.size)
    )


def bc_flags_from_cloud(cloud: PointCloud, bc_types: list[str]) -> np.ndarray:
    """Per-point flags: 0 interior, 1 Dirichlet, 2 Neumann (grid.cpp:33-40)."""
    flags = np.zeros(cloud.n, dtype=np.int32)
    for bidx, t in zip(cloud.boundaries, bc_types):
        if t not in ("dirichlet", "neumann"):
            raise ValueError(f"bc type {t!r}")
        flags[bidx] = 1 if t == "dirichlet" else 2
    return flags


def assemble_operator_csr(
    cloud: PointCloud,
    bc_flags: np.ndarray,
    config: GridConfig,
    device=None,
    op: str = "laplace",
    neumann_rows: bool = True,
) -> sp.csr_matrix:
    """Raw RBF-FD operator CSR in logical point order; weights solved on
    ``device``.

    ``op="laplace"`` with ``neumann_rows=True`` gives the reference
    build_laplacian rows (n.grad rows at Neumann points, grid.cpp:520-565);
    with ``neumann_rows=False`` the plain velocity Laplacian
    (build_uv_laplace_mat, fractionalStepGrid.cpp:87-100).  ``"dx"`` /
    ``"dy"`` give the derivative operators (build_derivX_mat /
    build_derivY_mat).
    """
    pts = cloud.points
    n = cloud.n
    has_neumann = bool((bc_flags == 2).any())
    k = config.stencil_size
    neighbors = knn(pts, k, boundary_mask=bc_flags != 0, neumann=has_neumann)

    def weights(nbr, ev, which):
        return batched_weights(
            pts, nbr, ev, op=which, poly_deg=config.poly_deg,
            rbf_exp=config.rbf_exp, device=device,
        ).cpu().numpy()

    w = weights(neighbors, pts, op)
    if has_neumann and neumann_rows and op == "laplace":
        bidx = np.nonzero(bc_flags == 2)[0]
        nbb, pb = neighbors[bidx], pts[bidx]
        w[bidx] = (cloud.normals[bidx, 0:1] * weights(nbb, pb, "dx")
                   + cloud.normals[bidx, 1:2] * weights(nbb, pb, "dy"))
        if pts.shape[1] == 3:  # 3D extension: z-component of n.grad
            w[bidx] += cloud.normals[bidx, 2:3] * weights(nbb, pb, "dz")

    rows = np.repeat(np.arange(n), k)
    A = sp.coo_matrix(
        (w.ravel(), (rows, neighbors.ravel().astype(np.int64))), shape=(n, n)
    ).tocsr()
    A.sum_duplicates()
    return A


def build_level_operator(
    cloud: PointCloud,
    bc_flags: np.ndarray,
    bc_values: np.ndarray,
    config: GridConfig,
    block_rows: int = 256,
    class_size: int = 8,
    device=None,
) -> LevelOperator:
    """Assemble the full level operator for an ordered cloud.

    ``bc_values``: dense [N] boundary data g, zero at interior points.
    Neumann boundaries are condensed implicitly, as the reference always
    does on its Neumann paths (testing_functions.cpp:268).
    """
    n = cloud.n
    has_neumann = bool((bc_flags == 2).any())
    implicit = has_neumann

    A = assemble_operator_csr(cloud, bc_flags, config, device=device)
    cond_csr = None
    if has_neumann:
        A, cond_csr = _condense_neumann(A, bc_flags)

    # --- pad to a block multiple and apply the (block, class) permutation ---
    n_pad = _round_up(n, block_rows)
    A_pad = sp.block_diag(
        [A, sp.identity(n_pad - n, format="csr")], format="csr"
    ) if n_pad > n else A
    perm, conflicts = block_class_permutation(A_pad, block_rows, class_size)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_pad)
    row_map = inv[:n]

    A_p = A_pad[perm][:, perm].tocsr()
    A_p.sum_duplicates()
    ell = ell_from_csr(A_p, block_rows=block_rows)
    assert ell.nrows_pad == n_pad

    # --- damp residual coloring conflicts -----------------------------------
    # Rows sharing a (block, class) with a coupled neighbor see a stale value
    # during the simultaneous class update (Jacobi, not GS, on those pairs);
    # pull them back to omega=1.0 via the per-row omega_scale.
    omega_scale = np.ones(n_pad)
    if conflicts:
        coo = A_p.tocoo()
        blk_r, blk_c = coo.row // block_rows, coo.col // block_rows
        cls_r = (coo.row % block_rows) // class_size
        cls_c = (coo.col % block_rows) // class_size
        pair = (coo.row != coo.col) & (blk_r == blk_c) & (cls_r == cls_c)
        conflicted = np.unique(np.r_[coo.row[pair], coo.col[pair]])
        omega_scale[conflicted] = min(1.0, 1.0 / float(config.omega))
        warnings.warn(
            f"in-block coloring left {conflicts} conflicting pairs; "
            f"{conflicted.size} rows damped to omega=1.0 (stale-read "
            "updates stay contractive; exact GS elsewhere)"
        )

    def padded(v, dtype=np.float64):
        out = np.zeros(n_pad, dtype=dtype)
        out[row_map] = v
        return torch.from_numpy(out)

    bound = _compact_from_rows(A_p, row_map[bc_flags == 2], block_rows)
    if cond_csr is not None:
        cpad = sp.bmat(
            [[cond_csr, None], [None, sp.csr_matrix((n_pad - n, n_pad - n))]],
            format="csr",
        ) if n_pad > n else cond_csr
        cond_p = cpad[perm][:, perm].tocsr()
        crows = np.nonzero(np.diff(cond_p.indptr) > 0)[0]
        cond = _compact_from_rows(cond_p, crows, block_rows)
    else:
        cond = _empty_compact(n_pad, block_rows)

    lag = float(has_neumann)
    return LevelOperator(
        A=ell,
        bound=bound,
        cond=cond,
        lag_col=padded((bc_flags != 2) * lag),
        lag_row=padded((bc_flags != 2) * lag),
        omega_scale=torch.from_numpy(omega_scale),
        smooth_mask=padded(bc_flags == 0),
        dirichlet_mask=padded(bc_flags == 1),
        neumann_mask=padded(bc_flags == 2),
        dirichlet_values=padded(np.where(bc_flags == 1, bc_values, 0.0)),
        neumann_values=padded(np.where(bc_flags == 2, bc_values, 0.0)),
        row_map=torch.from_numpy(row_map.astype(np.int32)),
        has_lagrange=has_neumann,
        implicit=bool(implicit),
        omega=float(config.omega),
        iters=int(config.iters),
        class_size=int(class_size),
        n=n,
    )


def _condense_neumann(
    A: sp.csr_matrix, bc_flags: np.ndarray, diag_guard: float = 0.25
) -> tuple[sp.csr_matrix, sp.csr_matrix]:
    """Implicit static condensation of Neumann unknowns (grid.cpp:598-662).

    A' = A - S Bs with Bs = D^{-1} B; returns (A', C = S D^{-1}).  Rows whose
    condensed diagonal collapses (or whose dominance ratio degrades badly)
    revert to their un-condensed form and are dropped from C.
    """
    n = A.shape[0]
    interior = bc_flags == 0
    nmn = bc_flags == 2

    D = A.diagonal()
    if bool((nmn & (D == 0)).any()):
        raise ValueError(
            f"{int((nmn & (D == 0)).sum())} Neumann boundary rows have a "
            "zero diagonal (n.grad self-weight) — the boundary row-solve "
            "(grid.cpp:92-97) and condensation both divide by it; check "
            "the cloud's normals"
        )
    d_b = np.where(nmn, D, 1.0)

    S = A.multiply(interior[:, None]).multiply(nmn[None, :]).tocsr()
    C = S.multiply(1.0 / d_b[None, :]).tocsr()
    Bs = A.multiply(nmn[:, None]).multiply(1.0 / d_b[:, None]).tocsr()

    A2 = (A - (S @ Bs)).tocsr()
    A2.sum_duplicates()

    def row_ratio(M):
        d = M.diagonal()
        offsum = np.abs(M).sum(axis=1).A1 - np.abs(d)
        return offsum / np.maximum(np.abs(d), 1e-300)

    r1, r2 = row_ratio(A), row_ratio(A2)
    bad = interior & (
        (np.abs(A2.diagonal()) < diag_guard * np.abs(D))
        | (r2 > np.maximum(3.0 * r1, 10.0))
    )
    if bad.any():
        keep = ~bad
        A2 = A2.multiply(keep[:, None]).tocsr() + A.multiply(bad[:, None]).tocsr()
        A2 = A2.tocsr()
        A2.sum_duplicates()
        C = C.multiply(keep[:, None]).tocsr()
        C.eliminate_zeros()
        interior = interior & keep  # only condensed rows get cols zeroed

    mask_bad = interior[np.repeat(np.arange(n), np.diff(A2.indptr))] & nmn[A2.indices]
    A2.data[mask_bad] = 0.0
    A2.eliminate_zeros()
    return A2, C


def build_interp_operator(
    base_cloud_points: np.ndarray,
    target_points: np.ndarray,
    poly_deg: int,
    rbf_exp: int = 3,
    block_rows: int = 256,
    row_map_target: np.ndarray | None = None,
    row_map_base: np.ndarray | None = None,
    n_pad_target: int | None = None,
    n_pad_base: int | None = None,
    device=None,
) -> EllMatrix:
    """RBF interpolation matrix [n_target(_pad), n_base(_pad)].

    Row i holds base-grid interpolation weights at target point i
    (Multigrid::buildInterpMatrix, multigrid.cpp:17-33).  If row maps are
    given, rows and columns are placed in the levels' permuted padded spaces.
    """
    # dim-aware stencil size: 3D deg-3 monomials have 20 terms, so the 2D
    # k=25 stencil is barely unisolvent; 3D needs k = 2.5 * 20 = 50 here
    cfg = GridConfig(poly_deg=poly_deg, rbf_exp=rbf_exp,
                     dim=int(base_cloud_points.shape[1]))
    k = cfg.stencil_size
    nb = knn_queries(base_cloud_points, target_points, k)
    w = batched_weights(
        base_cloud_points, nb, target_points, op="interp",
        poly_deg=poly_deg, rbf_exp=rbf_exp, device=device,
    ).cpu().numpy()
    bad = ~np.isfinite(w).all(axis=1)
    if bad.any():
        # degenerate neighborhood (singular saddle): nearest-point injection
        # for those rows rather than NaN weights in every V-cycle
        warnings.warn(f"interp weights non-finite for {int(bad.sum())} "
                      f"target points; using nearest-point injection there")
        w[bad] = 0.0
        w[bad, 0] = 1.0
    m = target_points.shape[0]
    nbase = base_cloud_points.shape[0]
    rows = np.repeat(np.arange(m), k)
    cols = nb.ravel().astype(np.int64)
    if row_map_target is not None:
        rows = np.asarray(row_map_target)[rows]
        m = n_pad_target
    if row_map_base is not None:
        cols = np.asarray(row_map_base)[cols]
        nbase = n_pad_base
    mat = sp.coo_matrix((w.ravel(), (rows, cols)), shape=(m, nbase)).tocsr()
    return ell_from_csr(mat, block_rows=block_rows)
