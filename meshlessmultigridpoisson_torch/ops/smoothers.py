"""Relaxation sweeps and residuals (backend-dispatching solver protocol).

Port of the reference package's ``ops/smoothers.py``: the smoother is exact
Gauss-Seidel under the (block, class, slot) row permutation prepared at
setup, with the Lagrange row relaxed after the point rows and the Neumann
boundary rows re-solved after every sweep (grid.cpp:104-146).

The solve-path functions dispatch: ``LevelOperator`` (host, f64) -> the
plain path below, the semantics oracle used by setup-time stabilization and the tests;
``GpuLevel`` -> ``mg.gpu_backend``, which runs the CUDA kernels (and their
plain versions only for tensors on the CPU).

The Lagrange rank-1 border (grid.cpp:566-576) appears as:
  row i (non-Neumann):  ... + x_lag
  row N (border):       sum_{j non-Neumann} x_j + x_lag = b_lag
"""

from __future__ import annotations

import numpy as np
import torch

from meshlessmultigridpoisson_torch.ops.ell import global_cols, spmv
from meshlessmultigridpoisson_torch.stencil.operators import LevelOperator


def _gpu(op):
    """The GPU backend module if ``op`` is a GpuLevel, else None."""
    if isinstance(op, LevelOperator):
        return None
    from meshlessmultigridpoisson_torch.mg import gpu_backend

    return gpu_backend


def _zero(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros(())


def matvec(op, x: torch.Tensor, x_lag):
    """Full bordered matvec: (A x + lag_col*x_lag, lag_row.x + x_lag)."""
    be = _gpu(op)
    if be is not None:
        return be.matvec(op, x, x_lag)
    y = spmv(op.A, x)
    if op.has_lagrange:
        y = y + op.lag_col * x_lag
        y_lag = torch.dot(op.lag_row, x) + x_lag
    else:
        y_lag = _zero(x)
    return y, y_lag


def bound_eval_neumann(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exactly solve each Neumann boundary row for its own unknown.

    x_b = (b_b - sum_{j != b} A_bj x_j) / A_bb  (grid.cpp:73-103).
    """
    be = _gpu(op)
    if be is not None:
        return be.bound_eval_neumann(op, x, b)
    if op.bound.nrows == 0:
        return x
    c = op.bound
    y = spmv(c.ell, x)  # includes the diagonal term
    rows = c.rows.long()
    safe = rows.clamp(max=op.n_pad - 1)
    xb = (b[safe] - (y - c.ell.diag * x[safe])) / c.ell.diag
    keep = rows < op.n_pad  # padding slots point past the end: dropped
    x = x.clone()
    x[rows[keep]] = xb[keep]
    return x


def _gs_sweep(op: LevelOperator, x: torch.Tensor, x_lag, b: torch.Tensor):
    """One exact SOR sweep in (block, class) order — the plain f64 path.

    Rows were permuted at setup so that each [class_size]-row tile is an
    in-block independent set; updating tiles in storage order with fresh x
    is exact Gauss-Seidel under that ordering.  The tile loop runs on numpy
    views of the host tensors (a per-tile torch dispatch costs several times
    more at 150k rows, and this sweep runs at setup, 20 times per
    stabilization round).
    """
    S = op.class_size
    ntiles = op.n_pad // S
    width = op.A.width
    vals_t = op.A.vals.numpy().reshape(ntiles, S, width)
    gcols_t = global_cols(op.A).numpy().reshape(ntiles, S, width)
    diag_t = op.A.diag.numpy().reshape(ntiles, S)
    b_t = b.numpy().reshape(ntiles, S)
    m_t = op.smooth_mask.numpy().reshape(ntiles, S) > 0
    w_t = (op.omega * op.omega_scale).numpy().reshape(ntiles, S)
    lagx_t = (op.lag_col * float(x_lag)).numpy().reshape(ntiles, S)
    xn = x.numpy().copy()
    for t in range(ntiles):
        s = t * S
        xt = xn[s:s + S]
        y = np.einsum("ij,ij->i", vals_t[t], xn[gcols_t[t]]) + lagx_t[t]
        w, d = w_t[t], diag_t[t]
        xi = (1.0 - w) * xt + (w / d) * (b_t[t] - (y - d * xt))
        xn[s:s + S] = np.where(m_t[t], xi, xt)
    return torch.from_numpy(xn)


def smooth(op, x: torch.Tensor, x_lag, b: torch.Tensor, b_lag, iters: int | None = None):
    """``iters`` SOR sweeps (reference sor(), grid.cpp:104-146).

    Each sweep: exact (block, class)-ordered SOR over the interior mask ->
    Lagrange-row relax -> Neumann boundary row solve (grid.cpp:144).
    """
    be = _gpu(op)
    if be is not None:
        return be.smooth(op, x, x_lag, b, b_lag, iters)
    iters = op.iters if iters is None else iters
    w = op.omega
    for _ in range(iters):
        x = _gs_sweep(op, x, x_lag, b)
        if op.has_lagrange:
            # border row: A_NN = 1 (grid.cpp:573)
            x_lag = (1.0 - w) * x_lag + w * (b_lag - torch.dot(op.lag_row, x))
        x = bound_eval_neumann(op, x, b)
    return x, x_lag


def residual(op, x, x_lag, b, b_lag):
    """r = b - A_full x, zeroed at Dirichlet rows (grid.cpp:147-151,197-205)."""
    y, y_lag = matvec(op, x, x_lag)
    r = torch.where(op.dirichlet_mask > 0, torch.zeros_like(b), b - y)
    r_lag = (b_lag - y_lag) if op.has_lagrange else _zero(x)
    return r, r_lag


def relative_residual_l1(op, x, x_lag, b, b_lag):
    """||r||_1 / ||b||_1 over the full bordered system (multigrid.cpp:112-115)."""
    r, r_lag = residual(op, x, x_lag, b, b_lag)
    num = r.abs().sum() + torch.as_tensor(r_lag).abs()
    den = b.abs().sum() + torch.as_tensor(b_lag).abs()
    return num / den


def push_inhomog_to_rhs(op, b: torch.Tensor) -> torch.Tensor:
    """b_i -= sum_j C_ij b_j for interior rows (grid.cpp:664-685)."""
    be = _gpu(op)
    if be is not None:
        return be.push_inhomog_to_rhs(op, b)
    if op.cond.nrows == 0:
        return b
    c = op.cond
    delta = spmv(c.ell, b)
    rows = c.rows.long()
    keep = rows < op.n_pad
    out = b.clone()
    out[rows[keep]] = b[rows[keep]] - delta[keep]
    return out


def apply_dirichlet(op, x: torch.Tensor, coarse: bool) -> torch.Tensor:
    """boundaryOp: pin Dirichlet values to g (fine) or 0 (coarse) (grid.cpp:42-51)."""
    val = torch.zeros_like(x) if coarse else op.dirichlet_values
    return torch.where(op.dirichlet_mask > 0, val, x)


def set_neumann_source(op, b: torch.Tensor, coarse: bool):
    """modify_coeff_neumann: b at Neumann rows := g (fine) or 0 (coarse)."""
    val = torch.zeros_like(b) if coarse else op.neumann_values
    return torch.where(op.neumann_mask > 0, val, b)


def zero_dirichlet(op, v: torch.Tensor) -> torch.Tensor:
    """fix_vector_bound_coarse (grid.cpp:197-205)."""
    return torch.where(op.dirichlet_mask > 0, torch.zeros_like(v), v)
