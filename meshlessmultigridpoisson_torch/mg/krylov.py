"""Krylov-accelerated multigrid: V-cycle-preconditioned BiCGStab.

Port of the reference package's ``mg/krylov.py``.  System solved: the full
bordered fine-level system in defect form,
  rows:    Dirichlet -> identity;  others -> A x + lag_col * x_lag
  border:  lag_row . x + x_lag
with the preconditioner = one V-cycle from a zero guess on homogeneous
boundary data (linear by construction).  The ``lax.while_loop`` becomes a
Python loop that reads the residual on the host once per iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from meshlessmultigridpoisson_torch.mg.vcycle import Hierarchy, MGState, v_cycle
from meshlessmultigridpoisson_torch.ops import smoothers as sm


def homogeneous_hierarchy(hier: Hierarchy) -> Hierarchy:
    """Zero the fine Dirichlet pin values so the V-cycle is a linear map."""
    fine = hier.levels[-1]
    fine0 = dataclasses.replace(
        fine, dirichlet_values=torch.zeros_like(fine.dirichlet_values)
    )
    return Hierarchy(
        levels=hier.levels[:-1] + (fine0,),
        restrict=hier.restrict,
        prolong=hier.prolong,
    )


def full_matvec(op, x, x_lag):
    """Bordered matvec with Dirichlet identity rows."""
    y, y_lag = sm.matvec(op, x, x_lag)
    y = torch.where(op.dirichlet_mask > 0, x, y)
    if not op.has_lagrange:
        y_lag = x_lag  # keep the extra slot trivially consistent
    return y, y_lag


def _dot(u, v):
    return (u * v).sum()  # an elementwise product and a sum: no cuBLAS call


def _precond(hier0: Hierarchy, v, v_lag):
    """z ~ A^-1 v via one V-cycle from zero (linear in v)."""
    fine_i = len(hier0.levels) - 1
    z = [torch.zeros(op.n_pad, dtype=v.dtype, device=v.device) for op in hier0.levels]
    zl = [v.new_zeros(()) for _ in hier0.levels]
    state = MGState(
        x=tuple(z),
        x_lag=tuple(zl),
        b=tuple(v if i == fine_i else z[i] for i in range(len(z))),
        b_lag=tuple(v_lag if i == fine_i else zl[i] for i in range(len(z))),
    )
    state, _ = v_cycle(hier0, state, residual=False)
    op = hier0.levels[fine_i]
    x = sm.bound_eval_neumann(op, state.x[fine_i], state.b[fine_i])
    return x, state.x_lag[fine_i]


def solve_bicgstab(
    hier: Hierarchy,
    state: MGState,
    tol,
    max_iters: int = 100,
    matvec=None,
):
    """Preconditioned BiCGStab on the bordered fine system.

    Starts from ``state`` (x as initial guess, b as RHS); returns
    (state with solution, iterations, relative residual).  The tolerance is
    on ||r||_1 / ||b||_1 like the reference (multigrid.cpp:112-115).  On a
    breakdown the previous iterate is kept and the residual reported as the
    sentinel -1.

    ``matvec(x, x_lag) -> (y, y_lag)`` optionally replaces the fine-level
    operator in the OUTER Krylov system while ``hier`` stays the
    preconditioner: the matrix-free compatible PPE (models/fracstep.py)
    solves div o grad with a standard-Laplacian V-cycle preconditioner.
    """
    hier0 = homogeneous_hierarchy(hier)
    fine_i = len(hier.levels) - 1
    op = hier.levels[fine_i]
    b = state.b[fine_i]
    b_lag = state.b_lag[fine_i]
    # Dirichlet rows: equation x_d = g
    b = torch.where(op.dirichlet_mask > 0, op.dirichlet_values, b)
    bnorm = b.abs().sum() + b_lag.abs()

    def mv(p, pl):
        if matvec is not None:
            return matvec(p, pl)
        return full_matvec(op, p, pl)

    def dot(u, ul, v, vl):
        return _dot(u, v) + ul * vl

    def l1(u, ul):
        return u.abs().sum() + ul.abs()

    x, xl = state.x[fine_i], state.x_lag[fine_i]
    ax, axl = mv(x, xl)
    r, rl = b - ax, b_lag - axl
    rhat, rhatl = r, rl
    p, pl = r, rl
    rho = dot(rhat, rhatl, r, rl)
    resid = float(l1(r, rl) / bnorm)
    it = 0
    tiny = 1e-300
    while resid >= tol and it < max_iters:
        phat, phatl = _precond(hier0, p, pl)
        v, vl = mv(phat, phatl)
        rv = dot(rhat, rhatl, v, vl)
        alpha = rho / torch.where(rv == 0, torch.full_like(rv, tiny), rv)
        s, sl = r - alpha * v, rl - alpha * vl
        shat, shatl = _precond(hier0, s, sl)
        t, tl = mv(shat, shatl)
        tt = dot(t, tl, t, tl)
        omega = dot(t, tl, s, sl) / torch.where(tt == 0, torch.full_like(tt, tiny), tt)
        x2 = x + alpha * phat + omega * shat
        xl2 = xl + alpha * phatl + omega * shatl
        r2, r2l = s - omega * t, sl - omega * tl
        rho2 = dot(rhat, rhatl, r2, r2l)
        beta = (rho2 / torch.where(rho == 0, torch.full_like(rho, tiny), rho)) * (
            alpha / torch.where(omega == 0, torch.full_like(omega, tiny), omega)
        )
        p2, p2l = r2 + beta * (p - omega * v), r2l + beta * (pl - omega * vl)
        resid2 = l1(r2, r2l) / bnorm
        it += 1
        # breakdown (rho/omega underflow, common from a near-converged
        # guess): keep the previous iterate, report the -1 sentinel, stop
        ok = bool(torch.isfinite(resid2) & torch.isfinite(rho2)
                  & torch.isfinite(p2.abs().sum()))
        if not ok:
            resid = -1.0
            break
        x, xl, r, rl, p, pl, rho = x2, xl2, r2, r2l, p2, p2l, rho2
        resid = float(resid2)
    x = torch.where(op.dirichlet_mask > 0, op.dirichlet_values, x)
    x = sm.bound_eval_neumann(op, x, state.b[fine_i])
    return state.replace_level(fine_i, x=x, x_lag=xl), it, resid


def bicgstab_matfree(matvec, b, x0, tol, max_iters: int = 100):
    """Plain (unpreconditioned) BiCGStab for well-conditioned systems
    (the implicit-diffusion predictor's I - dt nu Lap).  Tolerance on the
    relative 2-norm; on a breakdown the previous iterate is kept and the
    residual reported as the sentinel -1.  Returns (x, iterations, resid).
    """
    tiny = 1e-300

    def safe(v):
        return torch.where(v == 0, torch.full_like(v, tiny), v)

    bnorm = float(_dot(b, b).sqrt()) or 1.0
    x = x0
    r = b - matvec(x0)
    rhat, p = r, r
    rho = _dot(rhat, r)
    resid = float(_dot(r, r).sqrt()) / bnorm
    it = 0
    while resid >= tol and it < max_iters:
        v = matvec(p)
        alpha = rho / safe(_dot(rhat, v))
        s = r - alpha * v
        t = matvec(s)
        om = _dot(t, s) / safe(_dot(t, t))
        x2 = x + alpha * p + om * s
        r2 = s - om * t
        rho2 = _dot(rhat, r2)
        beta = (rho2 / safe(rho)) * (alpha / safe(om))
        p2 = r2 + beta * (p - om * v)
        resid2 = float(_dot(r2, r2).sqrt()) / bnorm
        it += 1
        if resid2 != resid2 or resid2 == float("inf"):
            resid = -1.0
            break
        x, r, p, rho, resid = x2, r2, p2, rho2, resid2
    return x, it, resid
