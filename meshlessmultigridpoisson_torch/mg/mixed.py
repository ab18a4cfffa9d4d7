"""Mixed-precision solves: f64 defect correction over f32 kernels.

Port of the reference package's ``mg/mixed.py``:

    outer (f64):  r = b - A x          [exact residual, f64 ell_spmv kernel]
    inner (f32):  solve A e ~= r       [V-cycle-preconditioned BiCGStab]
    x <- x + e, repeat until ||r||_1 / ||b||_1 < tol

Two forms, both host loops here (PyTorch runs eagerly):

* ``solve_mixed`` — the reference's fused single-graph form: it stops at
  tol, at ``max_outer``, or when a pass fails to cut the residual below
  0.7x the previous one; no rollback, no escalation.  The fractional-step
  PPE uses it (models/fracstep_gpu.py).
* ``solve_mixed_stepped`` — the host-stepped form of the Poisson solve: on
  a stagnating pass the inner solve is escalated (inner_tol / 10,
  inner_iters x 2, up to ``max_escalations`` times) and a pass that made
  the residual worse is rolled back.

``solve_mixed``'s ``matvec64`` / ``matvec32`` optionally replace the outer /
inner fine operator (``(x, x_lag) -> (y, y_lag)``), as the matrix-free
compatible PPE does.  Both forms end with the f64 Neumann boundary-row
re-solve.
"""

from __future__ import annotations

import torch

from meshlessmultigridpoisson_torch.mg.krylov import (
    full_matvec,
    homogeneous_hierarchy,
    solve_bicgstab,
)
from meshlessmultigridpoisson_torch.mg.vcycle import Hierarchy, init_like
from meshlessmultigridpoisson_torch.ops import smoothers as sm


def defect_hierarchy(hier32: Hierarchy) -> Hierarchy:
    """Inner hierarchy for defect solves: fine Dirichlet pin values zeroed
    (the error at pinned rows is 0, not g)."""
    return homogeneous_hierarchy(hier32)


def _residual64(op64, x, xl, b, bl, matvec64=None):
    """b - A_full x with Dirichlet identity rows (f64)."""
    if matvec64 is None:
        y, yl = full_matvec(op64, x, xl)
    else:
        y, yl = matvec64(x, xl)
        y = torch.where(op64.dirichlet_mask > 0, x, y)
        if not op64.has_lagrange:
            yl = xl
    return b - y, bl - yl


def _l1(r, rl) -> float:
    return float(r.abs().sum() + rl.abs())


def _prepare(op64, x0, xl0, b, bl):
    """f64 right-hand side with Dirichlet rows set to g, its L1 norm, and
    the initial guess with the Dirichlet rows pinned.  The inner defect
    solve holds them at 0, so from an unpinned guess (the reference starts
    from x0 = 0) the first pass misses the boundary coupling A_ID g: with
    non-zero Dirichlet data (square_with_circle's hole) the pass makes the
    residual worse."""
    b = b.to(torch.float64)
    bl = torch.as_tensor(bl, dtype=torch.float64, device=b.device)
    b = torch.where(op64.dirichlet_mask > 0, op64.dirichlet_values, b)
    x = torch.where(op64.dirichlet_mask > 0, op64.dirichlet_values,
                    x0.to(torch.float64))
    xl = torch.as_tensor(xl0, dtype=torch.float64, device=b.device)
    return b, bl, _l1(b, bl) or 1.0, x, xl


def _inner(hier32_defect, r, rl, inner_tol, inner_iters, matvec32=None):
    """f32 defect solve A e ~= r, normalised for f32 dynamic range; returns
    the f64 correction (e, e_lag), the BiCGStab iterations and its final
    relative residual."""
    fine_i = len(hier32_defect.levels) - 1
    inner_dt = hier32_defect.levels[fine_i].smooth_mask.dtype
    rn = _l1(r, rl) or 1.0
    st = init_like(hier32_defect)
    st = st.replace_level(
        fine_i, b=(r / rn).to(inner_dt), b_lag=(rl / rn).to(inner_dt))
    st, its, resid = solve_bicgstab(
        hier32_defect, st, tol=inner_tol, max_iters=inner_iters,
        matvec=matvec32)
    return (st.x[fine_i].to(torch.float64) * rn,
            st.x_lag[fine_i].to(torch.float64) * rn, its, resid)


def solve_mixed(
    op64,
    hier32_defect: Hierarchy,
    x0,
    xl0,
    b,
    bl,
    tol=1e-10,
    inner_tol=1e-5,
    inner_iters: int = 60,
    max_outer: int = 20,
    matvec64=None,
    matvec32=None,
    passes: list | None = None,
):
    """Defect-corrected solve of the bordered fine system to f64 tolerance,
    with the reference's fused stopping rule (stop at tol, at ``max_outer``
    or when a pass leaves res >= 0.7 res_prev; every pass is kept).

    ``passes``, when given, receives one (inner BiCGStab iterations, inner
    relative residual, outer relative residual after the pass) per pass.
    Returns (x64, xl64, outer_iters, rel_residual).
    """
    b, bl, bnorm, x, xl = _prepare(op64, x0, xl0, b, bl)
    r, rl = _residual64(op64, x, xl, b, bl, matvec64)
    res, res_prev, it = _l1(r, rl) / bnorm, float("inf"), 0
    while res >= tol and it < max_outer and res < 0.7 * res_prev:
        e, el, its, inner_res = _inner(hier32_defect, r, rl, inner_tol,
                                       inner_iters, matvec32)
        x = torch.where(op64.dirichlet_mask > 0, op64.dirichlet_values, x + e)
        xl = xl + el
        r, rl = _residual64(op64, x, xl, b, bl, matvec64)
        res_prev, res = res, _l1(r, rl) / bnorm
        it += 1
        if passes is not None:
            passes.append((its, inner_res, res))
    x = sm.bound_eval_neumann(op64, x, b)
    return x, xl, it, res


def solve_mixed_stepped(
    op64,
    hier32_defect: Hierarchy,
    x0,
    xl0,
    b,
    bl,
    tol=1e-10,
    inner_tol=1e-5,
    inner_iters: int = 60,
    max_outer: int = 20,
    log=None,
    stall: float = 0.7,
    max_escalations: int = 2,
):
    """Defect-corrected solve of the bordered fine system to f64 tolerance.

    op64: f64 fine operator (a matvec-only GpuLevel on the device, or a
    host LevelOperator).  hier32_defect: ``defect_hierarchy(gpu_hierarchy(
    ...))``.  Returns (x64, xl64, outer_iters, rel_residual).
    """
    b, bl, bnorm, x, xl = _prepare(op64, x0, xl0, b, bl)
    r, rl = _residual64(op64, x, xl, b, bl)
    res = _l1(r, rl) / bnorm
    it, escalations = 0, 0
    while res >= tol and it < max_outer:
        e, el, _, _ = _inner(hier32_defect, r, rl, inner_tol, inner_iters)
        x_new = torch.where(op64.dirichlet_mask > 0, op64.dirichlet_values, x + e)
        xl_new = xl + el
        r_new, rl_new = _residual64(op64, x_new, xl_new, b, bl)
        res_new = _l1(r_new, rl_new) / bnorm
        it += 1
        accepted = res_new < res
        if accepted:  # accept any improvement
            x, xl, r, rl = x_new, xl_new, r_new, rl_new
            res_prev, res = res, res_new
        else:
            res_prev = res  # reject the worsening update, keep (x, r)
        if log is not None:
            log(f"outer {it}: rel residual {res:.3e}"
                + ("" if accepted else "  (pass rejected)"))
        if res >= tol and res >= stall * res_prev:
            if escalations >= max_escalations:
                break
            escalations += 1
            inner_tol, inner_iters = inner_tol / 10.0, inner_iters * 2
            if log is not None:
                log(f"stagnating at {res:.3e}: escalating inner solve to "
                    f"tol={inner_tol:.0e}, iters={inner_iters}")
    x = sm.bound_eval_neumann(op64, x, b)
    return x, xl, it, res
