"""Mixed-precision solves: f64 defect correction over f32 kernels.

Port of the reference package's ``mg/mixed.py`` (the host-stepped form):

    outer (f64):  r = b - A x          [exact residual, f64 ell_spmv kernel]
    inner (f32):  solve A e ~= r       [V-cycle-preconditioned BiCGStab]
    x <- x + e, repeat until ||r||_1 / ||b||_1 < tol

On a stagnating pass the inner solve is escalated (inner_tol / 10,
inner_iters x 2, up to ``max_escalations`` times) and a pass that made the
residual worse is rolled back.  The fused single-graph ``solve_mixed`` of
the reference is not ported.
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


def _residual64(op64, x, xl, b, bl):
    """b - A_full x with Dirichlet identity rows (f64)."""
    y, yl = full_matvec(op64, x, xl)
    return b - y, bl - yl


def _l1(r, rl) -> float:
    return float(r.abs().sum() + rl.abs())


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
    fine_i = len(hier32_defect.levels) - 1
    inner_dt = hier32_defect.levels[fine_i].smooth_mask.dtype
    b = b.to(torch.float64)
    bl = torch.as_tensor(bl, dtype=torch.float64, device=b.device)
    b = torch.where(op64.dirichlet_mask > 0, op64.dirichlet_values, b)
    bnorm = _l1(b, bl) or 1.0

    # Pin the Dirichlet rows before the first residual.  The inner defect
    # solve holds them at 0, so from an unpinned guess (the reference
    # starts from x0 = 0) the first pass misses the boundary coupling
    # A_ID g: with non-zero Dirichlet data (square_with_circle's hole) the
    # pass makes the residual worse, is rejected, and the loop never moves.
    x = torch.where(op64.dirichlet_mask > 0, op64.dirichlet_values,
                    x0.to(torch.float64))
    xl = torch.as_tensor(xl0, dtype=torch.float64, device=b.device)
    r, rl = _residual64(op64, x, xl, b, bl)
    res = _l1(r, rl) / bnorm
    it, escalations = 0, 0
    while res >= tol and it < max_outer:
        rn = _l1(r, rl) or 1.0
        st = init_like(hier32_defect)
        st = st.replace_level(
            fine_i, b=(r / rn).to(inner_dt), b_lag=(rl / rn).to(inner_dt))
        st, _, _ = solve_bicgstab(
            hier32_defect, st, tol=inner_tol, max_iters=inner_iters)
        x_new = x + st.x[fine_i].to(torch.float64) * rn
        xl_new = xl + st.x_lag[fine_i].to(torch.float64) * rn
        x_new = torch.where(op64.dirichlet_mask > 0, op64.dirichlet_values, x_new)
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
