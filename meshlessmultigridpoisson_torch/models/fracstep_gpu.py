"""Fractional-step Navier-Stokes on the GPU: f32 CUDA kernels + f64 PPE.

Counterpart of the reference package's ``models/fracstep_tpu.py``, the
device path of the reference program's default run (run_frac_step_test,
FractionalStepSim.cpp:201-204).  Precision split, as in the reference:

* predictor / corrector / PPE source: f32 ``ell_spmv`` on the derivative
  operators (role ``spmv6``: they are ``spmv_tpu6`` operands there), cast
  to f64 where the reference casts — ``b = rho/dt * div`` is formed in f64
  from the f32 divergence, and rho/dt = 5000 amplifies every f32 rounding,
  so the casts are kept exactly;
* the PPE solve to the reference's 1e-10 relative-L1 bar runs through
  ``mg/mixed.solve_mixed``: exact f64 outer residuals on the matrix-free
  compatible div o grad operator (``_mv64``: f64 ``ell_spmv`` plus the f64
  ``ppe_tail``) with the f32 GpuLevel hierarchy + the f32 compatible
  matvec (``_mv32``) as the inner defect solver, warm-started from the
  previous step's pressure.

The Neumann rows of the compatible matvec are the fine level's compact
boundary table.  After the matvec's four SpMVs, one ``ppe_tail`` launch
(role ``ppe2``) sums them, scatters the boundary rows' products over the
sum (the reference's ``spmv_tpu2`` + ``.at[rows].set``), keeps x on the
identity rows and adds the Lagrange column.  Its tables share their
tensors with the levels' ``bound2`` tables; the row -> boundary-row map is
made here, at repack.

On CPU tensors every kernel wrapper takes its plain PyTorch version, so
``device="cpu"`` runs the identical flow.  The time loop is a host loop:
each step reads a few scalars (residuals, iteration counts) on the host.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from meshlessmultigridpoisson_torch.config import FracStepConfig
from meshlessmultigridpoisson_torch.mg.gpu_backend import (
    GpuLevel,
    gpu_hierarchy,
    gpu_level_from_operator,
)
from meshlessmultigridpoisson_torch.mg.krylov import bicgstab_matfree
from meshlessmultigridpoisson_torch.mg.mixed import defect_hierarchy, solve_mixed
from meshlessmultigridpoisson_torch.mg.vcycle import Hierarchy, MGState
from meshlessmultigridpoisson_torch.models.fracstep import (
    FracStepProblem,
    FracStepState,
    u_error_vs_kovasznay,
)
from meshlessmultigridpoisson_torch.ops.gpu_kernels import (
    DeviceEll,
    PpeTail,
    device_ell,
    ell_spmv,
    ppe_tail,
    ppe_tail_table,
)


@dataclasses.dataclass(frozen=True)
class GpuFracStep:
    """Device-resident fractional-step problem (see module docstring)."""

    hd: Hierarchy  # f32 GpuLevel defect hierarchy (fine pins zeroed)
    op64: GpuLevel  # f64 matvec-only fine level (outer PPE residuals)
    dx32: DeviceEll  # f32 derivative operators, role spmv6
    dy32: DeviceEll
    lap32: DeviceEll
    dx64: DeviceEll  # f64 (outer compatible matvec)
    dy64: DeviceEll
    ppe32: PpeTail  # the compatible matvec's tail over the fine Neumann rows, f32
    ppe64: PpeTail  # the same, f64
    bmask: torch.Tensor  # [n_pad] f64
    u_bc: torch.Tensor
    v_bc: torch.Tensor
    normals: torch.Tensor  # [n_pad, 2] f64
    config: FracStepConfig
    n_pad: int
    n: int


def build_gpu_fracstep(prob: FracStepProblem, device) -> GpuFracStep:
    """Repack a host-built FracStepProblem for the kernels (setup stays f64
    on the host; only kernel-ready layouts move)."""
    if not prob.compatible_ppe:
        raise NotImplementedError(
            "the GPU fractional-step path implements the compatible "
            "div∘grad PPE only; --reference-ppe (assembled-Laplacian PPE) "
            "runs on the host f64 path (models/fracstep.py)")
    if (prob.config.hyperviscosity or 0.0) > 0.0:
        raise NotImplementedError(
            "hyperviscosity is not wired into the GPU predictor; use the "
            "host f64 path (models/fracstep.py)")
    device = torch.device(device)
    hd = defect_hierarchy(gpu_hierarchy(prob.hierarchy, device))
    fine = prob.hierarchy.finest
    op64 = gpu_level_from_operator(fine, device, torch.float64, sweep=False)

    def ell(m, dtype):
        return device_ell(m, dtype, device, "spmv6")

    def f64(v):
        return v.to(device=device, dtype=torch.float64).contiguous()

    def tail(top: GpuLevel):
        return ppe_tail_table(top.bound, (top.smooth_mask + top.neumann_mask) > 0,
                              top.lag_col)

    return GpuFracStep(
        hd=hd,
        op64=op64,
        dx32=ell(prob.dx, torch.float32),
        dy32=ell(prob.dy, torch.float32),
        lap32=ell(prob.lap, torch.float32),
        dx64=ell(prob.dx, torch.float64),
        dy64=ell(prob.dy, torch.float64),
        ppe32=tail(hd.levels[-1]),
        ppe64=tail(op64),
        bmask=f64(prob.bmask),
        u_bc=f64(prob.u_bc),
        v_bc=f64(prob.v_bc),
        normals=f64(prob.normals),
        config=prob.config,
        n_pad=fine.n_pad,
        n=fine.n,
    )


def _compatible(top: GpuLevel, dx: DeviceEll, dy: DeviceEll, tail: PpeTail):
    """Bordered compatible PPE matvec (models/fracstep.make_compatible_matvec)
    on the kernel operators: four SpMVs, then one ``ppe_tail`` launch (the
    Neumann rows' scatter, the identity on padding rows, the Lagrange
    column), and the border row."""

    def mv(x, xl):
        y = ppe_tail(tail, ell_spmv(dx, ell_spmv(dx, x)), ell_spmv(dy, ell_spmv(dy, x)),
                     x, xl)
        return y, (top.lag_row * x).sum() + xl  # product + sum: no cuBLAS

    return mv


def _mv32(t: GpuFracStep):
    """f32 compatible PPE matvec (the inner defect system)."""
    return _compatible(t.hd.levels[-1], t.dx32, t.dy32, t.ppe32)


def _mv64(t: GpuFracStep):
    """Exact f64 compatible PPE matvec (the outer residual)."""
    return _compatible(t.op64, t.dx64, t.dy64, t.ppe64)


def _predictor32(t: GpuFracStep, u, v):
    """f32 advection-diffusion predictor on the kernels; returns f64."""
    c = t.config
    # the reference's jnp.float32 constants
    nu = float(np.float32(c.mu / c.rho))
    dt = float(np.float32(c.dt))
    u32, v32 = u.to(torch.float32), v.to(torch.float32)
    u_x, u_y = ell_spmv(t.dx32, u32), ell_spmv(t.dy32, u32)
    v_x, v_y = ell_spmv(t.dx32, v32), ell_spmv(t.dy32, v32)
    adv_u = -(u32 * u_x + v32 * u_y)
    adv_v = -(u32 * v_x + v32 * v_y)

    if c.diffusion == "implicit":
        def helmholtz(w):
            return w - dt * nu * ell_spmv(t.lap32, w)

        # f32 floor ~1e-7 relative: orders below the scheme's O(dt) error
        u_hat, _, _ = bicgstab_matfree(helmholtz, u32 + dt * adv_u, u32,
                                       tol=1e-6, max_iters=60)
        v_hat, _, _ = bicgstab_matfree(helmholtz, v32 + dt * adv_v, v32,
                                       tol=1e-6, max_iters=60)
    else:
        lap_u, lap_v = ell_spmv(t.lap32, u32), ell_spmv(t.lap32, v32)
        u_hat = u32 + dt * (adv_u + nu * lap_u)
        v_hat = v32 + dt * (adv_v + nu * lap_v)
    return u_hat.to(torch.float64), v_hat.to(torch.float64)


def timestep_gpu(t: GpuFracStep, state: FracStepState, stats: dict | None = None):
    """One fractional step on the device (semantics of fracstep.timestep in
    compatible-PPE mode; reference loop FractionalStepSim.cpp:130-156).

    Returns (state, fs_residual as a 0-dim device tensor).  ``stats``, when
    given, receives the PPE solve's outer passes (``ppe_outer``), per pass
    the inner BiCGStab iterations, inner and outer relative residuals
    (``ppe_passes``), the final relative residual (``ppe_residual``),
    whether it is below ``config.ppe_tol`` (``ppe_converged``) and the
    pre-blend solution (``p_solve``, ``pl_solve``).  A PPE solve that stops
    above the tolerance (the fused stopping rule's stall or pass cap: the
    step goes on with it, as the reference's does) raises a
    ``RuntimeWarning``.
    """
    c = t.config
    fine_i = len(t.hd.levels) - 1
    rho_dt = c.rho / c.dt

    def bound(u, v):
        return (torch.where(t.bmask > 0, t.u_bc, u),
                torch.where(t.bmask > 0, t.v_bc, v))

    u, v = bound(state.u, state.v)
    u_old, v_old = u, v
    u_hat, v_hat = _predictor32(t, u, v)

    # PPE source (f32 divergence, f64 assembly)
    div = (ell_spmv(t.dx32, u_hat.to(torch.float32))
           + ell_spmv(t.dy32, v_hat.to(torch.float32)))
    b = rho_dt * div.to(torch.float64)
    dpdx = -rho_dt * (u - u_hat)
    dpdy = -rho_dt * (v - v_hat)
    bnd = t.normals[:, 0] * dpdx + t.normals[:, 1] * dpdy
    b = torch.where(t.bmask > 0, bnd, b)

    # PPE to the reference tolerance: f64 defect outer + f32 kernel inner,
    # warm-started from the previous pressure
    p_old = state.mg.x[fine_i].to(torch.float64)
    passes = []
    p, pl, outer, res = solve_mixed(
        t.op64, t.hd, p_old, state.mg.x_lag[fine_i], b, b.new_zeros(()),
        tol=c.ppe_tol, matvec64=_mv64(t), matvec32=_mv32(t), passes=passes)
    converged = res < c.ppe_tol
    if not converged:
        warnings.warn(f"PPE solve stopped at relative residual {res:.3e}, above "
                      f"ppe_tol {c.ppe_tol:.0e}, after {outer} outer passes",
                      RuntimeWarning, stacklevel=2)
    if stats is not None:
        stats.update(ppe_outer=outer, ppe_passes=passes, ppe_residual=res,
                     ppe_converged=converged, p_solve=p, pl_solve=pl)
    p = c.p_relax * p + (1.0 - c.p_relax) * p_old
    mg = state.mg.replace_level(fine_i, x=p, x_lag=pl, b=b)

    # corrector (f32 gradients)
    p32 = p.to(torch.float32)
    u = u_hat - (c.dt / c.rho) * ell_spmv(t.dx32, p32).to(torch.float64)
    v = v_hat - (c.dt / c.rho) * ell_spmv(t.dy32, p32).to(torch.float64)
    u, v = bound(u, v)
    res = (u - u_hat).abs().sum() / t.n
    return FracStepState(u=u, v=v, u_old=u_old, v_old=v_old,
                         u_hat=u_hat, v_hat=v_hat, mg=mg), res


def state_to(state: FracStepState, device) -> FracStepState:
    """The state's tensors on ``device`` (f64 kept)."""
    def to(v):
        return v.to(device)

    mg = state.mg
    return FracStepState(
        u=to(state.u), v=to(state.v), u_old=to(state.u_old), v_old=to(state.v_old),
        u_hat=to(state.u_hat), v_hat=to(state.v_hat),
        mg=MGState(**{k: tuple(to(a) for a in getattr(mg, k))
                      for k in ("x", "x_lag", "b", "b_lag")}))


def run_gpu(prob: FracStepProblem, device, steps: int | None = None,
            t: GpuFracStep | None = None, on_step=None):
    """Time loop on the device; same contract as fracstep.run.

    Returns (final state on the host, fs_residual history, u L1 error vs
    Kovasznay).  ``on_step(i, state, stats)``, when given, runs after each
    step (``stats``: see ``timestep_gpu``).
    """
    steps = prob.config.max_steps if steps is None else steps
    t = t or build_gpu_fracstep(prob, device)
    state = state_to(prob.state0, t.bmask.device)
    hist = []
    for i in range(steps):
        stats = {}
        state, res = timestep_gpu(t, state, stats)
        hist.append(float(res))
        if on_step is not None:
            on_step(i, state, stats)
    state = state_to(state, "cpu")
    return state, np.asarray(hist), u_error_vs_kovasznay(prob, state)
