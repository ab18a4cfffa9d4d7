"""Fractional-step incompressible Navier-Stokes with Kovasznay validation.

Port of the reference package's ``models/fracstep.py`` (the host f64
oracle; the device path is models/fracstep_gpu.py).  The velocity state is
a set of padded vectors on the finest level, in its permuted row space; the
predictor and corrector are SpMVs with the derivative operators plus
pointwise ops; the pressure-Poisson equation (PPE) reuses the multigrid
engine.  Everything here runs on host tensors in f64 through the plain
solver path (ops/smoothers.py on LevelOperators).

Reference semantics per timestep (run_fracstep_param, FractionalStepSim.cpp:
130-156):
  set_uv_bound -> u_hat = u + dt(-(u u_x + v u_y) + (mu/rho) lap u) (:101-124)
  -> PPE source: interior rho/dt (dx u_hat + dy v_hat), boundary
     n.(-rho/dt)(u - u_hat, v - v_hat) (:125-145), RHS pushdown (:137)
  -> solve PPE to tol (while residual >= tol: vCycle, :139-142)
  -> u = u_hat - dt/rho dx p ; v = v_hat - dt/rho dy p (:146-151)
  -> set_uv_bound; fs_residual = ||u - u_hat||_1 / N (:152-154)

The default PPE is the reference package's compatible one: the outer
system is the exact discrete div o grad = Dx.(Dx p) + Dy.(Dy p) that the
corrector applies (matrix-free; Neumann rows and the Lagrange border as
usual), solved by BiCGStab preconditioned with the standard Laplacian
V-cycle.  ``compatible_ppe=False`` is the reference's assembled-Laplacian
PPE with the condensation pushdown.

Kovasznay exact solution (Re = rho/mu, lambda = Re/2 - sqrt(Re^2/4 + 4pi^2),
fractionalStepGrid.cpp:26-59):
  u = 1 - e^(lambda x) cos(2 pi y)
  v = lambda/(2 pi) e^(lambda x) sin(2 pi y)
  p = 0.5 e^(2 lambda x)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from meshlessmultigridpoisson_torch.config import (
    REFERENCE_MG_SIZES,
    FracStepConfig,
    MultigridConfig,
)
from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud, make_cloud
from meshlessmultigridpoisson_torch.mg.krylov import bicgstab_matfree, solve_bicgstab
from meshlessmultigridpoisson_torch.mg.setup import build_hierarchy
from meshlessmultigridpoisson_torch.mg.vcycle import (
    Hierarchy,
    MGState,
    init_state,
    solve_to_tolerance,
)
from meshlessmultigridpoisson_torch.ops import smoothers as sm
from meshlessmultigridpoisson_torch.ops.ell import EllMatrix, ell_from_csr, spmv
from meshlessmultigridpoisson_torch.stencil.operators import (
    assemble_operator_csr,
    bc_flags_from_cloud,
)

PI = np.pi


def kovasznay_lambda(re: float) -> float:
    return 0.5 * re - np.sqrt(0.25 * re * re + 4 * PI * PI)


def kovasznay_uvp(points: np.ndarray, re: float):
    lam = kovasznay_lambda(re)
    x, y = points[:, 0], points[:, 1]
    u = 1.0 - np.exp(lam * x) * np.cos(2 * PI * y)
    v = lam / (2 * PI) * np.exp(lam * x) * np.sin(2 * PI * y)
    p = 0.5 * np.exp(2 * lam * x)
    return u, v, p


@dataclasses.dataclass(frozen=True)
class FracStepState:
    """Velocity fields (padded fine-level vectors) + pressure MG state."""

    u: torch.Tensor
    v: torch.Tensor
    u_old: torch.Tensor
    v_old: torch.Tensor
    u_hat: torch.Tensor
    v_hat: torch.Tensor
    mg: MGState  # pressure lives in mg.x[-1]


@dataclasses.dataclass
class FracStepProblem:
    hierarchy: Hierarchy
    clouds: list[PointCloud]
    dx: EllMatrix  # fine-level d/dx, permuted row space
    dy: EllMatrix
    lap: EllMatrix  # velocity Laplacian (no BC rows)
    bmask: torch.Tensor  # [n_pad] 1.0 at boundary points
    u_bc: torch.Tensor  # [n_pad] Kovasznay u at boundary (0 elsewhere)
    v_bc: torch.Tensor
    normals: torch.Tensor  # [n_pad, 2]
    config: FracStepConfig
    state0: FracStepState
    compatible_ppe: bool = True
    lap_scale: float = 1.0  # |lam_max(lap)| estimate for hyperviscosity


def _permuted_ell(a: sp.csr_matrix, row_map: np.ndarray, n_pad: int,
                  block_rows: int) -> EllMatrix:
    """A logical-order operator in the fine level's permuted padded space."""
    perm_mat = sp.coo_matrix(
        (np.ones(row_map.size), (row_map, np.arange(row_map.size))),
        shape=(n_pad, row_map.size),
    ).tocsr()
    ap = (perm_mat @ a @ perm_mat.T).tocsr()
    ap.sum_duplicates()
    return ell_from_csr(ap, block_rows=block_rows)


def build_fracstep_problem(
    sizes: list[int] | None = None,
    num_levels: int = 4,
    poly_deg: int = 6,
    config: FracStepConfig | None = None,
    seed: int = 0,
    block_rows: int = 256,
    compatible_ppe: bool = True,
    msh_files: list[str] | None = None,
    device=None,
) -> FracStepProblem:
    """genFractionalStepGrid + gen_fracstep_param equivalent
    (FractionalStepSim.cpp:3-79): square clouds (or Gmsh files, coarse ->
    fine), Neumann pressure BCs, implicit condensation, fine ``poly_deg`` /
    coarse 3, base-degree transfers (FracStepMultigrid.cpp:23), RCM
    ordering, every level stabilized.  Host f64 setup; ``device`` only hosts
    the RBF-FD weight solves.
    """
    config = config or FracStepConfig()
    if msh_files:
        # real Gmsh v2 meshes (the reference's own NS input path,
        # FractionalStepSim.cpp:190-199)
        from meshlessmultigridpoisson_torch.geometry.msh import pointcloud_from_msh

        clouds = [pointcloud_from_msh(p, geomtype="square") for p in msh_files]
        sizes = [c.n for c in clouds]
    else:
        if sizes is None:
            sizes = list(REFERENCE_MG_SIZES["square"][:num_levels])
        clouds = [make_cloud("square", n, seed=seed + i)
                  for i, n in enumerate(sizes)]
    mg_config = MultigridConfig(
        num_levels=len(sizes),
        fine_poly_deg=poly_deg,
        coarse_poly_deg=3,
        transfer_poly="base",  # FracStepMultigrid.cpp:23
    )
    lam = kovasznay_lambda(config.reynolds)

    def bc_fn(pts, normals, comp):
        # reference stores p values as the "bc data" (FractionalStepSim.cpp:18)
        return 0.5 * np.exp(2 * lam * pts[:, 0])

    hier, ordered = build_hierarchy(
        clouds, ["neumann"], bc_fn, mg_config, block_rows, device=device)

    fine = ordered[-1]
    op_f = hier.finest
    flags = bc_flags_from_cloud(fine, ["neumann"])
    cfg_f = mg_config.level_config(len(sizes) - 1)
    rm = op_f.row_map.numpy()

    def deriv(op, neumann_rows=True):
        csr = assemble_operator_csr(fine, flags, cfg_f, device=device, op=op,
                                    neumann_rows=neumann_rows)
        return _permuted_ell(csr, rm, op_f.n_pad, block_rows)

    dxe, dye = deriv("dx"), deriv("dy")
    lape = deriv("laplace", neumann_rows=False)

    u_ex, v_ex, _ = kovasznay_uvp(fine.points, config.reynolds)
    bmask_l = fine.boundary_mask

    def padded(v):
        return op_f.to_padded(torch.from_numpy(np.asarray(v, np.float64)))

    normals = torch.zeros(op_f.n_pad, 2, dtype=torch.float64)
    normals[op_f.row_map.long()] = torch.from_numpy(fine.normals)

    # spectral-radius estimate of the velocity Laplacian (hyperviscosity
    # normalization): a few power iterations on the host
    lap_scale = 1.0
    if (config.hyperviscosity or 0.0) > 0.0:
        vv = torch.from_numpy(np.random.default_rng(7).standard_normal(op_f.n_pad))
        for _ in range(20):
            v2 = spmv(lape, vv)
            lap_scale = float(v2.norm() / vv.norm())
            vv = v2 / v2.norm()

    mg0 = init_state(hier, torch.zeros(fine.n, dtype=torch.float64))
    zero = torch.zeros(op_f.n_pad, dtype=torch.float64)
    state0 = FracStepState(u=zero, v=zero, u_old=zero, v_old=zero,
                           u_hat=zero, v_hat=zero, mg=mg0)
    return FracStepProblem(
        hierarchy=hier,
        clouds=ordered,
        dx=dxe,
        dy=dye,
        lap=lape,
        bmask=padded(bmask_l),
        u_bc=padded(np.where(bmask_l, u_ex, 0.0)),
        v_bc=padded(np.where(bmask_l, v_ex, 0.0)),
        normals=normals,
        config=config,
        state0=state0,
        compatible_ppe=compatible_ppe,
        lap_scale=lap_scale,
    )


def set_uv_bound(prob: FracStepProblem, u, v):
    """Pin boundary velocities to the exact flow (fractionalStepGrid.cpp:41-59)."""
    u = torch.where(prob.bmask > 0, prob.u_bc, u)
    v = torch.where(prob.bmask > 0, prob.v_bc, v)
    return u, v


def predictor(prob: FracStepProblem, u, v):
    """Advection-diffusion predictor (fractionalStepGrid.cpp:101-124).

    ``diffusion="explicit"``: the reference's forward-Euler form, with
    optional hyperviscosity -hv*nu*Lap(Lap u)/|lam_max|.
    ``diffusion="implicit"``: backward-Euler viscosity — solve
    (I - dt nu Lap) u_hat = u - dt (u.grad)u with plain BiCGStab.
    """
    c = prob.config
    nu = c.mu / c.rho
    u_x, u_y = spmv(prob.dx, u), spmv(prob.dy, u)
    v_x, v_y = spmv(prob.dx, v), spmv(prob.dy, v)
    adv_u = -(u * u_x + v * u_y)
    adv_v = -(u * v_x + v * v_y)

    if c.diffusion == "implicit":
        def helmholtz(w):
            return w - c.dt * nu * spmv(prob.lap, w)

        u_hat, _, _ = bicgstab_matfree(
            helmholtz, u + c.dt * adv_u, u, tol=1e-12, max_iters=200)
        v_hat, _, _ = bicgstab_matfree(
            helmholtz, v + c.dt * adv_v, v, tol=1e-12, max_iters=200)
        return u_hat, v_hat

    lap_u, lap_v = spmv(prob.lap, u), spmv(prob.lap, v)
    rhs_u = adv_u + nu * lap_u
    rhs_v = adv_v + nu * lap_v
    if c.hyperviscosity > 0.0:
        g = c.hyperviscosity * nu / prob.lap_scale
        rhs_u = rhs_u - g * spmv(prob.lap, lap_u)
        rhs_v = rhs_v - g * spmv(prob.lap, lap_v)
    return u + c.dt * rhs_u, v + c.dt * rhs_v


def ppe_source(prob: FracStepProblem, u, v, u_hat, v_hat):
    """PPE RHS (fractionalStepGrid.cpp:125-145).

    The reference-PPE mode also applies the condensation pushdown
    (grid.cpp:664); the matrix-free compatible system keeps boundary
    coupling explicit, so the raw bordered RHS is used directly.
    """
    c = prob.config
    div = spmv(prob.dx, u_hat) + spmv(prob.dy, v_hat)
    b = c.rho / c.dt * div
    dpdx = -c.rho / c.dt * (u - u_hat)
    dpdy = -c.rho / c.dt * (v - v_hat)
    bnd = prob.normals[:, 0] * dpdx + prob.normals[:, 1] * dpdy
    b = torch.where(prob.bmask > 0, bnd, b)
    if not prob.compatible_ppe:
        b = sm.push_inhomog_to_rhs(prob.hierarchy.finest, b)
    return b


def make_compatible_matvec(prob: FracStepProblem):
    """Bordered matrix-free div o grad PPE operator.

    Interior rows: Dx.(Dx p) + Dy.(Dy p) (exactly what the corrector
    removes); Neumann rows: the standard n.grad rows; Lagrange border as
    usual.  Boundary p columns stay explicitly coupled (no condensation).
    """
    op = prob.hierarchy.finest
    bound = op.bound
    rows = bound.rows.long()
    keep = rows < op.n_pad  # padding slots point past the end: dropped

    def mv(x, xl):
        y = spmv(prob.dx, spmv(prob.dx, x)) + spmv(prob.dy, spmv(prob.dy, x))
        # Neumann rows from the compact n.grad set
        y[rows[keep]] = spmv(bound.ell, x)[keep]
        # identity on padding/Dirichlet rows keeps the bordered system square
        y = torch.where(op.smooth_mask + op.neumann_mask > 0, y, x)
        y = y + op.lag_col * xl
        return y, torch.dot(op.lag_row, x) + xl

    return mv


def corrector(prob: FracStepProblem, u_hat, v_hat, p):
    """Projection step (fractionalStepGrid.cpp:146-151)."""
    c = prob.config
    u = u_hat - c.dt / c.rho * spmv(prob.dx, p)
    v = v_hat - c.dt / c.rho * spmv(prob.dy, p)
    return u, v


def fs_residual(prob: FracStepProblem, u, u_hat):
    """||u - u_hat||_1 / N (fractionalStepGrid.cpp:152-154)."""
    return (u - u_hat).abs().sum() / prob.hierarchy.finest.n


def timestep(prob: FracStepProblem, state: FracStepState,
             ppe_solver: str = "vcycle", max_cycles: int = 60):
    """One fractional step; returns (state, fs_residual).

    The compatible PPE always runs BiCGStab with the compatible matvec;
    ``ppe_solver`` ("bicgstab" | "vcycle") picks the solver of the
    reference-PPE mode.
    """
    c = prob.config
    hier = prob.hierarchy
    fine_i = hier.num_levels - 1

    u, v = set_uv_bound(prob, state.u, state.v)
    u_old, v_old = u, v
    u_hat, v_hat = predictor(prob, u, v)
    b = ppe_source(prob, u, v, u_hat, v_hat)

    p_old = state.mg.x[fine_i]
    mg = state.mg.replace_level(fine_i, b=b, b_lag=b.new_zeros(()))
    if prob.compatible_ppe:
        mg, _, _ = solve_bicgstab(hier, mg, tol=c.ppe_tol, max_iters=max_cycles,
                                  matvec=make_compatible_matvec(prob))
    elif ppe_solver == "bicgstab":
        mg, _, _ = solve_bicgstab(hier, mg, tol=c.ppe_tol, max_iters=max_cycles)
    elif ppe_solver == "vcycle":
        mg, _, _ = solve_to_tolerance(hier, mg, tol=c.ppe_tol, max_cycles=max_cycles)
    else:
        raise ValueError(f"ppe_solver {ppe_solver!r}; use bicgstab|vcycle")
    # pressure under-relaxation (see FracStepConfig.p_relax)
    p = c.p_relax * mg.x[fine_i] + (1.0 - c.p_relax) * p_old
    mg = mg.replace_level(fine_i, x=p)

    u, v = corrector(prob, u_hat, v_hat, p)
    u, v = set_uv_bound(prob, u, v)
    res = fs_residual(prob, u, u_hat)
    return FracStepState(u=u, v=v, u_old=u_old, v_old=v_old, u_hat=u_hat,
                         v_hat=v_hat, mg=mg), res


def run(prob: FracStepProblem, steps: int | None = None,
        ppe_solver: str = "vcycle", max_cycles: int = 60):
    """Time loop (run_fracstep_param, FractionalStepSim.cpp:130-156).

    Returns (final state, fs_residual history, u L1 error vs Kovasznay) —
    the reference's final validation metric (:158-168).
    """
    steps = prob.config.max_steps if steps is None else steps
    state = prob.state0
    hist = []
    for _ in range(steps):
        state, res = timestep(prob, state, ppe_solver, max_cycles)
        hist.append(float(res))
    return state, np.asarray(hist), u_error_vs_kovasznay(prob, state)


def u_error_vs_kovasznay(prob: FracStepProblem, state: FracStepState) -> float:
    op = prob.hierarchy.finest
    u_log = op.to_logical(state.u.cpu().double()).numpy()
    u_ex, _, _ = kovasznay_uvp(prob.clouds[-1].points, prob.config.reynolds)
    return float(np.abs(u_log - u_ex).mean())


def prescribe_solution(prob: FracStepProblem, state: FracStepState) -> FracStepState:
    """Set exact Kovasznay u, v, p (prescribe_soln, fractionalStepGrid.cpp:26-40)."""
    op = prob.hierarchy.finest
    u_ex, v_ex, p_ex = kovasznay_uvp(prob.clouds[-1].points, prob.config.reynolds)
    u, v, p = (op.to_padded(torch.from_numpy(a)) for a in (u_ex, v_ex, p_ex))
    mg = state.mg.replace_level(prob.hierarchy.num_levels - 1, x=p)
    return dataclasses.replace(state, u=u, v=v, u_old=u, v_old=v, mg=mg)
