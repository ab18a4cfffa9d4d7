"""Manufactured-solution Poisson problems on the reference geometries.

Port of the reference package's ``models/poisson.py`` (genGmshGridDirichlet /
genGmshGridNeumann and calc_l1_error*, testing_functions.cpp:3-284); the
manufactured fields are identical, so both packages pose the same problem
on the same clouds.  The L1 error applies the reference's Neumann gauge fix
(testing_functions.cpp:12-32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meshlessmultigridpoisson_torch.config import MultigridConfig
from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud, make_cloud
from meshlessmultigridpoisson_torch.mg.setup import build_hierarchy
from meshlessmultigridpoisson_torch.mg.vcycle import Hierarchy, MGState, init_state
from meshlessmultigridpoisson_torch.ops.smoothers import (
    apply_dirichlet,
    push_inhomog_to_rhs,
    set_neumann_source,
)

PI = np.pi


# ---------------------------------------------------------------------------
# manufactured fields
# ---------------------------------------------------------------------------


def exact_square(pts: np.ndarray, neumann: bool, k1: int, k2: int) -> np.ndarray:
    x, y = pts[:, 0], pts[:, 1]
    if neumann:
        return np.cos(k1 * PI * x) * np.cos(k2 * PI * y)
    return np.sin(k1 * PI * x) * np.sin(k2 * PI * y)


def source_square(pts: np.ndarray, neumann: bool, k1: int, k2: int) -> np.ndarray:
    return -(k1 * k1 + k2 * k2) * PI * PI * exact_square(pts, neumann, k1, k2)


def exact_box3d(pts: np.ndarray, neumann: bool, k1: int, k2: int) -> np.ndarray:
    """3D product manufactured solution (the 2D family's designed
    extension; reference is strictly 2D, testing_functions.cpp:3-67)."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    if neumann:
        return np.cos(k1 * PI * x) * np.cos(k2 * PI * y) * np.cos(k1 * PI * z)
    return np.sin(k1 * PI * x) * np.sin(k2 * PI * y) * np.sin(k1 * PI * z)


def source_box3d(pts: np.ndarray, neumann: bool, k1: int, k2: int) -> np.ndarray:
    return (
        -(2 * k1 * k1 + k2 * k2) * PI * PI * exact_box3d(pts, neumann, k1, k2)
    )


def exact_circle(pts: np.ndarray, k: int) -> np.ndarray:
    x, y = pts[:, 0] - 0.5, pts[:, 1] - 0.5
    rstar = (np.sqrt(x * x + y * y) - 0.25) / 0.25
    return np.sin(rstar * PI * k)


def source_circle(pts: np.ndarray, k: int) -> np.ndarray:
    """The reference's expanded annulus source (testing_functions.cpp:113-123)."""
    x, y = pts[:, 0] - 0.5, pts[:, 1] - 0.5
    r2 = x * x + y * y
    rstar = (np.sqrt(r2) - 0.25) / 0.25
    s = np.zeros(pts.shape[0])
    for c in (x, y):
        s += -PI * k * k * PI * np.sin(PI * k * rstar) * (4 * c * r2**-0.5) ** 2 + (
            PI * k * np.cos(PI * k * rstar) * 4 * (r2**-0.5 + 2 * c * c * -0.5 * r2**-1.5)
        )
    return s


# ---------------------------------------------------------------------------
# problem assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PoissonProblem:
    hierarchy: Hierarchy
    clouds: list[PointCloud]
    state0: MGState
    exact: np.ndarray  # exact solution on the (ordered) finest cloud
    neumann: bool
    geomtype: str
    k1: int
    k2: int


def _bc_value_fn(geomtype: str, neumann: bool, k1: int, k2: int):
    def fn(pts: np.ndarray, normals: np.ndarray, comp: int) -> np.ndarray:
        x, y = pts[:, 0], pts[:, 1]
        if geomtype == "square":
            return np.zeros(pts.shape[0])
        if geomtype == "box3d":
            # Dirichlet: sin products vanish on the faces; Neumann: the
            # cos-product normal derivative has a sin(k pi {0,1}) = 0
            # factor on every face (the 3D analog of the 2D square case).
            return np.zeros(pts.shape[0])
        if geomtype == "square_with_circle":
            if comp == 0:
                return np.zeros(pts.shape[0])
            if not neumann:
                # reference uses k1 twice (testing_functions.cpp:103)
                return np.sin(k1 * PI * x) * np.sin(k1 * PI * y)
            nx, ny = normals[:, 0], normals[:, 1]
            return -nx * PI * k1 * np.sin(k1 * PI * x) * np.cos(k2 * PI * y) - (
                ny * PI * k2 * np.cos(k1 * PI * x) * np.sin(k2 * PI * y)
            )
        if geomtype == "concentric_circles":
            if not neumann:
                return np.zeros(pts.shape[0])
            # d/dn of sin(k pi r*) with r* = (r - .25)/.25 along the stored
            # normals (testing_functions.cpp:227-249)
            xc, yc = x - 0.5, y - 0.5
            r = np.sqrt(xc * xc + yc * yc)
            rstar = (r - 0.25) / 0.25
            nx, ny = normals[:, 0], normals[:, 1]
            dudx = k1 * PI * np.cos(k1 * PI * rstar) / 0.25 * xc / r
            dudy = k1 * PI * np.cos(k1 * PI * rstar) / 0.25 * yc / r
            return nx * dudx + ny * dudy
        raise ValueError(geomtype)

    return fn


def make_poisson_problem(
    geomtype: str,
    sizes: list[int],
    poly_deg: int = 4,
    k1: int = 1,
    neumann: bool = False,
    seed: int = 0,
    block_rows: int = 256,
    ordering: str = "rcm",
    device=None,
) -> PoissonProblem:
    """Replicates gen_mg_param + run_mg_sim setup (testing_functions.cpp:328-395).

    Host-side f64 setup; ``device`` only hosts the RBF-FD weight solves.
    """
    k2 = k1
    clouds = [make_cloud(geomtype, n, seed=seed + i) for i, n in enumerate(sizes)]
    if geomtype == "box3d":
        # 3D: poly terms grow cubically (deg 3 -> 20 terms, k=50);
        # coarse levels at deg 2 (k=25, the 27-neighbor-class stencil)
        config = MultigridConfig(
            num_levels=len(sizes), fine_poly_deg=poly_deg,
            coarse_poly_deg=min(poly_deg, 2), dim=3,
        )
    else:
        config = MultigridConfig(
            num_levels=len(sizes), fine_poly_deg=poly_deg, coarse_poly_deg=3
        )
    bc_types = ["neumann" if neumann else "dirichlet"] * max(
        len(c.boundaries) for c in clouds
    )
    hier, ordered = build_hierarchy(
        clouds, bc_types, _bc_value_fn(geomtype, neumann, k1, k2), config,
        block_rows, ordering=ordering, device=device,
    )

    fine = ordered[-1]
    if geomtype == "concentric_circles":
        src = source_circle(fine.points, k1)
        exact = exact_circle(fine.points, k1)
    elif geomtype == "box3d":
        src = source_box3d(fine.points, neumann, k1, k2)
        exact = exact_box3d(fine.points, neumann, k1, k2)
    else:
        src = source_square(fine.points, neumann, k1, k2)
        exact = exact_square(fine.points, neumann, k1, k2)

    op_f = hier.finest
    state = init_state(hier, torch.from_numpy(np.asarray(src, np.float64)))
    bf = state.b[-1]
    if neumann:
        bf = set_neumann_source(op_f, bf, coarse=False)  # fine g values
        bf = push_inhomog_to_rhs(op_f, bf)
    state = state.replace_level(len(hier.levels) - 1, b=bf)
    # pin fine Dirichlet values once (boundaryOp("fine"): done per-cycle too)
    xf = apply_dirichlet(op_f, state.x[-1], coarse=False)
    state = state.replace_level(len(hier.levels) - 1, x=xf)

    return PoissonProblem(
        hierarchy=hier,
        clouds=ordered,
        state0=state,
        exact=exact,
        neumann=neumann,
        geomtype=geomtype,
        k1=k1,
        k2=k2,
    )


def l1_error(problem: PoissonProblem, x_padded: torch.Tensor) -> float:
    """calc_l1_error / calc_l1_error_circle (testing_functions.cpp:3-67)."""
    op = problem.hierarchy.finest
    sol = op.to_logical(x_padded.cpu().double()).numpy()
    exact = problem.exact
    if problem.neumann:
        sol = sol + (exact.mean() - sol.mean())
    return float(np.abs(sol - exact).mean())
