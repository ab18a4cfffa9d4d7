"""Hierarchy construction: ordering, per-level operators, transfer operators.

Port of the reference package's ``mg/setup.py`` (the per-grid setup pipeline
of testing_functions.cpp:267-283 plus Multigrid::buildMatrices,
multigrid.cpp:49-60).  Levels are ordered coarse -> fine by point count.
Everything runs on the host except the RBF-FD weight solves, which run on
``device``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from meshlessmultigridpoisson_torch.config import MultigridConfig
from meshlessmultigridpoisson_torch.geometry.neighbors import knn
from meshlessmultigridpoisson_torch.geometry.ordering import (
    kd_tile_ordering,
    rcm_ordering,
)
from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud
from meshlessmultigridpoisson_torch.mg.stabilize import stabilize_level
from meshlessmultigridpoisson_torch.mg.vcycle import Hierarchy
from meshlessmultigridpoisson_torch.stencil.operators import (
    bc_flags_from_cloud,
    build_interp_operator,
    build_level_operator,
)

# bc_values_fn(points [N,d], normals [N,d], component) -> values [m] at the
# component's boundary points
BCValueFn = Callable[[np.ndarray, np.ndarray, int], np.ndarray]


def order_cloud(
    cloud: PointCloud, stencil_k: int, neumann: bool, method: str = "rcm"
) -> PointCloud:
    """Order a cloud for locality: ``rcm`` (banded windows) or ``kdtile``
    (aligned 128-point spatial patches).  Unknown names raise."""
    if method in ("kd", "kdtile"):
        return cloud.permuted(kd_tile_ordering(cloud.points))
    if method != "rcm":
        # a silent fallthrough here once ran every "kdtile" solve RCM-ordered
        raise ValueError(f"unknown ordering {method!r}; use rcm|kdtile")
    nb = knn(
        cloud.points, stencil_k, boundary_mask=cloud.boundary_mask, neumann=neumann
    )
    return cloud.permuted(rcm_ordering(nb))


def dense_bc_values(cloud: PointCloud, fn: BCValueFn) -> np.ndarray:
    out = np.zeros(cloud.n)
    for comp, bidx in enumerate(cloud.boundaries):
        out[bidx] = fn(cloud.points[bidx], cloud.normals[bidx], comp)
    return out


def build_hierarchy(
    clouds: Sequence[PointCloud],
    bc_types: Sequence[str],
    bc_values_fn: BCValueFn,
    config: MultigridConfig,
    block_rows: int = 256,
    ordering: str = "rcm",
    device=None,
) -> tuple[Hierarchy, list[PointCloud]]:
    """Build operators + transfers for clouds ordered coarse -> fine.

    Returns (hierarchy, ordered_clouds) — callers evaluate sources / exact
    solutions on the ordered clouds.  Every level goes through the
    setup-time smoother-stability pass (mg/stabilize.py).
    """
    if sorted(c.n for c in clouds) != [c.n for c in clouds]:
        clouds = sorted(clouds, key=lambda c: c.n)  # multigrid.cpp:120-122
    L = len(clouds)
    neumann = any(t == "neumann" for t in bc_types)

    ordered: list[PointCloud] = []
    levels = []
    for lvl, cloud in enumerate(clouds):
        cfg = config.level_config(lvl)
        oc = order_cloud(cloud, cfg.stencil_size, neumann, method=ordering)
        ordered.append(oc)
        flags = bc_flags_from_cloud(oc, list(bc_types))
        vals = dense_bc_values(oc, bc_values_fn)
        levels.append(stabilize_level(build_level_operator(
            oc, flags, vals, cfg, block_rows=block_rows, device=device)))

    restrict, prolong = [], []
    deg = config.level_config(L - 1).poly_deg  # finest degree, multigrid.cpp:22
    for i in range(L - 1):
        fine_pts, coarse_pts = ordered[i + 1].points, ordered[i].points
        fine_op, coarse_op = levels[i + 1], levels[i]
        restrict.append(
            build_interp_operator(
                fine_pts, coarse_pts, deg, config.rbf_exp, block_rows,
                row_map_target=coarse_op.row_map.numpy(),
                row_map_base=fine_op.row_map.numpy(),
                n_pad_target=coarse_op.n_pad, n_pad_base=fine_op.n_pad,
                device=device,
            )
        )
        prolong.append(
            build_interp_operator(
                coarse_pts, fine_pts, deg, config.rbf_exp, block_rows,
                row_map_target=fine_op.row_map.numpy(),
                row_map_base=coarse_op.row_map.numpy(),
                n_pad_target=fine_op.n_pad, n_pad_base=coarse_op.n_pad,
                device=device,
            )
        )

    hier = Hierarchy(
        levels=tuple(levels), restrict=tuple(restrict), prolong=tuple(prolong)
    )
    return hier, ordered
