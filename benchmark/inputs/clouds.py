"""Seeded point clouds of the benchmark's geometries.

Frozen from ``meshlessmultigridpoisson_torch/geometry/pointclouds.py`` at
commit 57ee902 (``poisson_disk``'s native path, ``square_with_circle_cloud``,
``box3d_cloud``), so the clouds a seed names stay the same whatever the
program's generators become.  A cloud is plain arrays: the points [n, dim],
one index array per boundary component, and the stored boundary normals
[n, dim] (zero rows inside), with the program's conventions (the square's
edge normals point inward, the hole's away from its centre, a cube edge or
corner takes the normal of its first face).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.inputs.native import poisson_disk_native


@dataclasses.dataclass(frozen=True)
class Cloud:
    points: np.ndarray  # [n, dim] float64
    boundaries: tuple  # of int32 index arrays, one per component
    normals: np.ndarray  # [n, dim] float64

    @property
    def n(self) -> int:
        return self.points.shape[0]


def _square_edges(r: float) -> np.ndarray:
    nb = max(4, int(round(1.0 / r)))  # boundary points per edge
    t = np.arange(nb) / nb  # [0, 1): each corner once
    return np.concatenate([np.stack([t, np.zeros(nb)], axis=1),
                           np.stack([np.ones(nb), t], axis=1),
                           np.stack([1.0 - t, np.ones(nb)], axis=1),
                           np.stack([np.zeros(nb), 1.0 - t], axis=1)], axis=0)


def _square_normals(pts: np.ndarray) -> np.ndarray:
    x, y = pts[:, 0], pts[:, 1]
    nvec = np.zeros((pts.shape[0], 2))
    nvec[y == 0] = (0, 1)
    nvec[y == 1] = (0, -1)
    nvec[(x == 0) & (y != 0) & (y != 1)] = (1, 0)
    nvec[(x == 1) & (y != 0) & (y != 1)] = (-1, 0)
    return nvec


def square_with_circle(n_target: int, seed: int) -> Cloud:
    """Unit square with a hole of radius 0.25 at (0.5, 0.5): blue-noise
    interior, the edges (component 0) and the circle (component 1) at the
    interior's spacing."""
    r_hole = 0.25
    area = 1.0 - np.pi * r_hole**2
    r = np.sqrt(0.72 * area / max(n_target, 16))
    outer = _square_edges(r)
    nb_inner = max(16, int(round(2 * np.pi * r_hole / r)))
    th = 2 * np.pi * (np.arange(nb_inner) / nb_inner)
    inner = np.stack([0.5 + r_hole * np.cos(th), 0.5 + r_hole * np.sin(th)], axis=1)
    # poisson_disk's radius from the box's area, so ~n_target points are kept
    r_box = np.sqrt(0.72 / max(int(n_target / area), 1))
    interior = poisson_disk_native(r_box, seed, np.concatenate([outer, inner], axis=0),
                                   0.9 * r_box, hole=(0.5, 0.5, r_hole))
    pts = np.concatenate([interior, outer, inner], axis=0)
    n0, n1 = interior.shape[0], interior.shape[0] + outer.shape[0]
    outer_idx = np.arange(n0, n1, dtype=np.int32)
    inner_idx = np.arange(n1, pts.shape[0], dtype=np.int32)
    normals = np.zeros_like(pts)
    normals[outer_idx] = _square_normals(pts[outer_idx])
    d = pts[inner_idx] - 0.5
    normals[inner_idx] = d / np.linalg.norm(d, axis=1, keepdims=True)
    return Cloud(pts, (outer_idx, inner_idx), normals)


def box3d(n_target: int, seed: int, jitter: float = 0.3) -> Cloud:
    """Unit cube: a jittered lattice inside, the six faces' lattice as one
    boundary component."""
    rng = np.random.default_rng(seed)
    nx = max(2, int(round(n_target ** (1.0 / 3.0) - 1)))
    xs = np.arange(1, nx + 1) / (nx + 1)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    h = 1.0 / (nx + 1)
    pts += rng.uniform(-jitter * h, jitter * h, size=pts.shape)

    face = np.arange(nx + 2) / (nx + 1)
    F1, F2 = np.meshgrid(face, face, indexing="ij")
    f = np.stack([F1.ravel(), F2.ravel()], axis=1)
    zeros, ones = np.zeros((f.shape[0], 1)), np.ones((f.shape[0], 1))
    faces = [np.concatenate([f, zeros], axis=1), np.concatenate([f, ones], axis=1),
             np.concatenate([f[:, :1], zeros, f[:, 1:]], axis=1),
             np.concatenate([f[:, :1], ones, f[:, 1:]], axis=1),
             np.concatenate([zeros, f], axis=1), np.concatenate([ones, f], axis=1)]
    bpts = np.unique(np.concatenate(faces, axis=0), axis=0)
    all_pts = np.concatenate([pts, bpts], axis=0)
    bidx = np.arange(pts.shape[0], all_pts.shape[0], dtype=np.int32)
    normals = np.zeros_like(all_pts)
    for axis in range(3):
        normals[bidx[all_pts[bidx, axis] == 0], axis] = 1.0
        normals[bidx[all_pts[bidx, axis] == 1], axis] = -1.0
    # edges and corners: the first face's normal
    active = normals[bidx] != 0
    multi = active.sum(axis=1) > 1
    rows = bidx[multi]
    first = np.argmax(active[multi], axis=1)
    signs = np.sign(normals[rows, first])
    normals[rows] = 0.0
    normals[rows, first] = signs
    return Cloud(all_pts, (bidx,), normals)


GENERATORS = {"square_with_circle": square_with_circle, "box3d": box3d}


def make_clouds(geometry: str, sizes, seed: int) -> list[Cloud]:
    """One cloud a level, coarse to fine, level i seeded ``seed + i``."""
    gen = GENERATORS[geometry]
    return [gen(n, seed + i) for i, n in enumerate(sizes)]
