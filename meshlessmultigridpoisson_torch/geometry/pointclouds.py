"""Scattered point-cloud generators for the reference geometries.

The reference loads gitignored Gmsh meshes (square_{170,...}.msh etc.,
testing_functions.cpp:355-364) and detects boundaries by exact coordinate
tests (x==0 | x==1 | y==0 | y==1, testing_functions.cpp:86; circles by
|r^2 - R^2| <= 1e-10, testing_functions.cpp:101,124).  Since the fixtures are
not in the repo, we generate equivalent scattered clouds directly: exact
boundary points plus jittered-lattice interior points (deterministic, seeded).

Clouds carry: coords [N,2] (or [N,3] for the 3D extension), per-boundary
index lists, outward unit normals at boundary points (analytic per geometry,
matching Grid::build_normal_vecs, grid.cpp:442-518).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PointCloud:
    """A scattered cloud with boundary structure (host-side, numpy).

    ``boundaries`` is a list of index arrays (one per boundary component,
    mirroring the reference's vector<Boundary>, gridclasses.hpp:15-20).
    ``normals`` is dense [N, dim]; zero rows at interior points.
    """

    points: np.ndarray  # [N, dim] float64
    boundaries: list[np.ndarray]  # each [nb] int32
    normals: np.ndarray  # [N, dim] float64
    geomtype: str = "custom"

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def boundary_mask(self) -> np.ndarray:
        m = np.zeros(self.n, dtype=bool)
        for b in self.boundaries:
            m[b] = True
        return m

    def permuted(self, perm: np.ndarray) -> "PointCloud":
        """Reorder points by ``perm`` (new[i] = old[perm[i]]).

        Mirrors Grid::rcm_order_points's remapping of points, normals and
        boundary index lists (grid.cpp:744-774).
        """
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n)
        return PointCloud(
            points=self.points[perm],
            boundaries=[np.sort(inv[b]).astype(np.int32) for b in self.boundaries],
            normals=self.normals[perm],
            geomtype=self.geomtype,
        )


def poisson_disk(
    n_target: int,
    seed: int,
    lo=(0.0, 0.0),
    hi=(1.0, 1.0),
    keep_fn=None,
    boundary_pts: np.ndarray | None = None,
    boundary_clearance: float = 0.9,
) -> np.ndarray:
    """Blue-noise interior sampling (Bridson) with min spacing ~ mesh quality.

    Scattered-point solvers need gmsh-grade local uniformity: jittered
    lattices allow ~0.3h pair gaps, which produce near-degenerate RBF-FD
    stencils whose Neumann condensation collapses interior diagonals
    (measured |offdiag|/|diag| ~ 140) and destabilizes relaxation.  Bridson
    sampling enforces pairwise distance >= r everywhere, matching the
    reference's mesh-generated clouds (testing_functions.cpp:355-364).
    ``keep_fn(pts)->mask`` restricts the domain; ``boundary_pts`` get a
    clearance of ``boundary_clearance * r``.
    """
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    area = float(np.prod(hi - lo))
    r = np.sqrt(0.72 * area / max(n_target, 1))

    # native fast path (csrc/fastgeom.cpp) for the unit box + the shapes the
    # reference geometries need; the generic keep_fn falls back to Python
    if tuple(lo) == (0.0, 0.0) and tuple(hi) == (1.0, 1.0):
        from meshlessmultigridpoisson_torch.geometry import native

        hole = getattr(keep_fn, "_hole", None) if keep_fn is not None else None
        annulus = getattr(keep_fn, "_annulus", None) if keep_fn is not None else None
        if keep_fn is None or hole is not None or annulus is not None:
            pts = native.poisson_disk_native(
                r, seed,
                boundary_pts=boundary_pts,
                clearance=boundary_clearance * r,
                hole=hole or (0.0, 0.0, -1.0),
                annulus=annulus or (-1.0, -1.0),
            )
            if pts is not None:
                return pts

    cell = r / np.sqrt(2)
    dims = np.maximum(((hi - lo) / cell).astype(int) + 1, 1)
    grid = -np.ones(dims, dtype=np.int64)
    samples: list[np.ndarray] = []
    active: list[int] = []

    btree = None
    if boundary_pts is not None and len(boundary_pts):
        from scipy.spatial import cKDTree

        btree = cKDTree(boundary_pts)

    def ok(p):
        if (p < lo).any() or (p >= hi).any():
            return False
        if keep_fn is not None and not keep_fn(p[None, :])[0]:
            return False
        if btree is not None and btree.query(p)[0] < boundary_clearance * r:
            return False
        c = ((p - lo) / cell).astype(int)
        c0 = np.maximum(c - 2, 0)
        c1 = np.minimum(c + 3, dims)
        for i in range(c0[0], c1[0]):
            for j in range(c0[1], c1[1]):
                s = grid[i, j]
                if s >= 0 and np.linalg.norm(samples[s] - p) < r:
                    return False
        return True

    # initial point
    for _ in range(100):
        p = lo + rng.random(2) * (hi - lo)
        if ok(p):
            break
    samples.append(p)
    grid[tuple(((p - lo) / cell).astype(int))] = 0
    active.append(0)

    while active:
        ai = rng.integers(len(active))
        base = samples[active[ai]]
        placed = False
        for _ in range(20):
            rad = r * (1 + rng.random())
            th = 2 * np.pi * rng.random()
            p = base + rad * np.array([np.cos(th), np.sin(th)])
            if ok(p):
                samples.append(p)
                grid[tuple(((p - lo) / cell).astype(int))] = len(samples) - 1
                active.append(len(samples) - 1)
                placed = True
        if not placed:
            active.pop(ai)
    return np.asarray(samples)


def square_cloud(n_target: int, jitter: float = 0.35, seed: int = 0) -> PointCloud:
    """Unit square [0,1]^2; single boundary component on the four edges.

    Interior: Poisson-disk (blue-noise) samples at mesh-grade spacing;
    boundary: uniform edge points at matching density.  Outward-facing
    reference quirk preserved: the stored boundary "normals" point INWARD
    (+y at y==0 etc.), exactly as Grid::build_normal_vecs writes them for
    the square (grid.cpp:449-460); all downstream Neumann algebra in the
    reference is built against these inward normals.
    """
    r = np.sqrt(0.72 / max(n_target, 16))
    nb = max(4, int(round(1.0 / r)))  # boundary points per edge
    t = np.arange(nb) / nb  # [0, 1): covers each corner exactly once
    bottom = np.stack([t, np.zeros(nb)], axis=1)
    right = np.stack([np.ones(nb), t], axis=1)
    top = np.stack([1.0 - t, np.ones(nb)], axis=1)
    left = np.stack([np.zeros(nb), 1.0 - t], axis=1)
    bpts = np.concatenate([bottom, right, top, left], axis=0)

    interior = poisson_disk(n_target, seed, boundary_pts=bpts)
    pts = np.concatenate([interior, bpts], axis=0)
    n = pts.shape[0]
    bidx = np.arange(interior.shape[0], n, dtype=np.int32)

    normals = np.zeros((n, 2))
    x, y = pts[bidx, 0], pts[bidx, 1]
    # Reference order of tests: y==0 -> (0,1); y==1 -> (0,-1); x==0 -> (1,0);
    # x==1 -> (-1,0) (grid.cpp:449-460).
    nvec = np.zeros((bidx.size, 2))
    nvec[y == 0] = (0, 1)
    nvec[y == 1] = (0, -1)
    nvec[(x == 0) & (y != 0) & (y != 1)] = (1, 0)
    nvec[(x == 1) & (y != 0) & (y != 1)] = (-1, 0)
    normals[bidx] = nvec
    return PointCloud(pts, [bidx], normals, geomtype="square")


def _circle_points(nb: int, cx: float, cy: float, r: float, phase: float = 0.0) -> np.ndarray:
    th = 2 * np.pi * (np.arange(nb) / nb) + phase
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)


def square_with_circle_cloud(
    n_target: int, jitter: float = 0.35, seed: int = 0
) -> PointCloud:
    """Unit square with a circular hole (center (.5,.5), radius .25).

    Matches the reference "square_with_circle" geometry: outer boundary on the
    square edges, inner boundary on the circle of radius 0.25
    (testing_functions.cpp:92-106; hole radius^2 = 0.0625).  Circle normals
    point away from the circle center (grid.cpp:480-492).
    """
    r_hole = 0.25
    area = 1.0 - np.pi * r_hole**2
    r = np.sqrt(0.72 * area / max(n_target, 16))
    nb = max(4, int(round(1.0 / r)))
    t = np.arange(nb) / nb
    bottom = np.stack([t, np.zeros(nb)], axis=1)
    right = np.stack([np.ones(nb), t], axis=1)
    top = np.stack([1.0 - t, np.ones(nb)], axis=1)
    left = np.stack([np.zeros(nb), 1.0 - t], axis=1)
    outer_b = np.concatenate([bottom, right, top, left], axis=0)
    nb_inner = max(16, int(round(2 * np.pi * r_hole / r)))
    inner = _circle_points(nb_inner, 0.5, 0.5, r_hole)

    def keep_fn(p):
        return ((p[:, 0] - 0.5) ** 2 + (p[:, 1] - 0.5) ** 2) > r_hole**2

    keep_fn._hole = (0.5, 0.5, r_hole)

    interior = poisson_disk(
        int(n_target / area),  # box-area-based radius -> ~n_target kept points
        seed,
        keep_fn=keep_fn,
        boundary_pts=np.concatenate([outer_b, inner], axis=0),
    )
    pts = np.concatenate([interior, outer_b], axis=0)
    all_pts = np.concatenate([pts, inner], axis=0)
    n = all_pts.shape[0]
    outer_idx = np.arange(interior.shape[0], pts.shape[0], dtype=np.int32)
    inner_idx = np.arange(pts.shape[0], n, dtype=np.int32)

    normals = np.zeros((n, 2))
    x, y = all_pts[outer_idx, 0], all_pts[outer_idx, 1]
    nvec = np.zeros((outer_idx.size, 2))
    nvec[y == 0] = (0, 1)
    nvec[y == 1] = (0, -1)
    nvec[(x == 0) & (y != 0) & (y != 1)] = (1, 0)
    nvec[(x == 1) & (y != 0) & (y != 1)] = (-1, 0)
    normals[outer_idx] = nvec
    d = all_pts[inner_idx] - 0.5
    normals[inner_idx] = d / np.linalg.norm(d, axis=1, keepdims=True)
    return PointCloud(
        all_pts,
        [outer_idx.astype(np.int32), inner_idx],
        normals,
        geomtype="square_with_circle",
    )


def concentric_circles_cloud(
    n_target: int, jitter: float = 0.3, seed: int = 0
) -> PointCloud:
    """Annulus between r=0.25 and r=0.5 centered at (.5,.5).

    Reference geometry "concentric_circles" (testing_functions.cpp:107-135).
    Boundary 0 = outer circle (r=0.5) with normals pointing INWARD toward the
    center (reference stores -(x,y)/|..| for boundary 0, grid.cpp:493-504);
    boundary 1 = inner circle (r=0.25) with normals pointing outward from
    center (grid.cpp:505-515).
    """
    r_in, r_out = 0.25, 0.5
    area = np.pi * (r_out**2 - r_in**2)
    h = np.sqrt(0.72 * area / max(n_target, 16))

    nb_out = max(16, int(round(2 * np.pi * r_out / h)))
    nb_in = max(16, int(round(2 * np.pi * r_in / h)))
    outer = _circle_points(nb_out, 0.5, 0.5, r_out)
    inner = _circle_points(nb_in, 0.5, 0.5, r_in)

    def keep_fn(p):
        rr = (p[:, 0] - 0.5) ** 2 + (p[:, 1] - 0.5) ** 2
        return (rr > r_in**2) & (rr < r_out**2)

    keep_fn._annulus = (r_in, r_out)

    # poisson_disk derives its radius from the full box area; scale the
    # target count so the annulus ends up with ~n_target points at spacing h
    interior = poisson_disk(
        int(n_target / area),
        seed,
        lo=(0.0, 0.0),
        hi=(1.0, 1.0),
        keep_fn=keep_fn,
        boundary_pts=np.concatenate([outer, inner], axis=0),
    )

    all_pts = np.concatenate([interior, outer, inner], axis=0)
    n = all_pts.shape[0]
    outer_idx = np.arange(interior.shape[0], interior.shape[0] + nb_out, dtype=np.int32)
    inner_idx = np.arange(interior.shape[0] + nb_out, n, dtype=np.int32)

    normals = np.zeros((n, 2))
    d_out = all_pts[outer_idx] - 0.5
    normals[outer_idx] = -d_out / np.linalg.norm(d_out, axis=1, keepdims=True)
    d_in = all_pts[inner_idx] - 0.5
    normals[inner_idx] = d_in / np.linalg.norm(d_in, axis=1, keepdims=True)
    return PointCloud(
        all_pts, [outer_idx, inner_idx], normals, geomtype="concentric_circles"
    )


def box3d_cloud(n_target: int, jitter: float = 0.3, seed: int = 0) -> PointCloud:
    """Unit cube [0,1]^3 cloud — the designed 3D extension.

    The reference is strictly 2D (``distance`` drops z,
    general_computation_functions.cpp:4-6); this generator supports the
    3D/BASELINE config-3 path.
    """
    rng = np.random.default_rng(seed)
    nx = max(2, int(round(n_target ** (1.0 / 3.0) - 1)))
    xs = (np.arange(1, nx + 1)) / (nx + 1)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    h = 1.0 / (nx + 1)
    pts += rng.uniform(-jitter * h, jitter * h, size=pts.shape)

    nb = nx + 2
    face = (np.arange(nb)) / (nb - 1)
    F1, F2 = np.meshgrid(face, face, indexing="ij")
    f = np.stack([F1.ravel(), F2.ravel()], axis=1)
    zeros = np.zeros((f.shape[0], 1))
    ones = np.ones((f.shape[0], 1))
    faces = [
        np.concatenate([f, zeros], axis=1),
        np.concatenate([f, ones], axis=1),
        np.concatenate([f[:, :1], zeros, f[:, 1:]], axis=1),
        np.concatenate([f[:, :1], ones, f[:, 1:]], axis=1),
        np.concatenate([zeros, f], axis=1),
        np.concatenate([ones, f], axis=1),
    ]
    bpts = np.unique(np.concatenate(faces, axis=0), axis=0)
    all_pts = np.concatenate([pts, bpts], axis=0)
    n = all_pts.shape[0]
    bidx = np.arange(pts.shape[0], n, dtype=np.int32)
    normals = np.zeros((n, 3))
    for axis in range(3):
        at0 = all_pts[bidx, axis] == 0
        at1 = all_pts[bidx, axis] == 1
        normals[bidx[at0], axis] = 1.0
        normals[bidx[at1], axis] = -1.0
    # Edge/corner points lie on 2-3 faces; snap their normal to the FIRST
    # active axis (the 2D square's corner convention).  A diagonal normal
    # can zero the n.grad row's self-weight, breaking the boundary
    # row-solve (grid.cpp:92-97 divides by it) and condensation.
    # (Vectorized: at 1M points / ~60k boundary points a Python loop here
    # costs minutes of setup.)
    bn = normals[bidx]
    active = bn != 0
    multi = active.sum(axis=1) > 1
    if multi.any():
        rows = bidx[multi]
        first_ax = np.argmax(active[multi], axis=1)
        signs = np.sign(normals[rows, first_ax])
        normals[rows] = 0.0
        normals[rows, first_ax] = signs
    nrm = np.linalg.norm(normals[bidx], axis=1, keepdims=True)
    normals[bidx] /= np.maximum(nrm, 1e-300)
    return PointCloud(all_pts, [bidx], normals, geomtype="box3d")


_GENERATORS = {
    "square": square_cloud,
    "square_with_circle": square_with_circle_cloud,
    "concentric_circles": concentric_circles_cloud,
    "box3d": box3d_cloud,
}


def make_cloud(geomtype: str, n_target: int, seed: int = 0) -> PointCloud:
    try:
        gen = _GENERATORS[geomtype]
    except KeyError:
        raise ValueError(
            f"unknown geomtype {geomtype!r}; options: {sorted(_GENERATORS)}"
        ) from None
    return gen(n_target, seed=seed)
