"""Gmsh v2 ``.msh`` and plain-text point ingest.

Port of the reference package's ``geometry/msh.py`` (host numpy, no
torch), itself the replacement of fileReadingFunctions.{h,cpp}:
pointsFromMshFile parses the $Nodes section (fileReadingFunctions.cpp:
6-32), pointsFromTxts reads one "x y z"-per-line (":33-57"),
boundPtsConnFromMsh recovers boundary chains from $Elements types 1/2/15
(":80-150").  We parse $Nodes and the line elements; unlike the reference
we validate input instead of crashing on a bad fopen
(fileReadingFunctions.cpp:12).
"""

from __future__ import annotations

import numpy as np

from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud


def read_msh_points(path: str) -> np.ndarray:
    """Coordinates [N, 3] from a Gmsh v2 ASCII file's $Nodes section."""
    with open(path) as f:
        lines = f.read().splitlines()
    try:
        start = lines.index("$Nodes")
    except ValueError:
        raise ValueError(f"{path}: no $Nodes section (not a Gmsh v2 ASCII file?)")
    count = int(lines[start + 1])
    pts = np.empty((count, 3), dtype=np.float64)
    for i in range(count):
        parts = lines[start + 2 + i].split()
        # "<id> <x> <y> <z>"
        pts[i] = [float(parts[1]), float(parts[2]), float(parts[3])]
    return pts


def read_msh_boundary_edges(path: str) -> np.ndarray:
    """[E, 2] node-index pairs of 2-node line elements (type 1), 0-based.

    Equivalent to the connectivity recovered by boundPtsConnFromMsh
    (fileReadingFunctions.cpp:80-150); used for mesh-derived boundary
    normals when analytic geometry normals are unavailable.
    """
    with open(path) as f:
        lines = f.read().splitlines()
    try:
        start = lines.index("$Elements")
    except ValueError:
        return np.zeros((0, 2), dtype=np.int64)
    count = int(lines[start + 1])
    edges = []
    for i in range(count):
        parts = lines[start + 2 + i].split()
        etype = int(parts[1])
        if etype == 1:  # 2-node line
            ntags = int(parts[2])
            a, b = parts[3 + ntags : 5 + ntags]
            edges.append((int(a) - 1, int(b) - 1))
    return np.asarray(edges, dtype=np.int64).reshape(-1, 2)


def read_txt_points(path: str) -> np.ndarray:
    """Coordinates from a whitespace-separated text file, one point per line."""
    pts = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if pts.shape[1] == 2:
        pts = np.concatenate([pts, np.zeros((pts.shape[0], 1))], axis=1)
    return pts


# ---------------------------------------------------------------------------
# .msh -> PointCloud (the end-to-end ingest path)
# ---------------------------------------------------------------------------


def boundary_components(edges: np.ndarray, n: int) -> list[np.ndarray]:
    """Connected components of the boundary-edge graph, as index arrays.

    The reference recovers per-boundary connectivity chains from the same
    line elements (boundPtsConnFromMsh, fileReadingFunctions.cpp:80-150) and
    carries one Boundary struct per component (gridclasses.hpp:15-20).
    """
    if edges.size == 0:
        return []
    parent = np.arange(n, dtype=np.int64)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    on_boundary = np.zeros(n, dtype=bool)
    on_boundary[edges.ravel()] = True
    roots = np.array([find(i) if on_boundary[i] else -1 for i in range(n)])
    comps = []
    for r in np.unique(roots):
        if r < 0:
            continue
        comps.append(np.flatnonzero(roots == r).astype(np.int32))
    # deterministic order: by smallest member index
    comps.sort(key=lambda c: int(c[0]))
    return comps


def chain_normals(
    points: np.ndarray, edges: np.ndarray, interior: np.ndarray
) -> np.ndarray:
    """Mesh-derived, domain-INWARD unit normals at boundary nodes.

    This is the general mesh-connectivity path the reference stubbed out
    (grid.cpp:462-479 is commented-out; only analytic per-geometry normals
    shipped, grid.cpp:442-518).  At each boundary node the tangent is the
    angle-bisecting average of its two chain edge directions; the normal is
    the perpendicular, oriented toward the domain interior — matching the
    reference's convention that stored normals point INTO the domain at
    every geometry (square (0,1) at y=0, grid.cpp:449-460; annulus outer
    -(x,y)/r, grid.cpp:493-504; hole +(x,y)/r, grid.cpp:480-492).

    ``interior`` = coordinates of non-boundary nodes, used only to pick the
    inward sign (nearest interior points' mean direction).
    """
    from scipy.spatial import cKDTree

    n = points.shape[0]
    normals = np.zeros((n, 2))
    if edges.size == 0:
        return normals
    nbrs: dict[int, list[int]] = {}
    for a, b in edges:
        nbrs.setdefault(int(a), []).append(int(b))
        nbrs.setdefault(int(b), []).append(int(a))
    itree = cKDTree(interior) if len(interior) else None
    for i, adj in nbrs.items():
        p = points[i]
        if len(adj) >= 2:
            d1 = points[adj[0]] - p
            d2 = p - points[adj[1]]
            d1 /= max(np.linalg.norm(d1), 1e-300)
            d2 /= max(np.linalg.norm(d2), 1e-300)
            t = d1 + d2
            if np.linalg.norm(t) < 1e-12:  # degenerate hairpin: use one edge
                t = d1
        else:  # open-chain end: single edge tangent
            t = points[adj[0]] - p
        t /= max(np.linalg.norm(t), 1e-300)
        nv = np.array([-t[1], t[0]])
        if itree is not None:
            _, idx = itree.query(p, k=min(6, len(interior)))
            inward = interior[np.atleast_1d(idx)].mean(axis=0) - p
            if np.dot(nv, inward) < 0:
                nv = -nv
        normals[i] = nv
    return normals


def pointcloud_from_msh(path: str, geomtype: str = "msh"):
    """Gmsh v2 ``.msh`` file -> PointCloud (coords, boundary components,
    mesh-derived inward normals) — the full ingest path the reference runs
    at every grid setup (pointsFromMshFile + boundPtsConnFromMsh,
    FractionalStepSim.cpp:5, fileReadingFunctions.cpp:6-150).

    ``geomtype`` tags the cloud (selects manufactured solutions downstream);
    the geometry itself comes entirely from the file.
    """
    pts3 = read_msh_points(path)
    pts = pts3[:, :2]  # reference distance() drops z
    edges = read_msh_boundary_edges(path)
    comps = boundary_components(edges, pts.shape[0])
    bmask = np.zeros(pts.shape[0], dtype=bool)
    for c in comps:
        bmask[c] = True
    normals = chain_normals(pts, edges, pts[~bmask])
    return PointCloud(points=pts, boundaries=comps, normals=normals,
                      geomtype=geomtype)


def write_msh(path: str, points: np.ndarray,
              boundary_loops: list[np.ndarray],
              triangles: np.ndarray | None = None) -> None:
    """Write a Gmsh v2.2 ASCII file: $Nodes + type-1 boundary line elements
    (consecutive pairs around each loop, wrapping) + optional type-2
    triangles.  Produces files the reference's own reader accepts
    (fileReadingFunctions.cpp:6-32, 80-150)."""
    n = points.shape[0]
    z = np.zeros(n) if points.shape[1] == 2 else points[:, 2]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(n)]
    for i in range(n):
        lines.append(f"{i + 1} {points[i, 0]:.17g} {points[i, 1]:.17g} {z[i]:.17g}")
    lines.append("$EndNodes")
    elems = []
    for loop in boundary_loops:
        for j in range(len(loop)):
            a = int(loop[j]) + 1
            b = int(loop[(j + 1) % len(loop)]) + 1
            elems.append(f"1 2 0 0 {a} {b}")
    if triangles is not None:
        for t in triangles:
            elems.append(f"2 2 0 0 {t[0] + 1} {t[1] + 1} {t[2] + 1}")
    lines += ["$Elements", str(len(elems))]
    lines += [f"{i + 1} {e}" for i, e in enumerate(elems)]
    lines += ["$EndElements", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
