"""RBF-FD stencils of the reference program: neighbours and PHS weights.

Frozen from ``meshlessmultigridpoisson_torch/geometry/neighbors.py``
(``knn``) and ``stencil/phs.py`` (``monomial_exponents``,
``_weights_chunk`` for the Laplacian and the first derivatives) at commit
57ee902, in plain NumPy, SciPy and PyTorch.  The numerics are the reference
program's (grid.cpp:216-401): the query point first in its own stencil, a
Neumann boundary point's other neighbours interior points only; each
stencil shifted by its minimum and scaled by its largest coordinate range;
the saddle system [[Phi, P], [P^T, 0]] with Phi_ij = r_ij^rbf_exp solved
in float64 for the operator's analytic right-hand side.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree


def knn(points: np.ndarray, k: int, boundary_mask: np.ndarray, neumann: bool) -> np.ndarray:
    """[n, k] int64 neighbour table, nearest first (the point itself first);
    with ``neumann`` a boundary point's other k-1 neighbours are the
    nearest interior points."""
    _, idx = cKDTree(points).query(points, k=k, workers=-1)
    idx = np.atleast_2d(idx).astype(np.int64)
    if neumann and boundary_mask.any():
        bidx = np.nonzero(boundary_mask)[0]
        interior = np.nonzero(~boundary_mask)[0]
        _, iidx = cKDTree(points[interior]).query(points[bidx], k=k - 1, workers=-1)
        idx[bidx, 0] = bidx
        idx[bidx, 1:] = interior[np.atleast_2d(iidx)]
    return idx


def monomial_exponents(poly_deg: int, dim: int) -> np.ndarray:
    """[P, dim]: 2D x^(p-q) y^q for p in 0..deg, q in 0..p (grid.cpp:287-297);
    3D graded lexicographic."""
    exps = []
    for p in range(poly_deg + 1):
        if dim == 2:
            exps += [(p - q, q) for q in range(p + 1)]
        else:
            exps += [(p - i - j, i, j) for i in range(p + 1) for j in range(p - i + 1)]
    return np.asarray(exps, dtype=np.int64)


def _powfix(base, expo):
    """base**expo with 0**0 = 1 and 0 where expo < 0."""
    return torch.where(expo >= 0, base ** expo.clamp(min=0), torch.zeros_like(base))


def _chunk(pts, ev, exps, rbf_exp, op):
    """Weights [c, k] of ``op`` ("laplace", "dx", "dy", "dz") for the c
    stencils ``pts`` [c, k, d] at ``ev`` [c, d]."""
    c, k, dim = pts.shape
    e = torch.as_tensor(exps, dtype=pts.dtype, device=pts.device)
    npoly = e.shape[0]
    lo = pts.amin(dim=1)
    scale = (pts.amax(dim=1) - lo).amax(dim=1)
    s = (pts - lo[:, None, :]) / scale[:, None, None]
    se = (ev - lo) / scale[:, None]
    phi = torch.linalg.vector_norm(s[:, :, None, :] - s[:, None, :, :], dim=-1) ** rbf_exp
    pmat = torch.prod(s[:, :, None, :] ** e[None, None], dim=-1)
    amat = torch.cat([torch.cat([phi, pmat], dim=2),
                      torch.cat([pmat.transpose(1, 2), pts.new_zeros(c, npoly, npoly)], dim=2)],
                     dim=1)
    d = se[:, None, :] - s
    r = torch.linalg.vector_norm(d, dim=-1)
    safe = torch.where(r > 0, r, torch.ones_like(r))
    m = float(rbf_exp)
    if op == "laplace":
        # lap r^m = m (m + d - 2) r^(m-2), 0 at r = 0 (grid.cpp:397-401)
        rbf = torch.where(r > 0, m * (m + dim - 2.0) * safe ** (m - 2), torch.zeros_like(r))
        poly = torch.zeros(c, npoly, dtype=pts.dtype, device=pts.device)
        for ax in range(dim):
            ea = e[:, ax]
            elow = e.clone()
            elow[:, ax] -= 2
            term = (ea * (ea - 1)) * torch.prod(_powfix(se[:, None, :], elow[None]), -1)
            poly = poly + torch.where(ea >= 2, term, torch.zeros_like(term))
        unscale = 1.0 / scale**2
    else:
        axis = {"dx": 0, "dy": 1, "dz": 2}[op]
        rbf = torch.where(r > 0, m * safe ** (m - 2) * d[..., axis], torch.zeros_like(r))
        ed = e[:, axis]
        elow = e.clone()
        elow[:, axis] -= 1
        poly = ed * torch.prod(_powfix(se[:, None, :], elow[None]), -1)
        poly = torch.where(ed > 0, poly, torch.zeros_like(poly))
        unscale = 1.0 / scale
    w, info = torch.linalg.solve_ex(amat, torch.cat([rbf, poly], dim=1))
    w = w[:, :k] * unscale[:, None]
    return torch.where((info != 0)[:, None], torch.full_like(w, float("nan")), w)


def weights(points: np.ndarray, neighbors: np.ndarray, eval_points: np.ndarray, op: str,
            poly_deg: int, rbf_exp: int, device, chunk: int = 4096) -> np.ndarray:
    """[m, k] float64 weights of ``op`` at ``eval_points``, solved on
    ``device`` ``chunk`` stencils at a time."""
    pts = torch.as_tensor(points, dtype=torch.float64, device=device)
    nbr = torch.as_tensor(neighbors, dtype=torch.int64, device=device)
    ev = torch.as_tensor(eval_points, dtype=torch.float64, device=device)
    exps = monomial_exponents(poly_deg, pts.shape[1])
    out = np.empty(tuple(nbr.shape))
    for c0 in range(0, nbr.shape[0], chunk):
        c1 = min(c0 + chunk, nbr.shape[0])
        out[c0:c1] = _chunk(pts[nbr[c0:c1]], ev[c0:c1], exps, rbf_exp, op).cpu().numpy()
    return out
