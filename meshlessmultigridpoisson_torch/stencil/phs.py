"""Polyharmonic-spline + polynomial RBF-FD weights, batched.

Same numerics as the reference package's ``stencil/phs.py`` (stencil shift
and scale by the neighbor set's extent, saddle system [[Phi, P], [P^T, 0]]
with Phi_ij = r_ij^rbf_exp, analytic RHS with the r -> 0 guards, un-scaling
by 1/scale or 1/scale^2).  Here each chunk of stencils is one batched f64
``torch.linalg.solve_ex`` on the given device: the host CPU for tests and
small problems, the GPU for production-size setups.
"""

from __future__ import annotations

import numpy as np
import torch


def monomial_exponents(poly_deg: int, dim: int = 2) -> np.ndarray:
    """Exponent table [P, dim] in the reference's ordering.

    2D: for p in 0..deg, for q in 0..p -> x^(p-q) y^q (grid.cpp:287-297).
    3D (designed extension): graded lexicographic over total degree.
    """
    exps = []
    if dim == 2:
        for p in range(poly_deg + 1):
            for q in range(p + 1):
                exps.append((p - q, q))
    elif dim == 3:
        for p in range(poly_deg + 1):
            for i in range(p + 1):
                for j in range(p - i + 1):
                    exps.append((p - i - j, i, j))
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    return np.asarray(exps, dtype=np.int64)


def _powfix(base: torch.Tensor, expo: torch.Tensor) -> torch.Tensor:
    """x**e with 0**0 = 1 and 0 wherever e < 0 (derivative of a constant)."""
    return torch.where(expo >= 0, base ** expo.clamp(min=0), torch.zeros_like(base))


_OPS = ("laplace", "dx", "dy", "dz", "interp")


def _weights_chunk(pts, ev, exps_np, rbf_exp, op, dim):
    """Weights [c, k] for c stencils ``pts`` [c, k, d] at ``ev`` [c, d]."""
    c, k, _ = pts.shape
    e = torch.as_tensor(exps_np, dtype=pts.dtype, device=pts.device)  # [P, d]
    npoly = e.shape[0]
    lo = pts.amin(dim=1)
    scale = (pts.amax(dim=1) - lo).amax(dim=1)  # [c]
    s = (pts - lo[:, None, :]) / scale[:, None, None]
    se = (ev - lo) / scale[:, None]

    # distances via vector_norm rather than torch.sqrt: on some x86 hosts the
    # first parallel elementwise torch.sqrt of a process has returned ~4e-11
    # relative errors on one worker thread's chunk, which the saddle systems
    # amplify to ~1e-8 in the weights; the norm reduction has not shown it
    phi = torch.linalg.vector_norm(s[:, :, None, :] - s[:, None, :, :], dim=-1) ** rbf_exp
    pmat = torch.prod(s[:, :, None, :] ** e[None, None], dim=-1)  # [c, k, P]
    top = torch.cat([phi, pmat], dim=2)
    bot = torch.cat(
        [pmat.transpose(1, 2), pts.new_zeros(c, npoly, npoly)], dim=2)
    amat = torch.cat([top, bot], dim=1)

    d = se[:, None, :] - s  # [c, k, dim]
    r = torch.linalg.vector_norm(d, dim=-1)
    m = float(rbf_exp)
    if op == "interp":
        rbf = r ** rbf_exp
        poly = torch.prod(se[:, None, :] ** e[None], dim=-1)
        unscale = torch.ones_like(scale)
    elif op == "laplace":
        # lap r^M = M (M + d - 2) r^(M-2), guarded at r = 0 (grid.cpp:397-401)
        safe = torch.where(r > 0, r, torch.ones_like(r))
        rbf = torch.where(r > 0, m * (m + dim - 2.0) * safe ** (m - 2),
                          torch.zeros_like(r))
        poly = torch.zeros(c, npoly, dtype=pts.dtype, device=pts.device)
        for ax in range(dim):
            ea = e[:, ax]
            elow = e.clone()
            elow[:, ax] -= 2
            term = (ea * (ea - 1)) * torch.prod(_powfix(se[:, None, :], elow[None]), -1)
            poly = poly + torch.where(ea >= 2, term, torch.zeros_like(term))
        unscale = 1.0 / scale**2
    elif op in ("dx", "dy", "dz"):
        axis = {"dx": 0, "dy": 1, "dz": 2}[op]
        safe_r = torch.where(r > 0, r, torch.ones_like(r))
        rbf = torch.where(r > 0, m * safe_r ** (m - 2) * d[..., axis],
                          torch.zeros_like(r))
        ed = e[:, axis]
        elow = e.clone()
        elow[:, axis] -= 1
        poly = ed * torch.prod(_powfix(se[:, None, :], elow[None]), -1)
        poly = torch.where(ed > 0, poly, torch.zeros_like(poly))
        unscale = 1.0 / scale
    else:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")

    rhs = torch.cat([rbf, poly], dim=1)
    w, info = torch.linalg.solve_ex(amat, rhs)
    w = w[:, :k] * unscale[:, None]
    # an exactly singular saddle system (degenerate neighborhood) gives NaN
    # rows, as the reference's LU does; callers decide how to repair them
    return torch.where((info != 0)[:, None], torch.full_like(w, float("nan")), w)


def batched_weights(
    points,  # [N, d] cloud coords
    neighbors,  # [M, k] stencil tables
    eval_points,  # [M, d] evaluation points
    *,
    op: str,
    poly_deg: int,
    rbf_exp: int = 3,
    chunk: int = 4096,
    device=None,
) -> torch.Tensor:
    """RBF-FD weights [M, k] (f64, on ``device``) for ``op`` at each eval point.

    Inputs may be numpy arrays or tensors; they are moved to ``device``
    (default CPU) and solved ``chunk`` stencils at a time.
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    pts = torch.as_tensor(points, dtype=torch.float64, device=device)
    nbr = torch.as_tensor(neighbors, dtype=torch.int64, device=device)
    ev = torch.as_tensor(eval_points, dtype=torch.float64, device=device)
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    mq, k = nbr.shape
    dim = pts.shape[1]
    exps = monomial_exponents(poly_deg, dim)
    out = torch.empty(mq, k, dtype=torch.float64, device=device)
    for c0 in range(0, mq, chunk):
        c1 = min(c0 + chunk, mq)
        out[c0:c1] = _weights_chunk(pts[nbr[c0:c1]], ev[c0:c1], exps, rbf_exp, op, dim)
    return out
