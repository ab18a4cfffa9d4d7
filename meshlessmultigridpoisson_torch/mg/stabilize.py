"""Setup-time smoother stabilization by localized under-relaxation.

Port of the reference package's ``mg/stabilize.py``: power-iterate the
homogeneous one-sweep error propagation with the plain f64 smoother on the
host, and while the estimated spectral radius is >= target, damp omega on
the rows where the dominant error mode concentrates (omega_scale *= damp),
re-estimate, repeat.  Any per-row omega keeps the fixed point.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meshlessmultigridpoisson_torch.ops import smoothers as sm
from meshlessmultigridpoisson_torch.stencil.operators import LevelOperator


def estimate_smoother_rho(
    op: LevelOperator, sweeps: int = 20, seed: int = 0
) -> tuple[float, np.ndarray]:
    """Power-iterate one-sweep error propagation; returns (rho, |mode|)."""
    rng = np.random.default_rng(seed)
    smask = op.smooth_mask.numpy() > 0
    e = torch.from_numpy(np.where(smask, rng.standard_normal(op.n_pad), 0.0))
    el = torch.zeros((), dtype=e.dtype)
    z = torch.zeros(op.n_pad, dtype=e.dtype)
    zl = torch.zeros((), dtype=e.dtype)
    nrm = torch.ones((), dtype=e.dtype)
    for _ in range(sweeps):
        e2, el2 = sm.smooth(op, e, el, z, zl, iters=1)
        nrm = torch.sqrt(torch.sum(e2 * e2) + el2 * el2)
        e, el = e2 / nrm, el2 / nrm
    return float(nrm), np.abs(e.numpy())


def stabilize_level(
    op: LevelOperator,
    target_rho: float = 0.995,
    damp: float = 0.5,
    mode_quantile: float = 0.995,
    max_rounds: int = 10,
    sweeps: int = 20,
) -> LevelOperator:
    """Damp unstable rows until the smoother's estimated rho < target."""
    for _ in range(max_rounds):
        rho, mode = estimate_smoother_rho(op, sweeps=sweeps)
        if rho < target_rho:
            break
        sel = mode[np.isfinite(mode) & (mode > 0)]
        if sel.size == 0:
            raise ValueError(
                "smoother power iteration produced no finite mode "
                f"(rho={rho}); the operator likely has zero/NaN rows"
            )
        thresh = np.quantile(sel, mode_quantile)
        bad = mode >= max(thresh, 1e-30)
        scale = op.omega_scale.numpy().copy()
        scale[bad] *= damp
        op = dataclasses.replace(op, omega_scale=torch.from_numpy(scale))
    return op
