"""The generic multigrid V-cycle engine.

Port of the reference package's ``mg/vcycle.py``: levels are a tuple ordered
coarse -> fine, and the level loop is a Python loop (PyTorch runs eagerly,
so the JAX trace-time unroll and ``lax.scan`` become plain loops).  The
engine is backend-agnostic: it calls ``ops.smoothers`` (which dispatches on
LevelOperator / GpuLevel) and ``ops.ell.spmv`` (EllMatrix oracle / DeviceEll
CUDA kernel) for the transfers.

Reference semantics per step (multigrid.cpp:62-110):
  * per cycle, the finest relative L1 residual is computed BEFORE any
    smoothing (:66-69), then the fine Neumann rows re-solved;
  * descend: coarse values zeroed, Dirichlet pinned (g on fine, 0 coarse),
    pre-smooth, restrict the Dirichlet-zeroed residual, zero the restricted
    source at coarse Dirichlet points, zero Neumann slots + border slot
    (:71-88);
  * coarsest: zero guess, TWO smoother calls (:91-95);
  * ascend: prolong, zero correction at Dirichlet points (non-Neumann grids
    only, :103-105), add, post-smooth (:98-109);
  * single-level fallback: just smooth (FracStepMultigrid.cpp:64-67).
"""

from __future__ import annotations

import dataclasses

import torch

from meshlessmultigridpoisson_torch.ops import smoothers as sm
from meshlessmultigridpoisson_torch.ops.ell import spmv


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Levels coarse->fine plus transfer operators.

    ``restrict[i]`` maps a level-(i+1) residual to the level-i source;
    ``prolong[i]`` maps level-i values to a level-(i+1) correction.
    """

    levels: tuple
    restrict: tuple  # len L-1
    prolong: tuple  # len L-1

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def finest(self):
        return self.levels[-1]


@dataclasses.dataclass(frozen=True)
class MGState:
    """Per-level solution/source vectors (each padded to its level's n_pad)."""

    x: tuple
    x_lag: tuple
    b: tuple
    b_lag: tuple

    def replace_level(self, i: int, **kw) -> "MGState":
        def upd(field, name):
            if name in kw:
                lst = list(field)
                lst[i] = kw[name]
                return tuple(lst)
            return field

        return MGState(
            x=upd(self.x, "x"),
            x_lag=upd(self.x_lag, "x_lag"),
            b=upd(self.b, "b"),
            b_lag=upd(self.b_lag, "b_lag"),
        )


def _dev(op) -> torch.device:
    return op.smooth_mask.device


def init_state(hier: Hierarchy, b_fine_logical: torch.Tensor, dtype=None) -> MGState:
    """Zero solution; fine source = b (scattered to permuted padded rows)."""
    xs, xl, bs, bl = [], [], [], []
    for i, op in enumerate(hier.levels):
        dt = dtype or op.smooth_mask.dtype
        dev = _dev(op)
        xs.append(torch.zeros(op.n_pad, dtype=dt, device=dev))
        xl.append(torch.zeros((), dtype=dt, device=dev))
        if i == hier.num_levels - 1:
            bs.append(op.to_padded(b_fine_logical.to(dtype=dt, device=dev)))
        else:
            bs.append(torch.zeros(op.n_pad, dtype=dt, device=dev))
        bl.append(torch.zeros((), dtype=dt, device=dev))
    return MGState(x=tuple(xs), x_lag=tuple(xl), b=tuple(bs), b_lag=tuple(bl))


def init_like(hier: Hierarchy, dtype=None) -> MGState:
    """All-zero state (solution AND source) shaped for ``hier``."""
    def z(op, shape):
        return torch.zeros(shape, dtype=dtype or op.smooth_mask.dtype, device=_dev(op))

    return MGState(
        x=tuple(z(op, op.n_pad) for op in hier.levels),
        x_lag=tuple(z(op, ()) for op in hier.levels),
        b=tuple(z(op, op.n_pad) for op in hier.levels),
        b_lag=tuple(z(op, ()) for op in hier.levels),
    )


def mg_residual(hier: Hierarchy, state: MGState):
    """Finest-grid relative L1 residual (multigrid.cpp:112-115)."""
    L = hier.num_levels - 1
    return sm.relative_residual_l1(
        hier.levels[L], state.x[L], state.x_lag[L], state.b[L], state.b_lag[L]
    )


def v_cycle(hier: Hierarchy, state: MGState, residual: bool = True):
    """One V-cycle; returns (new_state, pre-cycle finest relative residual).

    ``residual=False`` skips the (unused) residual when the cycle serves as
    a preconditioner — the JAX engine's compiler drops it there; an eager
    engine has to be told — and returns None in its place.
    """
    L = hier.num_levels
    fine = L - 1
    resid = mg_residual(hier, state) if residual else None

    if L == 1:
        op = hier.levels[0]
        x, xl = sm.smooth(op, state.x[0], state.x_lag[0], state.b[0], state.b_lag[0])
        return state.replace_level(0, x=x, x_lag=xl), resid

    op_f = hier.levels[fine]
    xf = sm.bound_eval_neumann(op_f, state.x[fine], state.b[fine])
    state = state.replace_level(fine, x=xf)

    # ---- descend ----
    for i in range(fine, 0, -1):
        op = hier.levels[i]
        x, xl, b, bl = state.x[i], state.x_lag[i], state.b[i], state.b_lag[i]
        if i != fine:
            x = torch.zeros_like(x)
            xl = torch.zeros_like(xl)
        x = sm.apply_dirichlet(op, x, coarse=(i != fine))
        x, xl = sm.smooth(op, x, xl, b, bl)
        r, _ = sm.residual(op, x, xl, b, bl)

        opc = hier.levels[i - 1]
        bc = spmv(hier.restrict[i - 1], r)
        bc = sm.zero_dirichlet(opc, bc)
        blc = state.b_lag[i - 1]
        if op.has_lagrange:
            blc = torch.zeros_like(blc)
            bc = torch.where(opc.neumann_mask > 0, torch.zeros_like(bc), bc)
        state = state.replace_level(i, x=x, x_lag=xl)
        state = state.replace_level(i - 1, b=bc, b_lag=blc)

    # ---- coarsest: zero guess, double smooth (multigrid.cpp:91-95) ----
    op0 = hier.levels[0]
    x0 = torch.zeros_like(state.x[0])
    xl0 = torch.zeros_like(state.x_lag[0])
    x0, xl0 = sm.smooth(op0, x0, xl0, state.b[0], state.b_lag[0])
    x0, xl0 = sm.smooth(op0, x0, xl0, state.b[0], state.b_lag[0])
    state = state.replace_level(0, x=x0, x_lag=xl0)

    # ---- ascend ----
    for i in range(1, L):
        op = hier.levels[i]
        corr = spmv(hier.prolong[i - 1], state.x[i - 1])
        if not op.has_lagrange:
            corr = sm.zero_dirichlet(op, corr)
        x = state.x[i] + corr
        x, xl = sm.smooth(op, x, state.x_lag[i], state.b[i], state.b_lag[i])
        state = state.replace_level(i, x=x, x_lag=xl)

    return state, resid


def run_v_cycles(hier: Hierarchy, state: MGState, num_cycles: int):
    """Fixed cycle count; returns (state, residual_history [num_cycles])."""
    hist = []
    for _ in range(num_cycles):
        state, resid = v_cycle(hier, state)
        hist.append(resid)
    return state, torch.stack(hist)


def solve_to_tolerance(hier: Hierarchy, state: MGState, tol, max_cycles: int = 200):
    """Cycle until the finest relative residual < tol (the PPE loop,
    FractionalStepSim.cpp:139-142), with fine Neumann rows re-solved after
    each cycle (:141).  Returns (state, cycles_used, final_residual)."""
    fine = hier.num_levels - 1
    op = hier.levels[fine]
    resid = float(mg_residual(hier, state))
    cycles = 0
    while resid >= tol and cycles < max_cycles:
        state, _ = v_cycle(hier, state, residual=False)
        xf = sm.bound_eval_neumann(op, state.x[fine], state.b[fine])
        state = state.replace_level(fine, x=xf)
        resid = float(mg_residual(hier, state))
        cycles += 1
    return state, cycles, resid
