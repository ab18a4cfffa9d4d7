"""GPU execution backend: LevelOperator -> GpuLevel over the CUDA kernels.

Counterpart of the reference package's ``mg/tpu_backend.py``.  The V-cycle
engine (mg/vcycle.py) calls ``ops.smoothers``, which dispatches here when
handed a GpuLevel.  A GpuLevel repacks a host-built f64 LevelOperator into
the kernels' layouts on ``device``:

* the level matrix as a row-major ELL with global int32 columns
  (``ops.gpu_kernels.DeviceEll``), for ``ell_spmv``;
* the one-shot block GS tables for ``block_oneshot_sweep``: per-block
  K = (D/omega + L)^-1 with omega * omega_scale and the smooth mask folded
  in (f32, f64, or bf16 under ``k_dtype``), and the block execution order.
  ``sweep_order="colored"``: colored (one phase per color) on levels with
  at least 32 blocks of 128 rows ("v8-colored", the reference's
  ``prepare_colored_sweep`` threshold), storage order otherwise.
  ``sweep_order="exact"``: storage order on every level, the matvec on the
  ``spmv6`` role throughout (the reference keeps ``kell6`` there).  A
  storage-order level is "v6-oneshot" (role ``sweep6``) where the
  reference's union-scratch tables would need more than 32 slots
  (``ops.gpu_kernels.union_slots``), "v7-exact" (``sweep7``) otherwise;
  both launch the same single-CTA chain;
* the Neumann boundary rows (``bound``) and the condensation rows
  (``cond``) as compact tables for ``compact_rows``, and the Lagrange
  rank-1 border (``lag_col``, ``lag_row``) as vectors.

Semantics match the reference backend: same (block, class) Gauss-Seidel,
then the Lagrange-row relax, then the exact Neumann boundary-row re-solve,
after every sweep; the same bordered matvec and RHS pushdown — in the
kernels' precision (f32 by default; tight tolerances come from the f64
outer loop of mg/mixed.py).  On CPU tensors the kernels' plain PyTorch
versions run instead, so ``--device cpu`` exercises the identical flow.
The Lagrange unknown stays a 0-dim tensor on the device throughout: the
sweep loop adds no host sync.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meshlessmultigridpoisson_torch.mg.vcycle import Hierarchy
from meshlessmultigridpoisson_torch.ops.ell import global_cols
from meshlessmultigridpoisson_torch.ops.gpu_kernels import (
    LANES,
    BlockSweep,
    DeviceCompact,
    DeviceEll,
    block_oneshot_sweep,
    UNION_MAX_SLOTS,
    block_patches,
    build_oneshot_K,
    color_blocks,
    colored_order,
    compact_rows,
    device_compact,
    device_ell,
    ell_spmv,
    union_slots,
)
from meshlessmultigridpoisson_torch.stencil.operators import CompactRows, LevelOperator

# below this many 128-row blocks the colored sweep loses to the storage-order
# chain (reference ops/kernels8.py prepare_colored_sweep, min_blocks=32)
MIN_COLORED_BLOCKS = 32
SWEEP_ORDERS = ("colored", "exact")


@dataclasses.dataclass(frozen=True)
class GpuLevel:
    """Per-level data in kernel-ready layouts on one device (the fields of
    the reference's ``TpuLevel`` that the solve path reads)."""

    A: DeviceEll
    sweep: BlockSweep | None  # None: matvec-only (the f64 outer operator)
    bound: DeviceCompact  # Neumann boundary rows ("bound2"; empty if none)
    cond: DeviceCompact  # condensation rows C = S D^-1 ("push2")
    lag_col: torch.Tensor  # [n_pad] Lagrange border column
    lag_row: torch.Tensor  # [n_pad] Lagrange border row
    smooth_mask: torch.Tensor  # [n_pad]
    dirichlet_mask: torch.Tensor
    neumann_mask: torch.Tensor
    dirichlet_values: torch.Tensor
    neumann_values: torch.Tensor
    row_map: torch.Tensor  # [n] int64: logical -> permuted row
    has_lagrange: bool
    implicit: bool
    omega: float
    iters: int

    @property
    def n_pad(self) -> int:
        return self.A.nrows_pad

    @property
    def kernel_kind(self) -> str:
        """Which sweep family this level runs (recorded in SolveRecords)."""
        if self.sweep is None:
            return "matvec-only"
        if not self.sweep.serial:
            return "v8-colored"
        return "v6-oneshot" if self.sweep.role == "sweep6" else "v7-exact"

    def to_padded(self, v_logical: torch.Tensor) -> torch.Tensor:
        out = v_logical.new_zeros(self.n_pad)
        out[self.row_map] = v_logical
        return out

    def to_logical(self, v_padded: torch.Tensor) -> torch.Tensor:
        return v_padded[self.row_map]


def check_resolve_in_place(bound: CompactRows) -> None:
    """Raise unless no boundary row reads another boundary row's unknown.

    The ``compact_rows`` re-solve writes each target row while other rows
    may still gather; that equals the reference's compute-all-then-scatter
    only if no row's non-zero entry (padding entries carry 0 and any valid
    column) sits in the column of another target row.  Neumann stencils
    exclude other boundary points, so this holds by construction.
    """
    m = bound.nrows
    if m == 0:
        return
    rows = bound.rows[:m].numpy().astype(np.int64)
    gc = global_cols(bound.ell)[:m].numpy().astype(np.int64)
    target = np.zeros(bound.ell.ncols, dtype=bool)
    target[rows] = True
    hit = (bound.ell.vals[:m].numpy() != 0) & target[gc] & (gc != rows[:, None])
    if hit.any():
        i = int(np.nonzero(hit.any(axis=1))[0][0])
        raise ValueError(
            f"{int(hit.sum())} entries of the Neumann boundary rows read "
            f"another boundary row (first: compact row {i}, target row "
            f"{rows[i]}); the in-place compact_rows re-solve needs boundary "
            "stencils that exclude other boundary points")


def gpu_level_from_operator(
    op: LevelOperator, device, dtype=torch.float32, sweep: bool = True,
    sweep_order: str = "colored", k_dtype=None,
) -> GpuLevel:
    """Repack a host LevelOperator for the kernels (``sweep=False``: matvec
    tables only, as for the f64 outer residual operator).  ``k_dtype``
    stores the sweep's K in another dtype (``torch.bfloat16`` with f32
    vectors: ``--fast-k``).  Raises on a layout the kernels cannot take."""
    if sweep_order not in SWEEP_ORDERS:
        raise ValueError(f"sweep_order {sweep_order!r} not in {SWEEP_ORDERS}")
    k_dtype = dtype if k_dtype is None else k_dtype
    if k_dtype not in (dtype, torch.bfloat16) or (
            k_dtype == torch.bfloat16 and dtype != torch.float32):
        raise ValueError(f"K in {k_dtype} with {dtype} vectors: the sweep takes "
                         "K in the vectors' dtype or bf16 K with f32")
    if op.n_pad % LANES:
        raise ValueError(f"n_pad={op.n_pad} is not a multiple of {LANES}")
    check_resolve_in_place(op.bound)
    device = torch.device(device)
    nb = op.n_pad // LANES
    colored = sweep_order == "colored" and nb >= MIN_COLORED_BLOCKS
    A = device_ell(op.A, dtype, device, role="spmv8" if colored else "spmv6")

    def f(v):
        return v.to(device=device, dtype=dtype)

    sw = None
    if sweep:
        kT = build_oneshot_K(
            op.A, op.omega * op.omega_scale.numpy(), op.smooth_mask.numpy(),
            class_size=op.class_size)
        pids = block_patches(global_cols(op.A).numpy(), nb)
        if colored:
            order, ptr = colored_order(color_blocks(pids, nb))
            role = "sweep8"
        else:
            order, ptr = np.arange(nb), (0, nb)
            role = "sweep6" if union_slots(pids, nb) > UNION_MAX_SLOTS else "sweep7"
        sw = BlockSweep(
            A=A,
            kT=torch.from_numpy(kT).to(device=device, dtype=k_dtype),
            lagc=f(op.lag_col),
            order=torch.from_numpy(order.astype(np.int32)).to(device),
            phase_ptr=ptr,
            serial=not colored,
            role=role,
        )
    return GpuLevel(
        A=A,
        sweep=sw,
        bound=device_compact(op.bound, dtype, device, "bound2"),
        cond=device_compact(op.cond, dtype, device, "push2"),
        lag_col=f(op.lag_col),
        lag_row=f(op.lag_row),
        smooth_mask=f(op.smooth_mask),
        dirichlet_mask=f(op.dirichlet_mask),
        neumann_mask=f(op.neumann_mask),
        dirichlet_values=f(op.dirichlet_values),
        neumann_values=f(op.neumann_values),
        row_map=op.row_map.to(device=device, dtype=torch.int64),
        has_lagrange=op.has_lagrange,
        implicit=op.implicit,
        omega=op.omega,
        iters=op.iters,
    )


def gpu_hierarchy(hier: Hierarchy, device, dtype=torch.float32,
                  sweep_order: str = "colored", k_dtype=None) -> Hierarchy:
    """Convert a host hierarchy to the GPU backend (transfers included)."""
    levels = tuple(gpu_level_from_operator(op, device, dtype,
                                           sweep_order=sweep_order, k_dtype=k_dtype)
                   for op in hier.levels)
    restrict = tuple(device_ell(r, dtype, device, "spmv6") for r in hier.restrict)
    prolong = tuple(device_ell(p, dtype, device, "spmv6") for p in hier.prolong)
    return Hierarchy(levels=levels, restrict=restrict, prolong=prolong)


# ---------------------------------------------------------------------------
# smoother-protocol implementations (called from ops/smoothers dispatchers)
# ---------------------------------------------------------------------------


def _lag_dot(op: GpuLevel, x):
    return (op.lag_row * x).sum()  # an elementwise product and a sum: no cuBLAS


def matvec(op: GpuLevel, x, x_lag):
    y = ell_spmv(op.A, x)
    if not op.has_lagrange:
        return y, x.new_zeros(())
    return y + op.lag_col * x_lag, _lag_dot(op, x) + x_lag


def bound_eval_neumann(op: GpuLevel, x, b):
    """Re-solve the Neumann boundary rows; returns a new vector."""
    if op.bound.nrows == 0:
        return x
    return compact_rows(op.bound, x.clone(), b.contiguous())


def push_inhomog_to_rhs(op: GpuLevel, b):
    """b_i -= sum_j C_ij b_j at the condensed rows; returns a new vector."""
    if op.cond.nrows == 0:
        return b
    b = b.contiguous()
    return compact_rows(op.cond, b, b)


def smooth(op: GpuLevel, x, x_lag, b, b_lag, iters=None):
    """``iters`` sweeps, each: block GS -> Lagrange-row relax -> Neumann
    row re-solve (reference tpu_backend.smooth).  The sweep and re-solve
    kernels update in place, so ``x`` is copied once up front."""
    iters = op.iters if iters is None else iters
    w = op.omega
    x = x.clone()
    x_lag = torch.as_tensor(x_lag, dtype=x.dtype, device=x.device)
    b_lag = torch.as_tensor(b_lag, dtype=x.dtype, device=x.device)
    b = b.contiguous()
    for _ in range(iters):
        block_oneshot_sweep(op.sweep, x, x_lag, b)
        if op.has_lagrange:
            # border row: A_NN = 1 (grid.cpp:573)
            x_lag = (1.0 - w) * x_lag + w * (b_lag - _lag_dot(op, x))
        if op.bound.nrows:
            compact_rows(op.bound, x, b)
    return x, x_lag
