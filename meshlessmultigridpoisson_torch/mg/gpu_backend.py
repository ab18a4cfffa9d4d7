"""GPU execution backend: LevelOperator -> GpuLevel over the CUDA kernels.

Counterpart of the reference package's ``mg/tpu_backend.py``.  The V-cycle
engine (mg/vcycle.py) calls ``ops.smoothers``, which dispatches here when
handed a GpuLevel.  A GpuLevel repacks a host-built f64 LevelOperator into
the kernels' layouts on ``device``:

* the level matrix as a row-major ELL (``ops.gpu_kernels.DeviceEll``),
  with each row's ``lens`` (one past its last nonzero), for ``ell_spmv``:
  global int32 columns where a sweep reads the table; u16 offsets from a
  per-128-row-block base where none does (the transfers and the
  ``sweep=False`` f64 outer operator) and every block spans at most 65,535
  columns (``device_ell(..., u16=True)``; ``DeviceEll.col_format``);
* the one-shot block GS tables for ``block_oneshot_sweep``: per-block
  K = (D/omega + L)^-1 with omega * omega_scale and the smooth mask folded
  in (f32, f64, or bf16 under ``k_dtype``), and the block execution order.
  ``sweep_order="colored"``: colored (one phase per color, "v8-colored",
  role ``sweep8``) on levels the reference's ``prepare_colored_sweep`` takes
  (``ops.gpu_kernels.colored_refusal``: at least 32 blocks of 128 rows,
  duplicate padding within 2x, program scratch within 96 or 256 slots),
  storage order otherwise.
  ``sweep_order="exact"``: storage order on every level, the matvec on the
  ``spmv6`` role throughout (the reference keeps ``kell6`` there).  A
  storage-order level is "v6-oneshot" where the reference's union-scratch
  tables would need more than 32 slots (``ops.gpu_kernels.union_slots``),
  "v7-exact" otherwise.  Roles: ``sweep7`` (the fused one-CTA
  ``coarse_smooth``) for a v7-exact level whose vectors fit its shared
  memory (``ops.gpu_kernels.coarse_smooth_fits``), else ``sweep6`` (the
  single-CTA ``storage_chain``, the same function), which every
  v6-oneshot level runs;
* or, on a "v2-fallback" level (``use_v6=False``, or a level the
  reference's v6 layout refuses: ``ops.gpu_kernels.v6_supported``), the
  K-free class SOR tables for ``class_sor_sweep`` (``ClassSweep``: diag,
  mask, per-row omega, Lagrange column; 512 B per row less than K in f32)
  and the matvec on the ``spmv2`` role;
* the Neumann boundary rows (``bound``) and the condensation rows
  (``cond``) as compact tables for ``compact_rows``, and the Lagrange
  rank-1 border (``lag_col``, ``lag_row``) as vectors.

Semantics match the reference backend: same (block, class) Gauss-Seidel,
then the Lagrange-row relax, then the exact Neumann boundary-row re-solve,
after every sweep; the same bordered matvec and RHS pushdown — in the
kernels' precision (f32 by default; tight tolerances come from the f64
outer loop of mg/mixed.py).  A smoother call on a ``sweep8``/``sweep7``
level is one launch of ``ops.gpu_kernels.block_smooth``, the V-cycle's own
re-solves of the fine level (and its Dirichlet pin) included when asked
(``smooth(..., resolve_first=, resolve_last=)``); other levels run
``ops.gpu_kernels.smooth_loop``, which with the plain kernels is also the
fused launch's plain version.  On CPU tensors the kernels' plain PyTorch
versions run instead, so ``--device cpu`` exercises the identical flow.
The Lagrange unknown stays a 0-dim tensor on the device throughout: the
smoother adds no host sync.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from meshlessmultigridpoisson_torch.mg.vcycle import Hierarchy
from meshlessmultigridpoisson_torch.ops.ell import global_cols
from meshlessmultigridpoisson_torch.ops.gpu_kernels import (
    FUSED_SWEEP_ROLES,
    LANES,
    UNION_MAX_SLOTS,
    BlockSweep,
    ClassSweep,
    DeviceCompact,
    DeviceEll,
    block_patches,
    block_read_tables,
    block_smooth,
    build_oneshot_K,
    class_sweep,
    coarse_smooth_fits,
    color_blocks,
    colored_order,
    colored_refusal,
    compact_rows,
    device_compact,
    device_ell,
    ell_spmv,
    smooth_loop,
    union_slots,
    v6_supported,
)
from meshlessmultigridpoisson_torch.stencil.operators import CompactRows, LevelOperator
from meshlessmultigridpoisson_torch.utils import trace

SWEEP_ORDERS = ("colored", "exact")


@dataclasses.dataclass(frozen=True)
class GpuLevel:
    """Per-level data in kernel-ready layouts on one device (the fields of
    the reference's ``TpuLevel`` that the solve path reads)."""

    A: DeviceEll
    # BlockSweep (v6/v7/v8), ClassSweep (v2-fallback), None: matvec-only
    # (the f64 outer operator)
    sweep: BlockSweep | ClassSweep | None
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
    # which sweep family this level runs (recorded in SolveRecords): the
    # reference's kind ("v8-colored", "v7-exact", "v6-oneshot",
    # "v2-fallback"), or "matvec-only"
    kernel_kind: str

    @property
    def n_pad(self) -> int:
        return self.A.nrows_pad

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


def runs_v2(op: LevelOperator, use_v6: bool | None = None) -> bool:
    """Whether the level runs the v2-fallback kernels (tpu_backend's rule).

    ``use_v6`` None: v6 (the one-shot sweeps) wherever the class size is 8
    and the reference's v6 layout takes the operator; False: v2 always.
    Where the reference's v6 prep would raise, warn as it does.
    """
    if use_v6 is None:
        use_v6 = op.class_size == 8
    if not (use_v6 and op.class_size == 8):
        return True
    if not v6_supported(op.A):
        warnings.warn(
            f"GPU level n={op.n}: the v6 layout refuses this operator (more than "
            "256 x patches in a 128-row block, or blocks not of whole 128 rows); "
            "falling back to the SLOW v2 class sweep", stacklevel=3)
        return True
    return False


def gpu_level_from_operator(
    op: LevelOperator, device, dtype=torch.float32, sweep: bool = True,
    sweep_order: str = "colored", k_dtype=None, use_v6: bool | None = None,
) -> GpuLevel:
    """Repack a host LevelOperator for the kernels (``sweep=False``: matvec
    tables only, as for the f64 outer residual operator, with u16 columns
    where the rule allows).  ``k_dtype``
    stores the sweep's K in another dtype (``torch.bfloat16`` with f32
    vectors: ``--fast-k``).  ``use_v6``: see ``runs_v2``; a v2 level holds
    no K.  Raises on a layout the kernels cannot take.  A matvec-only
    level's repack is the span ``repack.outer64`` (``utils.trace``)."""
    t0 = time.perf_counter()
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
    v2 = runs_v2(op, use_v6)
    colored = False
    if not v2:
        gcols = global_cols(op.A).numpy()
        pids = block_patches(gcols, nb)
        if sweep_order == "colored":
            colors = color_blocks(pids, nb)
            colored = colored_refusal(pids, nb, colors) is None
    role = "spmv2" if v2 else ("spmv8" if colored else "spmv6")
    A = device_ell(op.A, dtype, device, role=role, u16=not sweep)

    def f(v):
        return v.to(device=device, dtype=dtype)

    sw, kind = None, "matvec-only"
    if sweep and v2:
        sw = class_sweep(A, op.A.diag, op.smooth_mask, op.omega * op.omega_scale,
                         op.lag_col, class_size=op.class_size, role="sweep2")
        A = sw.A  # its rows reordered for the sweep's windows: one copy
        kind = "v2-fallback"
    elif sweep:
        kT = build_oneshot_K(
            op.A, op.omega * op.omega_scale.numpy(), op.smooth_mask.numpy(),
            class_size=op.class_size)
        if colored:
            order, ptr = colored_order(colors)
            kind, role = "v8-colored", "sweep8"
        else:
            order, ptr = np.arange(nb), (0, nb)
            kind = "v6-oneshot" if union_slots(pids, nb) > UNION_MAX_SLOTS else "v7-exact"
            m = op.bound.ell.nrows_pad if op.bound.nrows else 0
            role = ("sweep7" if kind == "v7-exact"
                    and coarse_smooth_fits(op.n_pad, dtype, k_dtype, m) else "sweep6")
        sw = BlockSweep(
            A=A,
            kT=torch.from_numpy(kT).to(device=device, dtype=k_dtype),
            lagc=f(op.lag_col),
            order=torch.from_numpy(order.astype(np.int32)).to(device),
            phase_ptr=ptr,
            serial=not colored,
            role=role,
            reads=block_read_tables(gcols, nb, device) if colored else None,
        )
    level = GpuLevel(
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
        kernel_kind=kind,
    )
    if not sweep:
        trace.add("repack.outer64", time.perf_counter() - t0)
    return level


def col_formats(hier: Hierarchy, op64: GpuLevel | None = None) -> dict:
    """The column format ("i32" or "u16") the repack took for each table of
    a GPU hierarchy (and of the f64 outer operator ``op64``)."""
    out = dict(levels=[lv.A.col_format for lv in hier.levels],
               restrict=[A.col_format for A in hier.restrict],
               prolong=[A.col_format for A in hier.prolong])
    if op64 is not None:
        out["outer_f64"] = op64.A.col_format
    return out


def gpu_hierarchy(hier: Hierarchy, device, dtype=torch.float32,
                  sweep_order: str = "colored", k_dtype=None,
                  use_v6: bool | None = None) -> Hierarchy:
    """Convert a host hierarchy to the GPU backend (transfers included).
    Transfers keep ``spmv6`` whatever ``use_v6`` says, and take ``spmv2``
    where the v6 layout refuses them (tpu_backend.tpu_hierarchy); no sweep
    reads them, so they take u16 columns where the rule allows.  A new
    repack: its stages (``utils.trace.REPACK_STAGES``) replace the last
    one's, ``repack.levels`` and ``repack.transfers`` timed here."""
    trace.begin(trace.REPACK_STAGES)
    with trace.span("repack.levels"):
        levels = tuple(gpu_level_from_operator(op, device, dtype, sweep_order=sweep_order,
                                               k_dtype=k_dtype, use_v6=use_v6)
                       for op in hier.levels)

    def transfer(ell):
        return device_ell(ell, dtype, device, "spmv6" if v6_supported(ell) else "spmv2",
                          u16=True)

    with trace.span("repack.transfers"):
        restrict = tuple(map(transfer, hier.restrict))
        prolong = tuple(map(transfer, hier.prolong))
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
    """Re-solve the Neumann boundary rows (one ``compact_rows`` launch);
    returns a new vector."""
    if op.bound.nrows == 0:
        return x
    return compact_rows(op.bound, x.clone(), b.contiguous())


def push_inhomog_to_rhs(op: GpuLevel, b):
    """b_i -= sum_j C_ij b_j at the condensed rows; returns a new vector."""
    if op.cond.nrows == 0:
        return b
    b = b.contiguous()
    return compact_rows(op.cond, b, b)


def smooth(op: GpuLevel, x, x_lag, b, b_lag, iters=None, resolve_first: bool = False,
           resolve_last: bool = False):
    """``iters`` sweeps, each: block GS (class SOR on a v2-fallback level)
    -> Lagrange-row relax -> Neumann row re-solve (reference
    tpu_backend.smooth); returns new (x, x_lag).  ``resolve_first``: before
    them the Neumann rows' re-solve, then the Dirichlet pin (the V-cycle's
    start on the fine level); ``resolve_last``: one more re-solve after
    them (the preconditioner's).  A ``sweep8``/``sweep7`` level runs the
    whole call in one launch (``block_smooth``); other levels the loop of
    sweep, relax and re-solve launches (``smooth_loop``)."""
    iters = op.iters if iters is None else iters
    x_lag = torch.as_tensor(x_lag, dtype=x.dtype, device=x.device)
    b_lag = torch.as_tensor(b_lag, dtype=x.dtype, device=x.device)
    b = b.contiguous()
    lag_row = op.lag_row if op.has_lagrange else None
    bound = op.bound if op.bound.nrows else None
    ends = dict(start=(op.dirichlet_mask, op.dirichlet_values) if resolve_first else None,
                resolve_last=resolve_last)
    if isinstance(op.sweep, BlockSweep) and op.sweep.role in FUSED_SWEEP_ROLES:
        return block_smooth(op.sweep, x, x_lag, b, b_lag, iters, op.omega, lag_row, bound,
                            **ends)
    return smooth_loop(op.sweep, x, x_lag, b, b_lag, iters, op.omega, lag_row, bound,
                       **ends)
