"""GPU execution backend: LevelOperator -> GpuLevel over the CUDA kernels.

Counterpart of the reference package's ``mg/tpu_backend.py``.  The V-cycle
engine (mg/vcycle.py) calls ``ops.smoothers``, which dispatches here when
handed a GpuLevel.  A GpuLevel repacks a host-built f64 LevelOperator into
the kernels' layouts on ``device``:

* the level matrix as a row-major ELL with global int32 columns
  (``ops.gpu_kernels.DeviceEll``), for ``ell_spmv``;
* the one-shot block GS tables for ``block_oneshot_sweep``: per-block
  K = (D/omega + L)^-1 with omega * omega_scale and the smooth mask folded
  in, and the block execution order — colored (one phase per color) on
  levels with at least 32 blocks of 128 rows ("v8-colored", the reference's
  ``prepare_colored_sweep`` threshold), storage order otherwise
  ("v7-exact").

Semantics match the reference backend: same (block, class) Gauss-Seidel
in the kernels' precision (f32 by default;
tight tolerances come from the f64 outer loop of mg/mixed.py).  On CPU
tensors the kernels' plain PyTorch versions run instead, so ``--device cpu``
exercises the identical flow.

Levels with Neumann rows (boundary re-solve, condensation pushdown) need
the reference's ``spmv_tpu2`` compact-row kernel, which is not ported yet:
``gpu_level_from_operator`` raises for them rather than run a plain path on
the device.
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
    DeviceEll,
    block_oneshot_sweep,
    block_patches,
    build_oneshot_K,
    color_blocks,
    colored_order,
    device_ell,
    ell_spmv,
)
from meshlessmultigridpoisson_torch.stencil.operators import LevelOperator

# below this many 128-row blocks the colored sweep loses to the storage-order
# chain (reference ops/kernels8.py prepare_colored_sweep, min_blocks=32)
MIN_COLORED_BLOCKS = 32


@dataclasses.dataclass(frozen=True)
class GpuLevel:
    """Per-level data in kernel-ready layouts on one device.

    Only Dirichlet levels exist here (Neumann levels are refused at
    construction), so the Lagrange border, the Neumann row re-solve and the
    RHS pushdown are absent: ``has_lagrange`` is always False.
    """

    A: DeviceEll
    sweep: BlockSweep | None  # None: matvec-only (the f64 outer operator)
    smooth_mask: torch.Tensor  # [n_pad]
    dirichlet_mask: torch.Tensor
    dirichlet_values: torch.Tensor
    row_map: torch.Tensor  # [n] int64: logical -> permuted row
    iters: int

    has_lagrange = False

    @property
    def n_pad(self) -> int:
        return self.A.nrows_pad

    @property
    def kernel_kind(self) -> str:
        """Which sweep family this level runs (recorded in SolveRecords)."""
        if self.sweep is None:
            return "matvec-only"
        return "v7-exact" if self.sweep.serial else "v8-colored"

    def to_padded(self, v_logical: torch.Tensor) -> torch.Tensor:
        out = v_logical.new_zeros(self.n_pad)
        out[self.row_map] = v_logical
        return out

    def to_logical(self, v_padded: torch.Tensor) -> torch.Tensor:
        return v_padded[self.row_map]


def gpu_level_from_operator(
    op: LevelOperator, device, dtype=torch.float32, sweep: bool = True
) -> GpuLevel:
    """Repack a host LevelOperator for the kernels (``sweep=False``: matvec
    tables only, as for the f64 outer residual operator)."""
    if op.has_lagrange or op.bound.nrows > 0 or op.cond.nrows > 0:
        raise NotImplementedError(
            f"level n={op.n} has {op.bound.nrows} Neumann boundary rows and "
            f"{op.cond.nrows} condensation rows; their device path (the "
            "reference's compact-row kernel spmv_tpu2, ops/kernels.py, and "
            "the Lagrange border) is not ported yet")
    if op.n_pad % LANES:
        raise ValueError(f"n_pad={op.n_pad} is not a multiple of {LANES}")
    device = torch.device(device)
    nb = op.n_pad // LANES
    colored = nb >= MIN_COLORED_BLOCKS
    A = device_ell(op.A, dtype, device, role="spmv8" if colored else "spmv6")

    def f(v):
        return v.to(device=device, dtype=dtype)

    sw = None
    if sweep:
        kT = build_oneshot_K(
            op.A, op.omega * op.omega_scale.numpy(), op.smooth_mask.numpy(),
            class_size=op.class_size)
        if colored:
            colors = color_blocks(block_patches(global_cols(op.A).numpy(), nb), nb)
            order, ptr = colored_order(colors)
        else:
            order, ptr = np.arange(nb), (0, nb)
        sw = BlockSweep(
            A=A,
            kT=torch.from_numpy(kT).to(device=device, dtype=dtype),
            lagc=f(op.lag_col),
            order=torch.from_numpy(order.astype(np.int32)).to(device),
            phase_ptr=ptr,
            serial=not colored,
            role="sweep8" if colored else "sweep7",
        )
    return GpuLevel(
        A=A,
        sweep=sw,
        smooth_mask=f(op.smooth_mask),
        dirichlet_mask=f(op.dirichlet_mask),
        dirichlet_values=f(op.dirichlet_values),
        row_map=op.row_map.to(device=device, dtype=torch.int64),
        iters=op.iters,
    )


def gpu_hierarchy(hier: Hierarchy, device, dtype=torch.float32) -> Hierarchy:
    """Convert a host hierarchy to the GPU backend (transfers included)."""
    levels = tuple(gpu_level_from_operator(op, device, dtype) for op in hier.levels)
    restrict = tuple(device_ell(r, dtype, device, "spmv6") for r in hier.restrict)
    prolong = tuple(device_ell(p, dtype, device, "spmv6") for p in hier.prolong)
    return Hierarchy(levels=levels, restrict=restrict, prolong=prolong)


# ---------------------------------------------------------------------------
# smoother-protocol implementations (called from ops/smoothers dispatchers)
# ---------------------------------------------------------------------------


def matvec(op: GpuLevel, x, x_lag):
    return ell_spmv(op.A, x), x.new_zeros(())


def bound_eval_neumann(op: GpuLevel, x, b):
    return x  # no Neumann rows on a GpuLevel


def smooth(op: GpuLevel, x, x_lag, b, b_lag, iters=None):
    """``iters`` block GS sweeps.  The sweep kernel updates in place, so
    ``x`` is copied once up front."""
    iters = op.iters if iters is None else iters
    x = x.clone()
    x_lag = torch.as_tensor(x_lag, dtype=x.dtype, device=x.device)
    b = b.contiguous()
    for _ in range(iters):
        block_oneshot_sweep(op.sweep, x, x_lag, b)
    return x, x_lag
