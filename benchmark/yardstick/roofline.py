"""Peaks, bytes and operations: the least time a call could take.

Frozen from ``meshlessmultigridpoisson_torch/utils/profiling.py`` at commit
57ee902 (``PEAKS``, ``bound_ms``, ``spmv_bytes``/``spmv_flops``,
``sweep_bytes``/``sweep_flops`` for a sweep with K, ``smooth_bytes``/
``smooth_flops``).  The counts are what a call needs, from the tables'
shapes and dtypes and the nonzeros they hold: each input read once and each
output written once, whatever the kernel reads again; ELL padding and the
zeros of K are left out.  The least time is the larger of the bytes over
the card's memory rate and the operations over its arithmetic rate.
"""

from __future__ import annotations

import torch

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# memory bytes/s, and FLOP/s outside the tensor cores per dtype.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes": 3.35e12, torch.float32: 67e12,
                              torch.float64: 34e12},  # H100 SXM
}

RESOLVE_FLOPS = 4  # a Neumann row's re-solve besides its products


def bound_ms(nbytes: float, flops: float, dtype, card: str) -> float:
    """The least milliseconds for ``nbytes`` and ``flops`` at ``dtype``'s
    rate on ``card``; an unknown card raises."""
    if card not in PEAKS:
        raise ValueError(f"no published peaks for {card!r} (known: {sorted(PEAKS)})")
    pk = PEAKS[card]
    return max(nbytes / pk["bytes"], flops / pk[dtype]) * 1e3


def _nnz(t: torch.Tensor) -> int:
    return int(torch.count_nonzero(t))


def spmv_bytes(A) -> int:
    """One SpMV of a DeviceEll: each nonzero's value and column (4 B int32;
    2 B in the u16 format, plus its 4 B base column a 128-row block), x
    read once, y written once."""
    es = A.vals.element_size()
    if A.col_base is not None:
        return _nnz(A.vals) * (es + 2) + 4 * A.col_base.numel() + (A.ncols + A.nrows_pad) * es
    return _nnz(A.vals) * (es + 4) + (A.ncols + A.nrows_pad) * es


def spmv_flops(A) -> int:
    return 2 * _nnz(A.vals)


def sweep_bytes(sw) -> int:
    """One sweep of a BlockSweep: the matrix's nonzeros, K's nonzeros in K's
    dtype, the Lagrange column and the block order, x read and written
    once, b once."""
    es = sw.A.vals.element_size()
    n = sw.A.nrows_pad
    return (_nnz(sw.A.vals) * (es + 4) + _nnz(sw.kT) * sw.kT.element_size()
            + sw.lagc.nbytes + sw.order.nbytes + 3 * n * es)


def sweep_flops(sw) -> int:
    return 2 * _nnz(sw.A.vals) + 2 * _nnz(sw.kT)


def smooth_bytes(sw, lag_row=None, bound=None) -> int:
    """One smoother call, whatever its sweeps: the sweep's bytes, the
    Lagrange row where it relaxes, the boundary rows' nonzeros (value and
    int32 column), targets and diagonals where it re-solves."""
    n = sweep_bytes(sw)
    if lag_row is not None:
        n += lag_row.nbytes
    if bound is not None and bound.nrows:
        es = bound.vals.element_size()
        n += _nnz(bound.vals) * (es + 4) + bound.nrows * (4 + es)
    return n


def smooth_flops(sw, iters: int, lag_row=None, bound=None) -> int:
    """``iters`` sweeps, each with its relax and re-solve."""
    per = sweep_flops(sw)
    if lag_row is not None:
        per += 2 * lag_row.numel() + 4
    if bound is not None and bound.nrows:
        per += 2 * _nnz(bound.vals) + RESOLVE_FLOPS * bound.nrows
    return iters * per
