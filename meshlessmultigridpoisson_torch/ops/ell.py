"""Windowed ELL sparse format — the host-side operator container.

Same layout as the reference package's ``ops/ell.py``: rows are ordered so
that each contiguous block of ``block_rows`` rows references a narrow column
window; columns are stored relative to the per-block window start.

Layout:
  vals      [nrows_pad, width]  float   (zero-filled padding)
  lcols     [nrows_pad, width]  int32   (window-local column ids)
  win_start [nblocks]           int32   (window origin per row block)
  diag      [nrows_pad]         float   (diagonal entries, 1.0 padding)

Padding entries point at the block's window origin with value 0.  The device
path does not use this container directly: ``ops.gpu_kernels.device_ell``
flattens it to global int32 columns for the CUDA SpMV, and the plain
gather-sum ``spmv`` below is the semantics oracle only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    vals: torch.Tensor
    lcols: torch.Tensor
    win_start: torch.Tensor
    diag: torch.Tensor
    nrows: int
    ncols: int
    block_rows: int
    win_size: int

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def nrows_pad(self) -> int:
        return self.vals.shape[0]

    @property
    def nblocks(self) -> int:
        return self.nrows_pad // self.block_rows

    @property
    def nnz(self) -> int:
        return self.nrows * self.width  # padded-ELL nnz (stored)

    def astype(self, dtype) -> "EllMatrix":
        return dataclasses.replace(
            self, vals=self.vals.to(dtype), diag=self.diag.to(dtype)
        )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ell_from_csr(
    a,
    block_rows: int = 256,
    win_align: int = 128,
    width: int | None = None,
    ncols: int | None = None,
) -> EllMatrix:
    """Pack a scipy CSR matrix into windowed ELL (host-side, numpy)."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    a.sum_duplicates()
    nrows = a.shape[0]
    ncols = int(ncols if ncols is not None else a.shape[1])
    row_nnz = np.diff(a.indptr)
    w = max(int(row_nnz.max()), 1) if row_nnz.size else 1
    if width is not None:
        if width < w:
            raise ValueError(f"width={width} < max row nnz {w}")
        w = width
    nrows_pad = _round_up(max(nrows, 1), block_rows)
    nblocks = nrows_pad // block_rows

    a.sort_indices()
    vals = np.zeros((nrows_pad, w), dtype=a.dtype)
    gcols = np.zeros((nrows_pad, w), dtype=np.int64)
    real = np.zeros((nrows_pad, w), dtype=bool)
    diag = np.ones(nrows_pad, dtype=a.dtype)

    rows = np.repeat(np.arange(nrows), row_nnz)
    pos = np.arange(a.nnz) - np.repeat(a.indptr[:-1], row_nnz)
    vals[rows, pos] = a.data
    gcols[rows, pos] = a.indices
    real[rows, pos] = True
    on_diag = (a.indices == rows) & (rows < ncols)
    diag[rows[on_diag]] = a.data[on_diag]

    # per-block windows over REAL entries; padding entries point at the
    # block's window origin so they never widen the window
    blocked = gcols.reshape(nblocks, block_rows, w)
    rmask = real.reshape(nblocks, block_rows, w)
    big = np.where(rmask, blocked, np.int64(np.iinfo(np.int64).max))
    small = np.where(rmask, blocked, np.int64(-1))
    lo = big.min(axis=(1, 2))
    hi = small.max(axis=(1, 2))
    empty = ~rmask.any(axis=(1, 2))
    lo[empty] = 0
    hi[empty] = 0
    win_size = int(_round_up(int((hi - lo).max()) + 1, win_align))
    win_start = lo.astype(np.int64)
    gcols = np.where(real, gcols, np.repeat(win_start, block_rows)[:, None])
    lcols = gcols - np.repeat(win_start, block_rows)[:, None]
    assert (lcols >= 0).all() and (lcols < win_size).all()

    return EllMatrix(
        vals=torch.from_numpy(vals),
        lcols=torch.from_numpy(lcols.astype(np.int32)),
        win_start=torch.from_numpy(win_start.astype(np.int32)),
        diag=torch.from_numpy(diag),
        nrows=int(nrows),
        ncols=ncols,
        block_rows=int(block_rows),
        win_size=win_size,
    )


def global_cols(ell: EllMatrix) -> torch.Tensor:
    """[nrows_pad, width] int32 global column indices."""
    starts = torch.repeat_interleave(ell.win_start, ell.block_rows)
    return ell.lcols + starts[:, None].to(torch.int32)


def ell_to_csr(ell: EllMatrix):
    """Back to scipy CSR (drops explicit zeros) — for tests/debug."""
    import scipy.sparse as sp

    gc = global_cols(ell).cpu().numpy()[: ell.nrows]
    v = ell.vals.cpu().numpy()[: ell.nrows]
    rows = np.repeat(np.arange(ell.nrows), ell.width)
    m = sp.coo_matrix(
        (v.ravel(), (rows, gc.ravel())), shape=(ell.nrows, ell.ncols)
    ).tocsr()
    m.sum_duplicates()
    m.eliminate_zeros()
    return m


def spmv(ell, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (padded-length output [nrows_pad]).

    A ``DeviceEll`` operand goes to the CUDA SpMV wrapper (which takes its
    plain version only for CPU tensors); an ``EllMatrix`` uses the gather-sum
    oracle below.
    """
    from meshlessmultigridpoisson_torch.ops import gpu_kernels

    if isinstance(ell, gpu_kernels.DeviceEll):
        return gpu_kernels.ell_spmv(ell, x)
    gc = global_cols(ell).long()
    return (ell.vals * x[gc]).sum(dim=1)


def spmv_n(ell: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with the logical row count."""
    return spmv(ell, x)[: ell.nrows]
