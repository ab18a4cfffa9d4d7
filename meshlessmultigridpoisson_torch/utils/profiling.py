"""Per-level kernel profiling: times, nnz/s, modelled bytes/s and bounds.

Port of the reference package's ``utils/profiling.py``.  Each level's
matvec and smoother sweep are timed on the card with CUDA events
(``chain_time``) and turned into throughputs from the level's true nonzero
count and a byte model of what each function needs: its nonzeros and its
vectors, no padding (``spmv_bytes``, ``sweep_bytes``, ``compact_bytes``).
Beside each time stands its bound: the
least time the card could take for the same work, the larger of the bytes
over the card's memory rate and the operations over its arithmetic rate
(``bound_ms``), with the rates taken from the card's name (``PEAKS``; an
unknown card raises).  Nothing here measures on the CPU: ``chain_time``
refuses a CPU tensor.
"""

from __future__ import annotations

import subprocess
from typing import Any

import numpy as np
import torch

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# memory bytes/s and arithmetic FLOP/s outside the tensor cores per dtype
# (the kernels multiply bf16 K in f32 on the CUDA cores).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes": 3.35e12, torch.float32: 67e12,
                              torch.float64: 34e12},  # H100 SXM
}


def peaks(name: str) -> dict:
    """The card's peak rates; raises for a card the table does not hold."""
    if name not in PEAKS:
        raise ValueError(f"no published peaks for {name!r} (known: {sorted(PEAKS)})")
    return PEAKS[name]


def card() -> dict[str, str]:
    """Name of card 0 and its power limit as ``nvidia-smi`` reports it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True)
    return {"name": torch.cuda.get_device_name(0),
            "power_limit": smi.stdout.strip().split(",")[-1].strip()}


def bound_ms(nbytes: float, flops: float, dtype, name: str) -> tuple[float, str]:
    """(least ms for the work, "bytes" or "operations": which bounds it)."""
    pk = peaks(name)
    t_b, t_f = nbytes / pk["bytes"], flops / pk[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def chain_time(op, x0: torch.Tensor, *sa, k: int = 16, reps: int = 5) -> float:
    """Median seconds per application of ``op(x0, *sa)`` on the card.

    One warm-up call, then per repetition ``k`` back-to-back applications
    to the same input between two CUDA events on the current stream; the
    median over ``reps`` of the elapsed time over ``k``.
    """
    if not isinstance(x0, torch.Tensor) or x0.device.type != "cuda":
        raise ValueError("chain_time times on the card: it takes a CUDA tensor "
                         f"(got {getattr(x0, 'device', type(x0))})")
    op(x0, *sa)
    torch.cuda.synchronize(x0.device)
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(k):
            op(x0, *sa)
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / 1e3 / k)
    return float(np.median(ts))


# The byte and operation counts below are what each function needs, not
# what the kernels stream: ELL padding slots (value 0) and the zeros of K
# are left out.  K = (D/omega + L)^-1 is lower class-triangular, its
# diagonal 8x8 class blocks diagonal (L holds only the strictly-lower
# class blocks), and its rows off the smoothing mask are zero: at most
# 7,808 of a block's 16,384 entries can be nonzero, and the count is the
# entries this run's K really holds.


def _nnz(t: torch.Tensor) -> int:
    return int(torch.count_nonzero(t))


def spmv_bytes(A) -> int:
    """Bytes ``ell_spmv`` needs (``A`` a DeviceEll): each nonzero's value
    and int32 column, x read once, y written once."""
    es = A.vals.element_size()
    return _nnz(A.vals) * (es + 4) + (A.ncols + A.nrows_pad) * es


def spmv_flops(A) -> int:
    return 2 * _nnz(A.vals)


def sweep_bytes(sw) -> int:
    """Bytes one full ``block_oneshot_sweep`` needs (``sw`` a BlockSweep):
    the matrix's nonzeros, K's nonzeros in K's own dtype, the Lagrange
    column and the block order, x read and written once, b read once."""
    es = sw.A.vals.element_size()
    return (_nnz(sw.A.vals) * (es + 4) + _nnz(sw.kT) * sw.kT.element_size()
            + sw.lagc.nbytes + sw.order.nbytes + 3 * sw.A.nrows_pad * es)


def sweep_flops(sw) -> int:
    return 2 * _nnz(sw.A.vals) + 2 * _nnz(sw.kT)


def compact_bytes(C) -> int:
    """Bytes one ``compact_rows`` call needs (``C`` a DeviceCompact): each
    nonzero's value and int32 column, each true row's target and diagonal,
    the distinct x entries it gathers, and per true row one read and one
    write in the big row space."""
    es = C.vals.element_size()
    nz = C.vals != 0
    return (int(nz.sum()) * (es + 4) + C.nrows * (4 + es)
            + (int(torch.unique(C.cols[nz]).numel()) + 2 * C.nrows) * es)


def compact_flops(C) -> int:
    return 2 * _nnz(C.vals)


def library_csr(vals: torch.Tensor, cols: torch.Tensor, ncols: int):
    """The nonzeros of a row-major ELL table as a ``torch.sparse`` CSR
    matrix: the operand of the library yardstick (``csr @ x``), a call the
    port never makes."""
    nz = vals != 0
    crow = torch.zeros(vals.shape[0] + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = nz.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(crow, cols[nz].long(), vals[nz],
                                   size=(vals.shape[0], ncols))


def _streamed_bytes(level, sweep: bool) -> int:
    """Bytes the level's kernel moves per application (model above)."""
    return sweep_bytes(level.sweep) if sweep else spmv_bytes(level.A)


def _level_nnz(level) -> int:
    return _nnz(level.A.vals)


def profile_hierarchy(hier, reps: int = 5, k: int = 16) -> list[dict[str, Any]]:
    """Time each level's smoother sweep and matvec on the card.

    Returns one dict per level (coarse -> fine): n, the sweep kind, nnz,
    per-op ms (``smooth`` with one sweep and ``matvec`` of the smoother
    protocol), Gnnz/s, modelled GB/s, and each op's kernel bound with what
    bounds it, the card's name and power limit.
    """
    from meshlessmultigridpoisson_torch.ops import smoothers as sm

    if any(lv.A.vals.device.type != "cuda" for lv in hier.levels):
        raise ValueError("profile_hierarchy times on the card: the hierarchy "
                         "is not on a CUDA device")
    info = card()
    out = []
    for li, lv in enumerate(hier.levels):
        dev, dt = lv.A.vals.device, lv.A.vals.dtype
        n_pad = lv.n_pad
        x0 = torch.from_numpy(np.random.default_rng(li).standard_normal(n_pad)).to(dev, dt)
        zl = torch.zeros((), dtype=dt, device=dev)
        b = torch.zeros(n_pad, dtype=dt, device=dev)
        t_mv = chain_time(lambda x: sm.matvec(lv, x, zl)[0], x0, k=k, reps=reps)
        t_sw = chain_time(lambda x: sm.smooth(lv, x, zl, b, zl, iters=1)[0], x0,
                          k=k, reps=reps)
        nnz = _level_nnz(lv)
        mv_b, sw_b = _streamed_bytes(lv, False), _streamed_bytes(lv, True)
        mv_bound, mv_by = bound_ms(mv_b, spmv_flops(lv.A), dt, info["name"])
        sw_bound, sw_by = bound_ms(sw_b, sweep_flops(lv.sweep), dt, info["name"])
        out.append(dict(
            level=li,
            n=int(lv.row_map.numel()),
            kernel=lv.kernel_kind,
            nnz=nnz,
            matvec_ms=t_mv * 1e3,
            sweep_ms=t_sw * 1e3,
            matvec_gnnz_s=nnz / t_mv / 1e9,
            sweep_gnnz_s=nnz / t_sw / 1e9,
            matvec_gb_s=mv_b / t_mv / 1e9,
            sweep_gb_s=sw_b / t_sw / 1e9,
            matvec_bound_ms=mv_bound,
            matvec_bound_by=mv_by,
            sweep_bound_ms=sw_bound,
            sweep_bound_by=sw_by,
            card=info["name"],
            power_limit=info["power_limit"],
        ))
    return out


def attach_throughput(rec, hier) -> None:
    """Aggregate solve-level throughput onto a SolveRecord.

    nnz/s over the whole solve: cycles x (pre+post smooth sweeps + residual
    matvec) x nnz summed over levels / wall time.  An *effective* number —
    includes transfer and host overheads — complementing the per-kernel
    profile.
    """
    total_nnz = sum(_level_nnz(lv) for lv in hier.levels)
    if rec.cycles and rec.wall_time_s:
        iters = getattr(hier.levels[-1], "iters", 5)
        apps = rec.cycles * (2 * iters + 1)
        rec.extra["total_nnz"] = total_nnz
        rec.extra["effective_gnnz_s"] = apps * total_nnz / rec.wall_time_s / 1e9
