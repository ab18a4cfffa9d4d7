"""Per-level kernel profiling: times, nnz/s, modelled bytes/s and bounds.

Port of the reference package's ``utils/profiling.py``.  Each level's
matvec and smoother sweep are timed on the card with CUDA events
(``chain_time``) and turned into throughputs from the level's true nonzero
count and a byte model of what each function needs: its nonzeros and its
vectors, no padding (``spmv_bytes``, ``sweep_bytes``, ``smooth_bytes``,
``compact_bytes``, ``ppe_tail_bytes``;
for the timing probes, each mode's or table mix's own work:
``probe_bytes``, ``spmv_probe_bytes``, ``stream_bytes``, ``kiso_bytes``).  Below
``ENQUEUE_MS`` a chain of launches times the host's enqueue, and
``device_ms`` reads the device time per call from ``torch.profiler``.
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

from meshlessmultigridpoisson_torch.ops.gpu_kernels import ClassSweep

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# memory bytes/s and arithmetic FLOP/s outside the tensor cores per dtype
# (the kernels multiply bf16 K in f32 on the CUDA cores); "bf16_tensor"
# the tensor cores' bf16 rate (``probes.chaintime``'s matmul calibration),
# "tf32_tensor" their TF32 rate (``ell_rowsum_mma``'s row sums).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes": 3.35e12, torch.float32: 67e12,
                              torch.float64: 34e12,
                              "bf16_tensor": 989e12,
                              "tf32_tensor": 495e12},  # H100 SXM
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


def bound_ms(nbytes: float, flops, dtype, name: str) -> tuple[float, str]:
    """(least ms for the work, "bytes" or "operations": which bounds it).
    ``flops``: operations at ``dtype``'s rate, or a dict of them by
    ``PEAKS`` key (units that run side by side: the slowest bounds)."""
    pk = peaks(name)
    ops = flops if isinstance(flops, dict) else {dtype: flops}
    t_b, t_f = nbytes / pk["bytes"], max(n / pk[k] for k, n in ops.items())
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def chain_time(op, x0: torch.Tensor, *sa, k: int = 16, reps: int = 5,
               restart: bool = False) -> float:
    """Median seconds per application of ``op(x0, *sa)`` on the card.

    One warm-up call, then per repetition ``k`` back-to-back applications
    to the same input between two CUDA events on the current stream; the
    median over ``reps`` of the elapsed time over ``k``.  ``restart``: for
    an ``op`` that works in place, the warm-up and each repetition start
    from a fresh copy of ``x0``, made before the first event.
    """
    if not isinstance(x0, torch.Tensor) or x0.device.type != "cuda":
        raise ValueError("chain_time times on the card: it takes a CUDA tensor "
                         f"(got {getattr(x0, 'device', type(x0))})")
    op(x0.clone() if restart else x0, *sa)
    torch.cuda.synchronize(x0.device)
    ts = []
    for _ in range(reps):
        x = x0.clone() if restart else x0
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(k):
            op(x, *sa)
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
    and column (4 B int32; 2 B in the u16 format, which adds its 4 B base
    column a 128-row block), x read once, y written once."""
    es = A.vals.element_size()
    if A.col_base is not None:
        return _nnz(A.vals) * (es + 2) + 4 * A.col_base.numel() + (A.ncols + A.nrows_pad) * es
    return _nnz(A.vals) * (es + 4) + (A.ncols + A.nrows_pad) * es


def spmv_flops(A) -> int:
    return 2 * _nnz(A.vals)


def sweep_bytes(sw) -> int:
    """Bytes one full sweep needs.  ``block_oneshot_sweep`` (a BlockSweep):
    the matrix's nonzeros, K's nonzeros in K's own dtype, the Lagrange
    column and the block order, x read and written once, b read once.
    ``class_sor_sweep`` (a ClassSweep, no K): the matrix's nonzeros, x read
    and written once, b, diag, mask, omega and the Lagrange column once."""
    es = sw.A.vals.element_size()
    n = sw.A.nrows_pad
    if isinstance(sw, ClassSweep):
        return _nnz(sw.A.vals) * (es + 4) + 7 * n * es
    return (_nnz(sw.A.vals) * (es + 4) + _nnz(sw.kT) * sw.kT.element_size()
            + sw.lagc.nbytes + sw.order.nbytes + 3 * n * es)


CLASS_UPDATE_FLOPS = 10  # per row: lagc*xlag + y - d*x, (1-w) x + w/d (b - off)


def sweep_flops(sw) -> int:
    if isinstance(sw, ClassSweep):
        return 2 * _nnz(sw.A.vals) + CLASS_UPDATE_FLOPS * sw.A.nrows_pad
    return 2 * _nnz(sw.A.vals) + 2 * _nnz(sw.kT)


RESOLVE_FLOPS = 4  # per boundary row: d * x, y - d x, b - (...), / d


def smooth_bytes(sw, lag_row=None, bound=None, start=None) -> int:
    """Bytes one smoother call needs, each input read once and each output
    written once, whatever its sweeps: the sweep's (``sweep_bytes``: x and b
    included), the Lagrange row where it relaxes (``lag_row``), where it
    re-solves (``bound``, a non-empty DeviceCompact) the boundary rows'
    nonzeros (value and int32 column), targets and diagonals, and where it
    pins (``start``: mask, values) both vectors.
    ``probes.launchrank`` charges a fused launch of ``iters`` sweeps
    ``iters`` times the one-sweep call's bound instead: what ``iters``
    separate sweeps must move."""
    n = sweep_bytes(sw)
    if lag_row is not None:
        n += lag_row.nbytes
    if bound is not None and bound.nrows:
        es = bound.vals.element_size()
        n += _nnz(bound.vals) * (es + 4) + bound.nrows * (4 + es)
    if start is not None:
        n += start[0].nbytes + start[1].nbytes
    return n


def smooth_flops(sw, iters: int = 1, lag_row=None, bound=None, resolves: int = 0) -> int:
    """Operations of ``iters`` sweeps, each with its relax (a multiply and an
    add a row, then the update) and re-solve (the rows' products and
    ``RESOLVE_FLOPS`` a row), and of ``resolves`` more re-solves (the
    V-cycle's, in the same call)."""
    per = sweep_flops(sw)
    if lag_row is not None:
        per += 2 * lag_row.numel() + 4
    resolve = (compact_flops(bound) + RESOLVE_FLOPS * bound.nrows
               if bound is not None and bound.nrows else 0)
    return iters * (per + resolve) + resolves * resolve


def level_smooth_args(level) -> tuple:
    """(lag_row, bound) of a GpuLevel's smoother: None where it has no
    border or no boundary rows."""
    return (level.lag_row if level.has_lagrange else None,
            level.bound if level.bound.nrows else None)


def probe_bytes(sw) -> int:
    """Bytes one sweep of a sweep-probe mode (``sw.role``) needs:
    ``probe_base`` and ``probe_hoist`` as ``sweep_bytes``; ``probe_nodot``
    reads no K, ``probe_nogather`` no A (neither values nor columns)."""
    es = sw.A.vals.element_size()
    a = _nnz(sw.A.vals) * (es + 4)
    k = _nnz(sw.kT) * sw.kT.element_size()
    vecs = sw.lagc.nbytes + sw.order.nbytes + 3 * sw.A.nrows_pad * es
    return {"probe_nodot": a, "probe_nogather": k}.get(sw.role, a + k) + vecs


def probe_flops(sw) -> int:
    a, k = 2 * _nnz(sw.A.vals), 2 * _nnz(sw.kT)
    return {"probe_nodot": a, "probe_nogather": k}.get(sw.role, a + k)


def spmv_probe_bytes(A) -> int:
    """Bytes one launch of an SpMV probe mode (``A.role``) needs: as
    ``spmv_bytes`` ("spmvp_base", "spmvp_noreduce"); "spmvp_nogather" and
    "spmvp_neither" read no x."""
    if A.role in ("spmvp_nogather", "spmvp_neither"):
        es = A.vals.element_size()
        return _nnz(A.vals) * (es + 4) + A.nrows_pad * es
    return spmv_bytes(A)


def spmv_probe_flops(A) -> int:
    """Per nonzero a multiply and an add, and for the no-gather modes the
    multiply by 1e-9 on top."""
    nogather = A.role in ("spmvp_nogather", "spmvp_neither")
    return (3 if nogather else 2) * _nnz(A.vals)


def _kiso_pad_work(A) -> int:
    """Padded output blocks that do real work: an unguarded one computes
    block 0's rows again; a guarded one reads its id and stops."""
    from meshlessmultigridpoisson_torch.ops.gpu_kernels import KISO_GUARDED

    if A.ids is None or A.role in KISO_GUARDED:
        return 0
    return int((A.ids < 0).sum())


def kiso_bytes(A) -> int:
    """Bytes one launch of a kiso role (``A`` a KisoEll) needs: per nonzero
    its f32 value and its column (4 B int32, or 2 B for the u16 roles, which
    add 4 B of base column a block); the id roles 4 B an id; x read once,
    y written once.  An unguarded padded block does real work and counts
    it: block 0's nonzeros and base column again and 128 rows of y.  The
    mma roles (widths padded to a multiple of 8) count the nonzeros only."""
    from meshlessmultigridpoisson_torch.ops.gpu_kernels import KISO_U16

    u16 = A.role in KISO_U16
    nz = A.vals != 0
    pad = _kiso_pad_work(A)
    nnz = int(nz.sum()) + pad * int(nz[:128].sum())
    out_rows = A.nrows_pad if A.ids is None else 128 * (int((A.ids >= 0).sum()) + pad)
    n = nnz * (6 if u16 else 8) + 4 * A.ncols + 4 * out_rows
    if u16:
        n += 4 * (A.nrows_pad // 128 + pad)
    if A.ids is not None:
        n += 4 * A.ids.numel()
    return n


def kiso_flops(A):
    """Operations one launch of a kiso role needs: a multiply and an add
    per nonzero (unguarded padded blocks: block 0's again).  The mma roles
    (a dict by ``PEAKS`` key): a row's entries padded with zeros to a
    multiple of 8, the mma's chunk, each count as a multiply on the CUDA
    cores (f32), plus, for two passes, the subtract of the hi/lo split; and
    as one tensor-core add a pass (TF32: column 0 of the product; the other
    seven columns of the all-ones B repeat it and are not counted)."""
    from meshlessmultigridpoisson_torch.ops.gpu_kernels import KISO_MMA

    nz = A.vals != 0
    if A.role in KISO_MMA:
        passes = KISO_MMA[A.role]
        mults = int(((nz.sum(dim=1) + 7) // 8 * 8).sum())
        return {torch.float32: mults * passes, "tf32_tensor": mults * passes}
    return 2 * (int(nz.sum()) + _kiso_pad_work(A) * int(nz[:128].sum()))


def stream_bytes(v: torch.Tensor, c, tile_rows: int) -> int:
    """Bytes one pass of the stream kernel needs: each table read once
    (``c`` None for the "f32" mix: 4 B an element; f32i32 and f32f32 8 B,
    f32i16 6 B) and the 8 output rows per tile written once."""
    out = v.shape[0] // tile_rows * 8 * v.shape[1] * 4
    return v.nbytes + (0 if c is None else c.nbytes) + out


def stream_flops(v: torch.Tensor, c, tile_rows: int) -> int:
    """One add per summed element; "f32i16" sums ``v`` and selects one row
    of a tile (a compare and an add per column)."""
    if c is None:
        return v.numel()
    if c.dtype == torch.int16:
        return v.numel() + 2 * (v.shape[0] // tile_rows) * v.shape[1]
    return v.numel() + c.numel()


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


def compact_fill(C) -> float:
    """Mean ``lens`` of a compact table's true rows over its width: the
    share of each row the kernels read."""
    m = C.nrows
    return float(C.lens[:m].double().mean()) / C.width if m else 0.0


def ppe_tail_bytes(T) -> int:
    """Bytes the function of one ``ppe_tail`` call needs (``T`` a
    PpeTail): the boundary rows' nonzeros (value and int32 column) and each
    true row's target, and over the fine level p, q, x, the Lagrange column
    and the live flags (1 B) read once, y written once.  The kernel's own
    row -> compact-row map and the rows' ``lens`` are how it reads them,
    not what the function needs: not counted."""
    C = T.C
    es = C.vals.element_size()
    return _nnz(C.vals) * (es + 4) + 4 * C.nrows + C.n_pad * (5 * es + 1)


def ppe_tail_flops(T) -> int:
    """The rows' products, p + q a row, the Lagrange column's product and
    add a row."""
    return compact_flops(T.C) + 3 * T.C.n_pad


def library_csr(vals: torch.Tensor, cols: torch.Tensor, ncols: int):
    """The nonzeros of a row-major ELL table as a ``torch.sparse`` CSR
    matrix: the operand of the library yardstick (``csr @ x``), a call the
    port never makes."""
    nz = vals != 0
    crow = torch.zeros(vals.shape[0] + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = nz.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(crow, cols[nz].long(), vals[nz],
                                   size=(vals.shape[0], ncols))


ENQUEUE_MS = 0.05  # below this a chain of launches times the host's enqueue


def device_ms(op, x: torch.Tensor, k: int = 50, tries: int = 3) -> float:
    """Device time per call of ``op(x)`` in ms: ``k`` calls after a warm-up
    under ``torch.profiler``, the summed duration of every device activity
    (kernels, copies, sets) over ``k``.  For calls whose chain time
    (``chain_time``) is below ``ENQUEUE_MS``, where that is the host's
    enqueue rate.  A window in which the profiler recorded no device
    activity at all (it has dropped a whole window's activities on an
    H100) is profiled again, up to ``tries`` windows; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("device_ms times on the card: it takes a CUDA tensor")
    op(x)
    torch.cuda.synchronize(x.device)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                op(x)
            torch.cuda.synchronize(x.device)
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / k
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} windows")


def _streamed_bytes(level, sweep: bool) -> int:
    """Bytes the level's kernel moves per application (model above)."""
    return sweep_bytes(level.sweep) if sweep else spmv_bytes(level.A)


def _level_nnz(level) -> int:
    return _nnz(level.A.vals)


def profile_hierarchy(hier, reps: int = 5, k: int = 16) -> list[dict[str, Any]]:
    """Time each level's smoother sweep and matvec on the card.

    Returns one dict per level (coarse -> fine): n, the sweep kind, nnz,
    per-op ms (``smooth`` with one sweep, its relax and re-solve, and
    ``matvec`` of the smoother protocol), Gnnz/s, modelled GB/s, and each
    op's kernel bound with what bounds it, the card's name and power limit;
    then the bounds of one launch of the transfers into the level
    (``restrict_bound_ms``: the restriction from the next finer level, on
    every level but the finest; ``prolong_bound_ms``: the prolongation from
    the next coarser, on every level but the coarsest; ``spmv_bytes`` over
    their tables) and of its boundary re-solve (``resolve_bound_ms``, 0
    without boundary rows), each 0 where the level has none.
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
        # a one-sweep smoother call: the sweep with its relax and re-solve
        mv_b = _streamed_bytes(lv, False)
        sw_b = smooth_bytes(lv.sweep, *level_smooth_args(lv))
        mv_bound, mv_by = bound_ms(mv_b, spmv_flops(lv.A), dt, info["name"])
        sw_bound, sw_by = bound_ms(sw_b, smooth_flops(lv.sweep, 1, *level_smooth_args(lv)),
                                   dt, info["name"])
        def spmv_bound(A):
            return bound_ms(spmv_bytes(A), spmv_flops(A), A.vals.dtype, info["name"])[0]

        nlev = len(hier.levels)
        restrict_b = spmv_bound(hier.restrict[li]) if li + 1 < nlev else 0.0
        prolong_b = spmv_bound(hier.prolong[li - 1]) if li > 0 else 0.0
        resolve_b = (bound_ms(compact_bytes(lv.bound), compact_flops(lv.bound)
                              + RESOLVE_FLOPS * lv.bound.nrows, dt, info["name"])[0]
                     if lv.bound.nrows else 0.0)
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
            restrict_bound_ms=restrict_b,
            prolong_bound_ms=prolong_b,
            resolve_bound_ms=resolve_b,
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
