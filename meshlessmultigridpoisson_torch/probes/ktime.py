"""Kernel-generation timing probe on a real RBF-FD pattern (card only).

    python -m meshlessmultigridpoisson_torch.probes.ktime [n] [iters]

Port of the reference package's ``scripts/ktime.py`` (defaults 1,048,576
rows and 50 iterations).  On ``probes.realsparsity.real_pattern_csr(n)``
(k = 70, values from seed 0) it times the kernels each reference kernel
generation runs, at the reference's block sizes:

* v2 (``spmv_tpu2``, ``sor_sweep_tpu2``) at 128- and 256-row ELL blocks:
  ``ell_spmv`` role ``spmv2`` and ``class_sor_sweep`` role ``sweep2``,
  the latter also timed against its parent design (``sweep2_tilewalk``,
  timing only) in turns parent, kernel, kernel, parent;
* v4 (``spmv_tpu4``, ``sor_sweep_tpu4``) at 128 rows: ``ell_spmv`` role
  ``spmv4`` and ``class_sor_sweep`` role ``sweep4``;
* v5 (``sor_sweep_tpu5``) at 128 rows: ``block_oneshot_sweep`` in storage
  order, role ``sweep5``, with K from ``build_oneshot_K`` (omega 1.4).

Sweep inputs are the reference's: omega 1.4 and every row smoothed, b
standard normal (seed 2), no Lagrange column, x_lag 0.  Before it is
timed, each kernel is held against its plain version on the same inputs
at the timed size (``TOL``, relative to max |plain output|); at 1M rows
the plain class sweep is a loop of 131,072 tile steps on the card (~10 s
a call on an H100).  Times are ``utils.profiling.chain_time`` (CUDA
events): the SpMV applied ``iters`` times to one input, a sweep chained
``iters`` times in place, the median of three such runs.  Each kernel's
line gives ms per call, Gnnz/s with nnz = n * k (the reference's count),
its bound (``utils.profiling``), the plain version's ms (a sweep: one
call; an SpMV: ``iters`` calls after a warm-up) and, for an SpMV, a
``torch.sparse`` CSR matvec's ms (timed, never called by the port); the
card's name and power
limit head the output, and one JSON line ends it.  Without a card it
exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from meshlessmultigridpoisson_torch.probes.realsparsity import K, real_pattern_csr

N, ITERS = 1_048_576, 50
OMEGA = 1.4
# kernel vs plain, relative to max |plain output|: an SpMV sums ~70
# products in another order (f32); a sweep adds the update's few
# operations, or the 128-term K product (v5), on top
TOL = {"spmv": 1e-5, "sweep": 1e-4}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_operator(n: int = N, seed: int = 0) -> dict:
    """Host side: the pattern, its ELL at 128- and 256-row blocks, and the
    v5 sweep's K (omega 1.4, every true row smoothed) at 128 rows."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops.ell import ell_from_csr

    a = real_pattern_csr(n, seed=seed)
    ells = {br: ell_from_csr(a, block_rows=br) for br in (128, 256)}
    kT = gk.build_oneshot_K(ells[128], np.full(ells[128].nrows_pad, OMEGA),
                            np.ones(a.shape[0]))
    return dict(a=a, ells=ells, kT=kT)


def _once_ms(fn):
    """(result, ms) of one call between CUDA events."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def run(n: int = N, iters: int = ITERS, seed: int = 0) -> dict:
    """Build, check and time; returns the result line as a dict."""
    if not torch.cuda.is_available():
        raise SystemExit("the ktime probe times on the card: "
                         "torch.cuda.is_available() is False")
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    info = pf.card()
    log(f"card {info['name']}, power limit {info['power_limit']}")
    t0 = time.perf_counter()
    op = build_operator(n, seed)
    setup_s = time.perf_counter() - t0
    n = op["a"].shape[0]
    nnz = n * K
    log(f"host setup {setup_s:.1f} s: n {n}, k {K}, stored nnz {op['a'].nnz}")
    # inputs over the longer padding (256-row blocks), cut per block size
    n_max = op["ells"][256].nrows_pad
    x_all = torch.from_numpy(np.random.default_rng(1).standard_normal(n_max)).to(dev, f32)
    b_all = torch.from_numpy(np.random.default_rng(2).standard_normal(n_max)).to(dev, f32)
    zl = torch.zeros((), dtype=f32, device=dev)
    rows = {}

    def row(label, role, ms, plain_ms, err, scale, nbytes, flops, library_ms=None):
        b_ms, by = pf.bound_ms(nbytes, flops, f32, info["name"])
        rows[label] = dict(role=role, ms=ms, gnnz_s=nnz / ms / 1e6,
                           plain_ms=plain_ms, max_abs_err=err, rel_err=err / scale,
                           bound_ms=b_ms, bound_by=by, pct_of_bound=100.0 * b_ms / ms,
                           library_ms=library_ms)
        log(f"  {label:<20s} [{role}] {ms:.4f} ms/iter  {nnz / ms / 1e6:.2f} Gnnz/s  "
            f"bound {b_ms:.4f} ms ({by}, {100.0 * b_ms / ms:.2f}%)  plain "
            f"{plain_ms:.4f} ms  rel err {err / scale:.2e}"
            + ("" if library_ms is None else f"  library {library_ms:.4f} ms"))

    def held(kind, label, out, ref):
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        if not err <= TOL[kind] * scale:
            raise AssertionError(f"{label}: kernel vs plain {err / scale:.3e} > "
                                 f"{TOL[kind]:.0e}")
        return err, scale

    def spmv(label, A):
        x = x_all[: A.ncols].contiguous()
        ref = gk.ell_spmv_plain(A.vals, A.cols, x)
        err, scale = held("spmv", label, gk.ell_spmv(A, x), ref)
        plain_ms = pf.chain_time(lambda v: gk.ell_spmv_plain(A.vals, A.cols, v), x,
                                 k=iters, reps=1) * 1e3
        ms = pf.chain_time(lambda v: gk.ell_spmv(A, v), x, k=iters, reps=3) * 1e3
        csr = pf.library_csr(A.vals, A.cols, A.ncols)
        lib = pf.chain_time(lambda v: csr @ v, x, k=iters, reps=3) * 1e3
        row(label, A.role, ms, plain_ms, err, scale, pf.spmv_bytes(A), pf.spmv_flops(A),
            lib)

    def sweep(label, sw, fn, plain, parent=None):
        """``parent``: the parent design's tables (role
        ``sweep2_tilewalk``), held against the same plain output and timed
        beside the kernel in turns parent, kernel, kernel, parent; its row
        is "``label`` parent"."""
        n_pad = sw.A.nrows_pad
        x0, b = x_all[:n_pad], b_all[:n_pad].contiguous()
        ref, plain_ms = _once_ms(lambda: plain(sw, x0.clone(), zl, b))
        err, scale = held("sweep", label, fn(sw, x0.clone(), zl, b), ref)
        xs = torch.zeros_like(x0)  # the reference chains sweeps from x = 0
        ms = pf.chain_time(lambda v: fn(sw, v, zl, b), xs, k=iters, reps=3) * 1e3
        row(label, sw.role, ms, plain_ms, err, scale, pf.sweep_bytes(sw),
            pf.sweep_flops(sw))
        if parent is None:
            return
        perr, _ = held("sweep", f"{label} parent", fn(parent, x0.clone(), zl, b), ref)
        t = [pf.chain_time(lambda v, s=s: fn(s, v, zl, b), torch.zeros_like(x0), k=iters,
                           reps=1) * 1e3 for s in (parent, sw, sw, parent)]
        row(f"{label} parent", parent.role, (t[0] + t[3]) / 2, plain_ms, perr, scale,
            pf.sweep_bytes(sw), pf.sweep_flops(sw))
        rows[label]["ab_ms"] = rows[f"{label} parent"]["ab_ms"] = t
        log(f"  {label}: parent / kernel / kernel / parent "
            + " / ".join(f"{v:.4f}" for v in t) + " ms")

    for br in (128, 256):
        ell = op["ells"][br]
        n_pad = ell.nrows_pad
        A = gk.device_ell(ell, f32, dev, "spmv2")
        log(f"br={br}: n_pad {n_pad}, width {ell.width}")
        spmv(f"spmv v2 (br={br})", A)
        sw = gk.class_sweep(A, ell.diag, np.ones(n), np.full(n_pad, OMEGA),
                            np.zeros(n_pad), role="sweep2")
        sweep(f"sweep v2 (br={br})", sw, gk.class_sor_sweep, gk.class_sor_sweep_plain,
              dataclasses.replace(sw, role=gk.CLASS_PARENT))
        if br != 128:
            continue
        spmv("spmv v4", dataclasses.replace(A, role="spmv4"))
        sweep("sweep v4", dataclasses.replace(sw, role="sweep4"), gk.class_sor_sweep,
              gk.class_sor_sweep_plain)
        nb = n_pad // gk.LANES
        sw5 = gk.BlockSweep(A=A, kT=torch.from_numpy(op["kT"]).to(dev, f32),
                            lagc=torch.zeros(n_pad, dtype=f32, device=dev),
                            order=torch.arange(nb, dtype=torch.int32, device=dev),
                            phase_ptr=(0, nb), serial=True, role="sweep5")
        sweep("sweep v5", sw5, gk.block_oneshot_sweep, gk.block_oneshot_sweep_plain)
    return {"probe": "ktime", "n": n, "k": K, "nnz": nnz, "iters": iters,
            "seed": seed, "card": info["name"], "power_limit": info["power_limit"],
            "host_setup_s": setup_s, "kernels": rows}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else N
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    print(json.dumps(run(n, iters)), flush=True)


if __name__ == "__main__":
    main()
