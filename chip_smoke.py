#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``meshlessmultigridpoisson_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows its own failure):

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernel library from the package's ``csrc/*.cu`` and print the build time;
2. build the slice's hierarchies (square_with_circle, deg 6, kd-tile
   ordering, 512-row assembly blocks, sizes 2500/10000/35000/150000;
   Dirichlet, then Neumann) and hold every kernel against its plain PyTorch
   version on the same inputs on the card: on the Dirichlet hierarchy
   ``ell_spmv`` (f32 and f64) on the fine and coarsest levels, one
   restriction and one prolongation; ``block_oneshot_sweep`` (f32 and f64)
   on the fine level in colored order (``sweep8``) and in storage order
   (``sweep6``) and on the coarsest level in storage order (``sweep7``);
   the bf16-K instance of all three against the bf16 plain version;
   ``stream_ceiling`` at the bench's shape against its plain reduction;
   on the Neumann hierarchy ``compact_rows`` (f32 and f64) on the fine
   level's boundary table (re-solve) and condensation table (pushdown).
   Prints each comparison's relative error, the kernel's and the plain
   version's time, the kernel's bound (bytes over 3.35 TB/s or operations
   over the arithmetic peak, utils/profiling.py) and, for the SpMV and
   compact-row roles, the time of a ``torch.sparse`` CSR matvec over the
   same rows (a yardstick the port never calls);
3. run the port's ``solve`` entry point in-process (one untimed outer pass,
   then the timed solve; launch counters set to 0 before each run and read
   after it), print each SolveRecord, and check: Dirichlet, then on the
   same host problem (repacked, not rebuilt) ``--sweep-order exact`` and
   ``--fast-k``, then Neumann.  Level kernels ``[v7-exact,
   v8-colored x3]`` (exact: ``[v7-exact, v6-oneshot x3]``; fast-k: every K
   in bf16); every kernel role of the path launched (exact: ``spmv6``,
   ``sweep7``, ``sweep6``, with ``spmv8`` and ``sweep8`` at 0; Neumann adds
   both ``compact_rows`` roles); relative L1 residual < 1e-8, re-checked
   from the returned (x, x_lag) with the plain f64 SpMV, border row
   included; L1 error < 1e-6.  After the exact path's counts are read, it
   runs once more with ``--profile`` and its per-level table is printed,
   each time at or above its bound;
4. the fractional-step Navier-Stokes path (``cli ns``, Kovasznay, the
   reference program's default run at its default width and depth: sizes
   170/600/2500/10000, deg 6): on its problem, ``compact_rows`` role
   ``ppe2`` (f32, f64) on the fine boundary table and ``ell_spmv`` on the
   derivative operators against their plain versions; then ``run_ns``
   in-process for 12 steps from rest (counts set to 0 before,
   read after), checking level kinds ``[v7-exact x3, v8-colored]``, the
   path's roles (SpMV, sweeps, ``bound2``, ``ppe2``) launched, every
   fs_residual finite, the steps 0, 4, 8, ... matching the reference's TPU
   record ``results/ns_tpu_r5.json`` within 2e-3 relative, and the last
   step's PPE solve (before the p_relax blend) re-checked with a plain f64
   composition of the compatible operator below 1e-9;
5. the kernel bench (``meshlessmultigridpoisson_torch.bench``) in-process
   on its 1M-row operator (counts set to 0 before, read after; the bench
   holds the stream probe at its timed depth and one sweep of each timed
   kind against their plain versions before it times them): prints its
   JSON line; checks the SpMV spot check, ``stream14``, ``spmv6``,
   ``sweep6`` and ``sweep8`` launched, and every ``pct_of_bound`` <= 105;
6. print a JSON line of per-kernel results, the total time, then, as the
   last line, ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package next to it, it exits with a
non-zero code and prints no result.  ``--sizes`` shrinks the ladder for a
quick rehearsal of the two solve paths; their level-kernel check then only
applies to the default.  The NS path always runs at its default width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

SLICE_SIZES = [2500, 10000, 35000, 150000]
EXPECT_KERNELS = ["v7-exact", "v8-colored", "v8-colored", "v8-colored"]
EXACT_KERNELS = ["v7-exact", "v6-oneshot", "v6-oneshot", "v6-oneshot"]
ROLES = {
    # role: (kernel, route source, TPU kernel replaced)
    "spmv6": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels6.py:407"),
    "spmv8": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels8.py:376"),
    "sweep6": ("block_oneshot_sweep",
               "meshlessmultigridpoisson_torch/csrc/block_oneshot_sweep.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels6.py:515"),
    "sweep7": ("block_oneshot_sweep",
               "meshlessmultigridpoisson_torch/csrc/block_oneshot_sweep.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels6.py:812"),
    "sweep8": ("block_oneshot_sweep",
               "meshlessmultigridpoisson_torch/csrc/block_oneshot_sweep.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels8.py:428"),
    "bound2": ("compact_rows", "meshlessmultigridpoisson_torch/csrc/compact_rows.cu",
               "meshlessmultigridpoisson_tpu/ops/kernels.py:510"),
    "push2": ("compact_rows", "meshlessmultigridpoisson_torch/csrc/compact_rows.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels.py:510"),
    "ppe2": ("compact_rows", "meshlessmultigridpoisson_torch/csrc/compact_rows.cu",
             "meshlessmultigridpoisson_tpu/ops/kernels.py:510"),
    "stream14": ("stream_ceiling", "meshlessmultigridpoisson_torch/csrc/stream_ceiling.cu",
                 "bench.py:118"),
}
DIRICHLET_ROLES = ("spmv6", "spmv8", "sweep7", "sweep8")
EXACT_ROLES = ("spmv6", "sweep6", "sweep7")
BENCH_ROLES = ("spmv6", "sweep6", "sweep8", "stream14")
NEUMANN_ROLES = DIRICHLET_ROLES + ("bound2", "push2")
# the NS main path: the reference program's default run at its own width
# and depth (cli ns defaults), S steps from rest
NS_SIZES = [170, 600, 2500, 10000]
NS_STEPS = 12
NS_ROLES = DIRICHLET_ROLES + ("bound2", "ppe2")
NS_EXPECT_KERNELS = ["v7-exact", "v7-exact", "v7-exact", "v8-colored"]
# the reference's TPU record of that run (2000 steps; history every 4th step)
NS_RECORD = "results/ns_tpu_r5.json"
NS_HIST_RTOL = 2e-3
# tolerances, relative to max |plain output|.  f32: the kernel sums a row in
# another order than the plain gather-sum (warp-shuffle tree vs sequential),
# ~70 products of ~1e5-scale weights with cancellation; a sweep adds the
# 128-term K product on top.  f64: the same reorderings at 1e-16 per op.
# compact_rows is a gather-sum like the SpMV (its re-solve epilogue adds
# two operations per row): the SpMV's tolerances.
# The bf16-K sweep against its bf16 plain version: 1e-2 of max |dx| (both
# round t to bf16; a t element on the other side of a rounding boundary
# moves its column's contribution by one bf16 ulp, 2^-8).  The stream
# probe sums small integers: exact.
TOL = {("spmv", "f32"): 1e-5, ("spmv", "f64"): 1e-12,
       ("sweep", "f32"): 1e-4, ("sweep", "f64"): 1e-11,
       ("compact", "f32"): 1e-5, ("compact", "f64"): 1e-12,
       ("sweep", "bf16k"): 1e-2, ("stream", "f32"): 0.0}
PCT_OF_BOUND_MAX = 105.0


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def bordered_residual(op, b, b_lag, x, x_lag) -> float:
    """Relative L1 residual of the bordered fine system, recomputed from
    (x, x_lag) with the plain f64 gather-sum SpMV on ``x``'s device:
    (||b - A x - lag_col x_lag||_1 + |b_lag - lag_row.x - x_lag|)
    / (||b||_1 + |b_lag|), Dirichlet rows as identity rows x = g.  ``op`` is
    the host f64 LevelOperator; without a border the border terms vanish."""
    import torch

    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops.ell import global_cols

    dev = x.device

    def f(v):
        return torch.as_tensor(v).to(device=dev, dtype=torch.float64)

    dmask = op.dirichlet_mask.to(dev) > 0
    b, b_lag, x_lag = torch.where(dmask, f(op.dirichlet_values), f(b)), f(b_lag), f(x_lag)
    y = gk.ell_spmv_plain(f(op.A.vals), global_cols(op.A).to(dev), x)
    r_lag = torch.zeros((), dtype=torch.float64, device=dev)
    if op.has_lagrange:
        y = y + f(op.lag_col) * x_lag
        r_lag = b_lag - (f(op.lag_row) * x).sum() - x_lag
    y = torch.where(dmask, x, y)
    return float(((b - y).abs().sum() + r_lag.abs())
                 / (b.abs().sum() + b_lag.abs()))


def compatible_residual(prob, b, x, x_lag) -> float:
    """Relative L1 residual of the bordered compatible pressure system
    (b_lag = 0), recomputed from (x, x_lag) on ``x``'s device by a plain f64
    composition of the host-built operators: Dx.(Dx x) + Dy.(Dy x) with the
    gather-sum SpMV, the fine boundary rows' products scattered over it,
    identity rows at padding, the Lagrange border.  ``prob`` is the host
    FracStepProblem."""
    import torch

    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops.ell import global_cols

    dev = x.device

    def f(v):
        return torch.as_tensor(v).to(device=dev, dtype=torch.float64)

    def spmv(m, v):
        return gk.ell_spmv_plain(f(m.vals), global_cols(m).to(dev), v)

    op = prob.hierarchy.finest
    x, x_lag = f(x), f(x_lag)
    y = spmv(prob.dx, spmv(prob.dx, x)) + spmv(prob.dy, spmv(prob.dy, x))
    rows = op.bound.rows.long().to(dev)
    keep = rows < op.n_pad
    y[rows[keep]] = spmv(op.bound.ell, x)[keep]
    y = torch.where(f(op.smooth_mask + op.neumann_mask) > 0, y, x)
    y = y + f(op.lag_col) * x_lag
    r_lag = (f(op.lag_row) * x).sum() + x_lag
    b = f(b)
    return float(((b - y).abs().sum() + r_lag.abs()) / b.abs().sum())


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=SLICE_SIZES)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from meshlessmultigridpoisson_torch import bench
        from meshlessmultigridpoisson_torch.apps import cli
        from meshlessmultigridpoisson_torch.mg.gpu_backend import (
            gpu_hierarchy,
            gpu_level_from_operator,
        )
        from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem
        from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
        from meshlessmultigridpoisson_torch.utils import profiling as pf
    except ImportError as e:
        return fail(f"the port package is not next to this script ({e})")
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    card_name = torch.cuda.get_device_name(0)
    pf.peaks(card_name)  # the bounds need the card's published peaks
    t0 = time.perf_counter()
    gk.build(verbose=True)
    gk._load()
    print(f"kernel library built in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 2. kernels vs plain on the slice's shapes --------------------------
    geom = dict(geomtype="square_with_circle", sizes=args.sizes, poly_deg=6,
                ordering="kdtile", block_rows=512)
    t0 = time.perf_counter()
    prob = make_poisson_problem(**geom, device=dev)
    hier = prob.hierarchy
    g32 = gpu_hierarchy(hier, dev, torch.float32)
    coarse64 = gpu_level_from_operator(hier.levels[0], dev, torch.float64)
    fine64 = gpu_level_from_operator(hier.levels[-1], dev, torch.float64)
    torch.cuda.synchronize()
    print(f"phase-2 setup {time.perf_counter() - t0:.1f} s, sizes "
          f"{[c.n for c in prob.clouds]}, level kinds "
          f"{[lv.kernel_kind for lv in g32.levels]}", flush=True)

    gen = torch.Generator(device="cpu").manual_seed(0)
    results = {r: [] for r in ROLES}

    def record(role, label, tol_key, err, scale, ms, plain_ms, nbytes, flops,
               dtype, library_ms=None):
        rel = err / max(scale, 1e-300)
        tol = TOL[tol_key]
        b_ms, by = pf.bound_ms(nbytes, flops, dtype, card_name)
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        print(f"  {label:<52s} rel err {rel:.3e} (tol {tol:.0e})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms "
              f"({by}){lib}", flush=True)
        results[role].append(dict(label=label, max_abs_err=err, rel_err=rel,
                                  ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=by, library_ms=library_ms))
        if not rel <= tol:
            raise AssertionError(f"{label}: relative error {rel:.3e} > {tol:.0e}")

    def ms_of(op, x, k):
        """ms per application of ``op(x)``: k back-to-back calls after a
        warm-up, between CUDA events."""
        return pf.chain_time(op, x, k=k, reps=1) * 1e3

    def dname(dtype):
        return "f32" if dtype == torch.float32 else "f64"

    def check_spmv(role, label, A):
        x = torch.randn(A.ncols, generator=gen, dtype=torch.float64).to(
            device=dev, dtype=A.vals.dtype)
        y = gk.ell_spmv(A, x)
        torch.cuda.synchronize()
        yp = gk.ell_spmv_plain(A.vals, A.cols, x)
        err = float((y - yp).abs().max())
        ms = ms_of(lambda v: gk.ell_spmv(A, v), x, 50)
        pms = ms_of(lambda v: gk.ell_spmv_plain(A.vals, A.cols, v), x, 10)
        csr = pf.library_csr(A.vals, A.cols, A.ncols)
        lms = ms_of(lambda v: csr @ v, x, 50)
        dt = dname(A.vals.dtype)
        record(role, f"ell_spmv {dt} {label}", ("spmv", dt), err,
               float(yp.abs().max()), ms, pms, pf.spmv_bytes(A), pf.spmv_flops(A),
               A.vals.dtype, lms)

    def check_sweep(label, sw):
        dtype = sw.A.vals.dtype
        n = sw.A.nrows_pad
        x0 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dtype)
        xl = torch.zeros((), dtype=dtype, device=dev)
        xk = gk.block_oneshot_sweep(sw, x0.clone(), xl, b)
        torch.cuda.synchronize()
        xp = gk.block_oneshot_sweep_plain(sw, x0.clone(), xl, b)
        err = float((xk - xp).abs().max())
        xs = x0.clone()
        ms = ms_of(lambda v: gk.block_oneshot_sweep(sw, v, xl, b), xs, 20)
        pms = ms_of(lambda v: gk.block_oneshot_sweep_plain(sw, v, xl, b), xs, 3)
        if sw.kT.dtype == torch.bfloat16:
            dt, scale = "bf16k", float((xp - x0).abs().max())
        else:
            dt, scale = dname(dtype), float(xp.abs().max())
        record(sw.role, f"block_oneshot_sweep {dt} {label} "
               f"({sw.nphases} launches)", ("sweep", dt), err, scale, ms, pms,
               pf.sweep_bytes(sw), pf.sweep_flops(sw), dtype)

    def storage_order(sw, role):
        nb = sw.A.nrows_pad // gk.LANES
        return dataclasses.replace(
            sw, order=torch.arange(nb, dtype=torch.int32, device=dev),
            phase_ptr=(0, nb), serial=True, role=role)

    def bf16k(sw):
        return dataclasses.replace(sw, kT=sw.kT.to(torch.bfloat16))

    print("kernel vs plain (same inputs, on the card):", flush=True)
    fine32, coarse32 = g32.levels[-1], g32.levels[0]
    check_spmv(fine32.A.role, "fine matvec", fine32.A)
    check_spmv(fine64.A.role, "fine matvec", fine64.A)
    check_spmv(coarse32.A.role, "coarsest matvec", coarse32.A)
    check_spmv(coarse64.A.role, "coarsest matvec", coarse64.A)
    for name, ell in (("restriction fine->next", hier.restrict[-1]),
                      ("prolongation next->fine", hier.prolong[-1])):
        for dt in (torch.float32, torch.float64):
            check_spmv("spmv6", name, gk.device_ell(ell, dt, dev, "spmv6"))
    check_sweep("fine, colored order", fine32.sweep)
    check_sweep("fine, colored order", fine64.sweep)
    check_sweep("fine, storage order", storage_order(fine32.sweep, "sweep6"))
    check_sweep("fine, storage order", storage_order(fine64.sweep, "sweep6"))
    check_sweep("coarsest, storage order", coarse32.sweep)
    check_sweep("coarsest, storage order", coarse64.sweep)
    check_sweep("fine, colored order", bf16k(fine32.sweep))
    check_sweep("fine, storage order", bf16k(storage_order(fine32.sweep, "sweep6")))
    check_sweep("coarsest, storage order", bf16k(coarse32.sweep))
    del g32, coarse64, fine64, hier, prob
    torch.cuda.empty_cache()

    # the bench's stream probe at its own shape: sums of small integers
    sv = torch.randint(0, 4, (bench.STREAM_ROWS, gk.STREAM_COLS), generator=gen).to(
        dev, torch.float32)
    sc = torch.randint(0, 4, (bench.STREAM_ROWS, gk.STREAM_COLS), generator=gen,
                       dtype=torch.int32).to(dev)
    out = gk.stream_ceiling(sv, sc, bench.STREAM_TILE)
    torch.cuda.synchronize()
    ref = gk.stream_ceiling_plain(sv, sc, bench.STREAM_TILE)
    ms = ms_of(lambda v: gk.stream_ceiling(v, sc, bench.STREAM_TILE), sv, 20)
    pms = ms_of(lambda v: gk.stream_ceiling_plain(v, sc, bench.STREAM_TILE), sv, 20)
    record("stream14", "stream_ceiling f32+i32 2 x [262144, 128] (1 pass)",
           ("stream", "f32"), float((out - ref).abs().max()), float(ref.abs().max()),
           ms, pms, sv.nbytes + sc.nbytes + out.nbytes, 2 * sv.numel(), torch.float32)
    del sv, sc, out, ref

    def check_compact(label, C):
        """Kernel vs plain on one table: "bound2" re-solves x in place,
        "push2" gathers b, "ppe2" scatters into a copy of b (never x)."""
        n = C.n_pad
        x0 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, C.vals.dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, C.vals.dtype)
        xin = b if C.role == "push2" else x0
        base = x0 if C.role == "bound2" else b  # what the output starts from
        before = gk.COUNTS[C.role]
        out = gk.compact_rows(C, xin.clone(), b.clone())
        torch.cuda.synchronize()
        if gk.COUNTS[C.role] != before + 1:
            raise AssertionError(f"compact_rows {label}: no launch counted")
        ref = gk.compact_rows_plain(C, xin.clone(), b.clone())
        err = float((out - ref).abs().max())
        untouched = torch.ones(n, dtype=torch.bool, device=dev)
        untouched[C.rows[: C.nrows].long()] = False
        if not torch.equal(out[untouched], base[untouched]):
            raise AssertionError(f"compact_rows {label}: wrote outside its rows")
        xs, bs = xin.clone(), b.clone()
        ms = ms_of(lambda v: gk.compact_rows(C, v, bs), xs, 200)
        pms = ms_of(lambda v: gk.compact_rows_plain(C, v, bs), xs, 50)
        csr = pf.library_csr(C.vals, C.cols, C.n_pad)
        lms = ms_of(lambda v: csr @ v, xs, 200)
        dt = dname(C.vals.dtype)
        record(C.role, f"compact_rows {dt} {label} ({C.nrows} of {C.m_pad} rows, "
               f"width {C.width})", ("compact", dt), err, float(ref.abs().max()),
               ms, pms, pf.compact_bytes(C), pf.compact_flops(C), C.vals.dtype, lms)

    t0 = time.perf_counter()
    prob = make_poisson_problem(**geom, neumann=True, device=dev)
    fine = prob.hierarchy.levels[-1]
    torch.cuda.synchronize()
    print(f"phase-2 Neumann setup {time.perf_counter() - t0:.1f} s, sizes "
          f"{[c.n for c in prob.clouds]}", flush=True)
    for dt in (torch.float32, torch.float64):
        check_compact("fine boundary re-solve",
                      gk.device_compact(fine.bound, dt, dev, "bound2"))
        check_compact("fine condensation pushdown",
                      gk.device_compact(fine.cond, dt, dev, "push2"))
    del prob, fine
    torch.cuda.empty_cache()

    # ---- 3. the main paths through the CLI entry point -----------------------
    argv_solve = ["solve", "--device", "cuda", "--geom", "square_with_circle",
                  "--sizes", *map(str, args.sizes), "--deg", "6",
                  "--ordering", "kdtile", "--block-rows", "512", "--tol", "1e-8"]
    full = args.sizes == SLICE_SIZES
    launches = {}
    # (path, extra flags, roles that must launch, roles that must not,
    #  expected level kinds, reuse the previous path's host problem)
    paths = (("dirichlet", [], DIRICHLET_ROLES, (), EXPECT_KERNELS, False),
             ("exact", ["--sweep-order", "exact"], EXACT_ROLES,
              ("spmv8", "sweep8"), EXACT_KERNELS, True),
             ("fast-k", ["--fast-k"], DIRICHLET_ROLES, (), EXPECT_KERNELS, True),
             ("neumann", ["--neumann"], NEUMANN_ROLES, (), EXPECT_KERNELS, False))
    prob = None
    for path, extra, roles, idle_roles, expect, reuse in paths:
        argv = argv_solve + extra
        print(f"main path ({path}): python -m meshlessmultigridpoisson_torch.apps.cli "
              + " ".join(argv) + (" (host problem reused)" if reuse else ""), flush=True)
        if not reuse:
            prob = None
            torch.cuda.empty_cache()
        gk.reset_counts()
        rec, prob, x, xl = cli.run_solve(argv, problem=prob)
        torch.cuda.synchronize()
        launches[path] = dict(gk.COUNTS)
        print(rec.to_json(), flush=True)
        print(f"launches during the {path} main path: {launches[path]}", flush=True)

        kinds = rec.extra["level_kernels"]
        if full and kinds != expect:
            return fail(f"{path}: level kernels {kinds} != {expect}")
        # a cut ladder may have no level past the union bound (no sweep6)
        idle = [r for r in roles if launches[path][r] == 0 and (full or r != "sweep6")]
        if idle:
            return fail(f"{path}: kernel roles never launched on the main path: {idle}")
        busy = [r for r in idle_roles if launches[path][r] != 0]
        if busy:
            return fail(f"{path}: roles off this path launched: {busy}")
        want_k = "torch.bfloat16" if path == "fast-k" else "torch.float32"
        if any(d != want_k for d in rec.extra["level_k_dtypes"]):
            return fail(f"{path}: K dtypes {rec.extra['level_k_dtypes']}, want {want_k}")
        if not rec.final_residual < 1e-8:
            return fail(f"{path}: final residual {rec.final_residual:.3e} >= 1e-8")
        # independent re-check: plain f64 gather-sum SpMV on the returned
        # (x, x_lag), against the host-built right-hand side
        recheck = bordered_residual(prob.hierarchy.levels[-1], prob.state0.b[-1],
                                    prob.state0.b_lag[-1], x, xl)
        print(f"{path}: re-checked relative L1 residual (plain f64 SpMV, border "
              f"row included): {recheck:.3e}", flush=True)
        if not recheck < 1e-8:
            return fail(f"{path}: re-checked residual {recheck:.3e} >= 1e-8")
        if not rec.l1_error < 1e-6:
            return fail(f"{path}: l1_error {rec.l1_error:.3e} >= 1e-6")
        if path == "exact":  # the per-level profile, after the counts are read
            rec, *_ = cli.run_solve(argv + ["--profile"], problem=prob)
            print(f"{path}: per-level profile, cli solve {' '.join(extra)} "
                  f"--profile ({card}):", flush=True)
            for row in rec.extra["per_level"]:
                print("  " + json.dumps(row), flush=True)
            slow = [r["level"] for r in rec.extra["per_level"]
                    if not 0 < r["sweep_bound_ms"] <= r["sweep_ms"]
                    or not 0 < r["matvec_bound_ms"] <= r["matvec_ms"]]
            if slow:
                return fail(f"{path}: per-level time below its bound at levels {slow}")
        del rec, x, xl
    del prob
    torch.cuda.empty_cache()

    # ---- 4. the fractional-step Navier-Stokes path ---------------------------
    from meshlessmultigridpoisson_torch.models.fracstep import build_fracstep_problem
    from meshlessmultigridpoisson_torch.models.fracstep_gpu import build_gpu_fracstep

    t0 = time.perf_counter()
    nsp = build_fracstep_problem(sizes=NS_SIZES, poly_deg=6, device=dev)
    gfs = build_gpu_fracstep(nsp, dev)
    torch.cuda.synchronize()
    print(f"phase-4 NS setup {time.perf_counter() - t0:.1f} s, sizes "
          f"{[c.n for c in nsp.clouds]}, level kinds "
          f"{[lv.kernel_kind for lv in gfs.hd.levels]}", flush=True)
    check_compact("NS compatible-PPE scatter", gfs.ppe32)
    check_compact("NS compatible-PPE scatter", gfs.ppe64)
    check_spmv("spmv6", "NS d/dx", gfs.dx32)
    check_spmv("spmv6", "NS velocity Laplacian", gfs.lap32)
    check_spmv("spmv6", "NS d/dx", gfs.dx64)
    del nsp, gfs
    torch.cuda.empty_cache()

    argv = ["ns", "--device", "cuda", "--sizes", *map(str, NS_SIZES), "--deg", "6",
            "--steps", str(NS_STEPS)]
    print("main path (ns): python -m meshlessmultigridpoisson_torch.apps.cli "
          + " ".join(argv), flush=True)
    gk.reset_counts()
    rec, prob, last = cli.run_ns(argv)
    torch.cuda.synchronize()
    launches["ns"] = dict(gk.COUNTS)
    print(rec.to_json(), flush=True)
    print(f"launches during the ns main path: {launches['ns']}", flush=True)
    ex = rec.extra
    print(f"ns: setup {ex['setup_time_s']:.2f} s, {NS_STEPS} steps in "
          f"{rec.wall_time_s:.2f} s (first {ex['step_time_s'][0]:.2f} s, then "
          f"{sum(ex['step_time_s'][1:]) / max(len(ex['step_time_s']) - 1, 1):.3f} "
          f"s/step); PPE outer passes {ex['ppe_outer']}, inner iterations "
          f"{ex['ppe_inner_iters']}, final PPE residuals {ex['ppe_residual']}",
          flush=True)
    if rec.extra["level_kernels"] != NS_EXPECT_KERNELS:
        return fail(f"ns: level kernels {rec.extra['level_kernels']} != "
                    f"{NS_EXPECT_KERNELS}")
    idle = [r for r in NS_ROLES if launches["ns"][r] == 0]
    if idle:
        return fail(f"ns: kernel roles never launched on the main path: {idle}")
    hist = rec.residual_history  # every step while steps < 1000
    if len(hist) != NS_STEPS or not all(math.isfinite(h) for h in hist):
        return fail(f"ns: fs_residual history not finite or short: {hist}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           NS_RECORD)) as fh:
        ref = json.load(fh)
    if rec.config["sizes"] != ref["config"]["sizes"]:
        return fail(f"ns: cloud sizes {rec.config['sizes']} != the record's "
                    f"{ref['config']['sizes']}")
    dev_max = 0.0
    for step in range(0, NS_STEPS, 4):
        r = ref["residual_history"][step // 4]
        d = abs(hist[step] - r) / r
        dev_max = max(dev_max, d)
        print(f"  ns step {step}: fs_residual {hist[step]:.10e} record "
              f"{r:.10e} rel dev {d:.3e} (tol {NS_HIST_RTOL:.0e})", flush=True)
    print(f"ns: largest deviation from {NS_RECORD}: {dev_max:.3e}", flush=True)
    if not dev_max <= NS_HIST_RTOL:
        return fail(f"ns: fs_residual deviates {dev_max:.3e} from the record")
    recheck = compatible_residual(prob, last["b"].to(dev), last["x"].to(dev),
                                  last["x_lag"].to(dev))
    print(f"ns: last PPE solve re-checked with the plain f64 compatible "
          f"operator: relative L1 residual {recheck:.3e} (solver reported "
          f"{ex['ppe_residual'][-1]:.3e})", flush=True)
    if not recheck < 1e-9:
        return fail(f"ns: re-checked PPE residual {recheck:.3e} >= 1e-9")
    del rec, prob, last
    torch.cuda.empty_cache()

    # ---- 5. the kernel bench -------------------------------------------------
    print("main path (bench): python -m meshlessmultigridpoisson_torch.bench", flush=True)
    gk.reset_counts()
    res = bench.run()
    torch.cuda.synchronize()
    launches["bench"] = dict(gk.COUNTS)
    print(json.dumps(res), flush=True)
    print(f"launches during the bench: {launches['bench']}", flush=True)
    idle = [r for r in BENCH_ROLES if launches["bench"][r] == 0]
    if idle:
        return fail(f"bench: kernel roles never launched: {idle}")
    over = {k: r["pct_of_bound"] for k, r in res["extra"]["kernels_ms"].items()
            if not r["pct_of_bound"] <= PCT_OF_BOUND_MAX}
    if over:
        return fail(f"bench: time below the bound (pct_of_bound > {PCT_OF_BOUND_MAX}): "
                    f"{over}")
    del res
    torch.cuda.empty_cache()

    # ---- 6. results ----------------------------------------------------------
    kernels = []
    for role, (name, source, replaces) in ROLES.items():
        by_path = {p: n[role] for p, n in launches.items()}
        for c in results[role]:
            kernels.append(dict(name=f"{name} [{role}] {c['label']}", route="cuda",
                                source=source, replaces=replaces,
                                launches=sum(by_path.values()),
                                launches_by_path=by_path,
                                max_abs_err=c["max_abs_err"],
                                ms=c["ms"], plain_ms=c["plain_ms"],
                                bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                                library_ms=c["library_ms"]))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s "
          f"({card})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
