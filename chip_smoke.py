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
   restriction and one prolongation, and ``block_oneshot_sweep`` (f32 and
   f64) on the fine level in colored order and on the coarsest level in
   storage order; on the Neumann hierarchy ``compact_rows`` (f32 and f64)
   on the fine level's boundary table (re-solve) and condensation table
   (pushdown).  Prints each comparison's relative error and both times;
3. run the port's ``solve`` entry point in-process on both configurations
   (one untimed outer pass, then the timed solve; launch counters set to 0
   before each run and read after it), print each SolveRecord, and check:
   level kernels ``[v7-exact, v8-colored x3]``; every kernel role of the
   path launched (Dirichlet: the four SpMV and sweep roles; Neumann: those
   and both ``compact_rows`` roles); relative L1 residual < 1e-8,
   re-checked from the returned (x, x_lag) with the plain f64 SpMV, border
   row included; L1 error < 1e-6;
4. print a JSON line of per-kernel results, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package next to it, it exits with a
non-zero code and prints no result.  ``--sizes`` shrinks the ladder for a
quick rehearsal; the level-kernel check then only applies to the default.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SLICE_SIZES = [2500, 10000, 35000, 150000]
EXPECT_KERNELS = ["v7-exact", "v8-colored", "v8-colored", "v8-colored"]
ROLES = {
    # role: (kernel, route source, TPU kernel replaced)
    "spmv6": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels6.py:407"),
    "spmv8": ("ell_spmv", "meshlessmultigridpoisson_torch/csrc/ell_spmv.cu",
              "meshlessmultigridpoisson_tpu/ops/kernels8.py:376"),
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
}
DIRICHLET_ROLES = ("spmv6", "spmv8", "sweep7", "sweep8")
# tolerances, relative to max |plain output|.  f32: the kernel sums a row in
# another order than the plain gather-sum (warp-shuffle tree vs sequential),
# ~70 products of ~1e5-scale weights with cancellation; a sweep adds the
# 128-term K product on top.  f64: the same reorderings at 1e-16 per op.
# compact_rows is a gather-sum like the SpMV (its re-solve epilogue adds
# two operations per row): the SpMV's tolerances.
TOL = {("spmv", "f32"): 1e-5, ("spmv", "f64"): 1e-12,
       ("sweep", "f32"): 1e-4, ("sweep", "f64"): 1e-11,
       ("compact", "f32"): 1e-5, ("compact", "f64"): 1e-12}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=SLICE_SIZES)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from meshlessmultigridpoisson_torch.apps import cli
        from meshlessmultigridpoisson_torch.mg.gpu_backend import (
            gpu_hierarchy,
            gpu_level_from_operator,
        )
        from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem
        from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
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

    def record(role, label, dtype, err, scale, ms, plain_ms, kind):
        rel = err / max(scale, 1e-300)
        tol = TOL[(kind, dtype)]
        print(f"  {label:<44s} rel err {rel:.3e} (tol {tol:.0e})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms", flush=True)
        results[role].append(dict(label=label, max_abs_err=err, rel_err=rel,
                                  ms=ms, plain_ms=plain_ms))
        if not rel <= tol:
            raise AssertionError(f"{label}: relative error {rel:.3e} > {tol:.0e}")

    def check_spmv(role, label, A):
        x = torch.randn(A.ncols, generator=gen, dtype=torch.float64).to(
            device=dev, dtype=A.vals.dtype)
        y = gk.ell_spmv(A, x)
        torch.cuda.synchronize()
        yp = gk.ell_spmv_plain(A.vals, A.cols, x)
        err = float((y - yp).abs().max())
        ms = time_ms(lambda: gk.ell_spmv(A, x), 50)
        pms = time_ms(lambda: gk.ell_spmv_plain(A.vals, A.cols, x), 10)
        dt = "f32" if A.vals.dtype == torch.float32 else "f64"
        record(role, f"ell_spmv {dt} {label}", dt, err, float(yp.abs().max()),
               ms, pms, "spmv")

    def check_sweep(label, lv):
        sw = lv.sweep
        n = lv.n_pad
        x0 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, sw.kT.dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, sw.kT.dtype)
        xl = torch.zeros((), dtype=sw.kT.dtype, device=dev)
        xk = gk.block_oneshot_sweep(sw, x0.clone(), xl, b)
        torch.cuda.synchronize()
        xp = gk.block_oneshot_sweep_plain(sw, x0.clone(), xl, b)
        err = float((xk - xp).abs().max())
        xs = x0.clone()
        ms = time_ms(lambda: gk.block_oneshot_sweep(sw, xs, xl, b), 20)
        pms = time_ms(lambda: gk.block_oneshot_sweep_plain(sw, xs, xl, b), 3)
        dt = "f32" if sw.kT.dtype == torch.float32 else "f64"
        record(sw.role, f"block_oneshot_sweep {dt} {label} "
               f"({sw.nphases} launches)", dt, err, float(xp.abs().max()),
               ms, pms, "sweep")

    from meshlessmultigridpoisson_torch.ops.gpu_kernels import device_ell

    print("kernel vs plain (same inputs, on the card):", flush=True)
    fine32, coarse32 = g32.levels[-1], g32.levels[0]
    check_spmv(fine32.A.role, "fine matvec", fine32.A)
    check_spmv(fine64.A.role, "fine matvec", fine64.A)
    check_spmv(coarse32.A.role, "coarsest matvec", coarse32.A)
    check_spmv(coarse64.A.role, "coarsest matvec", coarse64.A)
    for name, ell in (("restriction fine->next", hier.restrict[-1]),
                      ("prolongation next->fine", hier.prolong[-1])):
        for dt in (torch.float32, torch.float64):
            check_spmv("spmv6", name, device_ell(ell, dt, dev, "spmv6"))
    check_sweep("fine, colored order", fine32)
    check_sweep("fine, colored order", fine64)
    check_sweep("coarsest, storage order", coarse32)
    check_sweep("coarsest, storage order", coarse64)
    del g32, coarse64, fine64, hier, prob
    torch.cuda.empty_cache()

    def check_compact(label, C):
        n = C.n_pad
        x0 = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, C.vals.dtype)
        b = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, C.vals.dtype)
        xin = x0 if C.role == "bound2" else b  # pushdown: the gather reads b
        before = gk.COUNTS[C.role]
        out = gk.compact_rows(C, xin.clone(), b)
        torch.cuda.synchronize()
        if gk.COUNTS[C.role] != before + 1:
            raise AssertionError(f"compact_rows {label}: no launch counted")
        ref = gk.compact_rows_plain(C, xin.clone(), b)
        err = float((out - ref).abs().max())
        xs = xin.clone()
        ms = time_ms(lambda: gk.compact_rows(C, xs, b), 200)
        pms = time_ms(lambda: gk.compact_rows_plain(C, xs, b), 50)
        dt = "f32" if C.vals.dtype == torch.float32 else "f64"
        record(C.role, f"compact_rows {dt} {label} ({C.nrows} of {C.m_pad} rows, "
               f"width {C.width})", dt, err, float(ref.abs().max()), ms, pms,
               "compact")

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
    launches = {}
    for path, extra, roles in (("dirichlet", [], DIRICHLET_ROLES),
                               ("neumann", ["--neumann"], tuple(ROLES))):
        argv = argv_solve + extra
        print(f"main path ({path}): python -m meshlessmultigridpoisson_torch.apps.cli "
              + " ".join(argv), flush=True)
        gk.reset_counts()
        rec, prob, x, xl = cli.run_solve(argv)
        torch.cuda.synchronize()
        launches[path] = dict(gk.COUNTS)
        print(rec.to_json(), flush=True)
        print(f"launches during the {path} main path: {launches[path]}", flush=True)

        kinds = rec.extra["level_kernels"]
        if args.sizes == SLICE_SIZES and kinds != EXPECT_KERNELS:
            return fail(f"{path}: level kernels {kinds} != {EXPECT_KERNELS}")
        idle = [r for r in roles if launches[path][r] == 0]
        if idle:
            return fail(f"{path}: kernel roles never launched on the main path: {idle}")
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
        del rec, prob, x, xl
        torch.cuda.empty_cache()

    # ---- 4. results ----------------------------------------------------------
    kernels = []
    for role, (name, source, replaces) in ROLES.items():
        by_path = {p: n[role] for p, n in launches.items()}
        for c in results[role]:
            kernels.append(dict(name=f"{name} [{role}] {c['label']}", route="cuda",
                                source=source, replaces=replaces,
                                launches=sum(by_path.values()),
                                launches_by_path=by_path,
                                max_abs_err=c["max_abs_err"],
                                ms=c["ms"], plain_ms=c["plain_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
