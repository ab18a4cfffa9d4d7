#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``meshlessmultigridpoisson_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows its own failure):

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernel library from the package's ``csrc/*.cu`` and print the build time;
2. build the slice's hierarchy (Dirichlet square_with_circle, deg 6, kd-tile
   ordering, 512-row assembly blocks, sizes 2500/10000/35000/150000) and
   hold every kernel against its plain PyTorch version on the same inputs
   on the card: ``ell_spmv`` (f32 and f64) on the fine and coarsest levels,
   one restriction and one prolongation; ``block_oneshot_sweep`` (f32 and
   f64) on the fine level in colored order and on the coarsest level in
   storage order.  Prints each comparison's relative error and both times;
3. run the port's ``solve`` entry point in-process on that configuration
   (one untimed outer pass, then the timed solve), print its SolveRecord,
   and check: level kernels ``[v7-exact, v8-colored x3]``; every kernel role
   launched during the solve; relative L1 residual < 1e-8, re-checked from
   the returned solution with the plain f64 SpMV; L1 error < 1e-6;
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
}
# tolerances, relative to max |plain output|.  f32: the kernel sums a row in
# another order than the plain gather-sum (warp-shuffle tree vs sequential),
# ~70 products of ~1e5-scale weights with cancellation; a sweep adds the
# 128-term K product on top.  f64: the same reorderings at 1e-16 per op.
TOL = {("spmv", "f32"): 1e-5, ("spmv", "f64"): 1e-12,
       ("sweep", "f32"): 1e-4, ("sweep", "f64"): 1e-11}


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

    # ---- 3. the main path through the CLI entry point -----------------------
    argv_solve = ["solve", "--device", "cuda", "--geom", "square_with_circle",
                  "--sizes", *map(str, args.sizes), "--deg", "6",
                  "--ordering", "kdtile", "--block-rows", "512", "--tol", "1e-8"]
    print("main path: python -m meshlessmultigridpoisson_torch.apps.cli "
          + " ".join(argv_solve), flush=True)
    gk.reset_counts()
    rec, prob, x = cli.run_solve(argv_solve)
    torch.cuda.synchronize()
    launches = dict(gk.COUNTS)
    print(rec.to_json(), flush=True)
    print(f"launches during the main path: {launches}", flush=True)

    kinds = rec.extra["level_kernels"]
    if args.sizes == SLICE_SIZES and kinds != EXPECT_KERNELS:
        return fail(f"level kernels {kinds} != {EXPECT_KERNELS}")
    idle = [r for r, n in launches.items() if n == 0]
    if idle:
        return fail(f"kernel roles never launched on the main path: {idle}")
    if not rec.final_residual < 1e-8:
        return fail(f"final residual {rec.final_residual:.3e} >= 1e-8")
    # independent re-check: plain f64 gather-sum SpMV on the returned x
    op = prob.hierarchy.levels[-1]
    A = device_ell(op.A, torch.float64, dev, "spmv8")
    dmask = op.dirichlet_mask.to(dev) > 0
    bf = torch.where(dmask, op.dirichlet_values.to(dev), prob.state0.b[-1].to(dev))
    y = torch.where(dmask, x, gk.ell_spmv_plain(A.vals, A.cols, x))
    recheck = float((bf - y).abs().sum() / bf.abs().sum())
    print(f"re-checked relative L1 residual (plain f64 SpMV): {recheck:.3e}",
          flush=True)
    if not recheck < 1e-8:
        return fail(f"re-checked residual {recheck:.3e} >= 1e-8")
    if not rec.l1_error < 1e-6:
        return fail(f"l1_error {rec.l1_error:.3e} >= 1e-6")

    # ---- 4. results ----------------------------------------------------------
    kernels = []
    for role, (name, source, replaces) in ROLES.items():
        for c in results[role]:
            kernels.append(dict(name=f"{name} [{role}] {c['label']}", route="cuda",
                                source=source, replaces=replaces,
                                launches=launches[role],
                                max_abs_err=c["max_abs_err"],
                                ms=c["ms"], plain_ms=c["plain_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
