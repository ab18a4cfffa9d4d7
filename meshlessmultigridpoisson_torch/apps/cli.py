"""Command-line interface of the port: the ``solve`` sub-command.

    python -m meshlessmultigridpoisson_torch.apps.cli solve --device cuda \\
        --geom square_with_circle --sizes 2500 10000 35000 150000 --deg 6 \\
        --ordering kdtile --block-rows 512 --tol 1e-8

Flow (the reference package's ``solve --platform tpu``): f64 host setup
(clouds, kNN, ordering, RBF-FD weights on ``--device``, assembly,
coloring, stabilization, transfers) -> repack into the kernels' layouts on
``--device`` (mg/gpu_backend.py) -> mixed-precision defect correction
(mg/mixed.py) with an f64 outer residual and an f32 V-cycle-preconditioned
BiCGStab inside.  One outer pass runs untimed first, then the timed solve.

``--device cuda`` runs the CUDA kernels and refuses to start without a
card; ``--device cpu`` runs the same flow through the kernels' plain
PyTorch versions.  The printed JSON SolveRecord carries the level kernel
kinds, the device name and each kernel role's launch count in the timed
solve.
"""

from __future__ import annotations

import argparse
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="meshlessmultigridpoisson-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("solve", help="manufactured-solution Poisson solve")
    p.add_argument("--geom", default="square",
                   choices=["square", "square_with_circle",
                            "concentric_circles", "box3d"])
    p.add_argument("--sizes", type=int, nargs="+", default=[600, 2500])
    p.add_argument("--deg", type=int, default=4)
    p.add_argument("--k", type=int, default=1, help="manufactured wavenumber")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ordering", default="rcm", choices=["rcm", "kdtile"])
    p.add_argument("--block-rows", type=int, default=256,
                   help="(block, class) assembly block size; use 512 with "
                        "kdtile at 100k+ points")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: CUDA kernels on the first card (no card: "
                        "error); cpu: the kernels' plain versions")
    p.add_argument("--profile", action="store_true",
                   help="after the timed solve, run it once more under "
                        "torch.profiler and attach per-kernel device time "
                        "and the device busy share to the record")
    p.add_argument("--out", default=None, help="write the JSON SolveRecord here")
    return ap


def _device(name: str):
    import torch

    if name == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda requested but torch.cuda.is_available() "
                             "is False; refusing to run the solve on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_profile(solve, dev) -> dict:
    """Run ``solve()`` under torch.profiler; per-kernel device time (top 12
    by time) and the device busy share of that run's wall time."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return {"device_busy_share": "not measured (no CUDA device)"}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "kernels": [{"name": n[:96], "calls": c, "ms": ms}
                        for n, (c, ms) in top]}


def run_solve(argv=None):
    """Parse ``solve`` arguments and run it; returns (record, problem, x64)
    with x64 the f64 solution in the fine level's permuted padded rows."""
    import torch

    from meshlessmultigridpoisson_torch.mg import mixed
    from meshlessmultigridpoisson_torch.mg.gpu_backend import (
        gpu_hierarchy,
        gpu_level_from_operator,
    )
    from meshlessmultigridpoisson_torch.models.poisson import (
        l1_error,
        make_poisson_problem,
    )
    from meshlessmultigridpoisson_torch.ops import gpu_kernels
    from meshlessmultigridpoisson_torch.utils.metrics import SolveRecord, Timer

    args = _parser().parse_args(argv)
    dev = _device(args.device)
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731

    with Timer() as t_setup:
        prob = make_poisson_problem(
            args.geom, sizes=list(args.sizes), poly_deg=args.deg, k1=args.k,
            seed=args.seed, ordering=args.ordering,
            block_rows=args.block_rows, device=dev,
        )
        ghier = gpu_hierarchy(prob.hierarchy, dev)
        op64 = gpu_level_from_operator(prob.hierarchy.levels[-1], dev,
                                       dtype=torch.float64, sweep=False)
        _sync(dev)
    log(f"setup: {t_setup.elapsed:.1f}s")
    b = prob.state0.b[-1].to(dev)
    bl = prob.state0.b_lag[-1].to(dev)

    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    rec = SolveRecord(
        name=f"poisson-{args.geom}-{dev.type}",
        config=dict(sizes=[c.n for c in prob.clouds], deg=args.deg, k=args.k,
                    neumann=False, solver="mixed-defect", tol=args.tol,
                    platform=dev.type, ordering=args.ordering,
                    block_rows=args.block_rows),
    )
    rec.extra["level_kernels"] = [lv.kernel_kind for lv in ghier.levels]
    log(f"level kernels: {rec.extra['level_kernels']}")
    hd = mixed.defect_hierarchy(ghier)
    x0 = torch.zeros(op64.n_pad, dtype=torch.float64, device=dev)
    xl0 = torch.zeros((), dtype=torch.float64, device=dev)

    # untimed pass: one outer step (first launches, library load)
    with Timer() as t_first:
        mixed.solve_mixed_stepped(op64, hd, x0, xl0, b, bl, tol=args.tol,
                                  max_outer=1)
        _sync(dev)
    log(f"first run (1 outer pass): {t_first.elapsed:.1f}s")

    before = dict(gpu_kernels.COUNTS)
    with Timer() as t:
        x, xl, it, res = mixed.solve_mixed_stepped(
            op64, hd, x0, xl0, b, bl, tol=args.tol, log=log)
        _sync(dev)
    rec.wall_time_s = t.elapsed
    rec.cycles = int(it)
    rec.final_residual = float(res)
    rec.extra["launches"] = {k: v - before[k] for k, v in gpu_kernels.COUNTS.items()}
    rec.extra["setup_time_s"] = t_setup.elapsed
    rec.extra["first_run_s"] = t_first.elapsed
    rec.extra["device"] = device_name
    rec.l1_error = l1_error(prob, x)
    if args.profile:
        rec.extra["profile"] = _device_profile(
            lambda: mixed.solve_mixed_stepped(op64, hd, x0, xl0, b, bl,
                                              tol=args.tol), dev)
    if args.out:
        rec.save(args.out)
    return rec, prob, x


def main(argv=None):
    rec, _, _ = run_solve(argv)
    print(rec.to_json())
    return rec


if __name__ == "__main__":
    main()
