"""Command-line interface of the port: the ``solve`` and ``ns`` sub-commands.

    python -m meshlessmultigridpoisson_torch.apps.cli solve --device cuda \\
        --geom square_with_circle --sizes 2500 10000 35000 150000 --deg 6 \\
        --ordering kdtile --block-rows 512 --tol 1e-8 [--neumann] \\
        [--sweep-order exact] [--fast-k] [--profile]
    python -m meshlessmultigridpoisson_torch.apps.cli ns --device cuda \\
        --sizes 170 600 2500 10000 --deg 6 --steps 2000

Flow (the reference package's ``solve --platform tpu``): f64 host setup
(clouds, kNN, ordering, RBF-FD weights on ``--device``, assembly with
Neumann condensation, coloring, stabilization, transfers) -> repack into
the kernels' layouts on ``--device`` (mg/gpu_backend.py) -> the fine
right-hand side on the device (with ``--neumann``: boundary data and the
condensation pushdown) -> mixed-precision defect correction
(mg/mixed.py) with an f64 outer residual and an f32 V-cycle-preconditioned
BiCGStab inside.  One outer pass runs untimed first, then the timed solve.
``--sweep-order exact`` runs the storage-order sweep on every level,
``--fast-k`` stores the sweep's K in bf16; ``--profile`` adds a
torch.profiler summary of one more solve and a per-level table of kernel
times, throughputs and bounds (utils/profiling.py).

``ns`` (the reference package's ``ns --platform tpu``, the reference
program's default run): the fractional-step Kovasznay flow, f64 host setup
(models/fracstep.py) -> repack (models/fracstep_gpu.py) -> ``--steps``
device timesteps, each with an f32 predictor/corrector and the f64
compatible PPE solved by ``mg/mixed.solve_mixed`` to ``--ppe-tol``.

``--device cuda`` runs the CUDA kernels and refuses to start without a
card; ``--device cpu`` runs the same flow through the kernels' plain
PyTorch versions.  The printed JSON SolveRecord carries the level kernel
kinds, the device name and each kernel role's launch count in the timed
solve (``ns``: in the time loop).
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
    p.add_argument("--neumann", action="store_true",
                   help="Neumann boundaries (Lagrange border, implicit "
                        "condensation) instead of Dirichlet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ordering", default="rcm", choices=["rcm", "kdtile"])
    p.add_argument("--block-rows", type=int, default=256,
                   help="(block, class) assembly block size; use 512 with "
                        "kdtile at 100k+ points")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: CUDA kernels on the first card (no card: "
                        "error); cpu: the kernels' plain versions")
    p.add_argument("--fast-k", action="store_true",
                   help="store the one-shot sweep K tensor in bfloat16: "
                        "~34%% fewer sweep HBM bytes; smoother fixed point "
                        "unchanged, accuracy owned by the f64 defect outer "
                        "loop")
    p.add_argument("--sweep-order", default="colored", choices=["colored", "exact"],
                   help="smoother sweep order: colored (block-colored GS on "
                        "levels of 32+ blocks, same fixed point) or exact "
                        "(storage order on every level, the order of the "
                        "plain f64 sweep)")
    p.add_argument("--profile", action="store_true",
                   help="after the timed solve, run it once more under "
                        "torch.profiler and attach per-kernel device time "
                        "and the device busy share to the record, and a "
                        "per-level table (sweep/matvec ms, nnz/s, modelled "
                        "GB/s, bounds) and the solve's effective nnz/s")
    p.add_argument("--out", default=None, help="write the JSON SolveRecord here")

    pn = sub.add_parser("ns", help="fractional-step Navier-Stokes (Kovasznay)")
    pn.add_argument("--sizes", type=int, nargs="+", default=[170, 600, 2500, 10000])
    pn.add_argument("--deg", type=int, default=6)
    pn.add_argument("--steps", type=int, default=2000)
    pn.add_argument("--dt", type=float, default=2e-4)
    pn.add_argument("--mu", type=float, default=0.025)
    pn.add_argument("--rho", type=float, default=1.0)
    pn.add_argument("--ppe-tol", type=float, default=1e-10)
    pn.add_argument("--reference-ppe", action="store_true",
                    help="strict reference PPE (no compatible projection); "
                         "not implemented on this path: raises")
    pn.add_argument("--implicit-diffusion", action="store_true",
                    help="backward-Euler viscosity (needed at deg 6 + fine N)")
    pn.add_argument("--p-relax", type=float, default=0.7)
    pn.add_argument("--msh", nargs="+", default=None, metavar="FILE",
                    help="Gmsh v2 .msh files, coarse -> fine, replacing "
                         "--sizes (the reference's own NS input path, "
                         "FractionalStepSim.cpp:190-199)")
    pn.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: CUDA kernels on the first card (no card: "
                         "error); cpu: the kernels' plain versions")
    pn.add_argument("--profile", action="store_true",
                    help="after the run, run 3 more steps under torch.profiler "
                         "and attach per-kernel device time and the device "
                         "busy share to the record")
    pn.add_argument("--out", default=None, help="write the JSON SolveRecord here")
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


def run_solve(argv=None, problem=None):
    """Parse ``solve`` arguments and run it; returns (record, problem, x64,
    x_lag64): the f64 solution in the fine level's permuted padded rows and
    the Lagrange unknown (0 on Dirichlet problems).  ``problem``: a host
    problem returned by an earlier call with the same geometry arguments,
    repacked instead of built again."""
    import torch

    from meshlessmultigridpoisson_torch.mg import mixed
    from meshlessmultigridpoisson_torch.mg.gpu_backend import (
        gpu_hierarchy,
        gpu_level_from_operator,
    )
    from meshlessmultigridpoisson_torch.models.poisson import (
        fine_rhs,
        l1_error,
        make_poisson_problem,
    )
    from meshlessmultigridpoisson_torch.ops import gpu_kernels
    from meshlessmultigridpoisson_torch.utils.metrics import SolveRecord, Timer

    args = _parser().parse_args(argv)
    dev = _device(args.device)
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731

    with Timer() as t_setup:
        prob = problem or make_poisson_problem(
            args.geom, sizes=list(args.sizes), poly_deg=args.deg, k1=args.k,
            neumann=args.neumann, seed=args.seed, ordering=args.ordering,
            block_rows=args.block_rows, device=dev,
        )
        ghier = gpu_hierarchy(prob.hierarchy, dev, sweep_order=args.sweep_order,
                              k_dtype=torch.bfloat16 if args.fast_k else None)
        op64 = gpu_level_from_operator(prob.hierarchy.levels[-1], dev,
                                       dtype=torch.float64, sweep=False,
                                       sweep_order=args.sweep_order)
        # the solve's right-hand side, its pushdown on the device's f64 tables
        b = fine_rhs(op64, prob.source, prob.neumann)
        bl = prob.state0.b_lag[-1].to(dev)
        _sync(dev)
    log(f"setup: {t_setup.elapsed:.1f}s")

    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    rec = SolveRecord(
        name=f"poisson-{args.geom}-{dev.type}",
        config=dict(sizes=[c.n for c in prob.clouds], deg=args.deg, k=args.k,
                    neumann=args.neumann, solver="mixed-defect", tol=args.tol,
                    platform=dev.type, fast_k=args.fast_k,
                    sweep_order=args.sweep_order, ordering=args.ordering,
                    block_rows=args.block_rows),
    )
    rec.extra["level_kernels"] = [lv.kernel_kind for lv in ghier.levels]
    rec.extra["level_k_dtypes"] = [str(lv.sweep.kT.dtype) for lv in ghier.levels]
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
        if dev.type == "cuda":
            from meshlessmultigridpoisson_torch.utils.profiling import (
                attach_throughput,
                profile_hierarchy,
            )

            rec.extra["per_level"] = profile_hierarchy(ghier)
            attach_throughput(rec, ghier)
        else:
            rec.extra["per_level"] = "not measured (no CUDA device)"
    if args.out:
        rec.save(args.out)
    return rec, prob, x, xl


def run_ns(argv=None):
    """Parse ``ns`` arguments and run it; returns (record, problem, last
    PPE solve): the last step's PPE right-hand side ``b`` and its solution
    ``x``, ``x_lag`` before the ``p_relax`` blend, all f64 on the host in
    the fine level's permuted padded rows."""
    import time

    import torch

    from meshlessmultigridpoisson_torch.config import FracStepConfig
    from meshlessmultigridpoisson_torch.models import fracstep as fs
    from meshlessmultigridpoisson_torch.models.fracstep_gpu import (
        build_gpu_fracstep,
        run_gpu,
        state_to,
        timestep_gpu,
    )
    from meshlessmultigridpoisson_torch.ops import gpu_kernels
    from meshlessmultigridpoisson_torch.utils.metrics import SolveRecord, Timer

    args = _parser().parse_args(argv)
    if args.cmd != "ns":
        raise SystemExit("run_ns takes the ns sub-command")
    dev = _device(args.device)
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    if args.reference_ppe:
        raise NotImplementedError(
            "the device fractional-step path implements the compatible "
            "div∘grad PPE only; --reference-ppe is not available here")
    cfg = FracStepConfig(dt=args.dt, mu=args.mu, rho=args.rho,
                         ppe_tol=args.ppe_tol, max_steps=args.steps,
                         p_relax=args.p_relax,
                         diffusion="implicit" if args.implicit_diffusion
                         else "explicit")
    with Timer() as t_setup:
        prob = fs.build_fracstep_problem(sizes=list(args.sizes), poly_deg=args.deg,
                                         config=cfg, msh_files=args.msh, device=dev)
        gfs = build_gpu_fracstep(prob, dev)
        if dev.type == "cuda":
            gpu_kernels.build()  # nvcc at first use: setup, not step 0
        _sync(dev)
    log(f"setup: {t_setup.elapsed:.1f}s")

    rec = SolveRecord(
        name="fracstep-kovasznay",
        config=dict(sizes=[c.n for c in prob.clouds], deg=args.deg, dt=args.dt,
                    steps=args.steps, compatible=True, platform=dev.type,
                    msh=args.msh),
    )
    rec.extra["level_kernels"] = [lv.kernel_kind for lv in gfs.hd.levels]
    log(f"level kernels: {rec.extra['level_kernels']}")

    err_hist, outer, inner, passes, ppe_res, step_s, last = [], [], [], [], [], [], {}
    t_prev = [time.perf_counter()]

    def on_step(i, state, st):
        now = time.perf_counter()
        step_s.append(now - t_prev[0])
        t_prev[0] = now
        outer.append(st["ppe_outer"])
        inner.append([its for its, _, _ in st["ppe_passes"]])
        passes.append(st["ppe_passes"])
        ppe_res.append(st["ppe_residual"])
        last.clear()
        last.update(b=state.mg.b[-1], x=st["p_solve"], x_lag=st["pl_solve"])
        if i % 50 == 0:
            err = fs.u_error_vs_kovasznay(prob, state)
            err_hist.append([i, err])
            log(f"step {i}: u_err={err:.3e} ppe passes (inner iterations, "
                f"inner residual, outer residual) {st['ppe_passes']}")

    before = dict(gpu_kernels.COUNTS)
    with Timer() as t:
        state, hist_a, err = run_gpu(prob, dev, steps=args.steps, t=gfs,
                                     on_step=on_step)
        _sync(dev)
    hist = hist_a.tolist()
    rec.wall_time_s = t.elapsed
    rec.residual_history = hist[:: max(1, len(hist) // 500)]
    rec.l1_error = err
    rec.final_residual = hist[-1]
    rec.cycles = args.steps
    rec.extra.update(
        u_err_history=err_hist, final_u_l1_error_vs_kovasznay=err,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        launches={k: v - before[k] for k, v in gpu_kernels.COUNTS.items()},
        setup_time_s=t_setup.elapsed, step_time_s=step_s, ppe_outer=outer,
        ppe_inner_iters=inner, ppe_passes=passes, ppe_residual=ppe_res)
    if args.profile:
        s_dev = state_to(state, dev)

        def three_steps():
            s = s_dev
            for _ in range(3):
                s, _ = timestep_gpu(gfs, s)

        rec.extra["profile"] = _device_profile(three_steps, dev)
    if args.out:
        rec.save(args.out)
    return rec, prob, {k: v.cpu() for k, v in last.items()}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["ns"]:
        rec, *_ = run_ns(argv)
    else:
        rec, *_ = run_solve(argv)
    print(rec.to_json())
    return rec


if __name__ == "__main__":
    main()
