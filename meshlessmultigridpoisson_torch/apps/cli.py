"""Command-line interface of the port: ``solve``, ``ns``, ``probe``,
``sweep`` and ``preprocess`` (every flag of the reference package's CLI,
``--device`` in place of its ``--platform``).

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
torch.profiler summary of one more solve (with launches and device time
per launch by launch shape) and a per-level table of kernel times,
throughputs and bounds (utils/profiling.py).

``ns`` (the reference package's ``ns --platform tpu``, the reference
program's default run): the fractional-step Kovasznay flow, f64 host setup
(models/fracstep.py) -> repack (models/fracstep_gpu.py) -> ``--steps``
device timesteps, each with an f32 predictor/corrector and the f64
compatible PPE solved by ``mg/mixed.solve_mixed`` to ``--ppe-tol``.

``solve --setup-cache PATH`` keeps the host problem in a stamped file
(io/bundle.py), ``--write-solution DIR`` writes the reference's txt files,
``--msh`` reads Gmsh meshes; ``--solver`` / ``--cycles`` run the
reference's host f64 solvers (``--device cpu`` only).  ``probe``: the
single-grid smoother probe on one level, on the device the f64 class
sweep; ``sweep``: the reference's parameter grid, a ``solve`` a row;
``preprocess``: a stamped bundle of the hierarchy and clouds.

``--device cuda`` runs the CUDA kernels and refuses to start without a
card; ``--device cpu`` runs the same flow through the kernels' plain
PyTorch versions.  The printed JSON SolveRecord carries the level kernel
kinds, the device name and each kernel role's launch count in the timed
solve (``ns``: in the time loop; ``probe``: in its sweeps).
"""

from __future__ import annotations

import argparse
import sys

from meshlessmultigridpoisson_torch.utils.metrics import Timer

DEVICE_HELP = ("cuda: CUDA kernels on the first card (no card: error); cpu: the "
               "kernels' plain versions")


def _positive(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"{v} is not a positive count")
    return n


def _common(p) -> None:
    """The grid flags of ``solve``, ``probe`` and ``preprocess`` (the
    reference's own set, so its command lines parse here)."""
    p.add_argument("--geom", default="square",
                   choices=["square", "square_with_circle",
                            "concentric_circles", "box3d"])
    p.add_argument("--sizes", type=int, nargs="+", default=[600, 2500])
    p.add_argument("--msh", nargs="+", default=None, metavar="FILE",
                   help="Gmsh v2 .msh files, one a level (sorted by size), replacing "
                        "the generated clouds (the reference's own path, "
                        "testing_functions.cpp:333); --geom then selects the "
                        "manufactured solution and boundary data")
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
    p.add_argument("--out", default=None,
                   help="solve, probe: write the JSON SolveRecord here; "
                        "preprocess: the bundle (default bundle.npz)")
    p.add_argument("--write-solution", default=None, metavar="DIR",
                   help="solve: write x/y/solution/exact/error txt files, one "
                        "value a line (write_temp_contour, "
                        "testing_functions.cpp:285-310; Neumann: the solution "
                        "shifted to the exact solution's mean)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=DEVICE_HELP)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="meshlessmultigridpoisson-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("solve", help="manufactured-solution Poisson solve")
    _common(p)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--cycles", type=_positive, default=None,
                   help="host f64 path (--device cpu only): this many V-cycles "
                        "instead of a solve to --tol")
    p.add_argument("--solver", default=None, choices=["bicgstab", "vcycle"],
                   help="host f64 path (--device cpu only): V-cycle-preconditioned "
                        "BiCGStab (300 iterations at most) or V-cycles to --tol "
                        "(2000 at most); without it (and --cycles) the "
                        "mixed-precision solve runs on --device")
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
                        "torch.profiler and attach per-kernel device time, "
                        "launches and device time per launch by launch shape "
                        "and the device busy share to the record, and a "
                        "per-level table (sweep/matvec ms, nnz/s, modelled "
                        "GB/s, bounds) and the solve's effective nnz/s")
    p.add_argument("--setup-cache", default=None, metavar="PATH",
                   help="keep the host setup (hierarchy, clouds, right-hand "
                        "side, exact solution) in PATH (.npz appended if "
                        "missing): built and saved on first use, loaded after; "
                        "a cache stamped for other arguments, or not stamped, "
                        "is refused")

    pn = sub.add_parser("ns", help="fractional-step Navier-Stokes (Kovasznay)")
    pn.add_argument("--sizes", type=int, nargs="+", default=[170, 600, 2500, 10000])
    pn.add_argument("--deg", type=int, default=6)
    pn.add_argument("--steps", type=int, default=2000)
    pn.add_argument("--dt", type=float, default=2e-4)
    pn.add_argument("--mu", type=float, default=0.025)
    pn.add_argument("--rho", type=float, default=1.0)
    pn.add_argument("--ppe-tol", type=float, default=1e-10)
    pn.add_argument("--reference-ppe", action="store_true",
                    help="strict reference PPE (no compatible projection), the "
                         "host f64 model with BiCGStab: --device cpu only (the "
                         "device path refuses it, as the reference's does)")
    pn.add_argument("--implicit-diffusion", action="store_true",
                    help="backward-Euler viscosity (needed at deg 6 + fine N)")
    pn.add_argument("--p-relax", type=float, default=0.7)
    pn.add_argument("--msh", nargs="+", default=None, metavar="FILE",
                    help="Gmsh v2 .msh files, coarse -> fine, replacing "
                         "--sizes (the reference's own NS input path, "
                         "FractionalStepSim.cpp:190-199)")
    pn.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=DEVICE_HELP)
    pn.add_argument("--profile", action="store_true",
                    help="after the run, run 3 more steps under torch.profiler "
                         "and attach per-kernel device time and the device "
                         "busy share to the record")
    pn.add_argument("--out", default=None, help="write the JSON SolveRecord here")

    pw = sub.add_parser("sweep", help="the reference's run_tests parameter sweep")
    pw.add_argument("--geoms", nargs="+",
                    default=["square", "square_with_circle", "concentric_circles"])
    pw.add_argument("--levels", type=int, nargs="+", default=[2, 3])
    pw.add_argument("--ks", type=int, nargs="+", default=[1, 2])
    pw.add_argument("--degs", type=int, nargs="+", default=[4])
    pw.add_argument("--cycles", type=int, default=100,
                    help="unused, as in the reference: every row solves to 1e-8")
    pw.add_argument("--out", default="sweep_results.json")
    pw.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: each row the mixed-precision solve on the card "
                         "(no card: error); cpu: each row the host f64 BiCGStab")

    pb = sub.add_parser("probe", help="single-grid raw-smoother convergence probe "
                                      "(testGmshSingleGrid, testing_functions.cpp:422-479)")
    _common(pb)
    pb.add_argument("--sweeps", type=_positive, default=1000)
    pb.add_argument("--cond", action="store_true",
                    help="also estimate cond(A) of the effectively solved "
                         "(pinned-Dirichlet) system, host f64; the reference "
                         "program's cond_L (grid.cpp:152) conditions the raw "
                         "assembled matrix instead")

    pp = sub.add_parser("preprocess", help="build the host setup and save it as a "
                                           "stamped bundle (hierarchy and clouds)")
    _common(pp)
    return ap


def _log(m) -> None:
    print(m, file=sys.stderr, flush=True)


def _args(argv, cmd: str):
    args = _parser().parse_args(argv)
    if args.cmd != cmd:
        raise SystemExit(f"run_{cmd} takes the {cmd} sub-command, not {args.cmd}")
    return args


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
    by time), the device busy share of that run's wall time, per launch
    shape of the solve's kernels ("role rows x cols": the rows a launch
    writes, the length of the vector it reads; ``gpu_kernels.SHAPES``) the
    launches and the device time per launch, and per V-cycle level range
    ("vcycle L{i} down|coarse|up", ``utils.trace.level_range``) the device
    time of the kernels inside it a V-cycle.  The ranges add host time: the
    busy share is the plain run's only where no range was entered; the
    level ranges' end marks are left out of every table."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from meshlessmultigridpoisson_torch.ops import gpu_kernels
    from meshlessmultigridpoisson_torch.utils import trace

    if dev.type != "cuda":
        return {"device_busy_share": "not measured (no CUDA device)"}
    gpu_kernels.SHAPES = {}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve()
            _sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        shapes = gpu_kernels.SHAPES
    finally:
        gpu_kernels.SHAPES = None
    by_name: dict[str, list] = {}
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        row = (e.time_range.start, e.time_range.end, e.name)
        # a range shows on the device too, from its first kernel's start to
        # its last one's end: not a kernel
        if e.name in shapes:
            spans.append(row)
            continue
        if trace.MARK_KERNEL in e.name:  # a level range's end mark
            continue
        kernels.append(row)
        acc = by_name.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    dev_us = {e.key: e.device_time_total for e in prof.key_averages() if e.key in shapes}
    launches = [{"shape": k, "launches": c, "device_ms": dev_us.get(k, 0.0) / 1e3,
                 "device_ms_per_launch": dev_us.get(k, 0.0) / 1e3 / c}
                for k, c in sorted(shapes.items()) if not k.startswith("vcycle ")]
    vcycles = shapes.get("vcycle L0 coarse", 0)
    levels = [{"range": k, "device_ms_per_vcycle": ms / vcycles}
              for k, ms in sorted(_kernels_inside(spans, kernels).items())
              if k.startswith("vcycle ")] if vcycles else []
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "kernels": [{"name": n[:96], "calls": c, "ms": ms}
                        for n, (c, ms) in top],
            "launch_shapes": launches, "vcycles": vcycles, "vcycle_levels": levels}


def _kernels_inside(spans, kernels) -> dict:
    """{range name: device ms of the kernels inside its occurrences}, each
    (start_us, end_us, name) on one stream."""
    import bisect

    kernels = sorted(kernels)
    starts = [k[0] for k in kernels]
    out: dict[str, float] = {}
    for a, b, name in spans:
        j = bisect.bisect_left(starts, a)
        while j < len(kernels) and kernels[j][0] <= b:
            if kernels[j][1] <= b:
                out[name] = out.get(name, 0.0) + (kernels[j][1] - kernels[j][0]) / 1e3
            j += 1
    return out


def _setup_build_config(args) -> dict:
    """The arguments that determine a setup bundle's contents (the
    reference's keys, its ``cli.py:178-189``): stamped into every bundle
    and checked on load."""
    return dict(geom=args.geom, sizes=list(args.sizes), deg=args.deg, k=args.k,
                neumann=bool(args.neumann), seed=args.seed, msh=list(args.msh or []),
                ordering=args.ordering, block_rows=args.block_rows)


def _make_problem(args, dev, sizes=None, msh=None):
    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem

    return make_poisson_problem(
        args.geom, sizes=list(sizes or args.sizes), poly_deg=args.deg, k1=args.k,
        neumann=args.neumann, seed=args.seed, ordering=args.ordering,
        block_rows=args.block_rows, device=dev, msh_files=msh or args.msh)


def _build_problem(args, dev):
    """(host problem, setup-cache record or None).  With ``--setup-cache``:
    the cache loaded if it exists, else built, saved and loaded back, so a
    first-use run and a cached run solve the same bits."""
    import os

    from meshlessmultigridpoisson_torch.io import bundle

    if not args.setup_cache:
        return _make_problem(args, dev), None
    path = bundle.npz_path(args.setup_cache)
    cfg = _setup_build_config(args)
    info = {"path": path, "built": not os.path.exists(path)}
    if info["built"]:
        prob = _make_problem(args, dev)
        with Timer() as t_save:
            bundle.save_problem(path, prob, build_config=cfg)
        info["save_s"] = t_save.elapsed
        _log(f"setup built and cached to {path} ({t_save.elapsed:.2f} s to save)")
    with Timer() as t_load:
        try:
            prob = bundle.load_problem(path, cfg)
        except bundle.StampError as e:
            raise SystemExit(f"--setup-cache: {e}") from None
    info.update(load_s=t_load.elapsed, bytes=os.path.getsize(path))
    _log(f"setup loaded from {path} ({info['bytes'] / 1e9:.3f} GB in {t_load.elapsed:.2f} s)")
    return prob, info


def _write_solution(outdir: str, prob, x) -> None:
    """Per-point txt files (write_temp_contour, testing_functions.cpp:285-310):
    x, y, solution, exact and error on the ordered fine cloud; a Neumann
    solution shifted to the exact solution's mean."""
    import os

    import numpy as np

    from meshlessmultigridpoisson_torch.io import write_vector_txt

    os.makedirs(outdir, exist_ok=True)
    sol = prob.hierarchy.finest.to_logical(x.cpu().double()).numpy()
    exact = prob.exact
    if prob.neumann:
        sol = sol + (exact.mean() - sol.mean())
    pts = prob.clouds[-1].points
    for name, v in (("x", pts[:, 0]), ("y", pts[:, 1]), ("solution", sol),
                    ("exact", exact), ("error", np.abs(sol - exact))):
        write_vector_txt(v, os.path.join(outdir, f"{name}.txt"))


def _solve_host(args, prob, rec):
    """The reference's host f64 solvers (its ``cli.py:380-397``) on the
    host problem: ``--cycles`` V-cycles, or BiCGStab, or V-cycles to
    ``--tol``.  Returns (x, x_lag) of the fine level."""
    from meshlessmultigridpoisson_torch.mg.krylov import solve_bicgstab
    from meshlessmultigridpoisson_torch.mg.vcycle import run_v_cycles, solve_to_tolerance

    with Timer() as t:
        if args.cycles:
            state, hist = run_v_cycles(prob.hierarchy, prob.state0, args.cycles)
            rec.residual_history = hist.tolist()
            rec.cycles = args.cycles
            rec.final_residual = rec.residual_history[-1]
        else:
            solve = solve_bicgstab if args.solver == "bicgstab" else solve_to_tolerance
            cap = {"max_iters": 300} if args.solver == "bicgstab" else {"max_cycles": 2000}
            state, it, resid = solve(prob.hierarchy, prob.state0, tol=args.tol, **cap)
            rec.cycles = int(it)
            rec.final_residual = float(resid)
    rec.wall_time_s = t.elapsed
    return state.x[-1], state.x_lag[-1]


def run_solve(argv=None, problem=None, use_v6=None):
    """Parse ``solve`` arguments and run it; returns (record, problem, x64,
    x_lag64): the f64 solution in the fine level's permuted padded rows and
    the Lagrange unknown (0 on Dirichlet problems).  ``problem``: a host
    problem returned by an earlier call with the same geometry arguments,
    repacked instead of built again.  ``use_v6``: the repack's knob
    (``mg.gpu_backend.runs_v2``, the reference's ``tpu_hierarchy(use_v6=)``):
    False runs every level on the v2-fallback kernels (class SOR, no K);
    the reference CLI has no flag for it.  ``--solver`` / ``--cycles`` run
    the host f64 solvers instead, on ``--device cpu`` only."""
    import torch

    from meshlessmultigridpoisson_torch.mg.gpu_backend import (
        gpu_hierarchy,
        gpu_level_from_operator,
    )
    from meshlessmultigridpoisson_torch.models.poisson import fine_rhs, l1_error
    from meshlessmultigridpoisson_torch.utils.metrics import SolveRecord

    args = _args(argv, "solve")
    host = bool(args.cycles) or args.solver is not None
    if host and args.device != "cpu":
        raise SystemExit("--solver and --cycles select the host f64 solvers, which "
                         "run with --device cpu only; on the card the solve is the "
                         "mixed-precision defect correction (drop them)")
    dev = _device(args.device)
    if dev.type == "cuda":  # the record's peak is this run's
        torch.cuda.reset_peak_memory_stats(dev)

    cache, built = None, problem is None
    with Timer() as t_setup:
        if problem is None:
            problem, cache = _build_problem(args, dev)
            built = cache is None or cache["built"]
        prob = problem
        if not host:
            ghier = gpu_hierarchy(prob.hierarchy, dev, sweep_order=args.sweep_order,
                                  k_dtype=torch.bfloat16 if args.fast_k else None,
                                  use_v6=use_v6)
            # the f64 outer operator takes the fine level's matvec role
            op64 = gpu_level_from_operator(prob.hierarchy.levels[-1], dev,
                                           dtype=torch.float64, sweep=False,
                                           sweep_order=args.sweep_order, use_v6=use_v6)
            # the solve's right-hand side, its pushdown on the device's f64 tables
            b = fine_rhs(op64, prob.source, prob.neumann)
            bl = prob.state0.b_lag[-1].to(dev)
            _sync(dev)
    _log(f"setup: {t_setup.elapsed:.1f}s")

    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    rec = SolveRecord(
        name=f"poisson-{args.geom}-{dev.type}",
        config=dict(sizes=[c.n for c in prob.clouds], deg=args.deg, k=args.k,
                    neumann=args.neumann,
                    solver="fixed-cycles" if args.cycles else args.solver or "mixed-defect",
                    tol=args.tol, platform=dev.type, msh=args.msh, fast_k=args.fast_k,
                    sweep_order=args.sweep_order, ordering=args.ordering,
                    block_rows=args.block_rows),
    )
    rec.extra["setup_time_s"] = t_setup.elapsed
    if cache is not None:
        rec.extra["setup_cache"] = cache
    rec.extra["device"] = device_name
    if host:
        x, xl = _solve_host(args, prob, rec)
    else:
        x, xl, rerun = _solve_device(args, rec, dev, ghier, op64, b, bl)
    rec.extra["setup_stages_s"] = _setup_stages(built, cache, repacked=not host)
    rec.l1_error = l1_error(prob, x)
    if args.write_solution:
        _write_solution(args.write_solution, prob, x)
    if args.profile and (host or dev.type != "cuda"):
        rec.extra["profile"] = {"device_busy_share": "not measured (no CUDA device)"}
        rec.extra["per_level"] = "not measured (no CUDA device)"
    elif args.profile:
        from meshlessmultigridpoisson_torch.utils.profiling import (
            attach_throughput,
            profile_hierarchy,
        )

        rec.extra["profile"] = _device_profile(rerun, dev)
        rec.extra["per_level"] = profile_hierarchy(ghier)
        attach_throughput(rec, ghier)
    if args.out:
        rec.save(args.out)
    return rec, prob, x, xl


def _setup_stages(built: bool, cache, repacked: bool) -> dict:
    """The set-up's stages from the program's spans (``utils.trace``): the
    hierarchy's build, where this run built one, and a cache's save and
    load (``host_problem``), and the repack (``repack``), each stage by
    name beside them."""
    from meshlessmultigridpoisson_torch.utils import trace

    stages = dict.fromkeys(trace.SETUP_STAGES + trace.REPACK_STAGES, 0.0)
    if built:
        stages.update((k, trace.SPANS[k]) for k in trace.SETUP_STAGES)
    if repacked:
        stages.update((k, trace.SPANS[k]) for k in trace.REPACK_STAGES)
    cache_s = sum((cache or {}).get(k, 0.0) for k in ("save_s", "load_s"))
    return {"host_problem": sum(stages[k] for k in trace.SETUP_STAGES) + cache_s,
            "repack": sum(stages[k] for k in trace.REPACK_STAGES), **stages}


def _solve_device(args, rec, dev, ghier, op64, b, bl):
    """The mixed-precision defect correction on ``dev``: one untimed outer
    pass, then the timed solve; fills the record, returns (x, x_lag, a
    function that runs the timed solve again)."""
    import dataclasses

    import torch

    from meshlessmultigridpoisson_torch.mg import mixed
    from meshlessmultigridpoisson_torch.mg.gpu_backend import col_formats
    from meshlessmultigridpoisson_torch.ops import gpu_kernels
    from meshlessmultigridpoisson_torch.utils import trace

    rec.extra["level_kernels"] = [lv.kernel_kind for lv in ghier.levels]
    rec.extra["spmv_col_formats"] = col_formats(ghier, op64)
    rec.extra["level_k_dtypes"] = [  # None: a v2-fallback level holds no K
        str(lv.sweep.kT.dtype) if isinstance(lv.sweep, gpu_kernels.BlockSweep) else None
        for lv in ghier.levels]
    _log(f"level kernels: {rec.extra['level_kernels']}")
    hd = mixed.defect_hierarchy(ghier)
    x0 = torch.zeros(op64.n_pad, dtype=torch.float64, device=dev)
    xl0 = torch.zeros((), dtype=torch.float64, device=dev)

    # untimed pass: one outer step (first launches, library load)
    with Timer() as t_first:
        mixed.solve_mixed_stepped(op64, hd, x0, xl0, b, bl, tol=args.tol, max_outer=1)
        _sync(dev)
    _log(f"first run (1 outer pass): {t_first.elapsed:.1f}s")

    before = dict(gpu_kernels.COUNTS)
    with Timer() as t:
        x, xl, it, res = mixed.solve_mixed_stepped(
            op64, hd, x0, xl0, b, bl, tol=args.tol, log=_log)
        _sync(dev)
    rec.wall_time_s = t.elapsed
    rec.cycles = int(it)
    rec.final_residual = float(res)
    rec.extra["trace"] = dataclasses.asdict(trace.SOLVES[-1])
    rec.extra["launches"] = {k: v - before[k] for k, v in gpu_kernels.COUNTS.items()}
    rec.extra["first_run_s"] = t_first.elapsed
    if dev.type == "cuda":  # the tensors of setup and both solves
        rec.extra["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return x, xl, lambda: mixed.solve_mixed_stepped(op64, hd, x0, xl0, b, bl, tol=args.tol)


def run_ns(argv=None):
    """Parse ``ns`` arguments and run it; returns (record, problem, last
    PPE solve): the last step's PPE right-hand side ``b`` and its solution
    ``x``, ``x_lag`` before the ``p_relax`` blend, all f64 on the host in
    the fine level's permuted padded rows (empty with ``--reference-ppe``,
    the host path: ``_ns_strict``)."""
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
    from meshlessmultigridpoisson_torch.utils.metrics import SolveRecord

    args = _args(argv, "ns")
    if args.reference_ppe and args.device == "cuda":
        raise NotImplementedError(
            "the device fractional-step path implements the compatible "
            "div∘grad PPE only; --reference-ppe runs on --device cpu")
    dev = _device(args.device)
    log = _log
    cfg = FracStepConfig(dt=args.dt, mu=args.mu, rho=args.rho,
                         ppe_tol=args.ppe_tol, max_steps=args.steps,
                         p_relax=args.p_relax,
                         diffusion="implicit" if args.implicit_diffusion
                         else "explicit")
    if args.reference_ppe:
        return _ns_strict(args, cfg, dev)
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
    over = []  # steps whose PPE solve stopped above --ppe-tol
    t_prev = [time.perf_counter()]

    def on_step(i, state, st):
        now = time.perf_counter()
        step_s.append(now - t_prev[0])
        t_prev[0] = now
        outer.append(st["ppe_outer"])
        inner.append([its for its, _, _ in st["ppe_passes"]])
        passes.append(st["ppe_passes"])
        ppe_res.append(st["ppe_residual"])
        if not st["ppe_converged"]:
            over.append(i)
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
        ppe_inner_iters=inner, ppe_passes=passes, ppe_residual=ppe_res,
        ppe_over_tol=over)
    if over:
        log(f"{len(over)} of {args.steps} PPE solves stopped above --ppe-tol "
            f"{args.ppe_tol:.0e}: steps {over}")
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


def _ns_strict(args, cfg, dev):
    """``ns --reference-ppe`` on the host: the strict PPE (no compatible
    projection), each step the host f64 ``models/fracstep.timestep`` with
    its BiCGStab, as the reference's CPU branch (its ``apps/cli.py``
    ``_ns``).  Returns (record, problem, {}): no device PPE solve."""
    from meshlessmultigridpoisson_torch.models import fracstep as fs
    from meshlessmultigridpoisson_torch.utils.metrics import SolveRecord

    with Timer() as t_setup:
        prob = fs.build_fracstep_problem(sizes=list(args.sizes), poly_deg=args.deg,
                                         config=cfg, compatible_ppe=False,
                                         msh_files=args.msh, device=dev)
    _log(f"setup: {t_setup.elapsed:.1f}s")
    rec = SolveRecord(
        name="fracstep-kovasznay",
        config=dict(sizes=[c.n for c in prob.clouds], deg=args.deg, dt=args.dt,
                    steps=args.steps, compatible=False, platform=dev.type,
                    msh=args.msh),
    )
    state, hist, err_hist = prob.state0, [], []
    with Timer() as t:
        for i in range(args.steps):
            state, res = fs.timestep(prob, state, ppe_solver="bicgstab")
            hist.append(float(res))
            if i % 50 == 0:
                err = fs.u_error_vs_kovasznay(prob, state)
                err_hist.append([i, err])
                _log(f"step {i}: fs_res={hist[-1]:.3e} u_err={err:.3e}")
    rec.wall_time_s = t.elapsed
    rec.residual_history = hist[:: max(1, len(hist) // 500)]
    rec.l1_error = fs.u_error_vs_kovasznay(prob, state)
    rec.final_residual = hist[-1]
    rec.cycles = args.steps
    rec.extra.update(u_err_history=err_hist, final_u_l1_error_vs_kovasznay=rec.l1_error,
                     setup_time_s=t_setup.elapsed, device="cpu")
    if args.out:
        rec.save(args.out)
    return rec, prob, {}


def run_probe(argv=None):
    """Parse ``probe`` arguments and run it (the reference's ``cli.py:542-585``,
    testGmshSingleGrid): one level at the largest ``--sizes`` (or the last
    ``--msh``), x pinned to the Dirichlet data, ``--sweeps`` single sweeps
    of the class-ordered SOR (then the border relax and the Neumann
    re-solve), the relative L1 residual before each.  On ``--device`` the
    level is repacked in f64 as a v2 level (``class_sor_sweep``, role
    ``sweep2``; its matvec ``ell_spmv``, role ``spmv2``).  Returns (record,
    problem, x, history as numpy)."""
    import torch

    from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_level_from_operator
    from meshlessmultigridpoisson_torch.models.poisson import l1_error
    from meshlessmultigridpoisson_torch.ops import gpu_kernels
    from meshlessmultigridpoisson_torch.ops.smoothers import (
        apply_dirichlet,
        condition_estimate,
        single_grid_probe,
    )
    from meshlessmultigridpoisson_torch.utils.metrics import SolveRecord

    args = _args(argv, "probe")
    dev = _device(args.device)
    with Timer() as t_setup:
        prob = _make_problem(args, dev, sizes=[max(args.sizes)],
                             msh=args.msh and [args.msh[-1]])
        op = prob.hierarchy.finest
        level = gpu_level_from_operator(op, dev, dtype=torch.float64, use_v6=False)
        x0 = apply_dirichlet(op, prob.state0.x[-1], coarse=False).to(dev)
        b = prob.state0.b[-1].to(dev)
        _sync(dev)
    rec = SolveRecord(
        name=f"probe-{args.geom}-{dev.type}",
        config=dict(sizes=[c.n for c in prob.clouds], deg=args.deg, k=args.k,
                    neumann=args.neumann, sweeps=args.sweeps, platform=dev.type,
                    msh=args.msh, ordering=args.ordering, block_rows=args.block_rows))
    before = dict(gpu_kernels.COUNTS)
    with Timer() as t:
        x, hist = single_grid_probe(level, x0, b, sweeps=args.sweeps)
        hist = hist.cpu().numpy()  # the history's one read
    rec.wall_time_s = t.elapsed
    rec.residual_history = hist[:: max(1, len(hist) // 1000)].tolist()
    rec.final_residual = float(hist[-1])
    rec.cycles = args.sweeps
    rec.l1_error = l1_error(prob, x)
    rec.extra.update(
        setup_time_s=t_setup.elapsed, level_kernels=[level.kernel_kind],
        ms_a_sweep=t.elapsed / args.sweeps * 1e3,
        launches={k: v - before[k] for k, v in gpu_kernels.COUNTS.items()},
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    if args.cond:
        rec.extra["cond_L"] = condition_estimate(op)
    if args.out:
        rec.save(args.out)
    return rec, prob, x, hist


def run_sweep(argv=None) -> list:
    """Parse ``sweep`` arguments and run it (the reference's run_tests grid,
    testing_functions.cpp:396-420, its ``cli.py:503-539``): every (geometry,
    levels, k, degree) a Neumann ``solve`` to 1e-8 on the reference's
    fixture sizes, through ``run_solve`` on ``--device`` (cpu: the host f64
    BiCGStab).  A failed row is recorded with its error; the rows are
    rewritten to ``--out`` after each one; returns them, and exits non-zero
    after the last if any row failed."""
    import itertools
    import json
    import time

    from meshlessmultigridpoisson_torch.config import REFERENCE_MG_SIZES

    args = _args(argv, "sweep")
    _device(args.device)  # no card: refuse before the first row
    rows = []
    for geom, lv, k, deg in itertools.product(args.geoms, args.levels, args.ks, args.degs):
        row_argv = ["solve", "--device", args.device, "--geom", geom, "--sizes",
                    *map(str, REFERENCE_MG_SIZES[geom][:lv]), "--deg", str(deg),
                    "--k", str(k), "--neumann", "--tol", "1e-8",
                    *(["--solver", "bicgstab"] if args.device == "cpu" else [])]
        t0 = time.perf_counter()
        try:
            rec, *_ = run_solve(row_argv)
            row = json.loads(rec.to_json())
        except Exception as e:  # recorded; the sweep exits non-zero at its end
            row = dict(name=f"poisson-{geom}", error=f"{type(e).__name__}: {e}")
        row["elapsed"] = time.perf_counter() - t0
        row["config"] = dict(geom=geom, levels=lv, k=k, deg=deg)
        rows.append(row)
        _log(f"{geom} L{lv} k{k} deg{deg}: {row.get('l1_error', row.get('error'))}")
        with open(args.out, "w") as f:  # long sweeps stay harvestable
            json.dump(rows, f, indent=1)
    print(f"wrote {args.out}")
    failed = [r["config"] for r in rows if "error" in r]
    if failed:
        raise SystemExit(f"sweep: {len(failed)} of {len(rows)} rows failed: {failed} "
                         f"(their errors are in {args.out})")
    return rows


def run_preprocess(argv=None) -> str:
    """Parse ``preprocess`` arguments, build the host setup and save its
    hierarchy and clouds as a bundle stamped with the arguments
    (``io.save_bundle``); returns the path written."""
    from meshlessmultigridpoisson_torch.io import save_bundle

    args = _args(argv, "preprocess")
    prob = _make_problem(args, _device(args.device))
    path = save_bundle(args.out or "bundle.npz", prob.hierarchy, prob.clouds,
                       build_config=_setup_build_config(args))
    print(f"wrote {path}")
    return path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    cmd = _parser().parse_args(argv).cmd
    if cmd == "sweep":
        return run_sweep(argv)
    if cmd == "preprocess":
        return run_preprocess(argv)
    run = {"solve": run_solve, "ns": run_ns, "probe": run_probe}[cmd]
    rec, *_ = run(argv)
    print(rec.to_json())
    return rec


if __name__ == "__main__":
    main()
