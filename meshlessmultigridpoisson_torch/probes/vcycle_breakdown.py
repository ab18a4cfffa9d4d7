"""Where a V-cycle's time goes, level by level and phase by phase.

    python -m meshlessmultigridpoisson_torch.probes.vcycle_breakdown [solve arguments]
        [--setup-cache PATH] [--device cuda|cpu] [--out row.json]

Counterpart of the reference's ``scripts/vcycle_breakdown.py``.  The
problem is the ``solve`` sub-command's (``apps.cli``: ``--geom``,
``--sizes``, ``--deg``, ``--neumann``, ``--ordering``, ``--block-rows``,
``--sweep-order``, ``--fast-k``), built, or loaded from ``--setup-cache``
(``io.bundle.load_problem``; built and saved there first if missing), and
repacked as the solve repacks it (the f32 GPU hierarchy and the f64 outer
operator).  Then, each piece timed on its own:

* per level: one smoother call (``mg/gpu_backend.smooth``: the level's
  sweeps, relaxes and re-solves) and one residual (``ops.smoothers.residual``:
  the matvec and the subtraction), the two per-level phases of
  ``mg/vcycle.v_cycle``;
* per transfer: the restriction and the prolongation (``ell_spmv``);
* the whole ``v_cycle`` (as the preconditioner runs it, no residual),
  from the fine right-hand side: the host clock around one cycle ending
  in ``torch.cuda.synchronize()`` (median), CUDA events around a chain of
  cycles, and the device's busy time per cycle (``torch.profiler``: the
  summed device activity, ``utils.profiling.device_ms``);
* the f64 outer residual of ``mg/mixed`` (``_residual64``).

Each piece is timed as a chain of back-to-back calls between CUDA events
(``utils.profiling.chain_time``), so a piece whose launches are shorter
than the host's enqueue takes the host's time, as in the cycle.  The
modelled cycle is the schedule's sum of the parts (the reference's model):
two smoother calls and one residual on every level but the coarsest, two
smoother calls on the coarsest, one restriction and one prolongation a
transfer.  Printed beside it: the measured cycle (chain), their gap, and
the host and dispatch share of the cycle's wall time (1 - device busy /
wall).  ``--device cpu`` runs the same pieces on the kernels' plain
versions, timed by the host clock: a rehearsal, not a device measurement
(its output says so and has no device time).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

K_PART, REPS = 10, 3  # calls a chain, chains a piece (median), on the card
K_CYCLE, WALL_REPS = 5, 7


def _timer(device):
    """ms per call of ``fn(x)``: CUDA events over ``REPS`` chains of ``k``
    calls after a warm-up (card), or the host clock around one call (CPU:
    the plain versions, a rehearsal)."""
    if device.type == "cuda":
        from meshlessmultigridpoisson_torch.utils.profiling import chain_time

        return lambda fn, x, k: chain_time(fn, x, k=k, reps=REPS) * 1e3

    def host(fn, x, k):
        t0 = time.perf_counter()
        fn(x)
        return (time.perf_counter() - t0) * 1e3

    return host


def model_ms(levels: list, transfers: list) -> float:
    """The schedule's sum of the parts: every level two smoother calls,
    every level but the coarsest one residual, every transfer one
    restriction and one prolongation."""
    return (sum(2 * lv["smooth_ms"] for lv in levels)
            + sum(lv["residual_ms"] for lv in levels[1:])
            + sum(t["restrict_ms"] + t["prolong_ms"] for t in transfers))


def breakdown(hier, op64, b: torch.Tensor, b_lag) -> dict:
    """The breakdown (module docstring) of the GPU hierarchy ``hier`` (f32)
    and the f64 outer operator ``op64`` with fine right-hand side ``b``
    (f64, the level's padded rows) and ``b_lag``."""
    from meshlessmultigridpoisson_torch.mg import mixed
    from meshlessmultigridpoisson_torch.mg.vcycle import init_like, v_cycle
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops import smoothers as sm
    from meshlessmultigridpoisson_torch.ops.ell import spmv

    fine = hier.levels[-1]
    dev, dt = fine.A.vals.device, fine.A.vals.dtype
    cuda = dev.type == "cuda"
    ms = _timer(dev)

    def rand(n, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(dev, dt)

    zl = torch.zeros((), dtype=dt, device=dev)
    levels = []
    for li, lv in enumerate(hier.levels):
        bb = torch.zeros(lv.n_pad, dtype=dt, device=dev)
        x0 = rand(lv.n_pad, li)
        sweep = lv.sweep
        levels.append(dict(
            level=li, n=int(lv.row_map.numel()), n_pad=lv.n_pad, kernel=lv.kernel_kind,
            role=sweep.role, iters=lv.iters,
            smooth_ms=ms(lambda x, lv=lv, bb=bb: sm.smooth(lv, x, zl, bb, zl)[0], x0, K_PART),
            residual_ms=ms(lambda x, lv=lv, bb=bb: sm.residual(lv, x, zl, bb, zl)[0], x0,
                           K_PART)))
    transfers = []
    for i in range(len(hier.levels) - 1):
        R, P = hier.restrict[i], hier.prolong[i]
        transfers.append(dict(
            i=i, restrict=f"L{i + 1}->L{i}", prolong=f"L{i}->L{i + 1}",
            restrict_ms=ms(lambda x, R=R: spmv(R, x), rand(R.ncols, 100 + i), K_PART),
            prolong_ms=ms(lambda x, P=P: spmv(P, x), rand(P.ncols, 200 + i), K_PART)))

    state0 = init_like(hier)
    state0 = state0.replace_level(len(hier.levels) - 1, b=b.to(dt),
                                  b_lag=torch.as_tensor(b_lag, dtype=dt, device=dev))

    def cycle(x):
        return v_cycle(hier, state0.replace_level(len(hier.levels) - 1, x=x),
                       residual=False)[0].x[-1]

    xf = torch.zeros(fine.n_pad, dtype=dt, device=dev)
    before = dict(gk.COUNTS)
    cycle(xf)
    if cuda:
        torch.cuda.synchronize(dev)
    launches = {k: gk.COUNTS[k] - before[k] for k in gk.COUNTS if gk.COUNTS[k] != before[k]}
    walls = []
    for _ in range(WALL_REPS if cuda else 1):
        t0 = time.perf_counter()
        cycle(xf)
        if cuda:
            torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    chain = ms(cycle, xf, K_CYCLE)
    busy = None
    if cuda:
        from meshlessmultigridpoisson_torch.utils.profiling import device_ms

        busy = device_ms(cycle, xf, k=K_CYCLE)
    x64 = torch.zeros(op64.n_pad, dtype=torch.float64, device=dev)
    zl64 = torch.zeros((), dtype=torch.float64, device=dev)
    b64 = b.to(torch.float64)
    bl64 = torch.as_tensor(b_lag, dtype=torch.float64, device=dev)
    outer = ms(lambda x: mixed._residual64(op64, x, zl64, b64, bl64)[0], x64, K_PART)
    model = model_ms(levels, transfers)
    return dict(
        clock="cuda events" if cuda else "host clock (CPU, the plain versions: not device "
                                         "times)",
        levels=levels, transfers=transfers,
        vcycle_wall_ms=wall, vcycle_wall_ms_all=walls, vcycle_chain_ms=chain,
        vcycle_device_busy_ms=busy if cuda else "not measured (no CUDA device)",
        vcycle_model_ms=model, gap_ms=chain - model,
        host_dispatch_share=(1.0 - busy / wall) if cuda else "not measured (no CUDA device)",
        outer_residual64_ms=outer, launches_per_cycle=launches)


def run(argv: list, device: str = "cuda", problem=None) -> dict:
    """Build (or load, ``--setup-cache``) the ``solve`` problem of ``argv``
    (the CLI's arguments after ``solve``; ``problem``: a host problem to
    reuse instead), repack it as the solve does on ``device`` and return
    the breakdown with the card's name and power limit and the seconds of
    setup."""
    from meshlessmultigridpoisson_torch.apps import cli
    from meshlessmultigridpoisson_torch.mg.gpu_backend import (
        gpu_hierarchy,
        gpu_level_from_operator,
    )
    from meshlessmultigridpoisson_torch.models.poisson import fine_rhs

    args = cli._args(["solve", *argv, "--device", device], "solve")
    dev = cli._device(device)
    t0 = time.perf_counter()
    cache = None
    if problem is None:
        problem, cache = cli._build_problem(args, dev)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hier = gpu_hierarchy(problem.hierarchy, dev, sweep_order=args.sweep_order,
                         k_dtype=torch.bfloat16 if args.fast_k else None)
    op64 = gpu_level_from_operator(problem.hierarchy.levels[-1], dev, torch.float64,
                                   sweep=False, sweep_order=args.sweep_order)
    b = fine_rhs(op64, problem.source, problem.neumann)
    bl = problem.state0.b_lag[-1].to(dev)
    cli._sync(dev)
    repack_s = time.perf_counter() - t0
    res = breakdown(hier, op64, b, bl)
    if dev.type == "cuda":
        from meshlessmultigridpoisson_torch.utils.profiling import card

        res.update(card())
    res.update(argv=list(argv), sizes=[c.n for c in problem.clouds],
               setup_s={"host_problem": host_s, "repack": repack_s},
               setup_cache=cache)
    return res


def report(res: dict) -> str:
    """The breakdown as lines of text."""
    who = f" ({res['name']}, {res['power_limit']})" if "name" in res else ""
    out = [f"V-cycle breakdown, {res['clock']}{who}: sizes {res.get('sizes')}"]
    for lv in res["levels"]:
        out.append(f"  L{lv['level']} n={lv['n']} [{lv['kernel']}, {lv['role']}, "
                   f"{lv['iters']} sweeps]: smooth {lv['smooth_ms']:.4f} ms, residual "
                   f"{lv['residual_ms']:.4f} ms")
    for t in res["transfers"]:
        out.append(f"  T{t['i']}: restrict {t['restrict']} {t['restrict_ms']:.4f} ms, "
                   f"prolong {t['prolong']} {t['prolong_ms']:.4f} ms")
    busy = res["vcycle_device_busy_ms"]
    share = res["host_dispatch_share"]
    out.append(f"  cycle: modelled {res['vcycle_model_ms']:.4f} ms, measured (chain) "
               f"{res['vcycle_chain_ms']:.4f} ms, gap {res['gap_ms']:+.4f} ms; wall "
               f"{res['vcycle_wall_ms']:.4f} ms, device busy "
               + (f"{busy:.4f} ms, host and dispatch share {share:.3f}"
                  if isinstance(busy, float) else busy))
    out.append(f"  f64 outer residual {res['outer_residual64_ms']:.4f} ms; launches a "
               f"cycle {res['launches_per_cycle']}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args, solve_argv = ap.parse_known_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probes.vcycle_breakdown: --device cuda needs a card (torch.cuda."
              "is_available() is False); --device cpu rehearses on the plain versions",
              file=sys.stderr)
        return 1
    res = run(solve_argv, args.device)
    print(report(res), flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
