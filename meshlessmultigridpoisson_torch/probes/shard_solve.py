"""The row-sharded f64 BiCGStab on the card, P ranks (card only).

    python -m meshlessmultigridpoisson_torch.probes.shard_solve --shards 4 [--out row.json]

Builds the Dirichlet slice's problem (``square_with_circle``, sizes
2500/10000/35000/150000, deg 6, kd-tile order, 512-row assembly blocks;
``run`` takes another problem's ``solve`` arguments), runs the
port's serial device solve on it (``cli solve --device cuda``, to 1e-8) for
the reference solution, then the sharded solve on ``--shards`` ranks: one
rank in this process (a world of one, NCCL), several as spawned processes
(``parallel.dryrun.spawn``: NCCL where every rank has a card of its own,
gloo staged through host memory where ranks share one), the top two levels
sharded.  Each world runs
the f64 sharded BiCGStab to 1e-12 (near the serial device solve's floor:
that solve ends far below its 1e-8, the L1 bars compare solutions, not
stopping points, and at 1e-10 the P = 2 Dirichlet solve stopped with an L1
error 1.966e-12 against the bar's 1.5 x 8.0e-15 + 1e-12) and 25 f32
sharded V-cycles from zero.  Before each, every rank holds its kernels on
the levels that solve repacked (every sharded level, f64 and f32) against
their plain versions (``dryrun.level_plain_errors``; any miss fails the
rank).

Checks, any miss raising: the reported residual < 1e-8 and re-checked with
the plain f64 SpMV over the bordered system (``utils.metrics.
bordered_residual``) < 1e-8; the solution within 1e-6 (relative, max
norm; the mean removed on Neumann problems) of the serial device solve's;
its L1 error below 1.5x the serial one's + 1e-12 (the reference test's
bar, tests/test_parallel.py:289); the sharded path's kernel
roles launched (the frontier class sweep where a shard has a frontier, the
interior pass, the ext matvec).  Prints one JSON line with the backend,
the iterations, the solve's wall seconds, the collectives and bytes per
V-cycle (measured on rank 0, and counted from the partition's metadata),
the f32 25-cycle residual history (no bar) and the card's name and power
limit.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

SLICE_ARGV = ["solve", "--device", "cuda", "--geom", "square_with_circle", "--sizes", "2500",
              "10000", "35000", "150000", "--deg", "6", "--ordering", "kdtile",
              "--block-rows", "512", "--tol", "1e-8"]
SHARD_LEVELS = 2
SOLVE_TOL = 1e-12  # the sharded solve's tolerance: near the serial solve's floor
TOL = 1e-8  # the bar on its residual, reported and re-checked
PARITY = 1e-6
L1_RATIO, L1_SLACK = 1.5, 1e-12  # tests/test_parallel.py:289: err < 1.5 err_serial + 1e-12
F32_CYCLES = 25
JOIN_TIMEOUT_S = 600  # the ranks' set-up at full width is tens of seconds


def run(shards: int, argv=SLICE_ARGV, problem=None, serial=None) -> dict:
    """The row (module docstring).  ``argv``: the serial ``solve``'s
    arguments (the slice's by default); ``problem``: its host problem to
    reuse; ``serial``: (x64 padded, L1 error) of its serial device solve,
    else it is run here."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("shard_solve runs on the card: torch.cuda.is_available() is False")
    from meshlessmultigridpoisson_torch.apps import cli
    from meshlessmultigridpoisson_torch.models.poisson import l1_error
    from meshlessmultigridpoisson_torch.parallel import dryrun
    from meshlessmultigridpoisson_torch.parallel import runtime as rt
    from meshlessmultigridpoisson_torch.utils import profiling as pf
    from meshlessmultigridpoisson_torch.utils.metrics import bordered_residual

    info = pf.card()
    if serial is None or problem is None:
        rec, problem, x64, _ = cli.run_solve(argv, problem=problem)
        serial = (x64.double().cpu(), rec.l1_error)
        del x64
        torch.cuda.empty_cache()
    op = problem.hierarchy.finest
    neumann = bool(op.has_lagrange)
    b_log = op.to_logical(problem.state0.b[-1]).numpy()
    tasks = [dict(name="bicgstab", kind="bicgstab", max_iters=100, tol=SOLVE_TOL,
                  shard_levels=SHARD_LEVELS, plain_checks=True),
             dict(name="vcycle32", kind="vcycle", cycles=F32_CYCLES, dtype="float32",
                  shard_levels=SHARD_LEVELS, plain_checks=True)]
    if shards == 1:  # in process: a world of one
        tmp = tempfile.mkdtemp(prefix="shard_solve_")
        rt.init_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0, device="cuda")
        try:
            res = dryrun.run_job(dict(problems=[dict(hierarchy=problem.hierarchy, b=b_log)],
                                      tasks=tasks), rt.solver_mesh(1))
        finally:
            rt.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)
    else:
        res = dryrun.spawn(shards, [(problem.hierarchy, b_log)], tasks, device="cuda",
                           timeout_s=JOIN_TIMEOUT_S)
    bi, vc32 = res["bicgstab"], res["vcycle32"]
    x_log = np.asarray(bi["x"])
    x_pad = op.to_padded(torch.from_numpy(x_log))
    recheck = bordered_residual(op, problem.state0.b[-1], problem.state0.b_lag[-1], x_pad,
                                bi["x_lag"])
    ref = op.to_logical(serial[0]).numpy()
    a, r = (x_log - x_log.mean(), ref - ref.mean()) if neumann else (x_log, ref)
    parity = float(np.abs(a - r).max() / np.abs(r).max())
    l1 = l1_error(problem, x_pad)
    cycles = len(vc32["history"])
    row = dict(
        shards=shards, device=info["name"], power_limit=info["power_limit"],
        backend=res["topology"]["backend"], staged=res["topology"]["staged"],
        sizes=[c.n for c in problem.clouds], neumann=neumann, shard_levels=SHARD_LEVELS,
        partition=res[f"partition_0_{SHARD_LEVELS}"]["shards"],
        interior_kinds=bi["kinds"], iters=bi["iters"], resid=bi["resid"],
        recheck=recheck, parity=parity, l1_error=l1, l1_serial=serial[1],
        solve_seconds=bi["seconds"], launches=bi["launches"], comm=bi["comm"],
        comm_per_vcycle={k: v / cycles for k, v in vc32["comm"].items()},
        comm_model_per_vcycle=vc32["comm_model"],
        f32_history=[float(h) for h in vc32["history"]], f32_seconds=vc32["seconds"],
        plain_checks={t["plain_checks"]["dtype"]: _plain_summary(t["plain_checks"])
                      for t in (bi, vc32)})
    bad = []
    if not (0 <= bi["resid"] < TOL and recheck < TOL):
        bad.append(f"residual {bi['resid']:.3e}, re-checked {recheck:.3e} (want < {TOL})")
    if not parity < PARITY:
        bad.append(f"solution {parity:.3e} from the serial device solve's (want < {PARITY})")
    if not l1 < L1_RATIO * serial[1] + L1_SLACK:
        bad.append(f"L1 error {l1:.3e} >= {L1_RATIO} x the serial {serial[1]:.3e} + "
                   f"{L1_SLACK}")
    interior = {"v8-colored": "sweep8", "v6-oneshot": "sweep6"}
    want = {"spmv6"} | {interior[k] for k in bi["kinds"]}
    if any(p["nf"] for p in row["partition"]):
        want.add("sweep2")
    idle = sorted(k for k in want if not bi["launches"].get(k))
    if idle:
        bad.append(f"kernel roles of the sharded path never launched: {idle}")
    if vc32["comm"] != {k: cycles * v for k, v in vc32["comm_model"].items()}:
        bad.append(f"collectives {vc32['comm']} differ from the model "
                   f"{vc32['comm_model']} x {cycles}")
    if bad:
        print(json.dumps(row), flush=True)
        raise AssertionError(f"sharded solve on {shards} ranks: " + "; ".join(bad))
    return row


def _plain_summary(pc: dict) -> dict:
    """A task's gathered kernel-vs-plain errors: per check, the largest
    over ranks and levels, and how many (rank, level) shards it covered."""
    import numpy as np

    from meshlessmultigridpoisson_torch.parallel.dryrun import PLAIN_CHECKS

    errs = np.asarray(pc["errors"])
    out = {}
    for k, name in enumerate(PLAIN_CHECKS):
        e = errs[:, :, k]
        if np.isfinite(e).any():
            out[name] = dict(max_rel_err=float(np.nanmax(e)), tol=float(pc["tol"][k]),
                             shards=int(np.isfinite(e).sum()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    row = run(args.shards)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
