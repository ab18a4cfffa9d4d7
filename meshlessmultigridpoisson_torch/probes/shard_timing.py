"""One-card timing: the P = 1 sharded V-cycle against the unsharded one (card only).

    python -m meshlessmultigridpoisson_torch.probes.shard_timing [--sizes 2500 10000]
        [--deg 4] [--cycles 20] [--out row.json]

Counterpart of the reference's ``scripts/shard_timing.py``, with its sizes
and arguments: ``square`` (Dirichlet) at ``--sizes`` and ``--deg``, f32, and
``--cycles`` V-cycles from zero timed as one chain (median of 7 chains,
after one warm chain), per cycle, on

* the unsharded GPU backend (``gpu_hierarchy``: the serial V-cycle), and
* the sharded cycle (``parallel.sharded.make_sharded_vcycle``) on a world
  of one rank, in process (NCCL; the fine level's smoother call the serial
  one at P = 1, plus the sharded path's glue: the shard layout's repack,
  the all-reduces of the residual norms and of the restriction's partial
  products).

The reference expects the sharded cycle within ~10% of the unsharded one
at P = 1.  Prints one JSON line with both times, the overhead, the kernel
launches of each side's timed cycles and the card's name and power limit.
Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

REPS = 7


def timed(fn, reps: int = REPS) -> float:
    """Median seconds of ``fn()`` (after one warm call), synchronized."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def run(sizes=(2500, 10000), deg: int = 4, cycles: int = 20, problem=None,
        mesh=None) -> dict:
    """The row (module docstring).  ``problem``: a host Poisson problem to
    reuse (else ``square`` at ``sizes`` / ``deg``); ``mesh``: a shard group
    of one rank to reuse (else a world of one is brought up here and torn
    down after)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("shard_timing runs on the card: torch.cuda.is_available() is False")
    from meshlessmultigridpoisson_torch.mg import vcycle as vc
    from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_hierarchy
    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.parallel import runtime as rt
    from meshlessmultigridpoisson_torch.parallel import sharded as sh
    from meshlessmultigridpoisson_torch.parallel.partition import partition_hierarchy
    from meshlessmultigridpoisson_torch.utils import profiling as pf

    info = pf.card()
    dev = torch.device("cuda", 0)
    if problem is None:
        problem = make_poisson_problem("square", sizes=list(sizes), poly_deg=deg,
                                       neumann=False)
    hier = problem.hierarchy
    own = mesh is None
    if own:
        tmp = tempfile.mkdtemp(prefix="shard_timing_")
        rt.init_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0, device="cuda")
        mesh = rt.solver_mesh(1)
    try:
        # the unsharded GPU backend
        ghier = gpu_hierarchy(hier, dev, torch.float32)
        state0 = vc.MGState(**{k: tuple(t.to(dev, torch.float32)
                                        for t in getattr(problem.state0, k))
                               for k in ("x", "x_lag", "b", "b_lag")})

        def unsharded():
            st = state0
            for _ in range(cycles):
                st, r = vc.v_cycle(ghier, st)
            return r

        # the sharded cycle on the world of one
        shier = partition_hierarchy(hier, 1)
        cyc = sh.make_sharded_vcycle(shier, mesh, torch.float32)
        op = hier.finest
        b_log = op.to_logical(problem.state0.b[-1]).numpy()
        bf = sh.shard_vector(shier, mesh, b_log, torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        def sharded():
            xf, xl = torch.zeros_like(bf), zero
            for _ in range(cycles):
                xf, xl, r = cyc(xf, xl, bf, zero)
            return r

        launches = {}
        for name, fn in (("unsharded", unsharded), ("sharded1", sharded)):
            gk.reset_counts()
            fn()
            torch.cuda.synchronize()
            launches[name] = {k: v for k, v in gk.COUNTS.items() if v}
        t_un = timed(unsharded) / cycles
        t_sh = timed(sharded) / cycles
    finally:
        if own:
            rt.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)
    return dict(
        device=info["name"], power_limit=info["power_limit"], sizes=[c.n for c in problem.clouds],
        deg=deg, cycles=cycles, backend=mesh.backend,
        interior_kinds=[lv.kind for lv in cyc.shards.levels],
        unsharded_ms_per_cycle=t_un * 1e3, sharded1_ms_per_cycle=t_sh * 1e3,
        overhead_pct=(t_sh / t_un - 1) * 100, launches=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[2500, 10000])
    ap.add_argument("--deg", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    row = run(args.sizes, args.deg, args.cycles)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
