"""The 3D flagship solve on the card, and what its SolveRecord does not hold (card only).

    python -m meshlessmultigridpoisson_torch.probes.solve3d [--sizes N ...] [--out rec.json]
        [--setup-cache PATH]

Runs the port's ``solve`` entry point in-process with the 3D record's
settings (``results/solve3d_1m_r5.json``, ``scripts/build3d_cache.py``):

    cli solve --device cuda --geom box3d --sizes 500 2600 19000 140000 1060000
        --deg 3 --ordering kdtile --block-rows 512 --tol 1e-8 --profile

(1,092,727 fine points), then prints, with the card's name and power
limit: the record; its residual re-checked with the plain f64 SpMV over
the bordered system (``utils.metrics.bordered_residual``); the L1 error
against the record's 8.28e-5; the V-cycles of the timed solve; each
level's x patches a block (``gpu_kernels.block_patches``) and the fused
smoothers' last launch (grid, K and ELL buffers, shared bytes); the
per-level table; ``probes.launchrank``'s excess by kernel and level; and,
last, one JSON line of the numbers, with a SHA-256 of the solution's
bytes.  ``--sizes`` cuts the ladder (the smoke test's 3D phase runs the
first four).  ``--setup-cache PATH`` passes through to ``solve``: the
first run builds the host problem and saves it there, a rerun loads it
(the bundle's size and its save and load seconds in the line; the
counterpart of the reference's ``scripts/build3d_cache.py``).  Without a
card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

SIZES = [500, 2600, 19000, 140000, 1060000]
RECORD_L1 = 8.28e-5  # results/solve3d_1m_r5.json


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(sizes=SIZES, out: str | None = None, setup_cache: str | None = None) -> dict:
    import hashlib

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the 3D flagship probe runs on the card: "
                         "torch.cuda.is_available() is False")
    from meshlessmultigridpoisson_torch.apps import cli
    from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
    from meshlessmultigridpoisson_torch.ops.ell import global_cols
    from meshlessmultigridpoisson_torch.probes import launchrank
    from meshlessmultigridpoisson_torch.utils import profiling as pf
    from meshlessmultigridpoisson_torch.utils.metrics import bordered_residual

    info = pf.card()
    card = f"{info['name']}, {info['power_limit']}"
    argv = ["solve", "--device", "cuda", "--geom", "box3d", "--sizes", *map(str, sizes),
            "--deg", "3", "--ordering", "kdtile", "--block-rows", "512", "--tol", "1e-8",
            "--profile", *(["--out", out] if out else []),
            *(["--setup-cache", setup_cache] if setup_cache else [])]
    log("python -m meshlessmultigridpoisson_torch.apps.cli " + " ".join(argv))
    rec, prob, x, xl = cli.run_solve(argv)
    torch.cuda.synchronize()
    e = rec.extra
    log(rec.to_json())
    fine = prob.hierarchy.levels[-1]
    recheck = bordered_residual(fine, prob.state0.b[-1], prob.state0.b_lag[-1], x, xl)
    patches = [int(gk.block_patches(global_cols(lv.A).numpy(),
                                    lv.A.nrows_pad // gk.LANES).shape[1])
               for lv in prob.hierarchy.levels]
    rows, ranked = launchrank.rank(json.loads(rec.to_json()))
    for row in e["per_level"]:
        log("  " + json.dumps(row))
    for row in rows:
        log("  excess " + json.dumps(row))
    res = {"card": card, "points": rec.config["sizes"], "level_kernels": e["level_kernels"],
           "passes": rec.cycles,
           # two calls a V-cycle on each fused storage-order (sweep7) level
           "vcycles": e["launches"]["sweep7"] // (2 * e["level_kernels"].count("v7-exact")),
           "wall_time_s": rec.wall_time_s, "setup_time_s": e["setup_time_s"],
           "setup_stages_s": e["setup_stages_s"], "first_run_s": e["first_run_s"],
           "final_residual": rec.final_residual, "recheck_f64": recheck,
           "l1_error": rec.l1_error, "l1_over_record": rec.l1_error / RECORD_L1,
           "max_memory_allocated_gb": e["max_memory_allocated_gb"],
           "x_patches_a_block": patches, "smooth_info": dict(gk.SMOOTH_INFO),
           "spmv_col_formats": e["spmv_col_formats"], "setup_cache": e.get("setup_cache"),
           "x_sha256": hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest(),
           "device_busy_share": e["profile"]["device_busy_share"],
           "excess_ms_by_role": dict(ranked),
           "excess_ms_by_level": {f"{r['role']} L{r['level']} {r['part']}": r["excess_ms"]
                                  for r in rows}}
    log(f"3d: {res['points'][-1]} points, kinds {res['level_kernels']}, {rec.cycles} "
        f"passes, {res['vcycles']} V-cycles, timed solve {rec.wall_time_s:.4f} s, setup "
        f"{res['setup_time_s']:.1f} s, residual {rec.final_residual:.3e} (re-checked "
        f"{recheck:.3e}), L1 {rec.l1_error:.6e} ({res['l1_over_record']:.4f} x the "
        f"record's), device memory {res['max_memory_allocated_gb']:.3f} GB, x patches a "
        f"block {patches} ({card})")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    ap.add_argument("--out", default=None, help="write the SolveRecord here")
    ap.add_argument("--setup-cache", default=None, metavar="PATH",
                    help="solve's --setup-cache: build and save the host problem, "
                         "or load it")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.sizes, args.out, args.setup_cache)), flush=True)


if __name__ == "__main__":
    main()
