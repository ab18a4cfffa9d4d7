"""Readings for ``correct``'s limit: the program's and its control's, in one
process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 3 --solves 90 \\
        [--control-seeds 4 5 6] [--control-solves 90] [--out FILE]

Sets the cell's program up once, then for each seed drives ``--solves``
solves of that seed's stream (the sources in the order a run's window
drives them, at the cell's own size and load) and judges every answer against the reference's
assembly (``drivers/rhs_stream.judge``): the largest relative residual
over the seed's answers is the seed's reading.  The control is the same
stream with the port's f64 outer pass lowered to float32 (the nearest
precision below the configuration's float64): ``solve_mixed_stepped``'s
``matvec64`` hook computes the outer residual with an f32 copy of the
fine operator (``gpu_level_from_operator(dtype=float32, sweep=False)``)
on the solution rounded to f32.  Prints one JSON object of the readings;
``--out`` writes it too.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--solves", type=int, default=90)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-solves", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=None, help="a checkout other than this one")
    args = ap.parse_args(argv)

    from benchmark.inputs.fields import SourceStream
    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    spec = Spec(args.root) if args.root else Spec()
    cell = spec.cell(args.workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    d = spec.driver(mix["driver"])
    inp = d.make_inputs(config, mix, 0)
    prog = d.Program(config, inp.neumann, inp.clouds, dev)
    perm = d.point_order(inp.clouds[-1].points, prog.fine_points)
    perm_t = torch.as_tensor(perm, device=dev)
    out = {"workload": args.workload, "card": d._card(dev), "tol": inp.tol,
           "setup_spans": prog.spans, "program": [], "control": []}
    control_mv = _control_matvec(prog, dev) if args.control_seeds else None
    ref = d.reference(inp, config, dev)
    pool = d.program_sources(inp, perm)  # the same sources for every seed

    def reading(seed: int, count: int, matvec64) -> dict:
        key = SourceStream(inp.clouds[-1].points, seed, mix).wavenumber
        t0 = time.perf_counter()
        answers = d.stream(prog, key, pool, 0, inp.tol, count=count, matvec64=matvec64)
        wall = time.perf_counter() - t0
        placed = []
        for a in answers:
            xo = torch.empty_like(a.x[:perm.shape[0]])
            xo[perm_t] = prog.logical(a.x)
            placed.append((a.index, xo, float(a.x_lag)))
        res = d.judge(ref, placed, pool, perm)
        row = {"seed": seed, "solves": count, "seconds": wall,
               "residual_max": max(res, key=lambda r: (not math.isfinite(r), r)),
               "residual_median": sorted(res)[len(res) // 2],
               "own_residual_max": max(a.residual for a in answers),
               "failed": sum(1 for a in answers
                             if not (math.isfinite(a.residual) and a.residual < inp.tol)),
               "passes": [a.passes for a in answers],
               "wavenumbers": [a.index for a in answers]}
        print(json.dumps(row), file=sys.stderr, flush=True)
        return row

    for s in args.seeds:
        out["program"].append(reading(s, args.solves, None))
    for s in args.control_seeds:
        out["control"].append(reading(s, args.control_solves or args.solves, control_mv))
    if out["program"]:
        out["lower"] = max(r["residual_max"] for r in out["program"])
    if out["control"]:
        out["upper"] = min(r["residual_max"] for r in out["control"])
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


def _control_matvec(prog, dev):
    """The outer matvec in float32: an f32 copy of the fine operator, the
    solution rounded to f32, the product returned in f64."""
    from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_level_from_operator
    from meshlessmultigridpoisson_torch.mg.krylov import full_matvec

    op32 = gpu_level_from_operator(prog.host_fine, dev, dtype=torch.float32, sweep=False,
                                   sweep_order=prog.sweep_order)

    def mv(x, xl):
        y, yl = full_matvec(op32, x.float(), xl.float())
        return y.double(), yl.double()

    return mv


if __name__ == "__main__":
    sys.exit(main())
