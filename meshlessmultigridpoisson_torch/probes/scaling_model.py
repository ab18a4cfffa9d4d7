"""Weak scaling of the row-sharded solve: the communication model, the
curve on the card, and a projection from the card's own figures.

    python -m meshlessmultigridpoisson_torch.probes.scaling_model --shards 1 2 \
        [--rows-per-shard 65536] [--device cuda|cpu] [--out PATH]
    python -m meshlessmultigridpoisson_torch.probes.scaling_model --shards 4 --out PATH
    python -m meshlessmultigridpoisson_torch.probes.scaling_model --merge A.json B.json \
        --out results/scaling_model_torch_h100.json

Counterpart of the reference's ``scripts/scaling_model.py``.  A point P is
its problem at ``--rows-per-shard`` rows a shard: ``square``, deg 4,
Neumann, kd-tile order, sizes [n/16, n/4, n] with n = P x rows a shard
(the reference's), the finest level sharded over P ranks (one rank in
this process, several spawned: ``parallel.dryrun.spawn``; on one card the
ranks share it through gloo staged in host memory, on four cards NCCL).
On each point's ranks, in turn:

* 8 f32 sharded V-cycles from zero (after one untimed), timed, with rank
  0's collectives counted as they happen (``ShardGroup.stats``) beside
  ``parallel.sharded.comm_per_cycle``'s count from the partition;
* the f64 sharded BiCGStab to 1e-8 within ``MAX_ITERS`` iterations (the
  port's deliberate deviation: the reference's f32 solve ends at 9.7 /
  9.3 / 4.1 in ``results/scaling_model_r5.json``), re-checked with the
  plain f64 SpMV over the bordered system (< 1e-8, else the point fails);
* the fine level's frontier exchange and a scalar all-reduce, each timed
  over ``COMM_REPS`` calls: seconds, bytes and messages a call.

Beside them, ``comm_model``: the reference's per-V-cycle formula (its
counts of exchanges, collectives and bytes from the partition, f32
itemsize), kept here as the port's own copy, with every rate an argument:
the sweep and SpMV rates (nonzeros a second) measured on this card on the
P = 1 fine level (``probes.vcycle_breakdown.breakdown``: one smoother call
of ``iters`` sweeps and one residual), and, for each link the points
measured (gloo staged on one card, NCCL on four), the latency a
collective (the scalar all-reduce) and the rate of an exchange's bytes.
No rate of the reference's (TPU ICI / DCN, its sweep rate) is used.  The
projection to larger shards (``PROJECT_ROWS`` rows a shard, two shards)
takes the same formula with those measured figures.  Not here: P = 8 (no
eight-card machine) and any DCN row (no second host).

``--merge`` joins the points of several calls (P = 1-2 on one card, P = 4
on four) into one record, recomputing the projection from every link
measured.  Every point runs on the card unless given ``--device cpu``
(gloo and the kernels' plain versions: a rehearsal, no device time).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np

ROWS_PER_SHARD = 65536
CYCLES = 8
SOLVE_TOL = 1e-8
# the BiCGStab's iteration cap: above the iterations the points need (the
# reference's 100 stops the P = 4 point at 9.9e-6 on the card)
MAX_ITERS = 400
COMM_REPS = 50
ITEMSIZE = 4  # the reference's model counts f32 words
PROJECT_ROWS = (131072, 524288, 1048576)
JOIN_TIMEOUT_S = 900


def comm_model(f, nnz_fine, iters, nc_tail, rates: dict) -> dict:
    """Per-V-cycle volumes (bytes, counts) from the partition's metadata,
    line for line the reference's ``scripts/scaling_model.comm_model``:
    per sweep ``phases`` frontier exchanges (2 x hops messages of nf rows
    each) and one re-solve exchange and one scalar all-reduce; a residual
    matvec exchange and three scalar all-reduces a cycle; the restriction's
    all-reduce and the prolongation's all-gather of the nc-row tail.
    ``rates``: ``sweep_nnz_s`` and ``spmv_nnz_s`` (nonzeros a second) for
    the compute time, and ``links``: {name: (bytes a second, seconds a
    collective)}, one ``t_comm_<name>_s`` each."""
    nf, hops, phases = f.frontier_rows, f.phases - 1, f.phases
    sweeps = 2 * iters
    exch_per_sweep = phases + 1  # frontier phases + bound_eval
    n_exchanges = sweeps * exch_per_sweep + 1  # + residual matvec
    bytes_exchange = 2 * hops * nf * ITEMSIZE  # per shard, both directions
    ppermute_bytes = n_exchanges * bytes_exchange
    n_psum_scalar = sweeps + 3  # lagrange per sweep + resid num/den + lag
    psum_tail_bytes = nc_tail * ITEMSIZE  # restriction partial-product all-reduce
    allgather_bytes = nc_tail * ITEMSIZE  # coarse solution up
    coll_count = n_exchanges * 2 * hops + n_psum_scalar + 2
    total_bytes = ppermute_bytes + 2 * psum_tail_bytes + allgather_bytes
    nnz_shard = nnz_fine / f.num_shards
    t_comp = (sweeps * nnz_shard / rates["sweep_nnz_s"]
              + 2 * nnz_shard / rates["spmv_nnz_s"])
    out = dict(
        frontier_rows=nf, phases=phases,
        exchanges_per_cycle=n_exchanges,
        ppermute_bytes_per_cycle=int(ppermute_bytes),
        psum_tail_bytes=int(2 * psum_tail_bytes),
        allgather_bytes=int(allgather_bytes),
        total_bytes_per_cycle=int(total_bytes),
        collective_count=int(coll_count),
        t_comp_per_cycle_s=t_comp,
    )
    for name, (bw, lat) in rates.get("links", {}).items():
        out[f"t_comm_{name}_s"] = total_bytes / bw + coll_count * lat
    return out


def efficiency(model: dict, link: str) -> float:
    t = model["t_comp_per_cycle_s"]
    return t / (t + model[f"t_comm_{link}_s"])


def build_problem(P: int, rows_per_shard: int = ROWS_PER_SHARD):
    """The reference's point: ``square`` deg 4 Neumann, kd-tile, sizes
    [n/16, n/4, n] at n = P x rows a shard."""
    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem

    n = rows_per_shard * P
    sizes = [max(n // 16, 300), max(n // 4, 900), n]
    return make_poisson_problem("square", sizes=sizes, poly_deg=4, k1=1, neumann=True,
                                ordering="kdtile")


def partition_facts(hier, P: int) -> dict:
    """What the model reads of the partition of host hierarchy ``hier``
    (the reference's call: ``partition_hierarchy(hierarchy, P)``, the
    finest level sharded)."""
    from meshlessmultigridpoisson_torch.parallel.partition import partition_hierarchy

    shier = partition_hierarchy(hier, P)
    f = shier.sharded[0]
    op = hier.levels[-1]
    return dict(shier=shier, f=f, nnz_fine=int(np.count_nonzero(op.A.vals.numpy())),
                iters=op.iters, nc_tail=shier.coarse.levels[-1].n_pad
                if shier.coarse.levels else 0, n_fine=op.n)


def rates_on(prob, device: str) -> dict:
    """The sweep and SpMV rates (nonzeros a second) of ``prob``'s fine
    level on ``device``: one smoother call (``iters`` sweeps) and one
    residual, as ``probes.vcycle_breakdown`` times them."""
    import torch

    from meshlessmultigridpoisson_torch.mg.gpu_backend import (
        gpu_hierarchy,
        gpu_level_from_operator,
    )
    from meshlessmultigridpoisson_torch.models.poisson import fine_rhs
    from meshlessmultigridpoisson_torch.probes.vcycle_breakdown import breakdown

    dev = torch.device(device)
    hier = gpu_hierarchy(prob.hierarchy, dev)
    op64 = gpu_level_from_operator(prob.hierarchy.levels[-1], dev, torch.float64,
                                   sweep=False)
    b = fine_rhs(op64, prob.source, prob.neumann)
    bd = breakdown(hier, op64, b, prob.state0.b_lag[-1].to(dev))
    fine = bd["levels"][-1]
    nnz = int(np.count_nonzero(prob.hierarchy.levels[-1].A.vals.numpy()))
    return dict(clock=bd["clock"], fine_smooth_ms=fine["smooth_ms"],
                fine_residual_ms=fine["residual_ms"], fine_iters=fine["iters"],
                fine_kernel=fine["kernel"], nnz_fine=nnz,
                sweep_nnz_s=fine["iters"] * nnz / (fine["smooth_ms"] * 1e-3),
                spmv_nnz_s=nnz / (fine["residual_ms"] * 1e-3))


def run_point(P: int, device: str = "cuda", rows_per_shard: int = ROWS_PER_SHARD,
              log=None, prob=None, setup_s: float | None = None) -> dict:
    """One point of the curve (module docstring) on ``prob`` (None: built
    here; ``setup_s`` its host set-up seconds); raises on a failed check."""
    import torch

    from meshlessmultigridpoisson_torch.parallel import dryrun
    from meshlessmultigridpoisson_torch.parallel import runtime as rt
    from meshlessmultigridpoisson_torch.utils.metrics import bordered_residual

    log = log or (lambda m: None)
    if prob is None:
        t0 = time.perf_counter()
        prob = build_problem(P, rows_per_shard)
        setup_s = time.perf_counter() - t0
    facts = partition_facts(prob.hierarchy, P)
    op = prob.hierarchy.finest
    b_log = op.to_logical(prob.state0.b[-1]).numpy()
    tasks = [dict(name="vcycle32", kind="vcycle", cycles=CYCLES, dtype="float32", warmup=1),
             dict(name="bicgstab", kind="bicgstab", max_iters=MAX_ITERS, tol=SOLVE_TOL),
             dict(name="comm", kind="comm", reps=COMM_REPS)]
    log(f"P={P}: sizes {[c.n for c in prob.clouds]}, host set-up {setup_s:.1f} s")
    if P == 1:  # in process: a world of one
        tmp = tempfile.mkdtemp(prefix="scaling_model_")
        rt.init_distributed(f"file://{tmp}/store", 1, 0, device=device)
        try:
            res = dryrun.run_job(dict(problems=[dict(hierarchy=prob.hierarchy, b=b_log)],
                                      tasks=tasks), rt.solver_mesh(1, device))
        finally:
            rt.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)
    else:
        res = dryrun.spawn(P, [(prob.hierarchy, b_log)], tasks, device=device,
                           timeout_s=JOIN_TIMEOUT_S)
    vc, bi, cm = res["vcycle32"], res["bicgstab"], res["comm"]
    x_pad = op.to_padded(torch.from_numpy(np.asarray(bi["x"])))
    recheck = bordered_residual(op, prob.state0.b[-1], prob.state0.b_lag[-1], x_pad,
                                bi["x_lag"])
    counted = {k: v / CYCLES for k, v in vc["comm"].items()}
    f = facts["f"]
    row = dict(
        P=P, backend=res["topology"]["backend"], staged=res["topology"]["staged"],
        rows_per_shard=f.shard_rows, n_fine=facts["n_fine"], nnz_fine=facts["nnz_fine"],
        sizes=[c.n for c in prob.clouds], setup_s=setup_s,
        frontier_rows=f.frontier_rows, phases=f.phases, iters=facts["iters"],
        nc_tail=facts["nc_tail"],
        cycle_s=vc["seconds"] / CYCLES, cycle_residual_8=float(vc["history"][-1]),
        collectives_counted_per_cycle=counted,
        collectives_port_model_per_cycle=vc["comm_model"],
        solve_iters=int(bi["iters"]), solve_residual=float(bi["resid"]),
        solve_recheck=float(recheck), solve_s=bi["seconds"],
        exchange=cm.get("exchange"), all_reduce=cm.get("all_reduce"))
    bad = []
    if not (0 <= row["solve_residual"] < SOLVE_TOL and recheck < SOLVE_TOL):
        bad.append(f"f64 BiCGStab residual {row['solve_residual']:.3e}, re-checked "
                   f"{recheck:.3e} (want < {SOLVE_TOL})")
    if counted != vc["comm_model"]:
        bad.append(f"collectives counted {counted} != comm_per_cycle {vc['comm_model']}")
    log(f"P={P}: cycle {row['cycle_s'] * 1e3:.3f} ms, BiCGStab {row['solve_iters']} its "
        f"{row['solve_s']:.3f} s residual {row['solve_residual']:.3e} (re-checked "
        f"{recheck:.3e}), exchange {row['exchange']}, all-reduce {row['all_reduce']}")
    if bad:
        print(json.dumps(row), flush=True)
        raise AssertionError(f"scaling point P={P}: " + "; ".join(bad))
    return row


def links_of(points: list) -> dict:
    """{link: (bytes a second, seconds a collective)} from the points with
    a frontier exchange: the latency a collective is the scalar
    all-reduce's time, the rate an exchange's bytes over its whole time
    (its latency included, so the model's t_comm, which adds a latency a
    collective to the bytes over the rate, is an upper bound).  A link is
    named by its backend ("gloo_staged", "nccl"); of several points on one
    link, the one with the most ranks."""
    links = {}
    for p in sorted(points, key=lambda p: p["P"]):
        ex, ar = p.get("exchange"), p.get("all_reduce")
        if p["P"] < 2 or not ex or not ar or not ex.get("bytes"):
            continue
        name = p["backend"] + ("_staged" if p["staged"] else "")
        links[name] = (ex["bytes"] / ex["seconds"], ar["seconds"])
    return links


def assemble(points: list, rates: dict, card: dict | None) -> dict:
    """The record: each point with the model at the measured rates and
    links, and the projection to ``PROJECT_ROWS`` rows a shard on two
    shards (the frontier rows and phases of the widest measured
    partition, K = 70 nonzeros a row, the tail n/16 as the reference)."""
    links = links_of(points)
    r = dict(sweep_nnz_s=rates["sweep_nnz_s"], spmv_nnz_s=rates["spmv_nnz_s"], links=links)

    class _F:  # the model reads these four fields of a partition
        def __init__(self, nf, phases, shards):
            self.frontier_rows, self.phases, self.num_shards = nf, phases, shards

    for p in points:
        m = comm_model(_F(p["frontier_rows"], p["phases"], p["P"]), p["nnz_fine"],
                       p["iters"], p["nc_tail"], r)
        p["model"] = m
        p["projected_eff"] = {k: efficiency(m, k) for k in links}
    wide = max(points, key=lambda p: p["frontier_rows"])
    proj = {}
    for rps in PROJECT_ROWS:
        m = comm_model(_F(wide["frontier_rows"], wide["phases"], 2), rps * 2 * 70, 5,
                       max(rps // 16, 2048), r)
        proj[str(rps)] = dict(rows_per_shard=rps, model=m,
                              eff={k: efficiency(m, k) for k in links})
    return dict(rows_per_shard=points[0]["rows_per_shard"], cycles=CYCLES,
                solve_tol=SOLVE_TOL, rates=dict(rates, links={k: dict(bytes_s=v[0],
                                                                      latency_s=v[1])
                                                              for k, v in links.items()}),
                card=card, curve=sorted(points, key=lambda p: p["P"]),
                projection_2shards=proj,
                not_here=["P = 8 (no eight-card machine)", "DCN (no second host)"])


def _log(m) -> None:
    print(m, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--rows-per-shard", type=int, default=ROWS_PER_SHARD)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--merge", nargs="+", default=None, metavar="RECORD")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.merge:
        recs = []
        for p in args.merge:
            with open(p) as f:
                recs.append(json.load(f))
        points = [p for r in recs for p in r["curve"]]
        rates = next(r["rates"] for r in recs if r["rates"].get("measured_on_P1"))
        res = assemble(points, rates, recs[0]["card"])
    else:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            _log("probes.scaling_model: --device cuda needs a card (torch.cuda."
                 "is_available() is False); --device cpu rehearses on the plain versions")
            return 1
        card = None
        if args.device == "cuda":
            from meshlessmultigridpoisson_torch.utils.profiling import card as card_info

            card = card_info()
        t0 = time.perf_counter()
        one = build_problem(1, args.rows_per_shard) if 1 in args.shards else None
        one_s = time.perf_counter() - t0
        points = [run_point(P, args.device, args.rows_per_shard, _log,
                            *((one, one_s) if P == 1 else ())) for P in args.shards]
        rates = dict(measured_on_P1=False)
        if one is not None:
            rates = dict(rates_on(one, args.device), measured_on_P1=True)
            _log(f"rates: sweep {rates['sweep_nnz_s']:.4e}, SpMV {rates['spmv_nnz_s']:.4e} "
                 f"nonzeros/s ({rates['clock']})")
        res = (assemble(points, rates, card) if rates["measured_on_P1"]
               else dict(rows_per_shard=args.rows_per_shard, rates=rates, card=card,
                         curve=points))
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
