"""Multi-rank dry run of the row-sharded solve, and the rank worker that
spawned worlds run.

Counterpart of the reference's ``__graft_entry__.dryrun_multichip``:

    python -m meshlessmultigridpoisson_torch.parallel.dryrun --shards N [--device cpu]

spawns N ranks (processes; the card by default, ``--device cpu`` for gloo
on the CPU; ``--device cuda`` without a card exits non-zero), builds
``square`` [170, 600, 2500], deg 3, Neumann, with ``shard_levels=2``, runs
one sharded V-cycle (finite residual), then on rank 0 checks every shard's
kernels against their plain versions one shard at a time, with no
collectives: the ext matvec (``ell_spmv`` on the [ns x ext] table against
a host gather) and the interior pass's fixed point (with b = A x, halo
zero, one sweep leaves x unchanged).

``spawn`` is the launcher the tests and ``chip_smoke.py`` use: host
problems (a hierarchy and its logical right-hand side each) and a list of
tasks go to the ranks in one ``io.bundle`` file; every rank rendezvouses
by a ``file://`` store and runs ``run_job`` (partition each problem it
needs, once per ``shard_levels``; run the tasks), and rank 0 writes the
results back.  A child process imports this module only (never a test
module).  Each world has its own join timeout; a hung or failed rank
fails the run.  A task with ``plain_checks`` first holds every rank's
kernels on the levels that task repacked (every sharded level, at the
shapes its solve runs) against their plain versions: ``level_plain_errors``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.io import bundle
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.parallel import runtime as rt
from meshlessmultigridpoisson_torch.parallel import sharded as sh
from meshlessmultigridpoisson_torch.parallel.partition import partition_hierarchy

JOIN_TIMEOUT_S = 120
DRYRUN = dict(geomtype="square", sizes=[170, 600, 2500], poly_deg=3, k1=1, neumann=True)
DTYPES = {"float64": torch.float64, "float32": torch.float32}
# kernel-vs-plain tolerances of the per-shard checks (relative to max |ref|):
# f64 to rounding; f32 the reference's interpret-mode tolerances
SPMV_TOL = {torch.float64: 1e-12, torch.float32: 2e-4}
FIXED_POINT_TOL = {torch.float64: 1e-10, torch.float32: 2e-3}
# a kernel against its plain version on the same inputs (relative to max
# |plain output|), chip_smoke's tolerances: f32, the kernel sums a row in
# another order than the plain gather-sum (~70 products of ~1e5-scale
# weights with cancellation), a sweep adds the 128-term K product;
# compact_rows is a gather-sum like the SpMV; f64, the same reorderings at
# 1e-16 an operation
PLAIN_TOL = {(torch.float32, "spmv"): 1e-5, (torch.float64, "spmv"): 1e-12,
             (torch.float32, "sweep"): 1e-4, (torch.float64, "sweep"): 1e-11}
PLAIN_CHECKS = ("frontier", "interior", "spmv_ext", "bound2_ext")
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the tasks a rank runs
# ---------------------------------------------------------------------------


def run_task(task: dict, shier, mesh, b_log) -> dict:
    """Run one task on this rank; returns its outputs (numpy / scalars,
    the same on every rank)."""
    dtype = DTYPES[task.get("dtype", "float64")]
    kind = task["kind"]
    dev = mesh.device
    bf = sh.shard_vector(shier, mesh, b_log, dtype)
    x0 = torch.zeros_like(bf)
    zero = torch.zeros((), dtype=dtype, device=dev)
    out: dict = {}

    def start():
        """The repack is set-up: counts, collectives and time from here."""
        gk.reset_counts()
        mesh.reset_stats()
        _sync(dev)
        return time.perf_counter()

    if kind == "vcycle":
        cyc = sh.make_sharded_vcycle(shier, mesh, dtype)
        if task.get("plain_checks"):
            out["plain_checks"] = gathered_plain_checks(cyc.shards.levels, mesh)
        for _ in range(task.get("warmup", 0)):  # first launches, pinned buffers
            cyc(x0, zero, bf, zero)
        t0 = start()
        xf, xl, hist = x0, zero, []
        for _ in range(task["cycles"]):
            xf, xl, r = cyc(xf, xl, bf, zero)
            hist.append(float(r))
        out.update(history=np.asarray(hist), kinds=[lv.kind for lv in cyc.shards.levels],
                   comm_model=sh.comm_per_cycle(shier, mesh.rank, bf.element_size()))
    elif kind in ("solver", "bicgstab"):
        make = sh.make_sharded_solver if kind == "solver" else sh.make_sharded_bicgstab
        limit = dict(max_cycles=task["max_cycles"]) if kind == "solver" else dict(
            max_iters=task["max_iters"])
        solve = make(shier, mesh, dtype=dtype, **limit)
        if task.get("plain_checks"):
            out["plain_checks"] = gathered_plain_checks(solve.shards.levels, mesh)
        t0 = start()
        xf, xl, it, resid = solve(x0, zero, bf, zero, task["tol"])
        out.update(iters=it, resid=resid, kinds=[lv.kind for lv in solve.shards.levels])
    elif kind == "comm":
        # the fine level's frontier exchange and a scalar all-reduce, each
        # ``reps`` times back to back: seconds a call, bytes and messages
        lv = sh.device_shards(shier, mesh, dtype).levels[0]
        x_ext, s = torch.zeros(lv.ext, dtype=dtype, device=dev), zero.clone()
        n = task["reps"]
        for name, op in (("exchange", lambda: sh._frontier_exchange(lv, mesh, x_ext)),
                         ("all_reduce", lambda: mesh.all_reduce(s))):
            op()
            mesh.reset_stats()
            _sync(dev)
            t1 = time.perf_counter()
            for _ in range(n):
                op()
            _sync(dev)
            out[name] = dict(seconds=(time.perf_counter() - t1) / n,
                             **{k: v / n for k, v in mesh.stats.items() if v})
        t0 = start()
        xf, xl = x0, zero
    else:
        raise ValueError(f"unknown task kind {kind!r}")
    _sync(dev)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in gk.COUNTS.items() if v}
    out["comm"] = dict(mesh.stats)
    out["x"] = sh.unshard_vector(shier, sh.gather_vector(mesh, xf))
    out["x_lag"] = float(xl)
    return out


def level_plain_errors(lv: sh.ShardLevel, seed: int = 0) -> dict:
    """One rank's shard level ``lv``: each kernel of its smoother and
    matvec against its plain version on the same random inputs, no
    collectives: the rectangular frontier class sweep over x_ext (rows past
    nf untouched), the interior pass (frontier rows untouched), the ext
    ``ell_spmv``, the ext ``compact_rows`` re-solve.  Returns {check:
    relative error} (a check the shard has no table for is left out; a
    non-finite output, or a sweep that wrote outside its rows, gives inf:
    no rank raises before the others have gathered)."""
    dt, dev = lv.A.vals.dtype, lv.A.vals.device
    ns, nf, ext = lv.ns, lv.nf, lv.ext
    gen = torch.Generator().manual_seed(seed)

    def rand(n):
        return torch.randn(n, generator=gen, dtype=torch.float64).to(dev, dt)

    xe, b = rand(ext), rand(ns)
    xl = torch.tensor(0.3, dtype=dt, device=dev)
    pairs, strays = {}, set()
    if lv.front is not None:
        out = gk.class_sor_sweep(lv.front, xe.clone(), xl, b[:nf])
        if not torch.equal(out[nf:], xe[nf:]):
            strays.add("frontier")
        pairs["frontier"] = (out, gk.class_sor_sweep_plain(lv.front, xe.clone(), xl, b[:nf]))
    out = sh.interior_sweep(lv, xe[:ns].clone(), xl, b)
    if not torch.equal(out[:nf], xe[:nf]):
        strays.add("interior")
    pairs["interior"] = (out, gk.block_oneshot_sweep_plain(lv.sweep, xe[:ns].clone(), xl, b))
    pairs["spmv_ext"] = (gk.ell_spmv(lv.A, xe), gk.ell_spmv_lens_plain(lv.A, xe))
    if lv.bound.nrows:
        be = torch.zeros(ext, dtype=dt, device=dev)
        be[:ns] = b
        pairs["bound2_ext"] = (gk.compact_rows(lv.bound, xe.clone(), be),
                               gk.compact_rows_plain(lv.bound, xe.clone(), be))
    errs = {k: float((o - r).abs().max()) / max(float(r.abs().max()), 1e-300)
            for k, (o, r) in pairs.items()}
    # NaN is kept for "no such table" (gathered_plain_checks)
    return {k: e if np.isfinite(e) and k not in strays else np.inf for k, e in errs.items()}


def plain_tol(dtype: torch.dtype, check: str) -> float:
    return PLAIN_TOL[(dtype, "sweep" if check in ("frontier", "interior") else "spmv")]


def gathered_plain_checks(levels, mesh) -> dict:
    """``level_plain_errors`` on this rank's ``levels`` (fine-first), all
    gathered: {"errors": [rank, level, check] (NaN where a shard has no
    such table; checks in ``PLAIN_CHECKS`` order), "tol": [check],
    "levels": [(ns, nf, phases)]}.  Every rank raises if any
    rank's check misses its tolerance."""
    dt = levels[0].A.vals.dtype
    errs = torch.full((len(levels), len(PLAIN_CHECKS)), float("nan"), dtype=torch.float64)
    for j, lv in enumerate(levels):
        for k, e in level_plain_errors(lv, seed=1000 * mesh.rank + j).items():
            errs[j, PLAIN_CHECKS.index(k)] = e
    errs = mesh.all_gather(errs.reshape(-1).to(mesh.device)).cpu().numpy()
    errs = errs.reshape(mesh.size, len(levels), len(PLAIN_CHECKS))
    tol = np.array([plain_tol(dt, k) for k in PLAIN_CHECKS])
    bad = np.argwhere(errs > tol)
    if len(bad):
        raise AssertionError("kernel vs plain on the solve's shard levels ({}): {}".format(
            dt, ", ".join(f"rank {r} level {j} {PLAIN_CHECKS[k]} {errs[r, j, k]:.3e} > "
                          f"{tol[k]:.0e}" for r, j, k in bad)))
    return dict(errors=errs, tol=tol, dtype=str(dt),
                levels=np.array([(lv.ns, lv.nf, lv.phases) for lv in levels]))


def check_shard_kernels(shier, device):
    """Every shard's ext matvec and interior pass on every sharded level,
    one shard at a time, no collectives: ``ell_spmv`` on the [ns x ext]
    table against the host gather of the same table, and the interior
    pass's fixed point (b = A x with the halo at zero: one sweep leaves x
    unchanged).  Returns rows of (level, shard, dtype, check, relative
    error, tolerance); raises on a miss."""
    rng = np.random.default_rng(0)
    rows = []
    for j, level in enumerate(shier.sharded):
        for s in range(shier.num_shards):
            f = level.shard(s)
            ns, ext = f.shard_rows, f.ext_rows
            colored = sh.interior_colored(f)
            for dt in (torch.float64, torch.float32):
                lv = sh.shard_level(f, device, dt, colored)
                x_ext = rng.standard_normal(ext)
                y = gk.ell_spmv(lv.A, torch.as_tensor(x_ext, dtype=dt, device=device))
                ref = (f.vals * x_ext[f.lcols_ext]).sum(axis=1)
                err = float(np.abs(y.double().cpu().numpy() - ref).max() / np.abs(ref).max())
                rows.append((j, s, str(dt), "spmv_ext", err, SPMV_TOL[dt]))
                x_own = np.zeros(ext)
                x_own[:ns] = rng.standard_normal(ns)
                b = (f.vals * x_own[f.lcols_ext]).sum(axis=1)
                x = torch.as_tensor(x_own[:ns], dtype=dt, device=device)
                xt = sh.interior_sweep(lv, x.clone(), torch.zeros((), dtype=dt, device=device),
                                       torch.as_tensor(b, dtype=dt, device=device))
                err = float((xt - x).abs().max() / x.abs().max())
                rows.append((j, s, str(dt), f"interior_fixed_point_{lv.kind}", err,
                             FIXED_POINT_TOL[dt]))
    bad = [r for r in rows if not r[4] <= r[5]]
    if bad:
        raise AssertionError(f"per-shard kernel checks failed: {bad}")
    return rows


def run_job(job: dict, mesh) -> dict:
    """A world's job on this rank of ``mesh``: partition each problem the
    tasks need (once per ``shard_levels``), run the tasks in order; returns
    the results (the same on every rank, but rank 0's kernel checks).
    ``job``: {"problems": [{"hierarchy": host ``Hierarchy`` or its numpy
    tree, "b": logical right-hand side}], "tasks": [task]} (``spawn``)."""
    hiers = [h if not isinstance(h, dict) else interop.hierarchy_from_numpy(h)
             for h in (p["hierarchy"] for p in job["problems"])]
    parts: dict = {}
    # the group's size, and its order: every rank's id gathered
    ids = mesh.all_gather(torch.tensor([float(mesh.rank)], device=mesh.device))
    results = dict(topology=rt.topology_summary(),
                   group=dict(size=mesh.size, ranks=ids.cpu().numpy()))
    for task in job["tasks"]:
        key = (task.get("problem", 0), task.get("shard_levels", 1))
        if key not in parts:
            t0 = time.perf_counter()
            parts[key] = partition_hierarchy(hiers[key[0]], mesh.size, shard_levels=key[1])
            results[f"partition_{key[0]}_{key[1]}"] = dict(
                seconds=time.perf_counter() - t0,
                shards=[dict(ns=f.shard_rows, nf=f.frontier_rows, phases=f.phases)
                        for f in parts[key].sharded])
        b = np.asarray(job["problems"][key[0]]["b"])
        results[task["name"]] = run_task(task, parts[key], mesh, b)
        if task.get("check_kernels") and mesh.rank == 0:
            results[task["name"]]["kernel_checks"] = check_shard_kernels(
                parts[key], mesh.device)
    return results


def run_rank(job_path: str, rank: int, world: int, init_method: str) -> None:
    """One rank of a spawned world: rendezvous, ``run_job``; rank 0 writes
    the results next to the job file."""
    torch.set_num_threads(1)
    job = bundle.load_tree(job_path, "shard_job")
    device = job["device"]
    rt.init_distributed(init_method, world, rank, device=device)
    try:
        results = run_job(job, rt.solver_mesh(world, device))
        rt.barrier()
        if rank == 0:
            bundle.save_tree(job_path + ".out", "shard_result", results)
    finally:
        rt.shutdown()


def spawn(n: int, problems, tasks, *, device: str = "cuda", workdir: str | None = None,
          timeout_s: float = JOIN_TIMEOUT_S) -> dict:
    """Run ``tasks`` on a world of ``n`` rank processes; returns rank 0's
    results by task name (trees of numpy arrays and scalars).
    ``problems``: (hierarchy, b_log) pairs, the host ``Hierarchy`` (or its
    ``interop.hierarchy_to_numpy`` tree) and the logical fine right-hand
    side.  A task: a dict with ``name``, ``kind`` ("vcycle" with
    ``cycles`` and optionally ``warmup`` untimed cycles first; "solver" with ``max_cycles`` and ``tol``; "bicgstab" with
    ``max_iters`` and ``tol``; "comm" with ``reps``: the fine level's
    frontier exchange and a scalar all-reduce timed), and optionally ``problem`` (index, 0),
    ``shard_levels`` (1), ``dtype`` ("float64"), ``check_kernels`` (rank 0
    checks every shard's kernels after it), ``plain_checks`` (every rank
    holds its kernels on the task's levels against their plain versions
    before it).  ``device``: "cuda" (the default; raises without a card)
    or "cpu" (gloo, the kernels' plain versions).  Every rank must exit 0
    within ``timeout_s`` (else every rank is killed and the run fails)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    probs = [dict(hierarchy=h if isinstance(h, dict) else interop.hierarchy_to_numpy(h),
                  b=np.asarray(b, dtype=np.float64)) for h, b in problems]
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="shard_world_")
    job = os.path.join(workdir, "job")
    bundle.save_tree(job, "shard_job", dict(problems=probs, tasks=list(tasks),
                                            device=device))
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (PKG_ROOT, os.environ.get("PYTHONPATH")) if p))
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "meshlessmultigridpoisson_torch.parallel.dryrun", "--worker",
         job, "--rank", str(r), "--world", str(n), "--init",
         f"file://{store}"], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(n)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks failed or timed out after {timeout_s} s (rank, rc): "
                           f"{failed}\n" + "\n".join(
                               f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs)))
    res = bundle.load_tree(job + ".out", "shard_result")
    if own:
        for name in os.listdir(workdir):
            os.remove(os.path.join(workdir, name))
        os.rmdir(workdir)
    return res


def dryrun(n_shards: int, device: str = "cuda") -> dict:
    """The dry run (module docstring); returns rank 0's results."""
    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem

    prob = make_poisson_problem(**DRYRUN)
    op = prob.hierarchy.finest
    b_log = op.to_logical(prob.state0.b[-1]).numpy()
    res = spawn(n_shards, [(prob.hierarchy, b_log)],
                [dict(name="vcycle", kind="vcycle", cycles=1, shard_levels=2,
                      check_kernels=True)], device=device)
    resid = float(res["vcycle"]["history"][0])
    if not np.isfinite(resid) or not np.isfinite(res["vcycle"]["x"]).all():
        raise AssertionError(f"the sharded V-cycle is not finite (residual {resid})")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        run_rank(args.worker, args.rank, args.world, args.init)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    res = dryrun(args.shards, args.device)
    topo = res["topology"]
    print(f"dryrun: {args.shards} ranks on {topo['platform']} ({topo['device_kind']}), "
          f"backend {topo['backend']}{' staged through host' if topo['staged'] else ''}; "
          f"shards (ns, nf, phases) per sharded level "
          f"{[(s['ns'], s['nf'], s['phases']) for s in res['partition_0_2']['shards']]}; "
          f"interior kinds {res['vcycle']['kinds']}; one V-cycle, pre-cycle residual "
          f"{float(res['vcycle']['history'][0]):.6g}")
    for j, s, dt, check, err, tol in res["vcycle"]["kernel_checks"]:
        print(f"  level {j} shard {s} {dt:<14s} {check:<34s} rel err {err:.3e} "
              f"(tol {tol:.0e})")
    print("dryrun: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
