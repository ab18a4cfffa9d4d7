"""A closed-loop stream of Poisson solves on one fixed cloud.

One caller, as a simulation or a parameter sweep calls the solver: each
solve starts when the previous one has returned.  A solve is the port's
public sequence, as ``apps/cli.py``'s ``run_solve`` and ``_solve_device``
run it: the source, in the cloud's own point order, put into the fine
level's rows by ``models.poisson.fine_rhs`` on the f64 outer operator (with
the Neumann pushdown), then ``mg.mixed.solve_mixed_stepped`` to the mix's
tolerance, then a device synchronisation.

Set-up (``setup_s``) is the port's alone: ``mg.setup.build_hierarchy`` on
the benchmark's clouds, ``mg.gpu_backend.gpu_hierarchy`` and the f64 outer
operator (``gpu_level_from_operator``), and one warm-up solve of each of
the mix's sources (the kernel library loads at the first).  The clouds,
the boundary data, the sources, the kernel library's build (nvcc, in a
checkout's first run) and the reference's work are timed apart.

After the window every answer is judged against the reference's own
assembly of the fine system (``benchmark.reference.system``): its
relative L1 residual there, the largest over the answers, against the
mix's tolerance.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from benchmark.inputs.clouds import make_clouds
from benchmark.inputs.fields import SourceStream, boundary_values, dense_boundary_values
from benchmark.reference.system import assemble
from benchmark.yardstick import trace as tr


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def point_order(ours: np.ndarray, theirs: np.ndarray) -> np.ndarray | None:
    """p with theirs[i] == ours[p[i]] coordinate for coordinate, or None
    where ``theirs`` is not a permutation of ``ours``."""
    if ours.shape != theirs.shape:
        return None
    ko, kt = np.lexsort(ours.T[::-1]), np.lexsort(theirs.T[::-1])
    if not np.array_equal(ours[ko], theirs[kt]):
        return None
    p = np.empty(ours.shape[0], dtype=np.int64)
    p[kt] = ko
    return p


@dataclasses.dataclass
class Answer:
    index: int  # the source's key: its wavenumber
    x: torch.Tensor  # the solution, the program's padded rows (f64)
    x_lag: torch.Tensor  # the Lagrange unknown
    passes: int
    residual: float  # the solve's own relative residual
    seconds: float  # from the call to the synchronisation


class Program:
    """The port's solve path set up on a cell's clouds; each step of the
    set-up timed on the host clock (``spans``)."""

    def __init__(self, config: dict, neumann: bool, clouds, dev):
        from meshlessmultigridpoisson_torch.config import MultigridConfig
        from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud
        from meshlessmultigridpoisson_torch.mg import mixed
        from meshlessmultigridpoisson_torch.mg.gpu_backend import (
            gpu_hierarchy,
            gpu_level_from_operator,
        )
        from meshlessmultigridpoisson_torch.mg.setup import build_hierarchy

        self.dev, self.neumann = dev, neumann
        geometry, k = config["geometry"], config["manufactured_k"]
        pcs = [PointCloud(c.points, list(c.boundaries), c.normals, geomtype=geometry)
               for c in clouds]
        bc_types = ["neumann" if neumann else "dirichlet"] * max(len(c.boundaries)
                                                                 for c in clouds)

        def bc_values(pts, normals, comp):
            return boundary_values(geometry, neumann, k, pts, normals, comp)

        mg = MultigridConfig(num_levels=len(clouds), **config["multigrid"])
        self.spans = {}
        t0 = time.perf_counter()
        hier, ordered = build_hierarchy(pcs, bc_types, bc_values, mg, config["block_rows"],
                                        ordering=config["ordering"], device=dev)
        t1 = time.perf_counter()
        self.ghier = gpu_hierarchy(hier, dev, sweep_order=config["sweep_order"])
        self.op64 = gpu_level_from_operator(hier.levels[-1], dev, dtype=torch.float64,
                                            sweep=False, sweep_order=config["sweep_order"])
        self.hd = mixed.defect_hierarchy(self.ghier)
        sync(dev)
        t2 = time.perf_counter()
        self.spans.update({"setup.host": t1 - t0, "setup.repack": t2 - t1})
        self.fine_points = ordered[-1].points
        self.host_hierarchy, self.sweep_order = hier, config["sweep_order"]
        self.host_fine = hier.levels[-1]
        self.x0 = torch.zeros(self.op64.n_pad, dtype=torch.float64, device=dev)
        self.xl0 = torch.zeros((), dtype=torch.float64, device=dev)
        self.bl = torch.zeros((), dtype=torch.float64, device=dev)
        self._mixed = mixed

    def solve(self, source: np.ndarray, tol: float, matvec64=None):
        from meshlessmultigridpoisson_torch.models.poisson import fine_rhs

        b = fine_rhs(self.op64, source, self.neumann)
        out = self._mixed.solve_mixed_stepped(self.op64, self.hd, self.x0, self.xl0, b,
                                              self.bl, tol=tol, matvec64=matvec64)
        sync(self.dev)
        return out

    def logical(self, x: torch.Tensor) -> torch.Tensor:
        """A solution in the order of the program's fine cloud."""
        return self.op64.to_logical(x)


@dataclasses.dataclass
class Inputs:
    clouds: list
    neumann: bool
    tol: float
    stream: SourceStream  # in the benchmark's own point order


def make_inputs(config: dict, mix: dict, seed: int) -> Inputs:
    clouds = make_clouds(config["geometry"], config["sizes"], config["cloud_seed"])
    return Inputs(clouds, mix["boundary"] == "neumann", float(mix["tol"]),
                  SourceStream(clouds[-1].points, seed, mix))


def program_sources(inp: Inputs, perm: np.ndarray) -> dict:
    """{wavenumber: source in the program's fine point order}."""
    return {k: inp.stream.source(k)[perm] for k in inp.stream.wavenumbers}


def stream(prog: Program, key, sources: dict, first: int, tol: float,
           seconds: float | None = None, count: int | None = None, matvec64=None) -> list:
    """Solves ``first``, ``first + 1``, ... one after another, solve ``i`` on
    ``sources[key(i)]``, for ``seconds`` (the last one started before it is
    up) or ``count`` solves."""
    out = []
    t_start = time.perf_counter()
    while True:
        src_index = key(first + len(out))
        t0 = time.perf_counter()
        x, xl, it, res = prog.solve(sources[src_index], tol, matvec64)
        t1 = time.perf_counter()
        out.append(Answer(src_index, x.clone(), xl.clone(), int(it), float(res), t1 - t0))
        if count is not None and len(out) >= count:
            break
        if seconds is not None and t1 - t_start >= seconds:
            break
    return out


def reference(inp: Inputs, config: dict, dev):
    """The reference's assembly of the fine system, from the benchmark's
    own cloud and boundary data."""
    fine = inp.clouds[-1]
    g = dense_boundary_values(config["geometry"], inp.neumann, config["manufactured_k"], fine)
    mg = config["multigrid"]
    return assemble(fine, inp.neumann, g, mg["fine_poly_deg"], mg["rbf_exp"], dev)


def judge(ref, answers: list, sources: dict, perm: np.ndarray) -> list:
    """The reference's relative residual of every (source key, x, x_lag)
    answer, x in the benchmark's point order; ``sources`` are the arrays
    the program was handed, in its order (``perm``)."""
    out = []
    for i, x, xl in answers:
        src = np.empty_like(sources[i])
        src[perm] = sources[i]
        out.append(ref.relative_residual(x, xl, src))
    return out


def run(config: dict, mix: dict, seed: int, seconds: float, trace: bool, dev,
        read_metrics) -> dict:
    """One run of a cell; ``read_metrics(ctx)`` reads its metrics while the
    program is still set up.  Returns the run's record."""
    from meshlessmultigridpoisson_torch.ops import gpu_kernels

    t_in = time.perf_counter()
    inp = make_inputs(config, mix, seed)
    log(f"inputs: {[c.n for c in inp.clouds]} points, {time.perf_counter() - t_in:.1f} s")
    if dev.type == "cuda":
        t0 = time.perf_counter()
        gpu_kernels.build()  # nvcc in a checkout's first run, before set-up's clock
        log(f"kernel library: built or found in {time.perf_counter() - t0:.2f} s")
        torch.zeros(1, device=dev)  # the context, before set-up's clock
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    prog = Program(config, inp.neumann, inp.clouds, dev)
    perm = point_order(inp.clouds[-1].points, prog.fine_points)
    if perm is None:
        raise RuntimeError("the program's fine cloud is not a permutation of the "
                           "benchmark's: its answers cannot be placed")
    n_trace = int(mix["trace_solves"]) if trace else 0
    pool = program_sources(inp, perm)
    ks = inp.stream.wavenumbers
    t0 = time.perf_counter()
    warm = stream(prog, lambda i: ks[i], pool, 0, inp.tol, count=len(ks))
    prog.spans["setup.warmup"] = time.perf_counter() - t0
    log(f"set-up: host {prog.spans['setup.host']:.2f} s, repack "
        f"{prog.spans['setup.repack']:.2f} s, warm-up solves {prog.spans['setup.warmup']:.2f} s "
        f"(passes {[a.passes for a in warm]} for k = {ks})")
    del warm

    key = inp.stream.wavenumber
    before = dict(gpu_kernels.COUNTS)
    t0 = time.perf_counter()
    answers = stream(prog, key, pool, 0, inp.tol, seconds=seconds)
    window_s = time.perf_counter() - t0
    launches = {k: gpu_kernels.COUNTS[k] - before[k] for k in before}
    ctx = {"spans": dict(prog.spans, window=window_s), "solves": answers,
           "launches": launches, "program": prog, "card": _card(dev), "trace": None,
           "shapes": None}
    by_k = {k: [a for a in answers if a.index == k] for k in ks}
    log(f"window: {len(answers)} solves in {window_s:.3f} s; by wavenumber: passes "
        f"{ {k: sorted({a.passes for a in v}) for k, v in by_k.items()} }, median s "
        f"{ {k: sorted(a.seconds for a in v)[len(v) // 2] for k, v in by_k.items() if v} }")

    if trace:
        more = []
        events, wall = tr.profiled(lambda: more.extend(
            stream(prog, key, pool, len(answers), inp.tol, count=n_trace)))
        dev_iv, host_iv = tr.split(events)
        ctx["trace"] = {"busy_s": tr.busy_s(dev_iv), "window_s": wall,
                        "device_ops": tr.top_ops(dev_iv), "idle_gaps": tr.idle_gaps(dev_iv, host_iv)}
        del events, dev_iv, host_iv
        gpu_kernels.SHAPES = {}
        try:
            events, _ = tr.profiled(lambda: more.extend(
                stream(prog, key, pool, len(answers) + n_trace, inp.tol, count=n_trace)))
            names = set(gpu_kernels.SHAPES)
        finally:
            gpu_kernels.SHAPES = None
        ctx["shapes"] = {"kernels": tr.range_kernels(events, names)}
        del events
        answers = answers + more

    metrics = read_metrics(ctx)
    trace_summary = ctx["trace"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted = len(answers)
    failed = sum(1 for a in answers if not (math.isfinite(a.residual) and a.residual < inp.tol))

    perm_t = torch.as_tensor(perm, device=dev)
    placed = []
    for a in answers:
        xo = torch.empty_like(a.x[:perm.shape[0]])
        xo[perm_t] = prog.logical(a.x)
        placed.append((a.index, xo, float(a.x_lag)))
    del ctx, answers, prog, perm_t
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    residuals = judge(reference(inp, config, dev), placed, pool, perm)
    worst = max(residuals, key=lambda r: (not math.isfinite(r), r))
    log(f"reference: {len(placed)} answers judged in {time.perf_counter() - t0:.1f} s")
    checks = {"residual_max": {"value": worst, "limit": inp.tol}}
    return {"correct": bool(worst <= inp.tol), "attempted": attempted, "failed": failed,
            "metrics": metrics, "memory_peak_bytes": int(peak), "checks": checks,
            "trace": trace_summary}


def _card(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
