"""The program's spans and counters (``utils/trace.py``) on the CPU.

On a 3-level square ladder (170 / 600 / 2,500 points, degree 4), Dirichlet
and Neumann, through the kernels' plain versions:

* a solve's record: its BiCGStab iterations are the per-pass iterations
  ``solve_mixed(..., passes=[])`` reports, summed (and the stepped form's
  on the same problem), its V-cycles twice that, its host reads the reads
  the code makes (two before the loop, then per pass the correction's
  norm, BiCGStab's first residual, two a BiCGStab iteration and the pass's
  residual);
* the set-up stage spans: all present, together at least 90% of, and no
  more than, a clock around ``build_hierarchy``; a second build or repack
  replaces the first one's;
* no ``record_function`` entered during a solve with ``SHAPES`` None, and
  with ``SHAPES`` a dict every level's ``down`` / ``up`` / ``coarse``
  range registered, the coarse one once a V-cycle;
* the ring bounded; each new metric reader of ``benchmark/metrics`` a
  number on a context built from such records, None on an empty one.
"""

import collections
import time
import types

import pytest
import torch

from benchmark.spec import Spec
from meshlessmultigridpoisson_torch.apps import cli
from meshlessmultigridpoisson_torch.mg import gpu_backend, mixed
from meshlessmultigridpoisson_torch.models import poisson
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.utils import trace

SIZES = [170, 600, 2500]
CASES = ("dirichlet", "neumann")
TOL = 1e-8


def reads(passes) -> int:
    """The host reads of a ``solve_mixed`` run with these (iterations,
    inner residual, outer residual) passes: ``_prepare``'s and the first
    residual's norm, then per pass the correction's norm, BiCGStab's first
    residual, two a completed iteration (one where it broke down: the -1
    sentinel) and the pass's residual."""
    return 2 + sum(3 + 2 * its - (inner == -1.0) for its, inner, _ in passes)


class CountingRange:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CountingRange.entered += 1

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", params=CASES)
def run(request):
    """The problem built (the clock around ``build_hierarchy``), repacked
    for the plain kernels, and solved three ways: ``solve_mixed`` with its
    passes and a counted ``record_function``, ``solve_mixed_stepped``, and
    ``solve_mixed_stepped`` with ``SHAPES`` on."""
    neumann = request.param == "neumann"
    mp = pytest.MonkeyPatch()
    clock = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = build(*a, **kw)
        clock.append(time.perf_counter() - t0)
        return out

    build = poisson.build_hierarchy
    try:
        mp.setattr(poisson, "build_hierarchy", timed)
        prob = poisson.make_poisson_problem("square", sizes=SIZES, poly_deg=4,
                                            neumann=neumann)
        spans = {k: trace.SPANS[k] for k in trace.SETUP_STAGES}
        ghier = gpu_backend.gpu_hierarchy(prob.hierarchy, "cpu")
        op64 = gpu_backend.gpu_level_from_operator(prob.hierarchy.levels[-1], "cpu",
                                                   torch.float64, sweep=False)
        hd = mixed.defect_hierarchy(ghier)
        b = poisson.fine_rhs(op64, prob.source, neumann)
        args = (op64, hd, torch.zeros(op64.n_pad, dtype=torch.float64),
                torch.zeros((), dtype=torch.float64), b, prob.state0.b_lag[-1])

        mp.setattr(torch.profiler, "record_function", CountingRange)
        CountingRange.entered = 0
        passes = []
        out = mixed.solve_mixed(*args, tol=TOL, passes=passes)
        plain = dict(rec=trace.SOLVES[-1], out=out, passes=passes,
                     ranges=CountingRange.entered)
        stepped = dict(out=mixed.solve_mixed_stepped(*args, tol=TOL), rec=trace.SOLVES[-1])
        mp.setattr(gk, "SHAPES", {})
        CountingRange.entered = 0
        mixed.solve_mixed_stepped(*args, tol=TOL)
        shaped = dict(rec=trace.SOLVES[-1], shapes=dict(gk.SHAPES),
                      ranges=CountingRange.entered)
    finally:
        mp.undo()
    return dict(prob=prob, ghier=ghier, clock=clock, spans=spans, plain=plain,
                stepped=stepped, shaped=shaped, args=args)


def test_record_iterations_are_the_passes_sum(run):
    p = run["plain"]
    its = sum(i for i, _, _ in p["passes"])
    assert its > 0 and p["rec"].iters == its
    assert p["rec"].passes == p["out"][2] == len(p["passes"])
    assert p["out"][3] < TOL
    # the stepped form on the same problem takes the same passes here
    s = run["stepped"]
    assert s["out"][2] == p["out"][2] and s["rec"].iters == its


def test_vcycles_are_twice_the_iterations(run):
    for key in ("plain", "stepped", "shaped"):
        rec = run[key]["rec"]
        assert rec.vcycles == 2 * rec.iters > 0, key


def test_syncs_are_the_reads_the_code_makes(run):
    p = run["plain"]
    assert p["rec"].syncs == reads(p["passes"])
    s = run["stepped"]["rec"]  # no breakdown: reads() gives 3 + 2 its a pass
    assert s.syncs == 2 + 3 * s.passes + 2 * s.iters
    for key in ("plain", "stepped"):
        rec = run[key]["rec"]
        assert 0 <= rec.blocked_s <= rec.wall_s and rec.wall_s > 0
        assert not rec.profiled and not rec.shapes


def test_setup_stage_spans_cover_the_build(run):
    (clock,) = run["clock"]
    spans = run["spans"]
    assert set(spans) == set(trace.SETUP_STAGES) and all(v > 0 for v in spans.values())
    assert 0.9 * clock <= sum(spans.values()) <= clock


def test_a_second_build_and_repack_replace_the_record(run):
    t0 = time.perf_counter()
    prob = poisson.make_poisson_problem("square", sizes=SIZES[:2], poly_deg=4,
                                        neumann=run["prob"].neumann)
    t1 = time.perf_counter()
    gpu_backend.gpu_hierarchy(prob.hierarchy, "cpu")
    t2 = time.perf_counter()
    setup = [trace.SPANS[k] for k in trace.SETUP_STAGES]
    repack = [trace.SPANS[k] for k in trace.REPACK_STAGES]
    assert 0 < sum(setup) <= t1 - t0 < sum(run["spans"].values())
    assert 0 < sum(repack) <= t2 - t1
    assert trace.SPANS["repack.outer64"] == trace.SPANS["repack.defect"] == 0.0


def test_no_profiler_range_with_shapes_off(run):
    assert run["plain"]["ranges"] == 0


def test_every_level_range_registered_with_shapes_on(run):
    sh = run["shaped"]
    L = len(run["ghier"].levels)
    names = ({f"vcycle L{i} {part}" for i in range(1, L) for part in ("down", "up")}
             | {"vcycle L0 coarse"})
    assert set(sh["shapes"]) == names  # the plain kernels launch no shape range
    assert all(sh["shapes"][n] == sh["rec"].vcycles for n in names)
    assert sh["ranges"] == (2 * L - 1) * sh["rec"].vcycles
    assert sh["rec"].shapes and not sh["rec"].profiled


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_level_range_marks_its_ends_on_a_card(monkeypatch, device):
    """On a card a level range launches an empty kernel as it opens and as
    it closes (the profiler's projection of a range spans only the kernels
    launched in it outside its nested ranges); on the CPU none."""
    marks = []
    monkeypatch.setattr(torch.cuda, "_sleep", marks.append)
    monkeypatch.setattr(torch.profiler, "record_function", CountingRange)
    monkeypatch.setattr(gk, "SHAPES", {})
    with trace.level_range(2, "up", device):
        marks.append("work")
    assert gk.SHAPES == {"vcycle L2 up": 1}
    assert marks == ([0, "work", 0] if device == "cuda" else ["work"])


def test_counters_count_escalations_rejections_and_capped_solves(run, monkeypatch):
    """With an identity outer operator and an inner solve that returns
    (1 - ratio) r: a pass that made the residual worse is rolled back and
    counted, the stall it leaves escalates (counted), and an inner solve at
    its cap above its tolerance is counted capped; ``solve_mixed`` counts
    its capped solves and never escalates or rolls back."""
    op64 = run["args"][0]
    ident = lambda x, xl: (x, xl)  # noqa: E731
    script = iter([(0.5, "cap", 2.0), (1.5, 3, 0.5), (0.1, "cap", 0.5), (1e-12, 4, 0.5)])

    def inner(hier, r, rl, inner_tol, inner_iters, matvec32=None):
        ratio, its, res = next(script)
        its = inner_iters if its == "cap" else its
        c = 1.0 - ratio
        return c * r, c * rl, its, res * inner_tol

    monkeypatch.setattr(mixed, "_inner", inner)
    b = torch.ones(op64.n_pad, dtype=torch.float64)
    zero = torch.zeros((), dtype=torch.float64)
    out = mixed.solve_mixed_stepped(op64, None, torch.zeros_like(b), zero, b, zero,
                                    tol=1e-8, matvec64=ident)
    rec = trace.SOLVES[-1]
    # pass 1 capped (res 2 tol), pass 2 rolled back and escalated, pass 3 at
    # the doubled cap but under its tolerance, pass 4 reaches tol
    assert out[2] == rec.passes == 4
    assert (rec.escalations, rec.rejected, rec.capped) == (1, 1, 1)
    script = iter([(0.5, "cap", 2.0), (0.5, 7, 2.0), (1e-12, "cap", 0.5)])
    mixed.solve_mixed(op64, None, torch.zeros_like(b), zero, b, zero, tol=1e-8,
                      matvec64=ident)
    rec = trace.SOLVES[-1]
    assert rec.passes == 3 and (rec.escalations, rec.rejected, rec.capped) == (0, 0, 1)


def test_a_real_inner_solve_at_its_cap_is_counted(run):
    """Two BiCGStab iterations a pass cannot reach the inner tolerance: every
    pass is capped; the record's counters add no host read."""
    mixed.solve_mixed_stepped(*run["args"], tol=TOL, inner_iters=2, max_outer=3,
                              max_escalations=0)
    rec = trace.SOLVES[-1]
    assert rec.passes == rec.capped > 0 and rec.iters == 2 * rec.passes
    assert rec.syncs == 2 + 3 * rec.passes + 2 * rec.iters


def test_profiler_recording_is_in_the_record(run):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        mixed.solve_mixed_stepped(*run["args"], tol=1e-3)
    assert trace.SOLVES[-1].profiled and not trace.SOLVES[-1].shapes


def test_an_input_copy_across_devices_is_the_next_solves_sync(monkeypatch):
    """A copy to another device before a solve is counted in that solve's
    record; one on the same device is not (``fine_rhs`` on the CPU)."""
    monkeypatch.setattr(trace, "_staged", [0, 0.0])
    trace.input_copy(torch.ones(4), torch.empty(4))
    out = trace.input_copy(torch.ones(4), torch.empty(4, device="meta"))
    assert out.device.type == "meta" and trace._staged[0] == 1
    with trace.solve() as rec:
        trace.host_read(torch.ones(()))
    assert rec.syncs == 2 and trace._staged == [0, 0.0]


def test_the_ring_stays_bounded(monkeypatch):
    assert trace.RING >= 20_480 and trace.SOLVES.maxlen == trace.RING
    monkeypatch.setattr(trace, "SOLVES", collections.deque(maxlen=trace.RING))
    for _ in range(trace.RING + 10):
        with trace.solve():
            trace.vcycle()
    assert len(trace.SOLVES) == trace.RING


def test_cli_setup_stages_and_trace_come_from_the_spans(tmp_path):
    rec, *_ = cli.run_solve(["solve", "--device", "cpu", "--geom", "square", "--sizes",
                             "170", "600", "--deg", "4", "--tol", "1e-8"])
    st = rec.extra["setup_stages_s"]
    assert set(st) == {"host_problem", "repack", *trace.SETUP_STAGES, *trace.REPACK_STAGES}
    assert st["host_problem"] == pytest.approx(sum(st[k] for k in trace.SETUP_STAGES))
    assert st["repack"] == pytest.approx(sum(st[k] for k in trace.REPACK_STAGES))
    assert 0 < st["host_problem"] + st["repack"] <= rec.extra["setup_time_s"]
    assert all(st[k] > 0 for k in trace.SETUP_STAGES + trace.REPACK_STAGES)
    tr = rec.extra["trace"]
    assert tr["passes"] == rec.cycles and tr["vcycles"] == 2 * tr["iters"] > 0


def test_kernels_inside_a_range_are_its_own():
    spans = [(0, 10, "vcycle L1 down"), (12, 20, "vcycle L1 down"), (0, 4, "sweep8 1x1")]
    kernels = [(1, 3, "k"), (4, 9, "k"), (9, 11, "k"), (13, 15, "k"), (21, 22, "k")]
    got = cli._kernels_inside(spans, kernels)
    assert got == {"vcycle L1 down": pytest.approx(0.009), "sweep8 1x1": pytest.approx(0.002)}


# ---------------------------------------------------------------------------
# the benchmark's readers of these records
# ---------------------------------------------------------------------------

READERS = ("solve.inner_iters", "solve.host_syncs", "solve.host_blocked_share",
           "vcycle.finest_level_ms", "vcycle.lower_levels_ms", "setup.host.stencils_s",
           "setup.host.stabilize_s", "setup.host.transfers_s", "solve.escalations",
           "solve.rejected_passes", "solve.inner_capped_share", "solve.boundary_rows_ms")
COUNTER_READERS = ("solve.escalations", "solve.rejected_passes", "solve.inner_capped_share")


def record(**kw):
    return trace.SolveTrace(**kw)


@pytest.fixture
def records(monkeypatch):
    """Warm-up solves, a window of 3, then profiled solves without and with
    ``SHAPES``, as the benchmark's traced run leaves them; the set-up spans."""
    ring = collections.deque(maxlen=trace.RING)
    ring.extend(record(iters=99, syncs=99, blocked_s=9.0) for _ in range(4))
    ring.extend(record(passes=3, iters=30 + i, vcycles=2 * (30 + i), syncs=70 + i,
                       blocked_s=0.2, escalations=i, rejected=1, capped=i)
                for i in range(3))
    ring.extend(record(iters=99, vcycles=50, profiled=True) for _ in range(2))
    ring.extend(record(iters=10, vcycles=20, profiled=True, shapes=True) for _ in range(2))
    monkeypatch.setattr(trace, "SOLVES", ring)
    monkeypatch.setattr(trace, "SPANS", {"setup.order": 0.5, "setup.stencils": 4.0,
                                         "setup.stabilize": 2.0, "setup.transfers": 1.0})
    kernels = {"vcycle L2 down": [("smooth", 400.0), ("spmv", 100.0),
                                  (f"at::cuda::{trace.MARK_KERNEL}(long)", 1.0)],
               "vcycle L2 up": [("smooth", 400.0)],
               "vcycle L1 down": [("smooth", 100.0)], "vcycle L1 up": [("smooth", 100.0)],
               "vcycle L0 coarse": [("coarse", 200.0)],
               "sweep8 1024x1024x5": [("smooth", 400.0)],
               "bound2 3072x3072": [("compact_rows", 3.0), ("compact_rows", 5.0)],
               "push2 9728x3072": [("compact_rows", 4.0)]}
    solves = [types.SimpleNamespace(seconds=0.25) for _ in range(3)]
    return {"solves": solves, "shapes": {"kernels": kernels}}


EXPECTED = {"solve.inner_iters": 31.0, "solve.host_syncs": 71.0,
            "solve.host_blocked_share": 80.0,
            "vcycle.finest_level_ms": 0.9 / 40, "vcycle.lower_levels_ms": 0.4 / 40,
            "setup.host.stencils_s": 4.0, "setup.host.stabilize_s": 2.0,
            "setup.host.transfers_s": 1.0, "solve.escalations": 1.0,
            "solve.rejected_passes": 1.0, "solve.inner_capped_share": 100.0 * 3 / 9,
            "solve.boundary_rows_ms": 0.012 / 2}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_records(records, name):
    assert Spec().reader(name).read(records) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_records(monkeypatch, name):
    monkeypatch.setattr(trace, "SOLVES", collections.deque(maxlen=trace.RING))
    monkeypatch.setattr(trace, "SPANS", {})
    assert Spec().reader(name).read({"solves": [], "shapes": None}) is None


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_counter_reader_is_none_on_records_without_the_counter(monkeypatch, name):
    """A program whose records predate the counter reads None."""
    old = types.SimpleNamespace(passes=3, iters=30, profiled=False, shapes=False)
    monkeypatch.setattr(trace, "SOLVES", collections.deque([old] * 3, maxlen=trace.RING))
    assert Spec().reader(name).read({"solves": [None] * 3, "shapes": None}) is None
