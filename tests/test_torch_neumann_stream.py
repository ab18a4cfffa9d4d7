"""The benchmark's Neumann stream through the port's solve, on the CPU.

On ``square_hole-150k-neumann``'s generator cut to a 3-level ladder (216 / 678 /
2,442 points, degree 4, 256-row blocks: the benchmark tests' ``tiny``
cell), through the kernels' plain versions, every source of
``neumann-rhs-stream`` (k = 1..4, boundary data of k = 1) goes through
``fine_rhs`` + ``solve_mixed_stepped`` to 1e-8 and is judged by
``benchmark.reference.system``'s residual (plain NumPy/SciPy/torch, none of
the port); each solve's record holds its passes, none rolled back or
escalated.

The stall that kept the cell out (PERF.md §7 q1) shows only on a
133,240-point ladder whose fine smoother diverges at a corner of the
square; no CPU-sized ladder of this generator shows it, so this test holds
the stream's solve path and its counters at a size tier-1 affords.
"""

import pytest
import torch

from benchmark.drivers import rhs_stream
from benchmark.spec import Spec
from meshlessmultigridpoisson_torch.mg import mixed
from meshlessmultigridpoisson_torch.models.poisson import fine_rhs
from meshlessmultigridpoisson_torch.utils import trace

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture(scope="module")
def cell():
    spec = Spec()
    config = dict(spec.config("square_hole-150k-neumann"), sizes=[176, 640, 2532], block_rows=256)
    config["multigrid"] = dict(config["multigrid"], fine_poly_deg=4)
    inp = rhs_stream.make_inputs(config, spec.traffic("neumann-rhs-stream"), 2**31 + 77)
    prog = rhs_stream.Program(config, True, inp.clouds, torch.device("cpu"))
    perm = rhs_stream.point_order(inp.clouds[-1].points, prog.fine_points)
    return dict(inp=inp, prog=prog, perm=perm, pool=rhs_stream.program_sources(inp, perm),
                ref=rhs_stream.reference(inp, config, torch.device("cpu")))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_stream_source_meets_the_tolerance_by_the_reference(cell, k):
    prog, perm = cell["prog"], cell["perm"]
    assert k in cell["inp"].stream.wavenumbers
    b = fine_rhs(prog.op64, cell["pool"][k], True)
    x, xl, passes, res = mixed.solve_mixed_stepped(prog.op64, prog.hd, prog.x0, prog.xl0,
                                                   b, prog.bl, tol=TOL)
    rec = trace.SOLVES[-1]
    assert res < TOL and rec.passes == passes <= 4
    assert (rec.escalations, rec.rejected) == (0, 0) and 0 <= rec.capped <= passes
    xo = torch.empty(perm.shape[0], dtype=torch.float64)
    xo[torch.as_tensor(perm)] = prog.logical(x)
    assert cell["ref"].relative_residual(xo, float(xl), cell["inp"].stream.source(k)) <= TOL
