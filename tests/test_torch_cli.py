"""The port's CLI surfaces beside ``solve`` and ``ns``, held against the
reference package's CLI on the CPU (``--device cpu``: the kernels' plain
versions; ``--solver`` / ``--cycles``: the host f64 solvers).

* The parsers: every flag and sub-command of the reference's CLI but
  ``--platform`` (the port's ``--device``) parses here.
* ``solve --setup-cache``: a first-use run (built, saved, loaded back) and
  a cached run solve the same bits; other arguments, or a cache without a
  stamp, are refused.
* ``--msh`` on the reference's fixtures (Neumann, deg 4): 610 points, the
  L1 error within 1e-6 relative of the reference CLI's; with
  ``--write-solution``, x, y and exact within 1e-12 of the reference's
  files for the same points, the solution and the error within 1e-6 of
  max |exact|.
* ``--solver bicgstab|vcycle`` and ``--cycles 5`` on the reference's own
  problem (carried across by ``interop``): iterations equal, each history
  entry within 1e-9 relative, the final residual within 1e-12 (of
  ||b||_1), the L1 error within 1e-10 relative of the reference's host
  solvers (``vcycle``: 1e-9, see the test); refused with ``--device
  cuda``.
* ``probe``: 100 sweeps, history within 1e-10 relative of the reference
  CLI's, ``--cond`` within 1e-8 with numpy's global seed set before each.
* ``sweep``: one row a geometry against the reference's rows; a failed row
  is recorded and the sweep exits non-zero.
* ``preprocess``: a bundle that ``load_bundle`` reads with the same
  arguments' stamp.
* ``ops.ell.spmv_n`` (the logical rows of ``spmv``) within 1e-12 of the
  reference's on the same operator.
"""

import contextlib
import dataclasses
import io as pyio
import json
import os

import jax
import numpy as np
import pytest
import torch

from meshlessmultigridpoisson_tpu.apps import cli as jcli
from meshlessmultigridpoisson_tpu.mg.krylov import solve_bicgstab as jbicgstab
from meshlessmultigridpoisson_tpu.mg.vcycle import run_v_cycles as jcycles
from meshlessmultigridpoisson_tpu.mg.vcycle import solve_to_tolerance as jtol
from meshlessmultigridpoisson_tpu.models import poisson as jpoisson

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.apps import cli
from meshlessmultigridpoisson_torch.geometry.pointclouds import PointCloud
from meshlessmultigridpoisson_torch.io import load_bundle, read_vector_txt
from meshlessmultigridpoisson_torch.models import poisson as tpoisson
from test_torch_native import ensure_native_geometry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = ["--geom", "square", "--sizes", "170", "600", "--deg", "4"]
MSH = [os.path.join(REPO, "tests", "fixtures", f) for f in ("square_170.msh",
                                                            "square_600.msh")]


@pytest.fixture(scope="module", autouse=True)
def native():
    ensure_native_geometry()


def _reference_cli(argv, capsys):
    """The reference CLI's printed JSON record (it runs on the CPU here)."""
    capsys.readouterr()
    jcli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _help_flags(main, cmd, capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main([cmd, "--help"])
    return {w.strip(",") for w in capsys.readouterr().out.split() if w.startswith("--")}


@pytest.mark.parametrize("cmd", ["solve", "ns", "sweep", "probe", "preprocess"])
def test_every_reference_flag_parses(cmd, capsys):
    want = _help_flags(jcli.main, cmd, capsys) - {"--platform"}
    got = _help_flags(cli.main, cmd, capsys)
    assert want <= got, want - got
    assert "--device" in got


def test_setup_cache_first_use_and_cached_runs_are_bit_identical(tmp_path):
    cache = str(tmp_path / "cache")  # .npz appended, as the reference does
    argv = ["solve", "--device", "cpu", *GRID, "--neumann", "--setup-cache", cache]
    runs = []
    for _ in range(2):
        err = pyio.StringIO()
        with contextlib.redirect_stderr(err):
            runs.append(cli.run_solve(argv))
        runs[-1] = (*runs[-1], err.getvalue())
    (r1, p1, x1, xl1, e1), (r2, p2, x2, xl2, e2) = runs
    assert "built and cached" in e1 and "loaded from" in e1
    assert "built" not in e2 and "loaded from" in e2
    assert r1.extra["setup_cache"]["built"] and not r2.extra["setup_cache"]["built"]
    assert torch.equal(x1, x2) and torch.equal(xl1, xl2)
    assert r1.final_residual == r2.final_residual < 1e-8
    assert np.array_equal(p1.exact, p2.exact) and np.array_equal(p1.source, p2.source)
    # the same problem built without the cache solves the same bits
    _, _, x3, xl3 = cli.run_solve(argv[:-2])
    assert torch.equal(x1, x3) and torch.equal(xl1, xl3)
    with pytest.raises(SystemExit, match="different problem"):
        cli.run_solve([a if a != "4" else "5" for a in argv])


def test_msh_and_write_solution_match_reference(tmp_path, capsys):
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    flags = ["--msh", *MSH, "--neumann", "--deg", "4", "--tol", "1e-10", "--write-solution"]
    ref = _reference_cli(["solve", *flags, jdir], capsys)
    rec, prob, *_ = cli.run_solve(["solve", "--device", "cpu", *flags, tdir])
    assert rec.config["sizes"] == ref["config"]["sizes"] == [188, 610]
    assert rec.config["msh"] == MSH
    assert rec.final_residual < 1e-10
    assert abs(rec.l1_error - ref["l1_error"]) <= 1e-6 * ref["l1_error"]
    j = {k: read_vector_txt(os.path.join(jdir, f"{k}.txt")) for k in
         ("x", "y", "solution", "exact", "error")}
    t = {k: read_vector_txt(os.path.join(tdir, f"{k}.txt")) for k in j}
    scale = np.abs(j["exact"]).max()
    for k, tol in (("x", 1e-12), ("y", 1e-12), ("exact", 1e-12),
                   ("solution", 1e-6 * scale), ("error", 1e-6 * scale)):
        assert t[k].shape == j[k].shape == (610,)
        assert np.abs(t[k] - j[k]).max() <= tol, k


@pytest.fixture(scope="module")
def reference_problem():
    return jpoisson.make_poisson_problem("square", sizes=[170, 600], poly_deg=4, k1=1)


def _port_problem(pj):
    """The reference's problem as the port's (the same operators)."""
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, pj.hierarchy))
    fine = pj.clouds[-1]
    return tpoisson.PoissonProblem(
        hierarchy=interop.hierarchy_from_numpy(tree),
        clouds=[PointCloud(np.asarray(c.points), [np.asarray(b) for b in c.boundaries],
                           np.asarray(c.normals), c.geomtype) for c in pj.clouds],
        state0=interop.state_from_numpy(
            dataclasses.asdict(jax.tree_util.tree_map(np.asarray, pj.state0))),
        exact=np.asarray(pj.exact),
        source=tpoisson.source_square(np.asarray(fine.points), pj.neumann, pj.k1, pj.k2),
        neumann=pj.neumann, geomtype=pj.geomtype, k1=pj.k1, k2=pj.k2)


@pytest.mark.parametrize("flags", [["--solver", "bicgstab"], ["--solver", "vcycle"],
                                   ["--cycles", "5"]], ids=["bicgstab", "vcycle", "cycles"])
def test_host_solvers_match_reference(flags, reference_problem):
    pj = reference_problem
    rec, _, x, _ = cli.run_solve(["solve", "--device", "cpu", *GRID, *flags],
                                 problem=_port_problem(pj))
    if flags[0] == "--cycles":
        state, hist = jcycles(pj.hierarchy, pj.state0, 5)
        hist = np.asarray(hist)
        its, resid = 5, hist[-1]
        np.testing.assert_allclose(rec.residual_history, hist, rtol=1e-9, atol=0)
    elif flags[1] == "bicgstab":
        state, its, resid = jbicgstab(pj.hierarchy, pj.state0, tol=1e-8, max_iters=300)
    else:
        state, its, resid = jtol(pj.hierarchy, pj.state0, tol=1e-8, max_cycles=2000)
    assert rec.cycles == int(its)
    # relative to ||b||_1: 1e-12 is above the residual's roundoff floor
    # (1.5e-14 apart after the 30 V-cycles to 8e-9)
    assert abs(rec.final_residual - float(resid)) <= 1e-12
    l1 = jpoisson.l1_error(pj, state.x[-1])
    # vcycle: 30 V-cycles to 8e-9 leave the two iterates at their roundoff
    # floor (residuals 1.5e-14 apart): L1 errors 1.003e-10 apart, relative
    assert abs(rec.l1_error - l1) <= (1e-9 if flags[1:] == ["vcycle"] else 1e-10) * l1
    assert rec.config["solver"] == (flags[1] if flags[0] == "--solver" else "fixed-cycles")


def test_spmv_n_matches_reference(reference_problem):
    from meshlessmultigridpoisson_tpu.ops.ell import spmv_n as jspmv_n

    from meshlessmultigridpoisson_torch.ops.ell import spmv_n

    A = _port_problem(reference_problem).hierarchy.finest.A
    x = np.random.default_rng(5).standard_normal(A.ncols)
    y = spmv_n(A, torch.from_numpy(x)).numpy()
    yj = np.asarray(jspmv_n(reference_problem.hierarchy.finest.A, jax.numpy.asarray(x)))
    assert y.shape == yj.shape == (A.nrows,)
    assert np.abs(y - yj).max() <= 1e-12 * np.abs(yj).max()


@pytest.mark.parametrize("flags", [["--solver", "bicgstab"], ["--cycles", "3"]])
def test_host_solvers_refused_on_the_card(flags):
    with pytest.raises(SystemExit, match="--device cpu only"):
        cli.run_solve(["solve", "--device", "cuda", *GRID, *flags])


def test_probe_matches_reference(capsys):
    argv = ["probe", "--sizes", "600", "--sweeps", "100", "--cond"]
    np.random.seed(0)
    ref = _reference_cli(argv, capsys)
    np.random.seed(0)
    rec, _, x, hist = cli.run_probe([argv[0], "--device", "cpu", *argv[1:]])
    assert rec.extra["level_kernels"] == ["v2-fallback"] and x.dtype == torch.float64
    assert len(hist) == 100 and rec.cycles == 100
    np.testing.assert_allclose(rec.residual_history, ref["residual_history"], rtol=1e-10,
                               atol=0)
    assert abs(rec.extra["cond_L"] - ref["extra"]["cond_L"]) <= 1e-8 * ref["extra"]["cond_L"]
    assert abs(rec.l1_error - ref["l1_error"]) <= 1e-10 * ref["l1_error"]


SWEEP = ["--geoms", "square", "square_with_circle", "concentric_circles", "--levels", "2",
         "--ks", "1", "--degs", "4"]


def test_sweep_rows_match_reference(tmp_path, capsys):
    jout, tout = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    jcli.main(["sweep", *SWEEP, "--out", jout])
    rows = cli.run_sweep(["sweep", "--device", "cpu", *SWEEP, "--out", tout])
    with open(jout) as fh:
        ref = json.load(fh)
    with open(tout) as fh:
        assert json.load(fh) == rows
    assert [r["config"] for r in rows] == [r["config"] for r in ref]
    for r, j in zip(rows, ref):
        assert r["final_residual"] < 1e-8
        assert abs(r["l1_error"] - j["l1_error"]) <= 1e-5 * j["l1_error"], r["config"]


def test_sweep_records_a_failed_row_and_exits_non_zero(tmp_path, monkeypatch):
    out = str(tmp_path / "rows.json")
    solve = cli.run_solve

    def flaky(argv):
        if "concentric_circles" in argv:
            raise RuntimeError("injected")
        return solve(argv)

    monkeypatch.setattr(cli, "run_solve", flaky)
    with pytest.raises(SystemExit, match="1 of 2 rows failed"):
        cli.main(["sweep", "--device", "cpu", "--geoms", "square", "concentric_circles",
                  "--levels", "2", "--ks", "1", "--degs", "4", "--out", out])
    with open(out) as fh:
        rows = json.load(fh)
    assert "l1_error" in rows[0] and rows[1]["error"] == "RuntimeError: injected"


def test_preprocess_writes_a_bundle_load_bundle_reads(tmp_path):
    out = str(tmp_path / "b")
    argv = ["preprocess", "--device", "cpu", *GRID, "--out", out]
    path = cli.main(argv)
    assert path == out + ".npz"
    stamp = cli._setup_build_config(cli._parser().parse_args(argv))
    hier, clouds = load_bundle(path, stamp)
    assert [c.n for c in clouds] == [188, 598] and hier.num_levels == 2
    assert hier.finest.n == clouds[-1].n
