"""The port's fractional-step path held against the reference package, on the CPU.

Configuration: the reference's NS problem at sizes 170/600, deg 4 (clouds of
188 and 598 points; fine level 768 padded rows, both levels v7-exact), the
reference FracStepConfig with ``ppe_tol`` 1e-10.

* problem build: identical clouds; ``dx``/``dy``/``lap`` and the base-degree
  transfers to 1e-12 relative; ``bmask``, ``u_bc``, ``v_bc``, ``normals``
  exact;
* ``compact_rows`` role ``ppe2`` (plain version) against the reference
  ``spmv_tpu2`` in interpret mode plus the ``_mv32`` scatter;
* ``_mv64`` against the reference ``make_compatible_matvec`` (1e-12), and
  ``_mv32`` within the f32 kernel budget (rtol 2e-4 of max |y|);
* ``solve_mixed``'s stopping rule (tol, max_outer, 0.7x stagnation, no
  rollback);
* the f64 oracle's other modes: the reference PPE (bicgstab and vcycle),
  implicit diffusion, and hyperviscosity with its spectral-radius scale;
* 3 timesteps from the prescribed Kovasznay state: the port's f64
  ``fracstep.timestep`` against the reference's (velocities 1e-10; pressure
  and fs_residual 1e-6, see the test), and
  ``timestep_gpu`` on CPU tensors within the reference's own budget for its
  device path (tests/test_fracstep_tpu.py: u and v 2e-4 of max |u|,
  fs_residual 2e-2 relative);
* ``cli ns --device cpu --steps 5`` against the reference CLI's CPU record;
* the build guards and ``geometry/msh`` on the two square fixtures.

Operators reach the port through ``interop.fracstep_problem_from_numpy``
where a case compares solvers, so they compare the same matrices.
"""

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.config import FracStepConfig as JConfig
from meshlessmultigridpoisson_tpu.geometry import msh as jmsh
from meshlessmultigridpoisson_tpu.mg import tpu_backend as tb
from meshlessmultigridpoisson_tpu.models import fracstep as jfs
from meshlessmultigridpoisson_tpu.ops.kernels import spmv_tpu2

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.config import FracStepConfig
from meshlessmultigridpoisson_torch.geometry import msh as tmsh
from meshlessmultigridpoisson_torch.mg import mixed
from meshlessmultigridpoisson_torch.models import fracstep as tfs
from meshlessmultigridpoisson_torch.models import fracstep_gpu as fg
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

# the test workers share the host's cores with the JAX test files: one
# intra-op thread per process keeps torch's thread pool from contending
torch.set_num_threads(1)

SIZES, DEG = [170, 600], 4
REL = 1e-12
# the pressure and fs_residual of two f64 solves that stop at an iteration
# cap (see test_f64_timestep_matches_reference)
PPE_REL = 1e-6
FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


def _problem_tree(pj) -> dict:
    """A reference FracStepProblem as the dict interop takes."""
    tree = {f: _numpy_tree(getattr(pj, f))
            for f in ("hierarchy", "dx", "dy", "lap", "state0")}
    tree.update({f: np.asarray(getattr(pj, f))
                 for f in ("bmask", "u_bc", "v_bc", "normals")})
    tree.update(clouds=[dataclasses.asdict(c) for c in pj.clouds],
                config=dataclasses.asdict(pj.config),
                compatible_ppe=pj.compatible_ppe, lap_scale=pj.lap_scale)
    return tree


@pytest.fixture(scope="module")
def jprob():
    return jfs.build_fracstep_problem(sizes=SIZES, poly_deg=DEG, config=JConfig())


@pytest.fixture(scope="module")
def tprob(jprob):
    """The port's problem on the reference's operators."""
    return interop.fracstep_problem_from_numpy(_problem_tree(jprob))


@pytest.fixture(scope="module")
def gfs(tprob):
    return fg.build_gpu_fracstep(tprob, "cpu")


def test_problem_build_matches_reference(jprob):
    pt = tfs.build_fracstep_problem(sizes=SIZES, poly_deg=DEG, config=FracStepConfig())
    for cj, ct in zip(jprob.clouds, pt.clouds):
        np.testing.assert_array_equal(ct.points, cj.points)
        np.testing.assert_array_equal(ct.normals, cj.normals)
        for bt, bj in zip(ct.boundaries, cj.boundaries, strict=True):
            np.testing.assert_array_equal(bt, bj)
    pairs = [(getattr(jprob, f), getattr(pt, f)) for f in ("dx", "dy", "lap")]
    pairs += list(zip(jprob.hierarchy.restrict + jprob.hierarchy.prolong,
                      pt.hierarchy.restrict + pt.hierarchy.prolong, strict=True))
    for ej, et in pairs:
        np.testing.assert_array_equal(et.lcols.numpy(), np.asarray(ej.lcols))
        np.testing.assert_array_equal(et.win_start.numpy(), np.asarray(ej.win_start))
        assert (et.nrows, et.ncols, et.width) == (ej.nrows, ej.ncols, ej.width)
        assert _rel(ej.vals, et.vals.numpy()) < REL
    # base-degree transfers: restriction at the fine degree, prolongation at
    # the coarse one, so their stencils differ in width
    assert pt.hierarchy.restrict[0].width != pt.hierarchy.prolong[0].width
    for f in ("bmask", "u_bc", "v_bc", "normals"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(jprob, f)))
    np.testing.assert_array_equal(pt.hierarchy.finest.row_map.numpy(),
                                  np.asarray(jprob.hierarchy.finest.row_map))
    assert pt.hierarchy.finest.bound.nrows == jprob.hierarchy.finest.bound.nrows > 0


def test_compact_rows_ppe2_matches_spmv_tpu2_scatter(jprob, gfs):
    top = tb.tpu_level_from_operator(jprob.hierarchy.finest)
    C = gfs.ppe32
    assert C.role == "ppe2" and C.vals is gfs.hd.levels[-1].bound.vals  # shared
    rng = np.random.default_rng(51)
    x = rng.standard_normal(C.n_pad).astype(np.float32)
    y = rng.standard_normal(C.n_pad).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yb = spmv_tpu2(top.bound_kell, jnp.asarray(x))[: top.bound_rows.shape[0]]
        ref = np.asarray(jnp.asarray(y).at[top.bound_rows].set(yb, mode="drop"))
    before = gk.COUNTS["ppe2"]
    out = gk.compact_rows(C, torch.from_numpy(x), torch.from_numpy(y.copy())).numpy()
    assert gk.COUNTS["ppe2"] == before  # plain version: no launch counted
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4 * np.abs(ref).max())
    moved = np.nonzero(out != y)[0]
    assert set(moved) <= set(C.rows[: C.nrows].tolist())
    assert moved.size > 0.9 * C.nrows


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_compatible_matvec_matches_reference(jprob, gfs, dtype):
    mv_j = jfs.make_compatible_matvec(jprob)
    rng = np.random.default_rng(52)
    n_pad = gfs.n_pad
    x = rng.standard_normal(n_pad)
    xl = 0.3
    yj, ylj = (np.asarray(a) for a in mv_j(jnp.asarray(x), jnp.asarray(xl)))
    if dtype == "f64":
        y, yl = fg._mv64(gfs)(torch.from_numpy(x), torch.tensor(xl, dtype=torch.float64))
        assert y.dtype == torch.float64
        assert _rel(yj, y.numpy()) < REL and abs(float(yl) - ylj) <= REL * abs(ylj)
    else:
        y, yl = fg._mv32(gfs)(torch.from_numpy(x).float(), torch.tensor(xl))
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), yj, rtol=0, atol=2e-4 * np.abs(yj).max())
        assert abs(float(yl) - ylj) <= 2e-4 * abs(ylj)


def _identity_op(tprob):
    return tprob.hierarchy.finest, (lambda x, xl: (x, xl))


@pytest.mark.parametrize("ratios,kw,passes", [
    ([0.5, 0.1, 0.75, 0.5], {}, 3),          # a pass at >= 0.7x stops the loop
    ([0.5] * 10, dict(max_outer=4), 4),       # the pass cap
    ([1e-3] * 10, dict(tol=1e-7), 3),         # the tolerance
    ([1.5, 0.5], {}, 1),                      # a worse pass is kept, then stop
])
def test_solve_mixed_stopping_rule(tprob, monkeypatch, ratios, kw, passes):
    """With an identity outer operator and an inner solve that returns
    (1 - ratio) r, each pass multiplies the residual by ``ratio``."""
    op, ident = _identity_op(tprob)
    seq = iter(ratios)

    def inner(hier, r, rl, inner_tol, inner_iters, matvec32):
        c = 1.0 - next(seq)
        return c * r, c * rl, 7, 0.5

    monkeypatch.setattr(mixed, "_inner", inner)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(op.n_pad))
    log = []
    x, xl, it, res = mixed.solve_mixed(
        op, None, torch.zeros_like(b), 0.0, b, 0.0, matvec64=ident,
        matvec32=None, passes=log, **kw)
    assert it == passes == len(log)
    assert res == pytest.approx(float(np.prod(ratios[:passes])), rel=1e-9)
    for k, (its, inner_res, outer_res) in enumerate(log):
        assert (its, inner_res) == (7, 0.5)
        assert outer_res == pytest.approx(float(np.prod(ratios[:k + 1])), rel=1e-9)


def test_f64_timestep_matches_reference(jprob, tprob):
    """u, v and u_hat to 1e-10.  The pressure and fs_residual to 1e-6
    only: in both packages the f64 compatible BiCGStab stops at its
    60-iteration cap near 5e-8 relative residual, so the two iterates
    differ by round-off that 60 iterations amplify (measured: p 1e-8 after
    the solve, ~1e-7 after the step; fs_residual 3e-8).  fs_residual is
    |dt/rho Dx p| summed, so it carries p's gap; u and v see it scaled by
    dt/rho against values of order 1."""
    sj = jfs.prescribe_solution(jprob, jprob.state0)
    st = tfs.prescribe_solution(tprob, tprob.state0)
    for i in range(3):
        sj, rj = jfs.timestep(jprob, sj, ppe_solver="bicgstab")
        st, rt = tfs.timestep(tprob, st, ppe_solver="bicgstab")
        for f in ("u", "v", "u_hat"):
            assert _rel(getattr(sj, f), getattr(st, f).numpy()) < 1e-10, (i, f)
        assert _rel(sj.mg.x[-1], st.mg.x[-1].numpy()) < PPE_REL, (i, "p")
        assert abs(float(rt) - float(rj)) <= PPE_REL * float(rj), i


@pytest.mark.parametrize("ppe_solver", ["bicgstab", "vcycle"])
def test_reference_ppe_run_matches_reference(jprob, tprob, ppe_solver):
    """The reference-PPE mode (assembled Laplacian, the source's
    condensation pushdown) of the f64 oracle, through ``run``: one step
    from rest, then the u-L1 error against Kovasznay."""
    jp = dataclasses.replace(jprob, compatible_ppe=False)
    tp = dataclasses.replace(tprob, compatible_ppe=False)
    sj, hj, ej = jfs.run(jp, steps=1, ppe_solver=ppe_solver)
    st, ht, et = tfs.run(tp, steps=1, ppe_solver=ppe_solver)
    for f in ("u", "v"):
        assert _rel(getattr(sj, f), getattr(st, f).numpy()) < 1e-10, f
    assert _rel(sj.mg.x[-1], st.mg.x[-1].numpy()) < PPE_REL
    assert abs(ht[0] - hj[0]) <= PPE_REL * hj[0]
    assert abs(et - ej) <= 1e-10 * ej


def test_implicit_predictor_matches_reference(jprob, tprob, gfs):
    """Backward-Euler diffusion: the f64 predictor (bicgstab_matfree to
    1e-12) against the reference's to 1e-10; the device predictor (f32, to
    1e-6) within the f32 budget, 2e-4 of max |u|."""
    cfg = dict(diffusion="implicit")
    jp = dataclasses.replace(jprob, config=dataclasses.replace(jprob.config, **cfg))
    tp = dataclasses.replace(tprob, config=dataclasses.replace(tprob.config, **cfg))
    sj = jfs.prescribe_solution(jp, jp.state0)
    st = tfs.prescribe_solution(tp, tp.state0)
    uj, vj = (np.asarray(a) for a in jfs.predictor(jp, sj.u, sj.v))
    ut, vt = tfs.predictor(tp, st.u, st.v)
    assert _rel(uj, ut.numpy()) < 1e-10 and _rel(vj, vt.numpy()) < 1e-10
    g = dataclasses.replace(gfs, config=tp.config)
    u32, v32 = fg._predictor32(g, st.u, st.v)
    assert u32.dtype == torch.float64  # f32 arithmetic, returned as f64
    scale = np.abs(uj).max()
    assert np.abs(u32.numpy() - uj).max() / scale < 2e-4
    assert np.abs(v32.numpy() - vj).max() / scale < 2e-4
    # the explicit predictor differs: the implicit branch really ran
    ue, _ = tfs.predictor(tprob, st.u, st.v)
    assert _rel(ue.numpy(), ut.numpy()) > 1e-9


def test_hyperviscous_predictor_matches_reference(jprob, tprob):
    """Hyperviscosity on: the build's power-iteration estimate of the
    velocity Laplacian's spectral radius, then the explicit f64 predictor
    with the -hv nu Lap(Lap u) / lap_scale term, both against the
    reference's to 1e-10."""
    hv = 0.5
    jh = jfs.build_fracstep_problem(sizes=SIZES, poly_deg=DEG,
                                    config=JConfig(hyperviscosity=hv))
    th = tfs.build_fracstep_problem(sizes=SIZES, poly_deg=DEG,
                                    config=FracStepConfig(hyperviscosity=hv))
    assert jprob.lap_scale == tprob.lap_scale == 1.0  # off: not estimated
    assert th.lap_scale > 1.0
    assert th.lap_scale == pytest.approx(jh.lap_scale, rel=1e-12)
    tp = dataclasses.replace(tprob, config=th.config, lap_scale=th.lap_scale)
    sj = jfs.prescribe_solution(jh, jh.state0)
    st = tfs.prescribe_solution(tp, tp.state0)
    uj, vj = (np.asarray(a) for a in jfs.predictor(jh, sj.u, sj.v))
    ut, vt = tfs.predictor(tp, st.u, st.v)
    assert _rel(uj, ut.numpy()) < 1e-10 and _rel(vj, vt.numpy()) < 1e-10
    # without the term the predictor differs: the hyperviscous branch ran
    ue, _ = tfs.predictor(tprob, st.u, st.v)
    assert _rel(ue.numpy(), ut.numpy()) > 1e-9


def test_timestep_gpu_on_cpu_matches_reference_oracle(jprob, gfs):
    """The device flow (plain kernel versions) against the reference's f64
    oracle, with the reference's budget for its device path."""
    sj = jfs.prescribe_solution(jprob, jprob.state0)
    st = interop.fracstep_state_from_numpy(_numpy_tree(sj))
    for i in range(3):
        stats = {}
        sj, rj = jfs.timestep(jprob, sj, ppe_solver="bicgstab")
        st, rt = fg.timestep_gpu(gfs, st, stats)
        scale = np.abs(np.asarray(sj.u)).max()
        assert np.abs(st.u.numpy() - np.asarray(sj.u)).max() / scale < 2e-4, i
        assert np.abs(st.v.numpy() - np.asarray(sj.v)).max() / scale < 2e-4, i
        assert float(rt) == pytest.approx(float(rj), rel=2e-2, abs=1e-8), i
        assert stats["ppe_residual"] < 1e-10 and stats["ppe_outer"] >= 1
        assert len(stats["ppe_passes"]) == stats["ppe_outer"]
        assert stats["ppe_passes"][-1][2] == stats["ppe_residual"]
    assert st.u.dtype == torch.float64 and st.mg.x[-1].dtype == torch.float64


def test_cli_ns_cpu_matches_reference_record(tmp_path):
    from meshlessmultigridpoisson_tpu.apps import cli as jcli

    from meshlessmultigridpoisson_torch.apps import cli

    steps = 5
    out = tmp_path / "ref.json"
    jcli._ns(argparse.Namespace(
        sizes=SIZES, deg=DEG, steps=steps, dt=2e-4, mu=0.025, rho=1.0,
        ppe_tol=1e-10, reference_ppe=False, implicit_diffusion=False,
        p_relax=0.7, msh=None, out=str(out), platform="cpu"))
    rj = json.loads(out.read_text())
    rec, prob, last = cli.run_ns(
        ["ns", "--device", "cpu", "--sizes", *map(str, SIZES), "--deg", str(DEG),
         "--steps", str(steps)])
    assert rec.config["sizes"] == rj["config"]["sizes"] == [188, 598]
    assert rec.cycles == rj["cycles"] == steps
    assert rec.extra["level_kernels"] == ["v7-exact", "v7-exact"]
    assert len(rec.residual_history) == len(rj["residual_history"]) == steps
    np.testing.assert_allclose(rec.residual_history, rj["residual_history"], rtol=2e-2)
    assert rec.l1_error == pytest.approx(rj["l1_error"], rel=1e-3)
    assert all(r < 1e-10 for r in rec.extra["ppe_residual"])
    assert len(rec.extra["ppe_outer"]) == len(rec.extra["step_time_s"]) == steps
    assert all(v == 0 for v in rec.extra["launches"].values())  # CPU: no kernel

    # the smoke test's independent re-check of the last PPE solve
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    recheck = chip_smoke.compatible_residual(prob, last["b"], last["x"], last["x_lag"])
    assert recheck < 1e-9, recheck
    assert chip_smoke.compatible_residual(prob, last["b"], last["x"],
                                          last["x_lag"] + 1e-3) > 10 * recheck


def test_cli_ns_refuses_reference_ppe():
    from meshlessmultigridpoisson_torch.apps import cli

    with pytest.raises(NotImplementedError, match="reference-ppe"):
        cli.run_ns(["ns", "--device", "cpu", "--reference-ppe"])


def test_cli_ns_cuda_without_card_refuses(monkeypatch):
    from meshlessmultigridpoisson_torch.apps import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="refusing"):
        cli.run_ns(["ns", "--device", "cuda", "--sizes", "170", "600", "--deg", "4"])


def test_build_guards(tprob):
    with pytest.raises(NotImplementedError):
        fg.build_gpu_fracstep(dataclasses.replace(tprob, compatible_ppe=False), "cpu")
    hv = dataclasses.replace(tprob, config=dataclasses.replace(
        tprob.config, hyperviscosity=1.0))
    with pytest.raises(NotImplementedError):
        fg.build_gpu_fracstep(hv, "cpu")


@pytest.mark.parametrize("name", ["square_170.msh", "square_600.msh"])
def test_msh_matches_reference(name):
    path = os.path.join(FIX, name)
    np.testing.assert_array_equal(tmsh.read_msh_points(path), jmsh.read_msh_points(path))
    np.testing.assert_array_equal(tmsh.read_msh_boundary_edges(path),
                                  jmsh.read_msh_boundary_edges(path))
    ct = tmsh.pointcloud_from_msh(path, geomtype="square")
    cj = jmsh.pointcloud_from_msh(path, geomtype="square")
    np.testing.assert_array_equal(ct.points, cj.points)
    np.testing.assert_array_equal(ct.normals, cj.normals)
    assert ct.geomtype == cj.geomtype == "square"
    assert len(ct.boundaries) == len(cj.boundaries) == 1
    np.testing.assert_array_equal(ct.boundaries[0], cj.boundaries[0])
