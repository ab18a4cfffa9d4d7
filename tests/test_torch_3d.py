"""The 3D path (``box3d``) of the port held against the reference package, on the CPU.

Configuration: the 3D record's settings (``scripts/build3d_cache.py``:
deg 3, kd-tile ordering, 512-row tiles) cut to its first three sizes,
500 / 2,600 / 19,000 (clouds of 729 / 3,375 / 21,952 points; ELL width 25
on the coarse levels, 50 on the finest).  Both packages build the problem
on their native geometry path.

* identical clouds, boundary lists and normals;
* every level operator (matrix, boundary and condensation tables, masks,
  omega scales), restriction and prolongation to 1e-12 relative; the
  transfers' nearest-point injection for non-finite interpolation weights
  (reference ``stencil/operators.py`` ``build_interp_operator``) warns for
  as many rows in both, and on a degenerate (coplanar) 3D neighbourhood
  both inject the same rows;
* the repack's level kinds against the reference's decision for each level
  (``tpu_level_from_operator``, whose colored tier is
  ``prepare_colored_sweep``): ``v7-exact, v7-exact, v8-colored``;
* the port's CPU solve (``cli solve --device cpu``: the kernels' plain
  versions) against the reference's host f64 BiCGStab on the same problem:
  both below the 1e-8 tolerance, L1 errors within 1% of each other.
"""

import warnings

import numpy as np
import pytest
import torch

from meshlessmultigridpoisson_tpu.mg import tpu_backend as tb
from meshlessmultigridpoisson_tpu.mg.krylov import solve_bicgstab as jbicgstab
from meshlessmultigridpoisson_tpu.models import poisson as jpoisson
from meshlessmultigridpoisson_tpu.stencil import operators as jops

from meshlessmultigridpoisson_torch.mg import gpu_backend
from meshlessmultigridpoisson_torch.models import poisson as tpoisson
from meshlessmultigridpoisson_torch.stencil import operators as tops
from test_torch_native import ensure_native_geometry

torch.set_num_threads(1)

SIZES, DEG = [500, 2600, 19000], 3
BUILD = dict(sizes=SIZES, poly_deg=DEG, ordering="kdtile", block_rows=512)
REL = 1e-12
INJECT = "nearest-point injection"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _injections(caught) -> list[str]:
    return sorted(str(w.message) for w in caught if INJECT in str(w.message))


@pytest.fixture(scope="module")
def problems():
    """(reference problem, port problem, the injection warnings of each)."""
    ensure_native_geometry()  # both packages sample their clouds natively
    out = []
    for make in (jpoisson.make_poisson_problem, tpoisson.make_poisson_problem):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out.append((make("box3d", **BUILD), _injections(caught)))
    (pj, wj), (pt, wt) = out
    return pj, pt, wj, wt


def test_box3d_clouds_identical(problems):
    pj, pt, *_ = problems
    assert [c.n for c in pt.clouds] == [c.n for c in pj.clouds] == [729, 3375, 21952]
    for cj, ct in zip(pj.clouds, pt.clouds, strict=True):
        np.testing.assert_array_equal(ct.points, cj.points)
        np.testing.assert_array_equal(ct.normals, cj.normals)
        for bt, bj in zip(ct.boundaries, cj.boundaries, strict=True):
            np.testing.assert_array_equal(bt, bj)


def _ell_fields_match(ej, et):
    np.testing.assert_array_equal(et.lcols.numpy(), np.asarray(ej.lcols))
    np.testing.assert_array_equal(et.win_start.numpy(), np.asarray(ej.win_start))
    assert (et.nrows, et.ncols, et.width, et.block_rows) == (
        ej.nrows, ej.ncols, ej.width, ej.block_rows)
    assert _rel(ej.vals, et.vals.numpy()) < REL


def test_box3d_operators_and_transfers_match(problems):
    pj, pt, wj, wt = problems
    assert [lv.A.width for lv in pt.hierarchy.levels] == [25, 25, 50]
    for lj, lt in zip(pj.hierarchy.levels, pt.hierarchy.levels, strict=True):
        _ell_fields_match(lj.A, lt.A)
        for name in ("bound", "cond"):
            assert getattr(lt, name).nrows == getattr(lj, name).nrows
        for name in ("omega_scale", "smooth_mask", "dirichlet_mask", "dirichlet_values"):
            assert _rel(getattr(lj, name), getattr(lt, name).numpy()) <= REL, name
        np.testing.assert_array_equal(lt.row_map.numpy(), np.asarray(lj.row_map))
    for ej, et in zip(pj.hierarchy.restrict + pj.hierarchy.prolong,
                      pt.hierarchy.restrict + pt.hierarchy.prolong, strict=True):
        _ell_fields_match(ej, et)
    assert _rel(pj.state0.b[-1], pt.state0.b[-1].numpy()) < REL
    np.testing.assert_array_equal(pt.exact, pj.exact)
    assert wt == wj  # as many injected rows, transfer by transfer


def test_box3d_transfer_injection_matches_on_a_degenerate_neighbourhood(monkeypatch):
    """Target points whose 50 nearest base points are coplanar: the 3D
    interpolation system is singular there, and both packages replace
    those rows' weights by injection from the nearest base point.  The
    reference writes into ``np.asarray`` of its JAX weights, which this JAX
    returns read-only (``ValueError``); the test hands it a writable copy
    of the same weights and holds the port against what it then builds."""
    rng = np.random.default_rng(7)
    grid = np.stack(np.meshgrid(*[np.linspace(0, 1, 8)] * 3, indexing="ij"), -1)
    base = np.concatenate([grid.reshape(-1, 3) + rng.uniform(-0.02, 0.02, (512, 3)),
                           np.c_[rng.uniform(3, 4, (120, 2)), np.zeros(120)]])
    target = np.concatenate([rng.uniform(0.2, 0.8, (40, 3)),
                             np.c_[rng.uniform(3.2, 3.8, (8, 2)), np.zeros(8)]])
    with pytest.raises(ValueError, match="read-only"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jops.build_interp_operator(base, target, DEG, block_rows=128)
    weights = jops.batched_weights
    monkeypatch.setattr(jops, "batched_weights", lambda *a, **k: np.array(weights(*a, **k)))
    got = []
    for mod in (jops, tops):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got.append((mod.build_interp_operator(base, target, DEG, block_rows=128),
                        _injections(caught)))
    (ej, wj), (et, wt) = got
    assert wt == wj and len(wt) == 1
    _ell_fields_match(ej, et)
    vals = et.vals.numpy()[:target.shape[0]]
    injected = np.flatnonzero((vals == 1.0).sum(axis=1) == 1)
    assert set(injected) >= set(range(40, 48))
    assert np.all(np.isfinite(vals))


def test_box3d_level_kinds_follow_the_reference(problems):
    pj, pt, *_ = problems
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kinds_j = [tb.tpu_level_from_operator(lj).kernel_kind for lj in pj.hierarchy.levels]
    gh = gpu_backend.gpu_hierarchy(pt.hierarchy, "cpu")
    assert [lv.kernel_kind for lv in gh.levels] == kinds_j == [
        "v7-exact", "v7-exact", "v8-colored"]
    assert [lv.sweep.role for lv in gh.levels] == ["sweep7", "sweep7", "sweep8"]


def test_box3d_cpu_solve_matches_reference_host_solve(problems):
    from meshlessmultigridpoisson_torch.apps import cli

    pj, pt, *_ = problems
    state, _, res_j = jbicgstab(pj.hierarchy, pj.state0, tol=1e-8, max_iters=300)
    l1_j = float(jpoisson.l1_error(pj, state.x[-1]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec, *_ = cli.run_solve(
            ["solve", "--device", "cpu", "--geom", "box3d", "--sizes", *map(str, SIZES),
             "--deg", str(DEG), "--ordering", "kdtile", "--block-rows", "512",
             "--tol", "1e-8"], problem=pt)
    assert float(res_j) < 1e-8 and rec.final_residual < 1e-8
    assert rec.extra["level_kernels"] == ["v7-exact", "v7-exact", "v8-colored"]
    assert rec.config["sizes"] == [729, 3375, 21952]
    # setup split into the host problem (passed in: not built) and the
    # repack; no device peak on the CPU
    assert rec.extra["setup_stages_s"]["host_problem"] < 0.1 * rec.extra["setup_time_s"]
    assert "max_memory_allocated_gb" not in rec.extra
    assert abs(rec.l1_error - l1_j) <= 0.01 * l1_j, (rec.l1_error, l1_j)


def test_solve3d_probe_refuses_without_a_card():
    from meshlessmultigridpoisson_torch.probes import solve3d

    assert solve3d.SIZES == [500, 2600, 19000, 140000, 1060000]
    with pytest.raises(SystemExit, match="card"):
        solve3d.run()
