"""Host setup of the port held against the reference package, on the CPU.

Same seeds, same inputs, both packages: clouds, kNN tables, orderings and
colorings must be IDENTICAL; RBF-FD weights, every LevelOperator array and
every transfer operator must agree to 1e-12 relative (max abs difference
over max abs value).  Measured on these fixtures: <= ~7e-14 — both sides
solve the same f64 saddle systems with LAPACK LU, and the remaining gap is
the order of the RHS/monomial arithmetic amplified by the systems'
conditioning.
"""

import dataclasses

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from meshlessmultigridpoisson_tpu.geometry import coloring as jcol
from meshlessmultigridpoisson_tpu.geometry import neighbors as jnb
from meshlessmultigridpoisson_tpu.geometry import ordering as jord
from meshlessmultigridpoisson_tpu.geometry import pointclouds as jpc
from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake
from meshlessmultigridpoisson_tpu.stencil.phs import batched_weights as jweights
from meshlessmultigridpoisson_tpu.utils.jaxutils import on_cpu

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.geometry import coloring as tcol
from meshlessmultigridpoisson_torch.geometry import neighbors as tnb
from meshlessmultigridpoisson_torch.geometry import ordering as tord
from meshlessmultigridpoisson_torch.geometry import pointclouds as tpc
from meshlessmultigridpoisson_torch.mg.setup import order_cloud
from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem as tmake
from meshlessmultigridpoisson_torch.stencil.phs import batched_weights as tweights

# the test workers share the host's cores with the JAX test files: one
# intra-op thread per process keeps torch's thread pool from contending
torch.set_num_threads(1)

REL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _numpy_tree(obj):
    """A reference dataclass tree -> nested dicts of numpy arrays."""
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


@pytest.mark.parametrize("geom", ["square", "square_with_circle", "concentric_circles"])
def test_clouds_identical(geom):
    cj, ct = jpc.make_cloud(geom, 400, seed=3), tpc.make_cloud(geom, 400, seed=3)
    np.testing.assert_array_equal(ct.points, cj.points)
    np.testing.assert_array_equal(ct.normals, cj.normals)
    assert len(ct.boundaries) == len(cj.boundaries)
    for bt, bj in zip(ct.boundaries, cj.boundaries):
        np.testing.assert_array_equal(bt, bj)


def test_knn_orderings_colorings_identical():
    cloud = jpc.make_cloud("square_with_circle", 700, seed=1)
    pts, bmask = cloud.points, cloud.boundary_mask
    for neumann in (False, True):
        np.testing.assert_array_equal(
            tnb.knn(pts, 15, boundary_mask=bmask, neumann=neumann),
            jnb.knn(pts, 15, boundary_mask=bmask, neumann=neumann))
    np.testing.assert_array_equal(tnb.knn_queries(pts, pts[::3] + 1e-3, 10),
                                  jnb.knn_queries(pts, pts[::3] + 1e-3, 10))
    nbr = jnb.knn(pts, 15)
    np.testing.assert_array_equal(tord.kd_tile_ordering(pts), jord.kd_tile_ordering(pts))
    np.testing.assert_array_equal(tord.rcm_ordering(nbr), jord.rcm_ordering(nbr))
    rows = np.repeat(np.arange(pts.shape[0]), 15)
    a = sp.coo_matrix((np.ones(rows.size), (rows, nbr.ravel())),
                      shape=(pts.shape[0],) * 2).tocsr()
    n_pad = -(-pts.shape[0] // 256) * 256
    a = sp.block_diag([a, sp.identity(n_pad - pts.shape[0])], format="csr")
    pt, ct = tcol.block_class_permutation(a, 256, 8)
    pj, cj = jcol.block_class_permutation(a, 256, 8)
    np.testing.assert_array_equal(pt, pj)
    assert ct == cj


def test_unknown_ordering_raises():
    cloud = tpc.make_cloud("square", 200, seed=0)
    with pytest.raises(ValueError, match="unknown ordering"):
        order_cloud(cloud, 15, False, method="kd-tile")


@pytest.mark.parametrize("op", ["laplace", "dx", "dy", "interp"])
def test_batched_weights_match(op):
    cloud = jpc.make_cloud("square_with_circle", 400, seed=2)
    pts = cloud.points
    nbr = jnb.knn(pts, 37)  # deg 4: k = 2.5 * 15
    ev = pts + (1e-2 if op == "interp" else 0.0)
    wt = tweights(pts, nbr, ev, op=op, poly_deg=4).numpy()
    with on_cpu():
        wj = np.asarray(jweights(jax.numpy.asarray(pts), jax.numpy.asarray(nbr),
                                 jax.numpy.asarray(ev), op=op, poly_deg=4))
    assert _rel(wj, wt) < REL


def _ell_fields_match(ej, et):
    np.testing.assert_array_equal(et.lcols.numpy(), np.asarray(ej.lcols))
    np.testing.assert_array_equal(et.win_start.numpy(), np.asarray(ej.win_start))
    assert (et.nrows, et.ncols, et.block_rows, et.win_size) == (
        ej.nrows, ej.ncols, ej.block_rows, ej.win_size)
    assert _rel(ej.vals, et.vals.numpy()) < REL
    assert _rel(ej.diag, et.diag.numpy()) < REL


@pytest.mark.parametrize("neumann", [False, True], ids=["dirichlet", "neumann"])
def test_level_and_transfer_operators_match(neumann):
    kw = dict(sizes=[200, 500], poly_deg=4, neumann=neumann,
              ordering="kdtile", block_rows=128)
    pj = jmake("square_with_circle", **kw)
    pt = tmake("square_with_circle", **kw)
    for lj, lt in zip(pj.hierarchy.levels, pt.hierarchy.levels):
        _ell_fields_match(lj.A, lt.A)
        for name in ("bound", "cond"):
            cj, ct = getattr(lj, name), getattr(lt, name)
            assert ct.nrows == cj.nrows
            np.testing.assert_array_equal(ct.rows.numpy(), np.asarray(cj.rows))
            _ell_fields_match(cj.ell, ct.ell)
        for name in ("lag_col", "lag_row", "omega_scale", "smooth_mask",
                     "dirichlet_mask", "neumann_mask", "dirichlet_values",
                     "neumann_values"):
            a, b = np.asarray(getattr(lj, name)), getattr(lt, name).numpy()
            assert np.abs(a - b).max() <= REL * max(np.abs(a).max(), 1.0), name
        np.testing.assert_array_equal(lt.row_map.numpy(), np.asarray(lj.row_map))
        assert (lt.has_lagrange, lt.implicit, lt.omega, lt.iters, lt.class_size,
                lt.n) == (lj.has_lagrange, lj.implicit, lj.omega, lj.iters,
                          lj.class_size, lj.n)
    for ej, et in zip(pj.hierarchy.restrict + pj.hierarchy.prolong,
                      pt.hierarchy.restrict + pt.hierarchy.prolong):
        _ell_fields_match(ej, et)
    assert _rel(pj.state0.b[-1], pt.state0.b[-1].numpy()) < REL
    np.testing.assert_array_equal(pt.exact, pj.exact)


def test_ell_csr_round_trip_matches_reference():
    from meshlessmultigridpoisson_tpu.ops.ell import ell_from_csr as jfrom
    from meshlessmultigridpoisson_tpu.ops.ell import ell_to_csr as jto
    from meshlessmultigridpoisson_torch.ops.ell import ell_from_csr, ell_to_csr

    rng = np.random.default_rng(4)
    a = sp.random(300, 420, density=0.03, random_state=rng, format="csr")
    for kw in ({}, dict(block_rows=128, width=40, ncols=420)):
        back = ell_to_csr(ell_from_csr(a, **kw))
        assert back.shape == a.shape and (back != a).nnz == 0
        assert (back != jto(jfrom(a, **kw))).nnz == 0


def test_hierarchy_from_numpy_round_trip():
    pj = jmake("square", sizes=[170, 600], poly_deg=3, neumann=True)
    tree = _numpy_tree(pj.hierarchy)
    hier = interop.hierarchy_from_numpy(tree)
    for lj, lt in zip(pj.hierarchy.levels, hier.levels):
        np.testing.assert_array_equal(lt.A.vals.numpy(), np.asarray(lj.A.vals))
        np.testing.assert_array_equal(lt.cond.ell.vals.numpy(), np.asarray(lj.cond.ell.vals))
        np.testing.assert_array_equal(lt.omega_scale.numpy(), np.asarray(lj.omega_scale))
        assert lt.bound.nrows == lj.bound.nrows and lt.has_lagrange
    back = interop.hierarchy_to_numpy(hier)
    again = interop.hierarchy_from_numpy(back)
    flat_a = jax.tree_util.tree_leaves(back)
    flat_b = jax.tree_util.tree_leaves(interop.hierarchy_to_numpy(again))
    assert len(flat_a) == len(flat_b) == len(jax.tree_util.tree_leaves(tree))
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    st = interop.state_from_numpy(_numpy_tree(pj.state0))
    for a, b in zip(st.b, pj.state0.b):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    st2 = interop.state_from_numpy(interop.state_to_numpy(st))
    for a, b in zip(st2.x, st.x):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
