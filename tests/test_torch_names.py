"""The reference package's public names the port mirrors in the modules of
the same names, each against the reference's on the same inputs:
``geometry.ordering.sfc_ordering`` and ``tile_window_ordering``,
``stencil.phs.shift_scale``, ``config.reference_mg_config`` and
``reference_fracstep_config``, ``geometry.native.available`` and
``knn_native`` (through the port's own ``build/libfastgeom.so``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from meshlessmultigridpoisson_tpu import config as jconfig
from meshlessmultigridpoisson_tpu.geometry import native as jnative
from meshlessmultigridpoisson_tpu.geometry import ordering as jordering
from meshlessmultigridpoisson_tpu.stencil import phs as jphs

from meshlessmultigridpoisson_torch import config as tconfig
from meshlessmultigridpoisson_torch.geometry import native as tnative
from meshlessmultigridpoisson_torch.geometry import ordering as tordering
from meshlessmultigridpoisson_torch.stencil import phs as tphs
from test_torch_native import ensure_native_geometry


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.0, 1.0, (700, 2))
    return pts, cKDTree(pts).query(pts, k=12)[1].astype(np.int32)


@pytest.mark.parametrize("dim", [2, 3])
def test_sfc_ordering(dim):
    pts = np.random.default_rng(dim).uniform(0.0, 3.0, (900, dim))
    assert np.array_equal(tordering.sfc_ordering(pts), jordering.sfc_ordering(pts))


@pytest.mark.parametrize("prefer", ["rcm", "sfc", "none"])
def test_tile_window_ordering(cloud, prefer):
    pts, nbr = cloud
    got = tordering.tile_window_ordering(pts, nbr, prefer=prefer)
    assert np.array_equal(got, jordering.tile_window_ordering(pts, nbr, prefer=prefer))


def test_shift_scale():
    rng = np.random.default_rng(9)
    for dim in (2, 3):
        pts, ev = rng.uniform(-2.0, 5.0, (20, dim)), rng.uniform(-2.0, 5.0, dim)
        want = jphs.shift_scale(jnp.asarray(pts), jnp.asarray(ev))
        got = tphs.shift_scale(torch.from_numpy(pts), torch.from_numpy(ev))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15, atol=0)


@pytest.mark.parametrize("levels,deg", [(2, 4), (4, 6)])
def test_reference_configs(levels, deg):
    """Every field of the port's dataclasses equal to the reference's of
    the same name (the reference's MultigridConfig also carries ``dtype``
    and ``smoother``, which the port's has not)."""
    def same(got, want):
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert g == {k: w[k] for k in g}

    got, want = tconfig.reference_mg_config(levels, deg), jconfig.reference_mg_config(levels,
                                                                                   deg)
    same(got, want)
    for lv in range(levels):
        same(got.level_config(lv), want.level_config(lv))
    same(tconfig.reference_fracstep_config(), jconfig.reference_fracstep_config())


def test_native_available_and_knn(cloud):
    ensure_native_geometry()
    assert tnative.available() is jnative.available() is True
    pts, _ = cloud
    queries = pts[::7] + 0.01
    mask = np.arange(pts.shape[0]) % 3 != 0
    for cm in (None, mask):
        got = tnative.knn_native(pts, queries, 9, candidate_mask=cm)
        assert got.dtype == np.int32 and got.shape == (queries.shape[0], 9)
        assert np.array_equal(got, jnative.knn_native(pts, queries, 9, candidate_mask=cm))
    assert tnative.knn_native(np.zeros((5, 3)), np.zeros((2, 3)), 2) is None
