"""The stale-program sweep (``gpu_kernels.stale_sweep``: role
``sweep7_stale``, ``csrc/storage_chain.cu``'s cluster kernel, and its first
design, the timing role ``sweep7_stale_walk``, the mode kStale) held
against the reference package on the CPU.

* f32: the reference's ``kernels6.sor_sweep_tpu7(..., stale_program=True)``
  in TPU interpret mode against the port's plain version, on the pattern
  and K of ``tests/test_kernels6.py`` (1,296 rows, 11 blocks: a last group
  of 3), on the single-segment layout and on three segments, within 2e-4
  of max |x| (the reference's f32 kernels' tolerance);
* f64: the plain version against ``scripts/rho_stale.py``'s numpy
  ``_sweep_oneshot`` (groups of 1,024 rows), to 1e-12 of max |x|;
* the wrapper refuses an order that is not storage order from a multiple
  of 8 and a role that is not a stale one, the plain version differs from
  the exact sweep, the block-sweep entry refuses both roles, and the sweep
  probe's ``probe_hoist`` computes the same function.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.spatial import cKDTree

from meshlessmultigridpoisson_tpu.ops import kernels6 as K6
from meshlessmultigridpoisson_tpu.ops.ell import ell_from_csr as jell_from_csr
from meshlessmultigridpoisson_tpu.ops.kernels4 import build_oneshot_K

from meshlessmultigridpoisson_torch.geometry.ordering import kd_tile_ordering
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.ops.ell import ell_from_csr as tell_from_csr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-4  # of max |x|
F64_TOL = 1e-12


@pytest.fixture(scope="module")
def pattern():
    """tests/test_kernels6.py's pattern: 36 x 36 jittered points, kd-tile
    order, 28 neighbours, a dominant diagonal."""
    n_side, k = 36, 28
    rng = np.random.default_rng(3)
    xy = np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij"),
                  -1).reshape(-1, 2).astype(np.float64)
    xy += rng.uniform(-0.3, 0.3, xy.shape)
    xy = xy[kd_tile_ordering(xy, leaf=128)]
    nbr = cKDTree(xy).query(xy, k=k)[1]
    n = xy.shape[0]
    vals = rng.standard_normal((n, k))
    vals[:, 0] = k + 1.0
    a = sp.coo_matrix((vals.ravel(), (np.repeat(np.arange(n), k), nbr.ravel())),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    ell = jell_from_csr(a, block_rows=128)
    smask = np.ones(ell.nrows_pad)
    smask[: ell.nrows // 7] = 0.0  # some rows the smoother never moves
    kinvT = build_oneshot_K(ell, np.full(ell.nrows_pad, 1.4), smask)
    rng = np.random.default_rng(17)
    nb = ell.nrows_pad // 128
    inp = dict(x=rng.standard_normal(nb * 128), b=rng.standard_normal(nb * 128),
               lagc=0.01 * rng.standard_normal(nb * 128), xl=0.37)
    return a, ell, kinvT, inp


def _sweep(a, kinvT, inp, dtype, role="sweep6"):
    """The port's storage-order BlockSweep on the same matrix and K (CPU)."""
    A = gk.device_ell(tell_from_csr(a, block_rows=128), dtype, "cpu", "spmv6")
    nb = A.nrows_pad // 128
    return gk.BlockSweep(A=A, kT=torch.from_numpy(kinvT).to(dtype),
                         lagc=torch.from_numpy(inp["lagc"]).to(dtype),
                         order=torch.arange(nb, dtype=torch.int32), phase_ptr=(0, nb),
                         serial=True, role=role)


def _stale(sw, inp, dtype):
    x = torch.from_numpy(inp["x"]).to(dtype)
    return gk.stale_sweep(gk.stale_sweep_of(sw), x, torch.tensor(inp["xl"], dtype=dtype),
                          torch.from_numpy(inp["b"]).to(dtype)).numpy()


@pytest.mark.parametrize("segments", [1, 3])
def test_plain_matches_the_reference_stale_kernel(pattern, segments):
    a, ell, kinvT, inp = pattern
    kell = K6.prepare_kernel_ell6(ell, max_segments=segments)
    assert kell.nblocks == 11 and kell.nblocks % K6.MB == 3  # a partial last group
    nb = kell.nblocks
    f32 = lambda v: jnp.asarray(np.asarray(v).reshape(nb, 128), jnp.float32)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(K6.sor_sweep_tpu7(
            kell, K6.union_sweep_tables(kell), K6.pack_oneshot_K6(kell, kinvT),
            f32(inp["x"]), jnp.asarray(inp["xl"], jnp.float32), f32(inp["b"]),
            f32(inp["lagc"]), stale_program=True)).reshape(-1)
    sw = _sweep(a, kinvT, inp, torch.float32)
    out = _stale(sw, inp, torch.float32)
    assert np.abs(out - ref).max() <= F32_TOL * np.abs(ref).max()
    # it is not the exact sweep: later blocks of a group read stale rows
    exact = gk.block_oneshot_sweep_plain(
        sw, torch.from_numpy(inp["x"]).float(), torch.tensor(inp["xl"]),
        torch.from_numpy(inp["b"]).float()).numpy()
    assert np.abs(exact - ref).max() > 30 * F32_TOL * np.abs(ref).max()


def test_f64_plain_matches_rho_stale_numpy_sweep(pattern):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import rho_stale

    a, ell, kinvT, inp = pattern
    n_pad = ell.nrows_pad
    A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(a.shape[0], n_pad))
    A = sp.vstack([A, sp.csr_matrix((n_pad - a.shape[0], n_pad))]).tocsr()
    ref = rho_stale._sweep_oneshot(A, kinvT, inp["x"].copy(), inp["xl"], inp["b"],
                                   inp["lagc"], rho_stale.MBROWS)
    out = _stale(_sweep(a, kinvT, inp, torch.float64), inp, torch.float64)
    assert np.abs(out - ref).max() <= F64_TOL * np.abs(ref).max()


def test_the_wrapper_refuses_other_orders_and_roles(pattern):
    a, _, kinvT, inp = pattern
    sw = _sweep(a, kinvT, inp, torch.float64)
    nb = sw.order.shape[0]
    x, b = torch.from_numpy(inp["x"]), torch.from_numpy(inp["b"])
    for bad in (dataclasses.replace(sw, order=sw.order.flip(0)),
                dataclasses.replace(sw, order=sw.order[4:], phase_ptr=(0, nb - 4)),
                dataclasses.replace(sw, serial=False, phase_ptr=(0, 5, nb))):
        with pytest.raises(ValueError, match="storage-order"):
            gk.stale_sweep_of(bad)
    # a run of whole groups from a multiple of 8 is taken
    tail = gk.stale_sweep_of(dataclasses.replace(sw, order=sw.order[8:],
                                                 phase_ptr=(0, nb - 8)))
    assert tail.role == gk.STALE_ROLE
    with pytest.raises(ValueError, match="stale_sweep_of"):
        gk.stale_sweep(sw, x.clone(), 0.0, b)
    with pytest.raises(ValueError, match="stale_sweep runs it"):
        gk.block_oneshot_sweep(gk.stale_sweep_of(sw), x.clone(), 0.0, b)
    with pytest.raises(ValueError, match="stale_sweep runs it"):
        gk.block_oneshot_sweep(gk.stale_sweep_of(sw, gk.STALE_WALK), x.clone(), 0.0, b)
    with pytest.raises(ValueError, match="role"):
        gk.stale_sweep_of(sw, "sweep6")


def test_probe_hoist_is_the_stale_sweep(pattern):
    a, _, kinvT, inp = pattern
    sw = _sweep(a, kinvT, inp, torch.float32, role="probe_hoist")
    hoist = gk.sweep_probe(sw, torch.from_numpy(inp["x"]).float(), torch.tensor(inp["xl"]),
                           torch.from_numpy(inp["b"]).float()).numpy()
    stale = _stale(dataclasses.replace(sw, role="sweep6"), inp, torch.float32)
    assert np.array_equal(hoist, stale)
