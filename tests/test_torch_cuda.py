"""CUDA kernels of the port vs their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False (decided per test at setup time,
never at import).  The module imports no JAX, so on a machine with a card
and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Fixture: the ``tests/test_kernels8.py`` pattern (36x36 jittered grid,
k = 28, kd-tile ordered, non-symmetric values).  Tolerances, relative to
max |plain output|: f32 1e-5 for the SpMV (another summation order over
~28 products), 1e-4 for a sweep (the 128-term K product on top); f64
1e-12 / 1e-11 for the same reorderings in double.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from meshlessmultigridpoisson_torch.geometry.ordering import kd_tile_ordering
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU (CUDA kernels have no CPU mode)"),
]


@pytest.fixture(scope="module")
def et():
    from scipy.spatial import cKDTree

    n_side, k = 36, 28
    rng = np.random.default_rng(3)
    xy = np.stack(
        np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij"), -1
    ).reshape(-1, 2).astype(np.float64)
    xy += rng.uniform(-0.3, 0.3, xy.shape)
    xy = xy[kd_tile_ordering(xy, leaf=128)]
    nbr = cKDTree(xy).query(xy, k=k)[1]
    n = xy.shape[0]
    vals = rng.standard_normal((n, k))
    vals[:, 0] = k + 1.0
    rows = np.repeat(np.arange(n), k)
    a = sp.coo_matrix((vals.ravel(), (rows, nbr.ravel())), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return tell.ell_from_csr(a, block_rows=128)


def _rand(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, dtype=torch.float64, generator=g).to("cuda", dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_ell_spmv_matches_plain(et, dtype, tol):
    A = gk.device_ell(et, dtype, "cuda", "spmv6")
    x = _rand(et.ncols, dtype, 0)
    before = gk.COUNTS["spmv6"]
    y = gk.ell_spmv(A, x)
    torch.cuda.synchronize()
    assert gk.COUNTS["spmv6"] == before + 1
    yp = gk.ell_spmv_plain(A.vals, A.cols, x)
    assert float((y - yp).abs().max()) <= tol * float(yp.abs().max())


@pytest.mark.parametrize("serial", [False, True], ids=["colored", "storage"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
def test_block_sweep_matches_plain(et, serial, dtype, tol):
    n_pad = et.nrows_pad
    nb = n_pad // 128
    omega = np.full(n_pad, 1.4)
    omega[::5] = 1.0
    smask = np.ones(n_pad)
    smask[: n_pad // 7] = 0.0
    kT = gk.build_oneshot_K(et, omega, smask)
    if serial:
        order, ptr = np.arange(nb), (0, nb)
    else:
        colors = gk.color_blocks(gk.block_patches(tell.global_cols(et).numpy(), nb), nb)
        order, ptr = gk.colored_order(colors)
    sw = gk.BlockSweep(
        A=gk.device_ell(et, dtype, "cuda", "spmv6"),
        kT=torch.from_numpy(kT).to("cuda", dtype),
        lagc=torch.full((n_pad,), 0.01, dtype=dtype, device="cuda"),
        order=torch.from_numpy(order.astype(np.int32)).cuda(), phase_ptr=ptr,
        serial=serial, role="sweep7" if serial else "sweep8")
    x, b = _rand(n_pad, dtype, 1), _rand(n_pad, dtype, 2)
    xl = torch.tensor(0.3, dtype=dtype, device="cuda")
    before = gk.COUNTS[sw.role]
    out = gk.block_oneshot_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    assert gk.COUNTS[sw.role] == before + sw.nphases
    ref = gk.block_oneshot_sweep_plain(sw, x.clone(), xl, b)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    moved = (out - x).abs()[: n_pad // 7]
    assert float(moved.max()) == 0.0  # zero K rows never move


def test_wrapper_refuses_wrong_dtype(et):
    A = gk.device_ell(et, torch.float32, "cuda", "spmv6")
    with pytest.raises(ValueError):
        gk.ell_spmv(A, _rand(et.ncols, torch.float64, 0))


def test_cli_solve_on_card_runs_every_kernel():
    """The slice's flow at a small ladder: the CLI on the card reaches its
    tolerance and launches all four kernel roles."""
    from meshlessmultigridpoisson_torch.apps import cli

    rec, _, _ = cli.run_solve([
        "solve", "--device", "cuda", "--geom", "square_with_circle",
        "--sizes", "600", "2500", "5000", "--deg", "4", "--ordering", "kdtile",
        "--block-rows", "512", "--tol", "1e-10"])
    assert rec.final_residual < 1e-10
    assert rec.extra["level_kernels"] == ["v7-exact", "v7-exact", "v8-colored"]
    assert all(n > 0 for n in rec.extra["launches"].values()), rec.extra["launches"]
