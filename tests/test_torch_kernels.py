"""Port kernels (ops/gpu_kernels.py) held against the reference TPU kernels.

The CUDA kernels have no interpret mode, so on the CPU their plain PyTorch
versions stand in for them (a wrapper takes the plain version exactly when
handed CPU tensors) and are compared with the reference Pallas kernels run
in interpret mode, on the ``tests/test_kernels8.py`` fixture: a 36x36
jittered grid, k = 28 nearest neighbours, kd-tile ordered — NON-symmetric
values, so a transposed K or a wrong sweep order shows.  Tolerances:

* f32 vs the interpret-mode kernels: 3e-4 scaled by max |output| — the
  reference's own bound for these kernels (VPU reduction tree and
  HIGHEST-precision dots sum in another order than a gather-sum);
* f64 plain sweeps vs the numpy one-shot oracle: 1e-12 (same arithmetic,
  different summation order only).

The kernel-vs-plain cases need a card; they live in ``test_torch_cuda.py``
(which imports no JAX, so it also runs where only PyTorch is installed).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.ops import ell as jell
from meshlessmultigridpoisson_tpu.ops import kernels6 as K6
from meshlessmultigridpoisson_tpu.ops import kernels8 as K8
from meshlessmultigridpoisson_tpu.ops.kernels4 import build_oneshot_K as build_K_ref
from test_kernels8 import _colored_oracle

from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

# the test workers share the host's cores with the JAX test files: one
# intra-op thread per process keeps torch's thread pool from contending
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pattern():
    from scipy.spatial import cKDTree
    from meshlessmultigridpoisson_tpu.geometry.ordering import kd_tile_ordering

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
    return a


@pytest.fixture(scope="module")
def ells(pattern):
    """(reference EllMatrix, port EllMatrix, v6 tables) at 128-row blocks."""
    ej = jell.ell_from_csr(pattern, block_rows=128)
    et = tell.ell_from_csr(pattern, block_rows=128)
    return ej, et, K6.prepare_kernel_ell6(ej, max_segments=1)


def _omega_mask(n_pad):
    omega = np.full(n_pad, 1.4)
    omega[::5] = 1.0  # per-row omega_scale damping
    smask = np.ones(n_pad)
    smask[: n_pad // 7] = 0.0  # unsmoothed rows: zero K rows
    return omega, smask


def _sweep(et, kT, lagc, serial, dtype):
    nb = et.nrows_pad // 128
    A = gk.device_ell(et, dtype, "cpu", "spmv6")
    if serial:
        order, ptr = np.arange(nb), (0, nb)
    else:
        colors = gk.color_blocks(gk.block_patches(tell.global_cols(et).numpy(), nb), nb)
        order, ptr = gk.colored_order(colors)
    return gk.BlockSweep(
        A=A, kT=torch.from_numpy(kT).to(dtype), lagc=torch.as_tensor(lagc, dtype=dtype),
        order=torch.from_numpy(order.astype(np.int32)), phase_ptr=ptr,
        serial=serial, role="sweep7" if serial else "sweep8")


def _dedup(order):
    seen, out = set(), []
    for b in order:
        if int(b) not in seen:
            seen.add(int(b))
            out.append(int(b))
    return np.asarray(out)


def test_build_oneshot_K_and_colors_match_reference(ells):
    ej, et, kell = ells
    omega, smask = _omega_mask(ej.nrows_pad)
    # the port inverts with torch.linalg.inv, the reference with numpy: the
    # same LU in another library, equal to f64 rounding
    kT_ref = build_K_ref(ej, omega, smask)
    np.testing.assert_allclose(gk.build_oneshot_K(et, omega, smask), kT_ref,
                               rtol=0, atol=1e-13 * np.abs(kT_ref).max())
    nb = kell.nblocks
    pids_ref = np.asarray(kell.pids).reshape(nb, kell.gmax)
    colors_ref = K8.color_blocks(pids_ref, nb)
    np.testing.assert_array_equal(gk.color_blocks(pids_ref, nb), colors_ref)
    pids = gk.block_patches(tell.global_cols(et).numpy(), nb)
    assert [set(p) for p in pids] == [set(p) for p in pids_ref]
    np.testing.assert_array_equal(gk.color_blocks(pids, nb), colors_ref)
    kT = build_K_ref(ej, omega, smask)
    c8 = K8.prepare_colored_sweep(kell, kT, np.zeros((nb, 128), np.float32),
                                  max_expand=4.0, min_blocks=2)
    order, ptr = gk.colored_order(colors_ref)
    np.testing.assert_array_equal(order, _dedup(c8.block_order()))
    assert len(ptr) - 1 == c8.ncolors


def test_ell_spmv_plain_matches_spmv_tpu6_square_and_rectangular(pattern, ells):
    ej, et, kell = ells
    rng = np.random.default_rng(5)
    rect = pattern[:700]  # a restriction-shaped operator: 700 x 1296
    rj = jell.ell_from_csr(rect, block_rows=128, ncols=pattern.shape[1])
    rt = tell.ell_from_csr(rect, block_rows=128, ncols=pattern.shape[1])
    for ej_, et_, kell_ in ((ej, et, kell), (rj, rt, K6.prepare_kernel_ell6(rj))):
        x = rng.standard_normal(et_.ncols).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            yref = np.asarray(K6.spmv_tpu6(kell_, jnp.asarray(x)))
        A = gk.device_ell(et_, torch.float32, "cpu", "spmv6")
        y = gk.ell_spmv(A, torch.from_numpy(x)).numpy()
        assert y.shape == (et_.nrows_pad,)
        scale = np.abs(yref).max()
        np.testing.assert_allclose(y[: ej_.nrows], yref[: ej_.nrows],
                                   rtol=0, atol=3e-4 * scale)


def test_ell_spmv_plain_matches_spmv_tpu8(ells):
    ej, et, kell = ells
    nb = kell.nblocks
    omega, smask = _omega_mask(ej.nrows_pad)
    c8 = K8.prepare_colored_sweep(kell, build_K_ref(ej, omega, smask),
                                  np.zeros((nb, 128), np.float32),
                                  max_expand=4.0, min_blocks=2)
    x = np.random.default_rng(23).standard_normal(ej.nrows_pad).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yref = np.asarray(K8.spmv_tpu8(c8, jnp.asarray(x)))
    y = gk.ell_spmv(gk.device_ell(et, torch.float32, "cpu", "spmv8"),
                    torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, yref[: y.size], rtol=0,
                               atol=3e-4 * np.abs(yref).max())


@pytest.mark.parametrize("mb", [8, 4])
def test_colored_sweep_plain_matches_sor_sweep_tpu8(ells, mb):
    ej, et, kell = ells
    nb = kell.nblocks
    rng = np.random.default_rng(13 + mb)
    omega, smask = _omega_mask(ej.nrows_pad)
    kT = build_K_ref(ej, omega, smask)
    lagc2 = (rng.standard_normal((nb, 128)) * 0.01).astype(np.float32)
    c8 = K8.prepare_colored_sweep(kell, kT, lagc2, max_expand=6.0, mb=mb,
                                  min_blocks=2)
    assert c8.mb == mb
    x2 = rng.standard_normal((nb, 128)).astype(np.float32)
    b2 = rng.standard_normal((nb, 128)).astype(np.float32)
    xl = -0.21
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(K8.sor_sweep_tpu8(
            c8, jnp.asarray(x2), jnp.asarray(xl, jnp.float32),
            K8.permute_b8(c8, jnp.asarray(b2)))).reshape(-1)
    sw = _sweep(et, gk.build_oneshot_K(et, omega, smask), lagc2.reshape(-1),
                serial=False, dtype=torch.float32)
    out = gk.block_oneshot_sweep(sw, torch.from_numpy(x2.reshape(-1).copy()),
                                 torch.tensor(xl, dtype=torch.float32),
                                 torch.from_numpy(b2.reshape(-1))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-4 * np.abs(ref).max())
    moved = np.abs(out - x2.reshape(-1))
    assert moved[: ej.nrows_pad // 7].max() == 0.0  # zero K rows never move


def test_storage_sweep_plain_matches_sor_sweep_tpu7(ells):
    ej, et, kell = ells
    nb = kell.nblocks
    rng = np.random.default_rng(12)
    omega, smask = _omega_mask(ej.nrows_pad)
    kT = build_K_ref(ej, omega, smask)
    union = K6.union_sweep_tables(kell)
    kinv_sg = K6.pack_oneshot_K6(kell, kT)
    x2 = rng.standard_normal((nb, 128)).astype(np.float32)
    b2 = rng.standard_normal((nb, 128)).astype(np.float32)
    lagc2 = (rng.standard_normal((nb, 128)) * 0.01).astype(np.float32)
    xl = 0.37
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(K6.sor_sweep_tpu7(
            kell, union, kinv_sg, jnp.asarray(x2), jnp.asarray(xl, jnp.float32),
            jnp.asarray(b2), jnp.asarray(lagc2))).reshape(-1)
    sw = _sweep(et, gk.build_oneshot_K(et, omega, smask), lagc2.reshape(-1),
                serial=True, dtype=torch.float32)
    out = gk.block_oneshot_sweep(sw, torch.from_numpy(x2.reshape(-1).copy()),
                                 torch.tensor(xl, dtype=torch.float32),
                                 torch.from_numpy(b2.reshape(-1))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-4 * np.abs(ref).max())


@pytest.mark.parametrize("serial", [False, True], ids=["colored", "storage"])
def test_plain_sweeps_match_oneshot_oracle_f64(ells, serial):
    ej, et, kell = ells
    nb = kell.nblocks
    rng = np.random.default_rng(7)
    omega, smask = _omega_mask(ej.nrows_pad)
    kT = build_K_ref(ej, omega, smask)
    lagc = rng.standard_normal(ej.nrows_pad) * 0.01
    x = rng.standard_normal(ej.nrows_pad)
    b = rng.standard_normal(ej.nrows_pad)
    xl = 0.37
    sw = _sweep(et, gk.build_oneshot_K(et, omega, smask), lagc, serial,
                torch.float64)
    out = gk.block_oneshot_sweep(sw, torch.from_numpy(x.copy()),
                                 torch.tensor(xl, dtype=torch.float64),
                                 torch.from_numpy(b)).numpy()
    order = sw.order.numpy()
    ref = _colored_oracle(ej, kT, order, x.reshape(nb, 128), xl,
                          b.reshape(nb, 128), lagc.reshape(nb, 128))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    if serial:
        np.testing.assert_array_equal(order, np.arange(nb))


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-12), (torch.float32, 5e-4)])
def test_sweep_fixed_point(ells, dtype, atol):
    """At the exact solution a sweep is a no-op (K @ 0 = 0)."""
    ej, et, kell = ells
    xsol = np.random.default_rng(9).standard_normal(ej.nrows_pad)
    b = np.array(jell.spmv(ej.astype(jnp.float64), jnp.asarray(xsol)))
    kT = gk.build_oneshot_K(et, np.full(ej.nrows_pad, 1.4), np.ones(ej.nrows_pad))
    for serial in (False, True):
        sw = _sweep(et, kT, np.zeros(ej.nrows_pad), serial, dtype)
        out = gk.block_oneshot_sweep(
            sw, torch.from_numpy(xsol.copy()).to(dtype), torch.zeros((), dtype=dtype),
            torch.from_numpy(b).to(dtype))
        np.testing.assert_allclose(out.double().numpy(), xsol, rtol=0,
                                   atol=atol * np.abs(xsol).max())


def test_wrappers_refuse_cuda_mismatch(ells):
    """A DeviceEll on the CPU with a tensor elsewhere is refused, never
    silently computed on the CPU."""
    _, et, _ = ells
    A = gk.device_ell(et, torch.float32, "cpu", "spmv6")
    x = torch.zeros(et.ncols, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        gk.ell_spmv(A, x)
    with pytest.raises(ValueError):
        gk.device_ell(et, torch.float32, "cpu", "spmv2")
