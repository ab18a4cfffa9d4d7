"""The ``probes.kexp`` roles held against the reference package's v1 and v3
kernels (TPU kernels 8, 9 and 10) in interpret mode, on the CPU.

* ``ell_spmv`` (roles ``spmv1`` and ``spmv3``; the plain version: CPU
  tensors) against ``spmv_tpu(prepare_kernel_ell(ell))`` and
  ``spmv_tpu3(prepare_kernel_ell2(ell))`` on
  ``bench.synthetic_banded_csr(2048, 20, 300)`` at 128- and 256-row blocks;
* ``class_sor_sweep`` (role ``sweep1``) against ``sor_sweep_tpu`` on
  ``probes.realsparsity``'s pattern at 4,096 rows (unpermuted: rows of
  one 8-row tile couple, so a row-by-row GS is another function), with
  per-row omega, frozen rows, a Lagrange column and x_lag 0.3;
* ``kexp.build_operator``'s G against the reference's ``num_patches``, and
  ``kexp.run`` refuses without a card.

Tolerance: 3e-4 x max |output|, the reference's own for its kernels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.ops import ell as jell
from meshlessmultigridpoisson_tpu.ops import kernels as K1

from meshlessmultigridpoisson_torch.bench import synthetic_banded_csr
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.probes import kexp, realsparsity

torch.set_num_threads(1)

F32_TOL = 3e-4
N, KW, BAND = 2048, 20, 300


def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL * np.abs(ref).max())


@pytest.fixture(scope="module")
def synthetic():
    return synthetic_banded_csr(N, KW, BAND, seed=0)


@pytest.mark.parametrize("block_rows", [128, 256])
@pytest.mark.parametrize("role", ["spmv1", "spmv3"])
def test_ell_spmv_plain_matches_v1_and_v3(synthetic, role, block_rows):
    ej = jell.ell_from_csr(synthetic, block_rows=block_rows)
    et = tell.ell_from_csr(synthetic, block_rows=block_rows)
    x = np.random.default_rng(91).standard_normal(N).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        if role == "spmv1":
            ref = K1.spmv_tpu(K1.prepare_kernel_ell(ej), jnp.asarray(x))
        else:
            ref = K1.spmv_tpu3(K1.prepare_kernel_ell2(ej), jnp.asarray(x))
    ref = np.asarray(ref)
    A = gk.device_ell(et, torch.float32, "cpu", role)
    before = dict(gk.COUNTS)
    out = gk.ell_spmv(A, torch.from_numpy(x)).numpy()
    assert gk.COUNTS == before  # CPU tensors: the plain version, no launch
    assert out.shape == ref.shape == (et.nrows_pad,)
    _close(out, ref)


def test_sweep1_plain_matches_sor_sweep_tpu_on_real_pattern():
    a = realsparsity.real_pattern_csr(4096)
    ej, et = jell.ell_from_csr(a, block_rows=128), tell.ell_from_csr(a, block_rows=128)
    n = et.nrows_pad
    rng = np.random.default_rng(92)
    x, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    omega = np.full(n, 1.4)
    omega[::5] = 1.0
    mask = np.ones(n)
    mask[::7] = 0.0
    lagc, xl = rng.standard_normal(n) * 0.01, np.float32(0.3)
    kell = K1.prepare_kernel_ell(ej)
    nb = kell.nblocks

    def rows3(v):
        return jnp.asarray(np.asarray(v, np.float32).reshape(nb, 1, 128))

    x2 = np.zeros(kell.x_pad, np.float32)
    x2[:n] = x
    with pltpu.force_tpu_interpret_mode():
        ref = K1.sor_sweep_tpu(kell, jnp.asarray(x2.reshape(-1, 128)), jnp.asarray(xl),
                               rows3(1.0 / np.asarray(ej.diag)), rows3(b), rows3(mask),
                               rows3(omega), rows3(lagc))
    ref = np.asarray(ref).reshape(-1)[:n]
    sw = gk.class_sweep(gk.device_ell(et, torch.float32, "cpu", "spmv1"), et.diag, mask,
                        omega, lagc, role="sweep1")

    def run(s):
        return gk.class_sor_sweep(s, torch.from_numpy(x.copy()), torch.tensor(xl),
                                  torch.from_numpy(b)).numpy()

    _close(run(sw), ref)
    assert np.array_equal(run(sw)[mask == 0], x[mask == 0])  # frozen rows
    rowwise = np.abs(run(dataclasses.replace(sw, class_size=1)) - ref).max()
    assert rowwise > 30 * F32_TOL * np.abs(ref).max()


def test_kexp_host_operator_and_refusal_without_card(synthetic):
    op = kexp.build_operator(n=N, a=synthetic)
    for br in kexp.BLOCK_ROWS:
        kell2 = K1.prepare_kernel_ell2(jell.ell_from_csr(synthetic, block_rows=br))
        assert op["g"][br] == kell2.num_patches
        assert op["ells"][br].block_rows == br
        assert (tell.ell_to_csr(op["ells"][br]) != synthetic).nnz == 0
    with pytest.raises(SystemExit, match="card"):
        kexp.run(n=N, iters=1, a=synthetic)
