"""``--sweep-order exact`` and ``--fast-k`` of the port held against the
reference package, on the CPU.

* Level kinds: ``gpu_hierarchy(sweep_order="exact")`` names each level
  v7-exact / v6-oneshot exactly where the reference's
  ``tpu_hierarchy(sweep="exact")`` does, on a ladder that reaches v6.
* The kind rule: ``union_slots`` equals the slot count of the reference's
  ``union_sweep_tables`` where it accepts and exceeds 32 where it raises, on
  banded patterns whose union grows past the bound.
* Sweeps: the plain storage-order sweep against ``sor_sweep_tpu6`` in
  interpret mode, f32 at rtol 2e-4 (``__graft_entry__.py:118``) with an
  absolute floor of 2e-4 of max |output| for entries near zero; with K in
  bf16 (``pack_oneshot_K6(..., jnp.bfloat16)``) within 1e-2 of max |dx|
  (both round t to bf16; a t element on the other side of a rounding
  boundary moves its column's contribution by one bf16 ulp, 2^-8).
* V-cycles: the f64 exact-order GpuLevel hierarchy with the kernels' plain
  versions reproduces the reference f64 ``v_cycle`` history over its host
  hierarchy (``_gs_sweep``) to 1e-10 relative over 5 cycles: the same
  (block, class) Gauss-Seidel, summed in another order.
* The CLI: ``--device cpu --sweep-order exact`` and ``--device cpu
  --fast-k`` reach ``--tol`` on the CPU rehearsal ladder.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.mg.tpu_backend import tpu_hierarchy
from meshlessmultigridpoisson_tpu.mg.vcycle import run_v_cycles as jrun
from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake
from meshlessmultigridpoisson_tpu.ops import ell as jell
from meshlessmultigridpoisson_tpu.ops import kernels6 as K6
from meshlessmultigridpoisson_tpu.ops.kernels4 import Ell4Unsupported
from meshlessmultigridpoisson_tpu.ops.kernels4 import build_oneshot_K as build_K_ref
from test_torch_kernels import _omega_mask, pattern  # noqa: F401 (fixture)

from meshlessmultigridpoisson_torch import bench, interop
from meshlessmultigridpoisson_torch.mg import gpu_backend
from meshlessmultigridpoisson_torch.mg.vcycle import run_v_cycles as trun
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk

# the test workers share the host's cores with the JAX test files: one
# intra-op thread per process keeps torch's thread pool from contending
torch.set_num_threads(1)

RUNG = dict(sizes=[2500, 10000], poly_deg=6, ordering="kdtile", block_rows=512)
CPU_LADDER = ["--geom", "square_with_circle", "--sizes", "600", "2500", "5000",
              "--deg", "4", "--ordering", "kdtile", "--block-rows", "512",
              "--tol", "1e-10"]


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


def test_exact_level_kinds_match_tpu_hierarchy():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pj = jmake("square_with_circle", **RUNG)
    th = tpu_hierarchy(pj.hierarchy, sweep="exact")
    gh = gpu_backend.gpu_hierarchy(
        interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy)), "cpu",
        sweep_order="exact")
    kinds = [lv.kernel_kind for lv in gh.levels]
    assert kinds == [lv.kernel_kind for lv in th.levels] == ["v7-exact", "v6-oneshot"]
    assert [lv.sweep.role for lv in gh.levels] == ["sweep7", "sweep6"]
    assert all(lv.A.role == "spmv6" and lv.sweep.serial for lv in gh.levels)
    for lv in gh.levels:
        np.testing.assert_array_equal(lv.sweep.order.numpy(), np.arange(lv.n_pad // 128))
    with pytest.raises(ValueError, match="sweep_order"):
        gpu_backend.gpu_level_from_operator(
            interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy)).levels[0], "cpu",
            sweep_order="storage")


@pytest.mark.parametrize("n,band", [(16384, 256), (16384, 1024), (16384, 4096),
                                    (16084, 1536)],
                         ids=["band256", "band1024", "band4096", "ragged-band1536"])
def test_union_slots_match_union_sweep_tables(n, band):
    a = bench.synthetic_banded_csr(n, 12, band, seed=band)
    kell = K6.prepare_kernel_ell6(jell.ell_from_csr(a, block_rows=128))
    et = tell.ell_from_csr(a, block_rows=128)
    nb = et.nrows_pad // 128
    slots = gk.union_slots(gk.block_patches(tell.global_cols(et).numpy(), nb), nb)
    try:
        ref = K6.union_sweep_tables(kell).g8max
    except Ell4Unsupported:
        assert slots > gk.UNION_MAX_SLOTS
    else:
        assert slots == ref <= gk.UNION_MAX_SLOTS
    if band == 4096:
        assert slots > gk.UNION_MAX_SLOTS  # the pattern reaches v6


@pytest.fixture(scope="module")
def pattern_ells(pattern):
    """The ``tests/test_kernels8.py`` pattern (36x36 jittered grid, k = 28,
    kd-tile ordered, non-symmetric values) at 128-row blocks."""
    ej = jell.ell_from_csr(pattern, block_rows=128)
    return ej, tell.ell_from_csr(pattern, block_rows=128), K6.prepare_kernel_ell6(ej)


def _storage_sweep(et, kT, lagc, dtype, k_dtype=None):
    nb = et.nrows_pad // 128
    return gk.BlockSweep(
        A=gk.device_ell(et, dtype, "cpu", "spmv6"),
        kT=torch.from_numpy(kT).to(dtype).to(k_dtype or dtype),
        lagc=torch.as_tensor(lagc, dtype=dtype),
        order=torch.arange(nb, dtype=torch.int32), phase_ptr=(0, nb), serial=True,
        role="sweep6")


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16k"])
def test_storage_sweep_plain_matches_sor_sweep_tpu6(pattern_ells, fast):
    ej, et, kell = pattern_ells
    nb = kell.nblocks
    rng = np.random.default_rng(31 + fast)
    omega, smask = _omega_mask(ej.nrows_pad)
    kT = build_K_ref(ej, omega, smask).astype(np.float32)
    x2 = rng.standard_normal((nb, 128)).astype(np.float32)
    b2 = rng.standard_normal((nb, 128)).astype(np.float32)
    lagc2 = (rng.standard_normal((nb, 128)) * 0.01).astype(np.float32)
    xl = -0.43
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(K6.sor_sweep_tpu6(
            kell, K6.pack_oneshot_K6(kell, kT, jnp.bfloat16 if fast else jnp.float32),
            jnp.asarray(x2), jnp.asarray(xl, jnp.float32), jnp.asarray(b2),
            jnp.asarray(lagc2))).reshape(-1)
    sw = _storage_sweep(et, kT, lagc2.reshape(-1), torch.float32,
                        torch.bfloat16 if fast else None)
    x0 = x2.reshape(-1)
    out = gk.block_oneshot_sweep(sw, torch.from_numpy(x0.copy()),
                                 torch.tensor(xl, dtype=torch.float32),
                                 torch.from_numpy(b2.reshape(-1))).numpy()
    if fast:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2 * np.abs(ref - x0).max())
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())
    assert np.abs(out - x0)[: ej.nrows_pad // 7].max() == 0.0  # zero K rows


def test_exact_order_vcycle_history_f64_matches_reference():
    pj = jmake("square", sizes=[300, 1200], poly_deg=3, k1=1, neumann=False)
    _, hist_j = jrun(pj.hierarchy, pj.state0, 5)
    hier = interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy))
    gh = gpu_backend.gpu_hierarchy(hier, "cpu", torch.float64, sweep_order="exact")
    assert all(lv.sweep.serial for lv in gh.levels)
    state = interop.state_from_numpy(_numpy_tree(pj.state0))
    _, hist_t = trun(gh, state, 5)
    np.testing.assert_allclose(hist_t.numpy(), np.asarray(hist_j), rtol=1e-10, atol=0)


def test_fast_k_needs_f32_vectors():
    hier = interop.hierarchy_from_numpy(_numpy_tree(
        jmake("square", sizes=[300], poly_deg=2, k1=1, neumann=False).hierarchy))
    with pytest.raises(ValueError, match="bf16"):
        gpu_backend.gpu_level_from_operator(hier.levels[0], "cpu", torch.float64,
                                            k_dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def exact_cpu_solve():
    from meshlessmultigridpoisson_torch.apps import cli

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cli.run_solve(["solve", "--device", "cpu", "--sweep-order", "exact",
                              *CPU_LADDER])


def test_cpu_solve_sweep_order_exact_reaches_tol(exact_cpu_solve):
    rec, *_ = exact_cpu_solve
    assert rec.final_residual < 1e-10
    assert rec.config["sweep_order"] == "exact" and rec.config["fast_k"] is False
    assert rec.extra["level_kernels"] == ["v7-exact", "v7-exact", "v6-oneshot"]
    assert rec.l1_error < 1e-6


def test_cpu_solve_fast_k_reaches_tol(exact_cpu_solve):
    from meshlessmultigridpoisson_torch.apps import cli

    _, prob, *_ = exact_cpu_solve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec, *_ = cli.run_solve(["solve", "--device", "cpu", "--fast-k", *CPU_LADDER],
                                problem=prob)
    assert rec.final_residual < 1e-10
    assert rec.config["fast_k"] is True and rec.config["sweep_order"] == "colored"
    assert rec.extra["level_kernels"] == ["v7-exact", "v7-exact", "v8-colored"]
    assert rec.extra["level_k_dtypes"] == ["torch.bfloat16"] * 3
    assert rec.l1_error < 1e-6
