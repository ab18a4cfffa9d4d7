"""The kiso probes (``probes.kiso6``, ``kiso7``, ``kiso8``; the kiso roles of
``gpu_kernels.kiso_spmv``) held against the reference package, on the CPU.

* ``kiso7_affine`` and ``kiso7_ids`` against ``scripts/kiso7.py``'s
  ``spmv_var(prepare_kernel_ell4(ell), x, "affine" | "ids")``, and
  ``kiso8_mxu`` and ``kiso8_vpu`` against ``scripts/kiso8.py``'s
  ``spmv_var(..., "mxu" | "vpu")``, in TPU interpret mode on
  ``bench.synthetic_banded_csr(2048, 20, 300)`` at 128-row blocks, within
  3e-4 x max |y| (the reference's own tolerance for its kernels).
* ``kiso8_mxudef`` (its plain version: each product rounded to TF32, then
  an f32 sum) against ``"mxu-def"`` within 2e-3 x max |y|: on the CPU the
  reference's ``Precision.DEFAULT`` computes in f32, on the TPU it is one
  bf16 pass, and the card's counterpart is one TF32 pass (2^-11 relative
  a product, ~20 products a row beside a diagonal of 21 x).
* The four ``kiso6`` roles against ``kernels6.spmv_tpu6(prepare_kernel_ell6
  (ell, max_segments=1), x)`` under ``pltpu.force_tpu_interpret_mode()`` at
  1,920 rows (15 blocks: the id tables pad to 16, one padded block).
  ``scripts/kiso6.py`` itself no longer runs against the package: it calls
  ``prepare_kernel_ell6(..., max_buckets=...)`` and reads ``buckets``,
  ``out_order`` and ``kernels6._reduce_rows``, which the package replaced by
  ``max_segments`` and ``segments``; ``spmv_tpu6`` computes the function
  its variants time, y = A x on the v6 layout.
* The u16 offsets rebuild the global columns exactly, a block spanning
  more than 65,535 columns is refused, guarded and unguarded write what
  their plain versions say into the padded block, the byte and operation
  models count each role's own work, no CPU call counts a launch, the
  solve's SpMV refuses the kiso roles and each probe's ``run`` refuses
  without a card.

The scripts are loaded from this checkout's ``scripts/`` after the root
``bench`` of this checkout, so the fixed path they put on ``sys.path`` is
never searched, and ``MonkeyPatch`` restores ``sys.path`` afterwards.
Each interpret-mode reference runs once (module-scoped fixtures).
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.ops import ell as jell
from meshlessmultigridpoisson_tpu.ops import kernels4 as K4
from meshlessmultigridpoisson_tpu.ops import kernels6 as K6

from meshlessmultigridpoisson_torch.bench import synthetic_banded_csr
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.probes import kiso, kiso6, kiso7, kiso8
from meshlessmultigridpoisson_torch.utils import profiling as pf

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, KW, BAND = 2048, 20, 300
N6 = 1920  # 15 blocks of 128 rows: one padded block in the id tables
KISO6 = ("kiso6_i16_guarded", "kiso6_i16_unguarded", "kiso6_i32_guarded",
         "kiso6_i32_unguarded")


def _reference_script(monkeypatch, name):
    """``scripts/<name>.py`` of this checkout, loaded from its path after
    the root ``bench`` of this checkout (the scripts import it from a path
    they put on ``sys.path``)."""
    monkeypatch.syspath_prepend(REPO)
    import bench  # noqa: F401  (the root bench of this checkout)

    key = f"scripts.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(REPO, "scripts", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def _operator(n, seed=0):
    a = synthetic_banded_csr(n, KW, BAND, seed=seed)
    x = np.random.default_rng(81).standard_normal(n).astype(np.float32)
    return a, tell.ell_from_csr(a, block_rows=128), x


@pytest.fixture(scope="module")
def banded():
    return _operator(N)


@pytest.fixture(scope="module")
def banded6():
    return _operator(N6)


def _spmv_var_outputs(banded, name, modes):
    a, _, x = banded
    kell = K4.prepare_kernel_ell4(jell.ell_from_csr(a, block_rows=128))
    with pytest.MonkeyPatch.context() as mp:
        spmv_var = _reference_script(mp, name).spmv_var
        with pltpu.force_tpu_interpret_mode():
            return {m: np.asarray(spmv_var(kell, jnp.asarray(x), m)) for m in modes}


@pytest.fixture(scope="module")
def kiso7_ref(banded):
    return _spmv_var_outputs(banded, "kiso7", ("affine", "ids"))


@pytest.fixture(scope="module")
def kiso8_ref(banded):
    return _spmv_var_outputs(banded, "kiso8", ("mxu", "vpu", "mxu-def"))


@pytest.fixture(scope="module")
def kiso6_ref(banded6):
    a, _, x = banded6
    kell = K6.prepare_kernel_ell6(jell.ell_from_csr(a, block_rows=128), max_segments=1)
    assert kell.nblocks == 15 and kell.segments[0].nblocks == 16
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(K6.spmv_tpu6(kell, jnp.asarray(x)))


def _port(et, role, x, out=None):
    A = gk.device_kiso(et, "cpu", role)
    before = dict(gk.COUNTS)
    y = gk.kiso_spmv(A, torch.from_numpy(x), out)
    assert gk.COUNTS == before  # CPU tensors: the plain version, no launch
    return A, y.numpy()


def _close(out, ref, rtol):
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("role,mode", [("kiso7_affine", "affine"), ("kiso7_ids", "ids")])
def test_kiso7_roles_match_spmv_var(banded, kiso7_ref, role, mode):
    _, et, x = banded
    _close(_port(et, role, x)[1], kiso7_ref[mode], 3e-4)


@pytest.mark.parametrize("role,mode", [("kiso8_mxu", "mxu"), ("kiso8_vpu", "vpu"),
                                       ("kiso8_mxu_v1", "mxu")])
def test_kiso8_roles_match_spmv_var(banded, kiso8_ref, role, mode):
    _, et, x = banded
    A, y = _port(et, role, x)
    assert A.width % 8 == (0 if role in gk.KISO_MMA else et.width % 8)
    _close(y, kiso8_ref[mode], 3e-4)


@pytest.mark.parametrize("passes", [2, 1])
def test_kiso8_parent_roles_compute_the_same_function(banded, passes):
    """The parent design's timing roles (``_v1``) take the same tables and
    have the same plain version as the production roles of as many TF32
    passes: only the kernel's design differs."""
    _, et, x = banded
    role = {2: "kiso8_mxu", 1: "kiso8_mxudef"}[passes]
    A, y = _port(et, role, x)
    A1, y1 = _port(et, role + "_v1", x)
    assert gk.KISO_MMA[role] == gk.KISO_MMA[role + "_v1"] == passes
    assert torch.equal(A.vals, A1.vals) and torch.equal(A.cols, A1.cols)
    np.testing.assert_array_equal(y, y1)
    assert pf.kiso_bytes(A) == pf.kiso_bytes(A1)
    assert pf.kiso_flops(A) == pf.kiso_flops(A1)


def test_kiso8_mxudef_matches_mxu_def(banded, kiso8_ref):
    """One TF32 pass against the reference's DEFAULT precision, which on the
    CPU computes in f32 (on the TPU: one bf16 pass): 2e-3 x max |y|; the
    rounding shows (the f32 roles agree to ~1e-7)."""
    _, et, x = banded
    _, y = _port(et, "kiso8_mxudef", x)
    ref = kiso8_ref["mxu-def"]
    _close(y, ref, 2e-3)
    assert np.abs(y - ref).max() > 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("role", KISO6)
def test_kiso6_roles_match_spmv_tpu6(banded6, kiso6_ref, role):
    _, et, x = banded6
    A, y = _port(et, role, x)
    assert A.ids.tolist() == list(range(15)) + [-1]
    _close(y, kiso6_ref[:N6], 3e-4)


@pytest.mark.parametrize("role", KISO6)
def test_kiso6_padded_block_is_what_the_plain_version_says(banded6, role):
    """Guarded: the padded block keeps what the output held; unguarded: it
    holds block 0's rows (``max(-1, 0)``)."""
    _, et, x = banded6
    out = torch.full((16 * 128,), 7.0)
    _, y = _port(et, role, x, out)
    assert y.shape == (16 * 128,)
    full = tell.ell_to_csr(et) @ x.astype(np.float64)
    np.testing.assert_allclose(y[:N6], full, rtol=0, atol=1e-5 * np.abs(full).max())
    want = np.full(128, 7.0) if role in gk.KISO_GUARDED else y[:128]
    np.testing.assert_array_equal(y[N6:], want)


def test_u16_offsets_rebuild_global_columns(banded):
    _, et, _ = banded
    A = gk.device_kiso(et, "cpu", "kiso6_i16_guarded")
    assert A.cols.dtype == torch.int16 and A.col_base.shape == (N // 128,)
    assert torch.equal(gk.kiso_global_cols(A), tell.global_cols(et).long())


def test_u16_offsets_above_32767_and_the_span_limit():
    """Offsets up to 65,535 survive the int16 storage; 65,536 is refused."""
    n = 128
    for span, ok in ((65535, True), (65536, False)):
        rows = np.repeat(np.arange(n), 2)
        cols = np.stack([np.zeros(n, int), np.full(n, span)], 1).ravel()
        a = sp.csr_matrix((np.ones(2 * n), (rows, cols)), shape=(n, span + 1))
        et = tell.ell_from_csr(a, block_rows=128)
        if ok:
            A = gk.device_kiso(et, "cpu", "kiso6_i16_unguarded")
            assert int(A.cols.min()) < 0  # stored as int16 bits
            assert torch.equal(gk.kiso_global_cols(A), tell.global_cols(et).long())
        else:
            with pytest.raises(ValueError, match="spans 65536 columns"):
                gk.device_kiso(et, "cpu", "kiso6_i16_guarded")
            gk.device_kiso(et, "cpu", "kiso6_i32_guarded")  # int32 takes it


def test_tf32_rna_rounds_to_nearest_ties_away():
    """13 low mantissa bits: below half rounds down, half and above round
    away from zero, for either sign."""
    one = 0x3F800000
    bits = np.array([one + 0x0FFF, one + 0x1000, one + 0x1FFF, one + 0x2000 + 0x1000],
                    np.int32)
    v = torch.from_numpy(np.concatenate([bits, bits | np.int32(-2 ** 31)]).view(np.float32))
    got = gk.tf32_rna(v).numpy().view(np.int32)
    want = np.array([one, one + 0x2000, one + 0x2000, one + 0x4000], np.int32)
    np.testing.assert_array_equal(got, np.concatenate([want, want | np.int32(-2 ** 31)]))


@pytest.mark.parametrize("role", sorted(gk.KISO_ROLES))
def test_kiso_bytes_count_each_roles_own_work(banded6, role):
    """numpy counts on the 15-block operator: values and columns of the
    nonzeros (6 B u16 plus 4 B a block base, 8 B int32), x, y, the id
    table; the unguarded padded block block 0's work again, the guarded
    one nothing but its id; the mma roles' multiplies over rows padded to
    a multiple of 8."""
    _, et, _ = banded6
    A = gk.device_kiso(et, "cpu", role)
    vals = et.vals.numpy()
    nnz, nnz0 = np.count_nonzero(vals), np.count_nonzero(vals[:128])
    u16, ids = role.startswith("kiso6_i16"), role.startswith("kiso6") or role == "kiso7_ids"
    pad = int(role.startswith("kiso6") and role.endswith("unguarded"))
    want = (nnz + pad * nnz0) * (6 if u16 else 8) + 4 * N6 + 4 * (N6 + 128 * pad)
    want += 4 * (15 + pad) * u16 + 4 * (16 if role.startswith("kiso6") else 15) * ids
    assert pf.kiso_bytes(A) == want
    if role in gk.KISO_MMA:
        mults = int((-(-np.count_nonzero(vals, axis=1) // 8) * 8).sum())
        passes = gk.KISO_MMA[role]
        assert pf.kiso_flops(A) == {torch.float32: mults * passes,
                                    "tf32_tensor": mults * passes}
        assert mults > nnz
    else:
        assert pf.kiso_flops(A) == 2 * (nnz + pad * nnz0)
    if role in ("kiso7_affine", "kiso8_vpu"):
        assert pf.kiso_bytes(A) == pf.spmv_bytes(gk.device_ell(et, torch.float32, "cpu",
                                                               "spmv4"))


def test_bound_takes_the_slowest_unit():
    name = "NVIDIA H100 80GB HBM3"
    ms, by = pf.bound_ms(0, {torch.float32: 67e9, "tf32_tensor": 495e9}, torch.float32, name)
    assert ms == pytest.approx(1.0) and by == "operations"
    assert pf.bound_ms(3.35e9, 67e9, torch.float32, name) == pf.bound_ms(
        3.35e9, {torch.float32: 67e9}, torch.float32, name)


def test_kiso_roles_stay_off_the_solve_path(banded):
    _, et, x = banded
    with pytest.raises(ValueError, match="unknown SpMV role"):
        gk.device_ell(et, torch.float32, "cpu", "kiso7_affine")
    A = gk.device_kiso(et, "cpu", "kiso7_affine")
    with pytest.raises(ValueError, match="solve SpMV role"):
        gk.ell_spmv(A, torch.from_numpy(x))
    with pytest.raises(ValueError, match="not a kiso role"):
        gk.device_kiso(et, "cpu", "spmv6")
    with pytest.raises(ValueError, match="not a kiso role"):
        gk.kiso_spmv(gk.device_ell(et, torch.float32, "cpu", "spmv6"), torch.from_numpy(x))


@pytest.mark.parametrize("probe", [kiso6, kiso7, kiso8], ids=["kiso6", "kiso7", "kiso8"])
def test_probe_run_refuses_without_a_card(probe):
    with pytest.raises(SystemExit, match="card"):
        probe.run()


def test_kiso_host_prep_is_the_reference_operator():
    """``build_operator`` is the reference scripts' operator
    (``synthetic_banded_csr(n, 70, 512)``) at 128-row blocks; its block
    spans fit the u16 format."""
    ell = kiso6.build_operator(n=4096)
    a = synthetic_banded_csr(4096, kiso.K, kiso.BAND, 0)
    y = gk.ell_spmv_plain(ell.vals, tell.global_cols(ell),
                          torch.ones(4096, dtype=torch.float64))
    np.testing.assert_allclose(y.numpy()[:4096], a @ np.ones(4096), rtol=1e-12)
    assert ell.block_rows == 128 and ell.width <= kiso.K
    assert 128 < kiso6.max_block_span(ell) <= 128 + 2 * kiso.BAND
