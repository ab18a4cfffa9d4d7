"""The port's kernel bench and per-level profiler, on the CPU.

What a CPU run can check: the bench's synthetic operator is the reference
bench's (``bench.py:synthetic_banded_csr``, same seed, same matrix), its
host prep is consistent, the byte model counts what each function needs
(the nonzeros of A and K and the vectors, no ELL padding and none of K's
structural zeros), the library yardstick's CSR operand computes the SpMV,
the stream probe's plain version computes the reference Pallas kernel's
function, the bound arithmetic, and that every timing entry point refuses
to run without a card.  Times come only from the card (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import bench as reference_bench
from meshlessmultigridpoisson_torch import bench
from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_hierarchy
from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.ops.ell import ell_to_csr
from meshlessmultigridpoisson_torch.stencil.operators import _compact_from_rows
from meshlessmultigridpoisson_torch.utils import profiling as pf

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("n,k,band,seed", [(2048, 20, 100, 0), (3000, 70, 512, 3)])
def test_synthetic_operator_is_the_reference_bench_operator(n, k, band, seed):
    a = bench.synthetic_banded_csr(n, k, band, seed)
    r = reference_bench.synthetic_banded_csr(n, k, band, seed)
    np.testing.assert_array_equal(a.indptr, r.indptr)
    np.testing.assert_array_equal(a.indices, r.indices)
    np.testing.assert_array_equal(a.data, r.data)


def test_build_operator_host_prep():
    op = bench.build_operator(n=4096, k=20, band=300, seed=1)
    a, ell = op["a"], op["ell"]
    assert (ell_to_csr(ell) != a).nnz == 0
    nb = ell.nrows_pad // 128
    assert op["kT"].shape == (nb, 128, 128)
    order, ptr = op["order"], op["phase_ptr"]
    np.testing.assert_array_equal(np.sort(order), np.arange(nb))
    assert ptr[0] == 0 and ptr[-1] == nb
    # band 300 < 3 blocks: a group of 8 reads at most 3 blocks each side
    assert op["union_slots"] == 16


@pytest.fixture(scope="module")
def small_levels():
    prob = make_poisson_problem("square", sizes=[170, 600], poly_deg=3)
    return (gpu_hierarchy(prob.hierarchy, "cpu"),
            gpu_hierarchy(prob.hierarchy, "cpu", k_dtype=torch.bfloat16))


def test_streamed_bytes_is_the_tensors_the_kernels_touch(small_levels):
    """A's nonzeros (f32 value + int32 column), K's nonzeros in K's dtype,
    x and y (SpMV) or x read and written, b, lagc and the block order
    (sweep).  K's nonzeros lie in its lower class triangle (diagonal 8x8
    class blocks diagonal) on the smoothed rows: at most 7,808 of 16,384
    entries a block."""
    lane = np.arange(128)
    # kT[block, j, i] = K[i, j]: class(j) < class(i), or the diagonal
    tri = (lane[:, None] // 8 < lane[None, :] // 8) | (lane[:, None] == lane[None, :])
    assert tri.sum() == 7808
    for g32, gbf in zip(*(h.levels for h in small_levels)):
        A, sw = g32.A, g32.sweep
        vals = A.vals.numpy()
        es = vals.itemsize
        nnz = np.count_nonzero(vals)
        assert nnz < vals.size  # the ELL holds padding slots; they are left out
        assert pf._streamed_bytes(g32, False) == (nnz * (es + 4)
                                                  + (A.ncols + A.nrows_pad) * es)
        kT = sw.kT.numpy()
        smooth = np.diagonal(kT, axis1=1, axis2=2) != 0
        inside = tri[None] & smooth[:, :, None] & smooth[:, None, :]
        assert np.count_nonzero(kT[~inside]) == 0
        vec = sw.lagc.nbytes + sw.order.nbytes + 3 * A.nrows_pad * es
        assert pf._streamed_bytes(g32, True) == (nnz * (es + 4)
                                                 + np.count_nonzero(kT) * 4 + vec)
        kbf = np.count_nonzero(gbf.sweep.kT.float().numpy())
        assert pf._streamed_bytes(gbf, True) == nnz * (es + 4) + kbf * 2 + vec
        assert pf.sweep_flops(g32.sweep) == 2 * nnz + 2 * np.count_nonzero(kT)


def test_compact_bytes_and_library_csr():
    """``compact_bytes``: the table's nonzeros, each true row's target and
    diagonal, the distinct x entries gathered, one read and one write per
    true row; ``library_csr`` holds the nonzeros and computes the SpMV."""
    a = bench.synthetic_banded_csr(600, 9, 40, seed=5)
    targets = np.arange(3, 600, 7)
    C = gk.device_compact(_compact_from_rows(a, targets, block_rows=128),
                          torch.float32, "cpu", "bound2")
    sub = a[targets]
    nx = np.unique(sub.indices).size
    assert pf.compact_bytes(C) == (sub.nnz * 8 + targets.size * 8
                                   + (nx + 2 * targets.size) * 4)
    assert pf.compact_flops(C) == 2 * sub.nnz
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(600)).float()
    csr = pf.library_csr(C.vals, C.cols, C.n_pad)
    assert csr.values().numel() == sub.nnz
    np.testing.assert_allclose((csr @ x).numpy(),
                               gk.ell_spmv_plain(C.vals, C.cols, x).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_ppe_tail_bytes_count_what_the_function_needs(dtype):
    """``ppe_tail_bytes``: the boundary rows' nonzeros and targets, p, q,
    x, the Lagrange column and the live flags read once and y written once
    over the fine level; not the kernel's row -> compact-row map, nor the
    rows' ``lens``."""
    a = bench.synthetic_banded_csr(600, 9, 40, seed=5)
    targets = np.arange(3, 600, 7)
    C = gk.device_compact(_compact_from_rows(a, targets, block_rows=128),
                          dtype, "cpu", "ppe2")
    live = torch.from_numpy(np.random.default_rng(1).random(C.n_pad) < 0.9)
    T = gk.ppe_tail_table(C, live, torch.zeros(C.n_pad, dtype=dtype))
    es = torch.finfo(dtype).bits // 8
    assert pf.ppe_tail_bytes(T) == (a[targets].nnz * (es + 4) + targets.size * 4
                                    + C.n_pad * (5 * es + 1))
    assert pf.ppe_tail_flops(T) == 2 * a[targets].nnz + 3 * C.n_pad


def test_bound_picks_the_larger_time():
    ms, by = pf.bound_ms(3.35e9, 1.0, torch.float32, H100)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = pf.bound_ms(1.0, 34e9, torch.float64, H100)
    assert by == "operations" and ms == pytest.approx(1.0)
    with pytest.raises(ValueError, match="no published peaks"):
        pf.peaks("NVIDIA A100-SXM4-80GB")


def test_stream_ceiling_plain_is_the_reference_function():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 4, (4 * 512, 128)).astype(np.float32)
    c = rng.integers(-3, 4, (4 * 512, 128)).astype(np.int32)
    out = gk.stream_ceiling(torch.from_numpy(v), torch.from_numpy(c), tile_rows=512,
                            reps=2).numpy()
    s = v.reshape(4, 512, 128).sum(1) + c.reshape(4, 512, 128).sum(1).astype(np.float32)
    np.testing.assert_array_equal(out, np.repeat(s, 8, axis=0))
    with pytest.raises(ValueError, match="tiles"):
        gk.stream_ceiling(torch.from_numpy(v), torch.from_numpy(c), tile_rows=300)


def test_timing_refuses_the_cpu(small_levels, monkeypatch):
    with pytest.raises(ValueError, match="CUDA"):
        pf.chain_time(lambda x: x, torch.zeros(4))
    with pytest.raises(ValueError, match="card"):
        pf.profile_hierarchy(small_levels[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="card"):
        bench.main([])


def test_cpu_profile_says_not_measured():
    from meshlessmultigridpoisson_torch.apps import cli

    rec, *_ = cli.run_solve(["solve", "--device", "cpu", "--sizes", "170", "600",
                             "--deg", "3", "--profile"])
    assert rec.extra["per_level"] == "not measured (no CUDA device)"
    assert rec.extra["profile"]["device_busy_share"].startswith("not measured")
