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
1e-12 / 1e-11 for the same reorderings in double.  ``compact_rows`` is a
gather-sum with a two-operation epilogue: the SpMV's tolerances.  The
bf16-K sweep against its bf16 plain version: 1e-2 of max |dx| (both round
t to bf16; a t element on the other side of a rounding boundary moves its
column's contribution by one bf16 ulp, 2^-8).  ``stream_ceiling`` sums
small integers: exact.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from meshlessmultigridpoisson_torch.geometry.ordering import kd_tile_ordering
from meshlessmultigridpoisson_torch.mg.gpu_backend import check_resolve_in_place
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.stencil.operators import _compact_from_rows

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


def _sweep(et, dtype, serial, role, k_dtype=None):
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
    return gk.BlockSweep(
        A=gk.device_ell(et, dtype, "cuda", "spmv6"),
        kT=torch.from_numpy(kT).to("cuda", k_dtype or dtype),
        lagc=torch.full((n_pad,), 0.01, dtype=dtype, device="cuda"),
        order=torch.from_numpy(order.astype(np.int32)).cuda(), phase_ptr=ptr,
        serial=serial, role=role)


@pytest.mark.parametrize("role", ["sweep6", "sweep7"])
def test_storage_sweep_roles_count_and_match_plain(et, role):
    """Kernels 6 and 7 launch the same single-CTA chain under their own
    counters."""
    sw = _sweep(et, torch.float32, True, role)
    x, b = _rand(et.nrows_pad, torch.float32, 7), _rand(et.nrows_pad, torch.float32, 8)
    xl = torch.tensor(-0.2, dtype=torch.float32, device="cuda")
    before = dict(gk.COUNTS)
    out = gk.block_oneshot_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {role: 1}
    ref = gk.block_oneshot_sweep_plain(sw, x.clone(), xl, b)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("role,serial", [("sweep6", True), ("sweep7", True),
                                         ("sweep8", False)])
def test_block_sweep_bf16k_matches_plain(et, role, serial):
    sw = _sweep(et, torch.float32, serial, role, k_dtype=torch.bfloat16)
    x, b = _rand(et.nrows_pad, torch.float32, 9), _rand(et.nrows_pad, torch.float32, 10)
    xl = torch.tensor(0.3, dtype=torch.float32, device="cuda")
    out = gk.block_oneshot_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    ref = gk.block_oneshot_sweep_plain(sw, x.clone(), xl, b)
    assert float((out - ref).abs().max()) <= 1e-2 * float((ref - x).abs().max())
    f32 = _sweep(et, torch.float32, serial, role)  # bf16 K is close to f32 K
    ref32 = gk.block_oneshot_sweep_plain(f32, x.clone(), xl, b)
    assert float((out - ref32).abs().max()) <= 5e-2 * float((ref32 - x).abs().max())


def test_bf16k_sweep_refuses_f64_vectors(et):
    sw = _sweep(et, torch.float64, True, "sweep7", k_dtype=torch.bfloat16)
    x = _rand(et.nrows_pad, torch.float64, 11)
    with pytest.raises(ValueError, match="bf16"):
        gk.block_oneshot_sweep(sw, x, torch.zeros((), dtype=torch.float64, device="cuda"), x)


@pytest.mark.parametrize("reps", [1, 3])
def test_stream_ceiling_matches_plain(reps):
    g = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randint(0, 4, (4 * 4096, 128), generator=g, device="cuda").float()
    c = torch.randint(-3, 4, (4 * 4096, 128), generator=g, device="cuda", dtype=torch.int32)
    before = gk.COUNTS["stream14"]
    out = gk.stream_ceiling(v, c, 4096, reps)
    torch.cuda.synchronize()
    assert gk.COUNTS["stream14"] == before + 1
    assert out.shape == (32, 128)
    assert torch.equal(out, gk.stream_ceiling_plain(v, c, 4096))


@pytest.fixture(scope="module")
def compact(et):
    """A compact table cut from the fixture: every 37th row (35 rows, 93
    sentinel padding slots in 128), entries in other target rows' columns
    dropped (the re-solve's in-place condition), one row reduced to its
    diagonal."""
    a = tell.ell_to_csr(et).tolil()
    targets = np.arange(0, a.shape[0], 37)
    for r in targets:
        for c in targets:
            if c != r:
                a[r, c] = 0.0
    only_diag = targets[3]
    a[only_diag, :] = 0.0
    a[only_diag, only_diag] = 2.5
    table = _compact_from_rows(a.tocsr(), targets, block_rows=128)
    check_resolve_in_place(table)
    assert table.nrows == targets.size and table.rows.shape[0] == 128
    return table, only_diag


@pytest.mark.parametrize("role", ["bound2", "push2"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_compact_rows_matches_plain(compact, role, dtype, tol):
    table, only_diag = compact
    C = gk.device_compact(table, dtype, "cuda", role)
    x, b = _rand(C.n_pad, dtype, 3), _rand(C.n_pad, dtype, 4)
    xin = x if role == "bound2" else b
    before = gk.COUNTS[role]
    out = gk.compact_rows(C, xin.clone(), b)
    torch.cuda.synchronize()
    assert gk.COUNTS[role] == before + 1
    ref = gk.compact_rows_plain(C, xin.clone(), b)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    rows = table.rows[: table.nrows].long().cuda()
    untouched = torch.ones(C.n_pad, dtype=torch.bool, device="cuda")
    untouched[rows] = False  # sentinel slots wrote nothing
    assert torch.equal(out[untouched], xin[untouched])
    if role == "bound2":  # y - d x[r] = 0: x[r] = b[r] / d
        assert abs(float(out[only_diag] - b[only_diag] / 2.5)) <= tol * float(
            ref.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_compact_rows_scatter_matches_plain(compact, dtype, tol):
    """Role ppe2: y[r] = (C x)_i in place on y, sentinel slots write nothing,
    x is left alone; an output aliasing x is refused."""
    import dataclasses

    table, only_diag = compact
    C = dataclasses.replace(gk.device_compact(table, dtype, "cuda", "bound2"),
                            role="ppe2")
    x, y = _rand(C.n_pad, dtype, 5), _rand(C.n_pad, dtype, 6)
    x0 = x.clone()
    before = gk.COUNTS["ppe2"]
    out = gk.compact_rows(C, x, y.clone())
    torch.cuda.synchronize()
    assert gk.COUNTS["ppe2"] == before + 1
    ref = gk.compact_rows_plain(C, x, y.clone())
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(x, x0)
    rows = table.rows[: table.nrows].long().cuda()
    untouched = torch.ones(C.n_pad, dtype=torch.bool, device="cuda")
    untouched[rows] = False  # sentinel slots wrote nothing
    assert torch.equal(out[untouched], y[untouched])
    # the diagonal-only row: y[r] = 2.5 x[r]
    assert abs(float(out[only_diag] - 2.5 * x[only_diag])) <= tol * float(ref.abs().max())
    with pytest.raises(ValueError, match="alias"):
        gk.compact_rows(C, x, x)


def test_wrapper_refuses_wrong_dtype(et):
    A = gk.device_ell(et, torch.float32, "cuda", "spmv6")
    with pytest.raises(ValueError):
        gk.ell_spmv(A, _rand(et.ncols, torch.float64, 0))


def test_cli_solve_on_card_runs_every_kernel():
    """The slice's flow at a small ladder: the CLI on the card reaches its
    tolerance and launches the four SpMV and sweep roles (Dirichlet), and
    those and the boundary re-solve (Neumann)."""
    from meshlessmultigridpoisson_torch.apps import cli

    argv = ["solve", "--device", "cuda", "--geom", "square_with_circle",
            "--sizes", "600", "2500", "5000", "--deg", "4", "--ordering", "kdtile",
            "--block-rows", "512", "--tol", "1e-10"]
    for extra, roles in (([], ("spmv6", "spmv8", "sweep7", "sweep8")),
                         (["--neumann"], ("spmv6", "spmv8", "sweep7", "sweep8",
                                          "bound2"))):
        rec, *_ = cli.run_solve(argv + extra)
        assert rec.final_residual < 1e-10
        assert rec.extra["level_kernels"] == ["v7-exact", "v7-exact", "v8-colored"]
        launches = rec.extra["launches"]
        assert all(launches[r] > 0 for r in roles), launches


def test_cli_ns_on_card_runs_every_kernel():
    """The NS flow at a small ladder: every step's PPE reaches its
    tolerance and the path launches the SpMV and sweep roles, the boundary
    re-solve and the compatible-PPE scatter."""
    import math

    from meshlessmultigridpoisson_torch.apps import cli

    rec, prob, last = cli.run_ns(
        ["ns", "--device", "cuda", "--sizes", "170", "600", "--deg", "4",
         "--steps", "5"])
    assert rec.extra["level_kernels"] == ["v7-exact", "v7-exact"]
    launches = rec.extra["launches"]
    assert all(launches[r] > 0 for r in ("spmv6", "sweep7", "bound2", "ppe2")), launches
    assert launches["push2"] == 0
    assert all(math.isfinite(h) for h in rec.residual_history)
    assert all(r < 1e-10 for r in rec.extra["ppe_residual"])


def test_cli_solve_exact_and_fast_k_on_card():
    """``--sweep-order exact`` runs storage order on every level (kernel 6
    on the fine level of this ladder) with ``spmv6`` matvecs; ``--fast-k``
    stores every K in bf16; both reach the tolerance; ``--profile`` adds the
    per-level table with bounds."""
    from meshlessmultigridpoisson_torch.apps import cli

    argv = ["solve", "--device", "cuda", "--geom", "square_with_circle",
            "--sizes", "600", "2500", "5000", "--deg", "4", "--ordering", "kdtile",
            "--block-rows", "512", "--tol", "1e-10"]
    rec, prob, *_ = cli.run_solve(argv + ["--sweep-order", "exact", "--profile"])
    assert rec.final_residual < 1e-10
    assert rec.extra["level_kernels"] == ["v7-exact", "v7-exact", "v6-oneshot"]
    launches = rec.extra["launches"]
    assert launches["sweep6"] > 0 and launches["sweep7"] > 0 and launches["spmv6"] > 0
    assert launches["sweep8"] == 0 and launches["spmv8"] == 0
    rows = rec.extra["per_level"]
    assert [r["kernel"] for r in rows] == rec.extra["level_kernels"]
    assert all(0 < r["sweep_bound_ms"] <= r["sweep_ms"] for r in rows)
    rec, *_ = cli.run_solve(argv + ["--fast-k"], problem=prob)
    assert rec.final_residual < 1e-10
    assert rec.extra["level_kernels"] == ["v7-exact", "v7-exact", "v8-colored"]
    assert rec.extra["level_k_dtypes"] == ["torch.bfloat16"] * 3
