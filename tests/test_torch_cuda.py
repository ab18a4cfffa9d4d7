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
column's contribution by one bf16 ulp, 2^-8).  ``stream_ceiling`` and
``stream_probe`` (every table mix) sum small integers: exact.  The SpMV
probe modes (``spmv_probe``) against their plain versions: the SpMV's f32
tolerance.  ``class_sor_sweep`` (K-free class SOR) against
its plain version: the sweep's tolerances, on the fixture (unpermuted:
rows of one 8-row tile couple), on ``probes.realsparsity``'s 4,096-row
pattern and on a (block, class)-permuted solve level.  The kiso roles
(``kiso_spmv``) against their plain versions: the SpMV's f32 tolerance,
``kiso8_mxudef`` against its TF32 plain version (the same rounded
products, summed in another order); on the fixture, whose 11 blocks pad to
16, so that the padded blocks show what guarded and unguarded write.
"""

import dataclasses

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
    return _knn_ell(28)


def _knn_ell(k):
    """ELL of a k-nearest-neighbour operator with a heavy diagonal on a
    jittered 36 x 36 grid in kd-tile order (1,296 rows, width k)."""
    from scipy.spatial import cKDTree

    n_side = 36
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


def _with_patches(sw):
    """``sw`` with its blocks' x patches (role sweep8 needs them on the card)."""
    nb = sw.A.nrows_pad // 128
    return dataclasses.replace(
        sw, patches=gk.block_patch_tables(sw.A.cols.cpu().numpy(), nb, "cuda"))


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
    sw = sw if serial else _with_patches(sw)
    x, b = _rand(n_pad, dtype, 1), _rand(n_pad, dtype, 2)
    xl = torch.tensor(0.3, dtype=dtype, device="cuda")
    before = gk.COUNTS[sw.role]
    out = gk.block_oneshot_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    assert gk.COUNTS[sw.role] == before + 1  # a sweep8 / sweep7 sweep is one launch
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
    sw = gk.BlockSweep(
        A=gk.device_ell(et, dtype, "cuda", "spmv6"),
        kT=torch.from_numpy(kT).to("cuda", k_dtype or dtype),
        lagc=torch.full((n_pad,), 0.01, dtype=dtype, device="cuda"),
        order=torch.from_numpy(order.astype(np.int32)).cuda(), phase_ptr=ptr,
        serial=serial, role=role)
    return _with_patches(sw) if role == "sweep8" else sw


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


STALE_CASES = [(torch.float32, None, 1e-4), (torch.float64, None, 1e-11),
               (torch.float32, torch.bfloat16, 1e-2)]


@pytest.mark.parametrize("dtype,kdt,tol", STALE_CASES, ids=["f32", "f64", "bf16k"])
@pytest.mark.parametrize("start", [0, 8])
@pytest.mark.parametrize("role", ["sweep7_stale", "sweep7_stale_walk"])
def test_stale_sweep_counts_and_matches_plain(et, dtype, kdt, tol, start, role):
    """The stale-program sweep in one launch against its plain version: its
    cluster kernel (role ``sweep7_stale``) and the walk (``storage_chain``'s
    mode kStale, the timing role ``sweep7_stale_walk``); the fixture's 11
    blocks from block 0 (a last group of 3) and from block 8 (one partial
    group); rows outside the order untouched; bf16 K against the bf16 plain
    version within 1e-2 of max |dx|."""
    sw = _sweep(et, dtype, True, "sweep6", k_dtype=kdt)
    nb = sw.order.shape[0]
    sw = gk.stale_sweep_of(dataclasses.replace(sw, order=sw.order[start:].contiguous(),
                                               phase_ptr=(0, nb - start)), role)
    x, b = _rand(et.nrows_pad, dtype, 21), _rand(et.nrows_pad, dtype, 22)
    xl = torch.tensor(0.3, dtype=dtype, device="cuda")
    before = dict(gk.COUNTS)
    out = gk.stale_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    made = {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]}
    assert made == {role: 1}
    ref = gk.stale_sweep_plain(sw, x.clone(), xl, b)
    scale = (ref - x).abs().max() if kdt is not None else ref.abs().max()
    assert float((out - ref).abs().max()) <= tol * float(scale)
    assert torch.equal(out[: start * 128], x[: start * 128])
    if kdt is None:  # not the exact sweep: later blocks of a group read stale rows
        exact = gk.block_oneshot_sweep_plain(dataclasses.replace(sw, role="sweep6"),
                                             x.clone(), xl, b)
        assert float((exact - ref).abs().max()) > 30 * tol * float(scale)


def test_percolor_sweep_launches_a_color_each_and_matches_plain(et):
    """``sweep8_percolor``, the parent design of the colored sweep (one
    launch per color), kept as a timing role."""
    sw = _sweep(et, torch.float32, False, "sweep8_percolor")
    x, b = _rand(et.nrows_pad, torch.float32, 13), _rand(et.nrows_pad, torch.float32, 14)
    xl = torch.tensor(0.3, dtype=torch.float32, device="cuda")
    before = dict(gk.COUNTS)
    out = gk.block_oneshot_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        "sweep8_percolor": sw.nphases}
    ref = gk.block_oneshot_sweep_plain(sw, x.clone(), xl, b)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


FUSED_CASES = [(torch.float32, None, 1e-4), (torch.float64, None, 1e-11),
               (torch.float32, torch.bfloat16, 1e-2)]


@pytest.fixture(scope="module")
def bound_rows(et):
    """The compact fixture's rows (every 37th row, none reading another)
    over the fixture's padded row space, as a level's boundary table."""
    a = tell.ell_to_csr(et).tolil()
    a.resize((et.nrows_pad, et.nrows_pad))
    targets = np.arange(0, et.ncols, 37)
    for r in targets:
        for c in targets:
            if c != r:
                a[r, c] = 0.0
    table = _compact_from_rows(a.tocsr(), targets, block_rows=128)
    check_resolve_in_place(table)
    return table


def _fused_level(et, table, dtype, kdt, role):
    """The fixture's sweep of ``role`` (colored for sweep8, storage order for
    sweep7), a random Lagrange row and ``table`` as the boundary rows."""
    sw = _sweep(et, dtype, role == "sweep7", role, k_dtype=kdt)
    lag_row = _rand(et.nrows_pad, dtype, 15)
    bound = gk.device_compact(table, dtype, "cuda", "bound2")
    return sw, lag_row, bound


def _held(out, ref, x0, out_l, ref_l, xl0, kdt, tol):
    """Kernel vs plain within the sweep's tolerance: of max |plain x|, or,
    with bf16 K, of max |dx| (x_lag: of |plain x_lag|, or of its move)."""
    bf = kdt == torch.bfloat16
    scale = float((ref - x0).abs().max() if bf else ref.abs().max())
    assert float((out - ref).abs().max()) <= tol * scale
    scale_l = abs(float(ref_l - xl0)) if bf else abs(float(ref_l))
    assert abs(float(out_l - ref_l)) <= tol * scale_l


@pytest.mark.parametrize("role", ["sweep8", "sweep7"])
@pytest.mark.parametrize("iters", [1, 5])
@pytest.mark.parametrize("dtype,kdt,tol", FUSED_CASES, ids=["f32", "f64", "bf16k"])
def test_block_smooth_matches_plain(et, bound_rows, role, iters, dtype, kdt, tol):
    """One fused launch of ``iters`` sweeps with the Lagrange relax (x_lag
    0.3, b_lag -0.4) and the boundary re-solve against its plain version
    (the loop of plain sweeps, relax and re-solve); counted once; the input
    left alone; a rerun gives the same bits."""
    sw, lag_row, bound = _fused_level(et, bound_rows, dtype, kdt, role)
    x, b = _rand(et.nrows_pad, dtype, 16), _rand(et.nrows_pad, dtype, 17)
    x0 = x.clone()
    xl, bl = (torch.tensor(v, dtype=dtype, device="cuda") for v in (0.3, -0.4))
    args = (b, bl, iters, 1.4, lag_row, bound)
    before = dict(gk.COUNTS)
    out, out_l = gk.block_smooth(sw, x, xl, *args)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        role: 1}
    assert torch.equal(x, x0) and out_l.shape == ()
    ref, ref_l = gk.block_smooth_plain(sw, x, xl, *args)
    _held(out, ref, x0, out_l, ref_l, 0.3, kdt, tol)
    again, again_l = gk.block_smooth(sw, x, xl, *args)
    torch.cuda.synchronize()
    assert torch.equal(again, out) and torch.equal(again_l, out_l)
    grid, nk, ne, smem = gk.SMOOTH_INFO[role]
    assert (grid == 1) == (role == "sweep7") and nk in (1, 2) and ne in (0, 1, 2)
    coarse = dict(n_vec=et.nrows_pad, m=bound.m_pad) if role == "sweep7" else dict(
        cbytes=2, npx=sw.patches.pids.shape[1] * 128)
    assert smem == gk.smooth_smem_bytes(nk, ne, et.width, dtype, kdt or dtype, **coarse)


def test_colored_smooth_walks_a_color_larger_than_its_grid():
    """The bench pattern at 131,072 rows (1,024 blocks, ~200 a color):
    each CTA takes several blocks of a color; f32, 3 sweeps, no border."""
    from meshlessmultigridpoisson_torch import bench

    op = bench.build_operator(n=131072, k=20)
    A = gk.device_ell(op["ell"], torch.float32, "cuda", "spmv6")
    n = A.nrows_pad
    sw = _with_patches(gk.BlockSweep(
        A=A, kT=torch.from_numpy(op["kT"]).to("cuda", torch.float32),
        lagc=torch.zeros(n, device="cuda"),
        order=torch.from_numpy(op["order"].astype(np.int32)).cuda(),
        phase_ptr=op["phase_ptr"], serial=False, role="sweep8"))
    x, b = _rand(n, torch.float32, 18), _rand(n, torch.float32, 19)
    xl = torch.zeros((), device="cuda")
    out, _ = gk.block_smooth(sw, x, xl, b, None, 3)
    torch.cuda.synchronize()
    largest = max(q - p for p, q in zip(op["phase_ptr"], op["phase_ptr"][1:]))
    assert gk.SMOOTH_INFO["sweep8"][0] < largest
    ref, _ = gk.block_smooth_plain(sw, x, xl, b, None, 3)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_level_smooth_is_one_launch_on_the_card():
    """``gpu_backend.smooth`` on the Neumann slice's colored fine level and
    coarsest level (600/2500/5000, deg 4): one ``block_smooth`` launch a
    call, no ``bound2`` launch, the level's own relax and re-solve, and
    the same result as its plain version."""
    from meshlessmultigridpoisson_torch.mg import gpu_backend
    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem

    prob = make_poisson_problem("square_with_circle", [600, 2500, 5000], poly_deg=4,
                                neumann=True, block_rows=512, ordering="kdtile")
    for op, role in ((prob.hierarchy.levels[-1], "sweep8"), (prob.hierarchy.levels[0], "sweep7")):
        lv = gpu_backend.gpu_level_from_operator(op, "cuda")
        assert lv.sweep.role == role and lv.has_lagrange and lv.bound.nrows > 0
        x, b = _rand(lv.n_pad, torch.float32, 20), _rand(lv.n_pad, torch.float32, 21)
        xl, bl = torch.tensor(0.2, device="cuda"), torch.tensor(0.1, device="cuda")
        before = dict(gk.COUNTS)
        out, out_l = gpu_backend.smooth(lv, x, xl, b, bl)
        torch.cuda.synchronize()
        assert {k: gk.COUNTS[k] - before[k] for k in before
                if gk.COUNTS[k] != before[k]} == {role: 1}
        ref, ref_l = gk.block_smooth_plain(lv.sweep, x, xl, b, bl, lv.iters, lv.omega,
                                           lv.lag_row, lv.bound)
        _held(out, ref, x, out_l, ref_l, 0.2, None, 1e-4)


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
    """Role ppe2_scatter (the parent design of the PPE matvec's tail): y[r]
    = (C x)_i in place on y, sentinel slots write nothing, x is left alone;
    an output aliasing x is refused."""
    table, only_diag = compact
    C = gk.device_compact(table, dtype, "cuda", "ppe2_scatter")
    x, y = _rand(C.n_pad, dtype, 5), _rand(C.n_pad, dtype, 6)
    x0 = x.clone()
    before = gk.COUNTS["ppe2_scatter"]
    out = gk.compact_rows(C, x, y.clone())
    torch.cuda.synchronize()
    assert gk.COUNTS["ppe2_scatter"] == before + 1
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_ppe_tail_matches_plain_and_parent(compact, dtype, tol):
    """Role ppe2: the compatible matvec's tail in one launch (sum of the
    SpMVs, the boundary rows' products over it, x on the rows not live,
    the Lagrange column) against its plain version and the parent design's
    separate launches (``ppe2_scatter``): one launch each; the rows no
    boundary row targets bit-equal (elementwise, each product rounded on
    its own); the 93 sentinel slots write nothing; the inputs left alone."""
    table, only_diag = compact
    C = gk.device_compact(table, dtype, "cuda", "bound2")
    n = C.n_pad
    live = (torch.rand(n, generator=torch.Generator().manual_seed(29)) > 0.2).cuda()
    live[only_diag] = True
    T = gk.ppe_tail_table(C, live, _rand(n, dtype, 30))
    assert T.C.role == "ppe2" and T.C.vals is C.vals
    rows = table.rows[: table.nrows].long().cuda()
    assert torch.equal(T.slot[rows].long().cpu(), torch.arange(table.nrows))
    assert int((T.slot >= 0).sum()) == table.nrows  # sentinel slots: no row
    p, q, x = (_rand(n, dtype, s) for s in (31, 32, 33))
    ins = [v.clone() for v in (p, q, x)]
    xl = torch.tensor(0.7, dtype=dtype, device="cuda")
    before = dict(gk.COUNTS)
    y = gk.ppe_tail(T, p, q, x, xl)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        "ppe2": 1}
    assert all(torch.equal(a, b) for a, b in zip(ins, (p, q, x)))
    ref = gk.ppe_tail_loop(T, p, q, x, xl, plain=True)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= tol * scale
    off = torch.ones(n, dtype=torch.bool, device="cuda")
    off[rows] = False
    assert torch.equal(y[off], ref[off])
    want = 2.5 * x[only_diag] + T.lag_col[only_diag] * xl  # the diagonal-only row
    assert abs(float(y[only_diag] - want)) <= tol * scale
    before = dict(gk.COUNTS)
    parent = gk.ppe_tail_loop(T, p, q, x, xl)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        "ppe2_scatter": 1}
    assert float((parent - ref).abs().max()) <= tol * scale
    with pytest.raises(ValueError, match="ppe_tail"):
        gk.compact_rows(T.C, x, y)


def _cut_lens(C):
    """``C`` with each row's lens one short of its last nonzero."""
    return dataclasses.replace(C, lens=(C.lens - 1).clamp(min=0).contiguous())


@pytest.mark.parametrize("role", ["bound2", "push2"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_compact_rows_reads_to_lens(compact, role, dtype, tol):
    """Each row read to its ``lens``: with every lens cut one short of the
    row's last nonzero, the kernel drops that entry, as the plain version
    does (so the result moves off the full rows')."""
    table, _ = compact
    C = _cut_lens(gk.device_compact(table, dtype, "cuda", role))
    x, b = _rand(C.n_pad, dtype, 34), _rand(C.n_pad, dtype, 35)
    xin = x if role == "bound2" else b
    out = gk.compact_rows(C, xin.clone(), b)
    torch.cuda.synchronize()
    ref = gk.compact_rows_plain(C, xin.clone(), b)
    full = gk.compact_rows_plain(gk.device_compact(table, dtype, "cuda", role),
                                 xin.clone(), b)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol * scale
    assert float((full - ref).abs().max()) > 1e3 * tol * scale


def _pin(n_pad, dtype, targets, seed):
    """A Dirichlet pin over the fixture: every 5th row that is no boundary
    target, to random values."""
    mask = torch.zeros(n_pad, dtype=dtype)
    mask[::5] = 1.0
    mask[torch.as_tensor(targets).long()] = 0.0
    return mask.cuda(), _rand(n_pad, dtype, seed)


@pytest.mark.parametrize("role", ["sweep8", "sweep7"])
@pytest.mark.parametrize("dtype,kdt,tol", FUSED_CASES, ids=["f32", "f64", "bf16k"])
def test_block_smooth_fused_resolves_match_plain(et, bound_rows, role, dtype, kdt, tol):
    """The V-cycle's re-solves in the fused launch: before the first sweep
    the re-solve from the input x, then the pin (x unpinned on entry, so
    the pin's place shows); after the last one more re-solve; each alone
    and both, against the plain version (separate re-solves and
    ``torch.where``): one launch, no ``bound2``; a rerun gives the same
    bits.  Then the same with each boundary row's lens cut one short of
    its last nonzero: the fused re-solves read to lens too."""
    sw, lag_row, bound = _fused_level(et, bound_rows, dtype, kdt, role)
    n = et.nrows_pad
    pin = _pin(n, dtype, bound_rows.rows[: bound_rows.nrows], 26)
    x, b = _rand(n, dtype, 27), _rand(n, dtype, 28)
    xl, bl = (torch.tensor(v, dtype=dtype, device="cuda") for v in (0.3, -0.4))
    cases = [(bound, True, True), (bound, True, False), (bound, False, True),
             (_cut_lens(bound), True, True)]
    for table, first, last in cases:
        args = (b, bl, 2, 1.4, lag_row, table)
        kw = dict(start=pin if first else None, resolve_last=last)
        before = dict(gk.COUNTS)
        out, out_l = gk.block_smooth(sw, x, xl, *args, **kw)
        torch.cuda.synchronize()
        assert {k: gk.COUNTS[k] - before[k] for k in before
                if gk.COUNTS[k] != before[k]} == {role: 1}
        ref, ref_l = gk.block_smooth_plain(sw, x, xl, *args, **kw)
        _held(out, ref, x, out_l, ref_l, 0.3, kdt, tol)
        again, again_l = gk.block_smooth(sw, x, xl, *args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(again, out) and torch.equal(again_l, out_l)
    with pytest.raises(ValueError, match="in place"):
        gk.block_smooth(sw, x.clone(), xl, b, iters=1, inplace=True, start=pin)


def test_vcycle_launches_no_bound2_on_a_fused_fine_level():
    """``krylov._precond`` (one V-cycle from zero; the fine re-solves at its
    start and end) on the Neumann slice 600/2500/5000, deg 4, whose fine
    level is ``sweep8``: no ``bound2`` launch, one launch a smoother call,
    and the result of the plain flow on the CPU within 1e-4 of max (f32)."""
    from meshlessmultigridpoisson_torch.mg import gpu_backend, krylov, mixed
    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem

    prob = make_poisson_problem("square_with_circle", [600, 2500, 5000], poly_deg=4,
                                neumann=True, block_rows=512, ordering="kdtile")
    hd = {d: mixed.defect_hierarchy(gpu_backend.gpu_hierarchy(prob.hierarchy, d))
          for d in ("cuda", "cpu")}
    assert [lv.sweep.role for lv in hd["cuda"].levels] == ["sweep7", "sweep7", "sweep8"]
    fine = hd["cuda"].levels[-1]
    assert fine.has_lagrange and fine.bound.nrows > 0
    v = _rand(fine.n_pad, torch.float32, 36)
    vl = torch.tensor(0.05, device="cuda")
    before = dict(gk.COUNTS)
    z, zl = krylov._precond(hd["cuda"], v, vl)
    torch.cuda.synchronize()
    made = {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]}
    assert made.get("bound2", 0) == 0 and made["sweep8"] == 2 and made["sweep7"] == 4, made
    zc, zlc = krylov._precond(hd["cpu"], v.cpu(), vl.cpu())
    assert float((z.cpu() - zc).abs().max()) <= 1e-4 * float(zc.abs().max())
    assert abs(float(zl) - float(zlc)) <= 1e-4 * max(abs(float(zlc)), 1e-30)


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


def _class_sweep(case, dtype, et):
    """A ClassSweep with frozen rows, per-row omega and a Lagrange column:
    "fixture" (the kd-tile pattern above), "real" (the probe's pattern at
    4,096 rows), "level" (the fine level of a small square solve)."""
    if case == "level":
        from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_level_from_operator
        from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem

        op = make_poisson_problem("square", sizes=[170, 600], poly_deg=3).hierarchy.finest
        return gpu_level_from_operator(op, "cuda", dtype, use_v6=False).sweep
    if case == "real":
        from meshlessmultigridpoisson_torch.probes.realsparsity import real_pattern_csr

        ell = tell.ell_from_csr(real_pattern_csr(4096), block_rows=128)
    else:  # the fixture padded to a square operator with identity rows
        a = tell.ell_to_csr(et)
        pad = et.nrows_pad - a.shape[0]
        ell = tell.ell_from_csr(sp.block_diag([a, sp.identity(pad)], format="csr"),
                                block_rows=128)
    n_pad = ell.nrows_pad
    omega = np.full(n_pad, 1.4)
    omega[::5] = 1.0
    smask = np.ones(n_pad)
    smask[::7] = 0.0
    return gk.class_sweep(gk.device_ell(ell, dtype, "cuda", "spmv2"), ell.diag, smask,
                          omega, np.full(n_pad, 0.01), role="sweep2")


@pytest.mark.parametrize("role", ["sweep2", gk.CLASS_PARENT])
@pytest.mark.parametrize("case", ["fixture", "real", "level"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
def test_class_sor_sweep_matches_plain(et, case, dtype, tol, role):
    """The window kernel (``sweep2``) and the parent design
    (``sweep2_tilewalk``): one launch counted under the role, the sweep's
    tolerance, frozen rows bit-equal to the input."""
    sw = dataclasses.replace(_class_sweep(case, dtype, et), role=role)
    n = sw.A.nrows_pad
    x, b = _rand(n, dtype, 12), _rand(n, dtype, 13)
    xl = torch.tensor(0.3, dtype=dtype, device="cuda")
    before = dict(gk.COUNTS)
    out = gk.class_sor_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        role: 1}
    ref = gk.class_sor_sweep_plain(sw, x.clone(), xl, b)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    frozen = sw.mask == 0
    assert bool(frozen.any()) and torch.equal(out[frozen], x[frozen])


@pytest.mark.parametrize("class_size", [8, 4, 16, 32, 1, 2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
def test_class_sor_sweep_windows_and_tile_sizes(class_size, dtype, tol):
    """The window kernel on the real pattern (4,096 rows: 32 windows of
    128 rows) at tile sizes 1-32 (32 to 1 chain lanes a row) against its
    plain version, with frozen rows; the ring depth and shared bytes
    reported."""
    from meshlessmultigridpoisson_torch.probes.realsparsity import real_pattern_csr

    ell = tell.ell_from_csr(real_pattern_csr(4096), block_rows=128)
    n = ell.nrows_pad
    smask = np.ones(n)
    smask[::7] = 0.0
    sw = gk.class_sweep(gk.device_ell(ell, dtype, "cuda", "spmv2"), ell.diag, smask,
                        np.full(n, 1.2), np.full(n, 0.01), class_size=class_size)
    assert n // sw.window > 1 and int(sw.seg.max()) > 0
    x, b = _rand(n, dtype, 14), _rand(n, dtype, 15)
    xl = torch.tensor(-0.2, dtype=dtype, device="cuda")
    out = gk.class_sor_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    ref = gk.class_sor_sweep_plain(sw, x.clone(), xl, b)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(out[sw.mask == 0], x[sw.mask == 0])
    slots, nbytes, tiles = gk.CLASS_INFO["sweep2"]
    assert 2 <= slots <= 32 and 0 < nbytes <= 232448 and 1 <= tiles * class_size <= 128


def test_class_sor_sweep_refuses_tiles_over_32_rows(et):
    sw = dataclasses.replace(_class_sweep("real", torch.float32, et), class_size=64)
    x = _rand(sw.A.nrows_pad, torch.float32, 16)
    with pytest.raises(ValueError, match="tiles of 1-32 rows"):
        gk.class_sor_sweep(sw, x, torch.tensor(0.0, device="cuda"), x.clone())


def test_cli_solve_v2_fallback_on_card():
    """``use_v6=False``: every level on the class sweep and the v2 matvec,
    the transfers on the v6 SpMV; the solve reaches its tolerance, and
    ``--profile`` gives the v2 levels' per-level table."""
    from meshlessmultigridpoisson_torch.apps import cli

    argv = ["solve", "--device", "cuda", "--geom", "square_with_circle",
            "--sizes", "600", "2500", "5000", "--deg", "4", "--ordering", "kdtile",
            "--block-rows", "512", "--tol", "1e-10"]
    rec, *_ = cli.run_solve(argv + ["--profile"], use_v6=False)
    assert rec.final_residual < 1e-10 and rec.l1_error < 1e-6
    assert rec.extra["level_kernels"] == ["v2-fallback"] * 3
    assert rec.extra["level_k_dtypes"] == [None] * 3
    launches = rec.extra["launches"]
    assert all(launches[r] > 0 for r in ("sweep2", "spmv2", "spmv6")), launches
    assert all(launches[r] == 0 for r in ("sweep6", "sweep7", "sweep8", "spmv8")), launches
    rows = rec.extra["per_level"]  # --profile takes v2 levels
    assert [r["kernel"] for r in rows] == ["v2-fallback"] * 3
    assert all(0 < r["sweep_bound_ms"] <= r["sweep_ms"] for r in rows)


def test_ktime_probe_on_card():
    """The kernel-generation probe at a small size: every role launched,
    each kernel held against its plain version inside the probe."""
    from meshlessmultigridpoisson_torch.probes import ktime

    gk.reset_counts()
    res = ktime.run(n=16384, iters=2)
    assert all(gk.COUNTS[r] > 0 for r in ("spmv2", "sweep2", "spmv4", "sweep4", "sweep5"))
    assert set(res["kernels"]) == {"spmv v2 (br=128)", "sweep v2 (br=128)",
                                   "sweep v2 (br=128) parent", "spmv v2 (br=256)",
                                   "sweep v2 (br=256)", "sweep v2 (br=256) parent",
                                   "spmv v4", "sweep v4", "sweep v5"}
    assert gk.COUNTS[gk.CLASS_PARENT] > 0
    assert all(0 < r["bound_ms"] <= 1.05 * r["ms"] for r in res["kernels"].values())


@pytest.mark.parametrize("role", ["spmv1", "spmv3"])
def test_kexp_spmv_roles_count_and_match_plain(et, role):
    """Kernels 8 and 10 are roles of ``ell_spmv``: one launch counted under
    the role, the SpMV's tolerance."""
    A = gk.device_ell(et, torch.float32, "cuda", role)
    x = _rand(et.ncols, torch.float32, 21)
    before = dict(gk.COUNTS)
    y = gk.ell_spmv(A, x)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        role: 1}
    yp = gk.ell_spmv_plain(A.vals, A.cols, x)
    assert float((y - yp).abs().max()) <= 1e-5 * float(yp.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
def test_sweep1_role_counts_and_matches_plain(et, dtype, tol):
    """Kernel 9 is a role of ``class_sor_sweep`` on the unpermuted real
    pattern (rows of one tile couple)."""
    from dataclasses import replace

    sw = replace(_class_sweep("real", dtype, et), role="sweep1")
    n = sw.A.nrows_pad
    x, b = _rand(n, dtype, 22), _rand(n, dtype, 23)
    xl = torch.tensor(0.3, dtype=dtype, device="cuda")
    before = dict(gk.COUNTS)
    out = gk.class_sor_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        "sweep1": 1}
    ref = gk.class_sor_sweep_plain(sw, x.clone(), xl, b)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("mode", sorted(gk.PROBE_MODES))
def test_sweep_probe_modes_count_and_match_plain(mode):
    """Each timing mode of ``storage_chain`` against its plain version on
    the bench operator at 16,384 rows (128 blocks, 16 hoisted groups);
    ``probe_base`` is the production chain (``sweep6``), bit for bit."""
    from meshlessmultigridpoisson_torch import bench
    from meshlessmultigridpoisson_torch.probes import ksweepprobe

    op = bench.build_operator(n=16384)
    sw = ksweepprobe.probe_sweep(op, mode, "cuda")
    x, b = _rand(16384, torch.float32, 24), _rand(16384, torch.float32, 25)
    xl = torch.tensor(0.0, device="cuda")
    before = dict(gk.COUNTS)
    out = gk.sweep_probe(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        mode: 1}
    ref = gk.sweep_probe_plain(sw, x.clone(), xl, b)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    if mode == "probe_base":
        from dataclasses import replace

        prod = gk.block_oneshot_sweep(replace(sw, role="sweep6"), x.clone(), xl, b)
        assert torch.equal(prod, out)


def test_kexp_and_ksweepprobe_on_card():
    """Both probes at a small size: every role launched, each kernel held
    against its plain version inside the probe, times at or above bound."""
    from meshlessmultigridpoisson_torch import bench
    from meshlessmultigridpoisson_torch.probes import kexp, ksweepprobe

    op = bench.build_operator(n=16384)
    gk.reset_counts()
    res = kexp.run(n=16384, iters=2, a=op["a"])
    assert all(gk.COUNTS[r] > 0 for r in ("spmv1", "spmv2", "spmv3", "sweep1"))
    assert len(res["kernels"]) == 7 and set(res["blocks"]) == {128, 256}
    gk.reset_counts()
    res2 = ksweepprobe.run(iters=2, op=op)
    assert all(gk.COUNTS[r] > 0 for r in gk.PROBE_MODES)
    assert set(res2["split_per_block"]) == {"gather_us", "k_product_us", "base_us",
                                            "hoist_us"}
    for r in [*res["kernels"].values(), *res2["kernels"].values()]:
        assert 0 < r["bound_ms"] <= 1.05 * r["ms"]


@pytest.mark.parametrize("role", [r for r in gk.STREAM_ROLES if r != "stream14"])
@pytest.mark.parametrize("reps", [1, 3])
def test_stream_probe_roles_count_and_match_plain(role, reps):
    """Each table mix at 1,024-row tiles (64-row tiles for kprobe's role,
    its smallest), exact on small integers, one launch counted."""
    from meshlessmultigridpoisson_torch.probes import kstream

    mix = gk.STREAM_ROLES[role]
    tpp = 64 if role == "kprobe_stream" else 1024
    v, c = kstream.tables(mix, 8 * 1024, "cuda", seed=3)
    before = dict(gk.COUNTS)
    out = gk.stream_probe(v, c, role, tpp, reps)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        role: 1}
    assert 1 <= gk.STREAM_CTAS[role] <= v.shape[0] // tpp
    assert torch.equal(out, gk.stream_probe_plain(v, c, mix, tpp))


@pytest.mark.parametrize("mode", sorted(gk.SPMV_PROBE_MODES))
def test_spmv_probe_modes_count_and_match_plain(et, mode):
    """Each mode against its plain version; ``spmvp_base`` is the
    production SpMV bit for bit."""
    A0 = gk.device_ell(et, torch.float32, "cuda", "spmv6")
    A = gk.spmv_probe_ell(A0, mode)
    x = _rand(A.ncols, torch.float32, 26)
    before = dict(gk.COUNTS)
    out = gk.spmv_probe(A, x)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        mode: 1}
    ref = gk.spmv_probe_plain(A, x)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    if mode == "spmvp_base":
        assert torch.equal(out, gk.ell_spmv(A0, x))


def test_stream_probes_on_card():
    """The three probes, the SpMV at a small size (the streams at theirs:
    smaller tables would stay in L2 between passes and beat the memory
    bound): every role launched, each kernel held against its plain version
    inside the probe, times at or above bound."""
    from meshlessmultigridpoisson_torch.probes import chaintime, kprobe, kstream

    gk.reset_counts()
    res = [kstream.run(), kprobe.run(n=16384, iters=2), chaintime.run()]
    roles = [r for r in gk.COUNTS if r.startswith(("kstream_", "spmvp_"))]
    assert all(gk.COUNTS[r] > 0 for r in roles + ["kprobe_stream", "chain_stream"])
    assert len(res[0]["kernels"]) == 13 and len(res[1]["kernels"]) == 8
    assert set(res[1]["spmv_split"]) == {"base_ms", "gather_ms", "reduction_ms",
                                         "neither_ms"}
    for r in [row for p in res for row in p["kernels"].values()]:
        assert 0 < r["bound_ms"] <= 1.05 * r["ms"]


@pytest.mark.parametrize("role", sorted(gk.KISO_ROLES))
def test_kiso_roles_count_and_match_plain(et, role):
    """Each role once on the fixture (11 blocks; the kiso6 id tables pad to
    16): every output row, padded blocks included, against the plain
    version; guarded padded blocks keep what ``out`` held, unguarded ones
    hold block 0's rows."""
    A = gk.device_kiso(et, "cuda", role)
    x = _rand(A.ncols, torch.float32, 27)
    out = torch.full((A.nrows_out,), 7.0, device="cuda")
    before = dict(gk.COUNTS)
    gk.kiso_spmv(A, x, out=out)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        role: 1}
    ref = gk.kiso_spmv_plain(A, x, out=torch.full_like(out, 7.0))
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    if role in gk.KISO_PADDED_IDS:
        pad = out[et.nrows_pad:]
        assert pad.numel() == 5 * 128
        want = (torch.full_like(pad, 7.0) if role in gk.KISO_GUARDED
                else out[:128].repeat(5))
        assert torch.equal(pad, want)
    y = gk.kiso_spmv(A, x)
    assert y.shape == (et.nrows_pad,)
    if role in ("kiso7_affine", "kiso8_vpu"):  # the parent production instance
        A0 = gk.rowwarp_ell(gk.device_ell(et, torch.float32, "cuda", "spmv6"))
        assert torch.equal(y, gk.ell_spmv(A0, x))


@pytest.mark.parametrize("width", [8, 32, 64, 72, 104, 1024])
@pytest.mark.parametrize("role", sorted(gk.KISO_MMA))
def test_rowsum_mma_widths_match_plain(role, width):
    """``ell_rowsum_mma`` (production and parent ``_v1`` roles) at widths
    that are multiples of 8 other than the kiso operator's 72: width / 8
    odd (the staged design's two bulk copies a warp) and even (a copy a
    row into rows of width + 8), 1024 (fewer warps a CTA, to fit shared
    memory), over 4,112 rows (a last CTA with one warp of rows)."""
    n, ncols = 4112, 5000
    g = torch.Generator().manual_seed(width)
    cols = torch.randint(0, ncols, (n, width), generator=g, dtype=torch.int32)
    vals = torch.randn(n, width, generator=g)
    vals[::7, width // 2:] = 0.0  # rows with trailing padding
    A = gk.KisoEll(vals=vals.cuda(), cols=cols.cuda(), col_base=None, ids=None,
                   ncols=ncols, role=role)
    x = _rand(ncols, torch.float32, 29)
    before = gk.COUNTS[role]
    y = gk.kiso_spmv(A, x)
    torch.cuda.synchronize()
    assert gk.COUNTS[role] == before + 1
    ref = gk.kiso_spmv_plain(A, x)
    assert y.shape == ref.shape == (n,)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_ell_spmv_production_width_not_a_multiple_of_8(dtype, tol):
    """The production instances after the kiso axes: the kiso operator's
    width (70 entries a row at most) is no multiple of 8."""
    from meshlessmultigridpoisson_torch.probes import kiso

    ell = kiso.build_operator(n=4096)
    assert ell.width % 8 != 0
    A = gk.device_ell(ell, dtype, "cuda", "spmv6")
    x = _rand(A.ncols, dtype, 28)
    y = gk.ell_spmv(A, x)
    yp = gk.ell_spmv_plain(A.vals, A.cols, x)
    assert float((y - yp).abs().max()) <= tol * float(yp.abs().max())


def test_kiso_probes_on_card():
    """The three kiso probes at a small size on one shared operator: every
    role launched, each held against its plain version inside the probe,
    times at or above bound."""
    from meshlessmultigridpoisson_torch.probes import kiso, kiso6, kiso7, kiso8

    ell = kiso.build_operator(n=16384)
    gk.reset_counts()
    res = [p.run(n=16384, iters=2, ell=ell) for p in (kiso6, kiso7, kiso8)]
    assert all(gk.COUNTS[r] > 0 for r in list(gk.KISO_ROLES) + ["spmv4"])
    assert [len(r["kernels"]) for r in res] == [4, 3, 5]
    assert res[0]["padded_blocks"] == 0 and res[0]["max_block_span"] <= gk.U16_MAX_SPAN
    for r in [row for p in res for row in p["kernels"].values()]:
        assert 0 < r["bound_ms"] <= 1.05 * r["ms"]


def _ragged(et, seed=31):
    """``et`` with rows of mixed lengths, as condensation leaves a Neumann
    level: every third row keeps a random prefix of its entries (the rest
    zero, trailing), and one interior weight of row 1 is exactly zero."""
    vals = et.vals.clone()
    rng = np.random.default_rng(seed)
    for r in range(0, et.nrows, 3):
        vals[r, int(rng.integers(1, et.width)):] = 0.0
    vals[1, 1] = 0.0
    return dataclasses.replace(et, vals=vals)


# rows of a table -> rows a warp the launcher gives it: 16 (a CTA a
# 128-row block) from 264 such CTAs (33,792 rows), else 8, 4, 2, 1
SPMV_TABLES = {"fixture": 1, "6k": 2, "16k": 4, "24k": 8, "36k": 16}


@pytest.mark.parametrize("table", list(SPMV_TABLES))
@pytest.mark.parametrize("u16", [False, True], ids=["i32", "u16"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_ell_spmv_reads_to_lens_and_matches_plain_and_parent(et, dtype, tol, u16, table):
    """The redesigned ``ell_spmv`` (each row read to ``lens``, i32 or u16
    columns) against its plain version, the every-entry plain gather and
    the parent design (``spmv_rowwarp``); one launch of each counted under
    its role.  The tables run every mapping of the launcher: the fixture
    (1,408 rows) one row a warp, the kiso probe's operator at 6,144 /
    16,384 / 24,576 / 36,864 rows two, four, eight and sixteen (a CTA a
    128-row block, as every table of 33,792 rows or more)."""
    if table != "fixture":
        from meshlessmultigridpoisson_torch.probes import kiso

        et = kiso.build_operator(n=int(table[:-1]) * 1024)
    n = et.nrows_pad
    rpw = next(r for r in (16, 8, 4, 2) if -(-n // (8 * r)) >= 264) if n >= 4224 else 1
    assert rpw == SPMV_TABLES[table]
    ell = _ragged(et)
    A = gk.device_ell(ell, dtype, "cuda", "spmv6", u16=u16)
    assert A.col_format == ("u16" if u16 else "i32")
    assert int(A.lens[1]) == int(gk.row_lens(et.vals[1:2].to(dtype))[0]) > 2
    x = _rand(A.ncols, dtype, 32)
    before = dict(gk.COUNTS)
    y = gk.ell_spmv(A, x)
    yr = gk.ell_spmv(gk.rowwarp_ell(A), x)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        "spmv6": 1, "spmv_rowwarp": 1}
    yp = gk.ell_spmv_lens_plain(A, x)
    scale = float(yp.abs().max())
    for other in (yp, gk.ell_spmv_plain(A.vals, A.global_cols(), x), yr):
        assert float((y - other).abs().max()) <= tol * scale


@pytest.mark.parametrize("width", [28, 72])
@pytest.mark.parametrize("dtype,kdt,tol", FUSED_CASES, ids=["f32", "f64", "bf16k"])
def test_storage_chain_matches_plain_and_parent(et, dtype, kdt, tol, width):
    """The redesigned storage-order chain (``sweep6``: K staged ahead, ELL
    rows prefetched, each row read to ``lens``) on rows of mixed lengths
    against its plain version and the parent chain (``sweep6_chain``), one
    launch each; the ELL tile staged in shared memory where it fits beside
    the K tile (``CHAIN_INFO``): at 28 entries a row in every dtype, at 72
    in f32 and bf16 K but not beside f64's 128 KB K tile."""
    ell = _ragged(et if width == 28 else _knn_ell(width), seed=33)
    sw = _sweep(ell, dtype, True, "sweep6", k_dtype=kdt)
    parent = dataclasses.replace(sw, role="sweep6_chain")
    n = ell.nrows_pad
    x, b = _rand(n, dtype, 34), _rand(n, dtype, 35)
    xl = torch.tensor(0.3, dtype=dtype, device="cuda")
    before = dict(gk.COUNTS)
    out = gk.block_oneshot_sweep(sw, x.clone(), xl, b)
    par = gk.block_oneshot_sweep(parent, x.clone(), xl, b)
    torch.cuda.synchronize()
    assert {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]} == {
        "sweep6": 1, "sweep6_chain": 1}
    # shared bytes: mbarriers, the K tile, t and the partial sums, and the
    # ELL tile (values and columns, each 128-byte aligned) where it fits
    vs = torch.empty(0, dtype=dtype).element_size()
    ks = torch.empty(0, dtype=kdt or dtype).element_size()
    base = 128 + 128 * 128 * ks + 128 * vs + 512 * vs
    ell_tile = sum(-(-128 * ell.width * e // 128) * 128 for e in (vs, 4))
    fits = base + ell_tile <= gk.SMEM_OPTIN
    assert fits == (width == 28 or dtype != torch.float64)
    assert gk.CHAIN_INFO["sweep6"] == ((1, base + ell_tile) if fits else (0, base))
    ref = gk.block_oneshot_sweep_plain(sw, x.clone(), xl, b)
    scale = float((ref - x).abs().max() if kdt is not None else ref.abs().max())
    assert float((out - ref).abs().max()) <= tol * scale
    assert float((out - par).abs().max()) <= tol * scale
    again = gk.block_oneshot_sweep(sw, x.clone(), xl, b)
    assert torch.equal(again, out)  # one CTA, a fixed order: the same bits


@pytest.mark.parametrize("neumann", [False, True], ids=["dirichlet", "neumann"])
def test_single_grid_probe_f64_class_sweep_matches_plain(neumann):
    """``single_grid_probe`` on the probe's level (square, 600 points, deg 4,
    one level) repacked in f64 as a v2 level: 50 sweeps, each a
    ``class_sor_sweep`` launch and an ``ell_spmv`` residual, against the
    same level's plain versions on the CPU and the host f64 probe, the
    histories within 1e-10 relative."""
    from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_level_from_operator
    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem
    from meshlessmultigridpoisson_torch.ops.smoothers import apply_dirichlet, single_grid_probe

    prob = make_poisson_problem("square", [600], poly_deg=4, neumann=neumann)
    op = prob.hierarchy.finest
    x0 = apply_dirichlet(op, prob.state0.x[-1], coarse=False)
    b = prob.state0.b[-1]
    hists = {}
    for d in ("cuda", "cpu"):
        lv = gpu_level_from_operator(op, d, dtype=torch.float64, use_v6=False)
        assert lv.kernel_kind == "v2-fallback"
        before = dict(gk.COUNTS)
        x, hists[d] = single_grid_probe(lv, x0.to(d), b.to(d), sweeps=50)
        made = {k: gk.COUNTS[k] - before[k] for k in ("sweep2", "spmv2")}
        assert made == ({"sweep2": 50, "spmv2": 50} if d == "cuda"
                        else {"sweep2": 0, "spmv2": 0}), made
    _, hists["host"] = single_grid_probe(op, x0, b, sweeps=50)
    h = hists["cuda"].cpu().numpy()
    for ref in ("cpu", "host"):
        r = hists[ref].numpy()
        assert np.max(np.abs(h - r) / np.abs(r)) <= 1e-10, ref


@pytest.mark.parametrize("role", ["sweep2", gk.CLASS_PARENT])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
def test_class_sor_sweep_rectangular_matches_plain(dtype, tol, role):
    """The class sweep of the first 1,024 rows of the real pattern's 4,096
    (a shard's frontier rows over its extended vector): the rows past 1,024
    are read, never written; one launch; the sweep's tolerance; frozen
    rows bit-equal."""
    from meshlessmultigridpoisson_torch.probes.realsparsity import real_pattern_csr

    ell = tell.ell_from_csr(real_pattern_csr(4096)[:1024], block_rows=128, ncols=4096)
    n = ell.nrows_pad
    assert n == 1024 and ell.ncols == 4096
    smask = np.ones(n)
    smask[::7] = 0.0
    sw = gk.class_sweep(gk.device_ell(ell, dtype, "cuda", "spmv2"), ell.diag, smask,
                        np.full(n, 1.3), np.full(n, 0.01), role=role)
    x, b = _rand(4096, dtype, 20), _rand(n, dtype, 21)
    xl = torch.tensor(0.3, dtype=dtype, device="cuda")
    before = gk.COUNTS[role]
    out = gk.class_sor_sweep(sw, x.clone(), xl, b)
    torch.cuda.synchronize()
    assert gk.COUNTS[role] == before + 1
    ref = gk.class_sor_sweep_plain(sw, x.clone(), xl, b)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(out[n:], x[n:])
    frozen = torch.nonzero(sw.mask == 0).flatten()
    assert torch.equal(out[frozen], x[frozen])
    assert int(sw.seg.max()) > 0 and int((sw.A.global_cols() >= n).sum()) > 0


@pytest.mark.parametrize("neumann", [False, True], ids=["dirichlet", "neumann"])
def test_shard_levels_kernels_match_plain(neumann):
    """Every shard of both sharded levels of a 2-way partition (square,
    600/2500, deg 4, ``shard_levels=2``): the frontier class sweep over
    x_ext, the interior pass, the ext matvec and the ext re-solve on the
    card against the same tables' plain versions on the CPU, f32 and f64,
    each a launch of its role."""
    import itertools

    from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem
    from meshlessmultigridpoisson_torch.parallel import sharded as sh
    from meshlessmultigridpoisson_torch.parallel.partition import partition_hierarchy

    prob = make_poisson_problem("square", sizes=[600, 2500], poly_deg=4, neumann=neumann)
    shier = partition_hierarchy(prob.hierarchy, 2, shard_levels=2)
    assert all(level.frontier_rows for level in shier.sharded)
    for level, s in itertools.product(shier.sharded, range(2)):
        f = level.shard(s)
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-11)):
            lv = {d: sh.shard_level(f, d, dtype, colored=False) for d in ("cuda", "cpu")}
            x = _rand(f.ext_rows, dtype, 30 + s)
            b = _rand(f.shard_rows, dtype, 40 + s)
            xl = torch.tensor(0.2, dtype=dtype)

            def run(d):
                L = lv[d]
                xe = x.to(d).clone()
                gk.class_sor_sweep(L.front, xe, xl.to(d), b[:f.frontier_rows].to(d))
                xo = sh.interior_sweep(L, xe[:f.shard_rows].clone(), xl.to(d), b.to(d))
                y = gk.ell_spmv(L.A, xe)
                bb = torch.zeros(f.ext_rows, dtype=dtype, device=d)
                bb[:f.shard_rows] = b.to(d)
                xr = gk.compact_rows(L.bound, xe.clone(), bb)
                return [t.cpu() for t in (xe, xo, y, xr)]

            before = dict(gk.COUNTS)
            got = run("cuda")
            torch.cuda.synchronize()
            made = {k: gk.COUNTS[k] - before[k] for k in before if gk.COUNTS[k] != before[k]}
            want = {"sweep2": 1, "sweep6": 1, "spmv6": 1}
            if neumann and lv["cuda"].bound.nrows:
                want["bound2"] = 1
            assert made == want, made
            for name, g, r in zip(("frontier", "interior", "spmv", "resolve"), got,
                                  run("cpu")):
                assert float((g - r).abs().max()) <= tol * float(r.abs().max()), name
