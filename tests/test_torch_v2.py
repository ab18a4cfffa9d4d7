"""The port's v2-fallback path and the kernel-generation probe's kernels held
against the reference package, on the CPU.

* (a) A ``use_v6=False`` level of the small Neumann slice
  (``square_with_circle``, sizes 600/2500, deg 4, kd-tile, 512-row blocks;
  its coarsest level of 1,024 rows, with a Lagrange border and boundary
  rows): one ``GpuLevel.smooth`` sweep (class SOR, plain version) against
  ``tpu_backend.smooth`` over ``sor_sweep_tpu2`` in interpret mode, with
  non-zero ``x_lag`` and ``b_lag``; ``GpuLevel.matvec`` (role ``spmv2``)
  against ``tpu_backend.matvec`` over ``spmv_tpu2``.
* (b) The f64 plain class sweep is ``ops/smoothers._gs_sweep`` (1e-12) and
  the storage-order one-shot sweep (1e-10): one function.
* (c) On ``probes.realsparsity.real_pattern_csr(4096)`` (the reference
  probe's operator, 128-row blocks, unpermuted: rows of one 8-row tile
  couple) the plain class sweep against ``sor_sweep_tpu2`` and
  ``sor_sweep_tpu4``, the plain one-shot sweep against ``sor_sweep_tpu5``
  and ``ell_spmv_plain`` against ``spmv_tpu4``, all in interpret mode; a
  sweep that writes each row before the next one gathers misses them.
* (d) ``v6_supported`` raises and accepts as ``prepare_kernel_ell6`` does,
  and the level kinds and transfer roles follow ``tpu_level_from_operator``
  / ``tpu_hierarchy`` (``use_v6=None``) on operators whose 128-row block
  reads 256 or 257 x patches; under the colored sweep order the kinds
  follow ``prepare_colored_sweep``'s refusals (``colored_refusal``).
* (e) The port's CPU solve with ``use_v6=False`` on the small Dirichlet
  slice (600/2500/5000) against the reference CLI's CPU solve.

Tolerances: f32 against the interpret-mode kernels 3e-4 x max |output|,
the reference's own bound for its kernels (measured: 1.2e-7 to 5.1e-7);
f64 identities 1e-12 / 1e-10 relative (the same arithmetic in another
summation order; the one-shot sweep inverts M, 1e-10); (e) both residuals
< 1e-10, L1 errors within 5%, solutions within 1e-6 relative L1.
"""

import argparse
import dataclasses
import importlib.util
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.mg import tpu_backend as tb
from meshlessmultigridpoisson_tpu.mg.vcycle import Hierarchy as JHierarchy
from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake
from meshlessmultigridpoisson_tpu.ops import ell as jell
from meshlessmultigridpoisson_tpu.ops import kernels as K2
from meshlessmultigridpoisson_tpu.ops import kernels4 as K4
from meshlessmultigridpoisson_tpu.ops import kernels6 as K6
from meshlessmultigridpoisson_tpu.ops.kernels4 import Ell4Unsupported
from meshlessmultigridpoisson_tpu.stencil import operators as jops

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.mg import gpu_backend
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.ops import smoothers as sm
from meshlessmultigridpoisson_torch.probes import ktime, realsparsity
from meshlessmultigridpoisson_torch.utils import profiling as pf
from test_torch_native import ensure_native_geometry

# the test workers share the host's cores with the JAX test files: one
# intra-op thread per process keeps torch's thread pool from contending
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 3e-4
SLICE = dict(geom="square_with_circle", sizes=[600, 2500, 5000], deg=4,
             ordering="kdtile", block_rows=512, tol=1e-10)


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


def _close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# (a), (b): the small Neumann slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def neumann():
    """(reference TpuLevel of the coarsest level with use_v6=False, the
    port's host hierarchy on the same operators)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pj = jmake("square_with_circle", sizes=SLICE["sizes"][:2], poly_deg=4,
                   ordering="kdtile", block_rows=512, neumann=True)
    tl = tb.tpu_level_from_operator(pj.hierarchy.levels[0], use_v6=False)
    return tl, interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy))


@pytest.fixture(scope="module")
def v2_coarse(neumann):
    tl, ht = neumann
    gl = gpu_backend.gpu_level_from_operator(ht.levels[0], "cpu", use_v6=False)
    assert gl.kernel_kind == tl.kernel_kind == "v2-fallback"
    assert isinstance(gl.sweep, gk.ClassSweep) and gl.sweep.role == "sweep2"
    assert gl.A.role == "spmv2" and gl.n_pad == 1024
    assert gl.has_lagrange and gl.bound.nrows > 0
    return tl, gl


def _f32(rng, n):
    return rng.standard_normal(n).astype(np.float32)


def test_v2_level_smooth_matches_tpu_backend_smooth(v2_coarse):
    tl, gl = v2_coarse
    rng = np.random.default_rng(51)
    x, b = _f32(rng, gl.n_pad), _f32(rng, gl.n_pad)
    xl, bl = np.float32(0.37), np.float32(-0.81)
    with pltpu.force_tpu_interpret_mode():
        rx, rxl = tb.smooth(tl, jnp.asarray(x), jnp.asarray(xl), jnp.asarray(b),
                            jnp.asarray(bl), iters=1)
    rx, rxl = np.asarray(rx), float(rxl)
    before = dict(gk.COUNTS)
    px, pxl = gpu_backend.smooth(gl, torch.from_numpy(x), torch.tensor(xl),
                                 torch.from_numpy(b), torch.tensor(bl), iters=1)
    assert gk.COUNTS == before  # CPU tensors: the plain versions, no launch
    _close(px.numpy(), rx, F32_TOL)
    assert abs(float(pxl) - rxl) <= F32_TOL * abs(rxl)
    assert np.abs(px.numpy() - x).max() > 0.1 * np.abs(x).max()  # it moved


def test_v2_level_matvec_matches_spmv_tpu2(v2_coarse):
    tl, gl = v2_coarse
    rng = np.random.default_rng(52)
    x, xl = _f32(rng, gl.n_pad), np.float32(-1.3)
    with pltpu.force_tpu_interpret_mode():
        ry, ryl = tb.matvec(tl, jnp.asarray(x), jnp.asarray(xl))
    py, pyl = gpu_backend.matvec(gl, torch.from_numpy(x), torch.tensor(xl))
    _close(py.numpy(), np.asarray(ry), F32_TOL)
    assert abs(float(pyl) - float(ryl)) <= F32_TOL * abs(float(ryl))


@pytest.mark.parametrize("level", [0, 1], ids=["coarsest", "fine"])
def test_class_sweep_f64_is_gs_sweep_and_storage_order_oneshot(neumann, level):
    op = neumann[1].levels[level]
    g2 = gpu_backend.gpu_level_from_operator(op, "cpu", torch.float64, use_v6=False)
    g6 = gpu_backend.gpu_level_from_operator(op, "cpu", torch.float64,
                                             sweep_order="exact")
    assert g6.sweep.serial and g2.kernel_kind == "v2-fallback"
    rng = np.random.default_rng(60 + level)
    x, b = rng.standard_normal(op.n_pad), rng.standard_normal(op.n_pad)
    xl = 0.37
    ref = sm._gs_sweep(op, torch.from_numpy(x), xl, torch.from_numpy(b)).numpy()

    def run(sweep, sw):
        return sweep(sw, torch.from_numpy(x.copy()), torch.tensor(xl, dtype=torch.float64),
                     torch.from_numpy(b)).numpy()

    _close(run(gk.class_sor_sweep, g2.sweep), ref, 1e-12)
    _close(run(gk.block_oneshot_sweep, g6.sweep), ref, 1e-10)
    frozen = op.smooth_mask.numpy() == 0
    assert frozen.any() and np.array_equal(run(gk.class_sor_sweep, g2.sweep)[frozen],
                                           x[frozen])


def test_class_sweep_byte_and_operation_model(v2_coarse):
    """A's nonzeros (value + int32 column), x read and written, b, diag,
    mask, omega and lag_col once; 2 operations per nonzero and the update's
    per row.  The level holds no K."""
    _, gl = v2_coarse
    sw = gl.sweep
    nnz = int(np.count_nonzero(gl.A.vals.numpy()))
    assert pf._streamed_bytes(gl, True) == nnz * 8 + 7 * gl.n_pad * 4
    assert pf.sweep_flops(sw) == 2 * nnz + pf.CLASS_UPDATE_FLOPS * gl.n_pad
    assert not any(f.name == "kT" for f in dataclasses.fields(sw))
    pad = torch.ones(gl.n_pad, dtype=torch.bool)
    pad[gl.row_map] = False  # padding rows never move
    assert pad.any() and torch.all(sw.diag[pad] == 1) and torch.all(sw.mask[pad] == 0)


# ---------------------------------------------------------------------------
# (c): the probe's real pattern, where rows of one tile couple
# ---------------------------------------------------------------------------


def test_real_pattern_is_the_reference_pattern():
    spec = importlib.util.spec_from_file_location(
        "reference_realsparsity", os.path.join(REPO, "scripts", "realsparsity.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    a, r = realsparsity.real_pattern_csr(1024, seed=3), ref.real_pattern_csr(1024, seed=3)
    assert (a != r).nnz == 0 and a.shape == r.shape == (1024, 1024)


@pytest.fixture(scope="module")
def real():
    """The pattern at 128-row blocks in both packages, and sweep inputs:
    omega 1.4 (1.0 on every 5th row), every 7th row frozen, a Lagrange
    column, x_lag 0.3."""
    a = realsparsity.real_pattern_csr(4096)
    ej, et = jell.ell_from_csr(a, block_rows=128), tell.ell_from_csr(a, block_rows=128)
    n = et.nrows_pad
    gc, rows = tell.global_cols(et).numpy(), np.arange(n)[:, None]
    coupled = (gc // 8 == rows // 8) & (gc != rows) & (et.vals.numpy() != 0)
    assert n == 4096 and coupled.sum() > 1000  # same-tile coupling
    rng = np.random.default_rng(7)
    omega = np.full(n, 1.4)
    omega[::5] = 1.0
    mask = np.ones(n)
    mask[::7] = 0.0
    inp = dict(x=_f32(rng, n), b=_f32(rng, n), omega=omega, mask=mask,
               lagc=rng.standard_normal(n) * 0.01, xl=np.float32(0.3))
    return ej, et, inp


def _ref_rows(v, nb):
    return jnp.asarray(np.asarray(v, np.float32).reshape(nb, 128))


@pytest.mark.parametrize("kernel", ["sor_sweep_tpu2", "sor_sweep_tpu4"])
def test_class_sweep_plain_matches_reference_on_real_pattern(real, kernel):
    ej, et, p = real
    nb = et.nrows_pad // 128
    vecs = [_ref_rows(v, nb) for v in (1.0 / np.asarray(ej.diag), p["b"], p["mask"],
                                       p["omega"], p["lagc"])]
    x2, xl = jnp.asarray(p["x"].reshape(nb, 128)), jnp.asarray(p["xl"])
    with pltpu.force_tpu_interpret_mode():
        if kernel == "sor_sweep_tpu2":  # [blocks, block_rows / 128, 128] rows
            ref = K2.sor_sweep_tpu2(K2.prepare_kernel_ell2(ej), x2, xl,
                                    *(v[:, None] for v in vecs))
        else:
            ref = K4.sor_sweep_tpu4(K4.prepare_kernel_ell4(ej, split_inblock=True),
                                    x2, xl, *vecs)
    ref = np.asarray(ref).reshape(-1)
    role = "sweep2" if kernel == "sor_sweep_tpu2" else "sweep4"
    sw = gk.class_sweep(gk.device_ell(et, torch.float32, "cpu", "spmv2"), et.diag,
                        p["mask"], p["omega"], p["lagc"], role=role)

    def run(s):
        return gk.class_sor_sweep(s, torch.from_numpy(p["x"].copy()),
                                  torch.tensor(p["xl"]), torch.from_numpy(p["b"])).numpy()

    _close(run(sw), ref, F32_TOL)
    # a sweep that writes each row before the next row of its tile gathers
    # (1-row tiles: row-by-row GS) is another function on this pattern
    rowwise = np.abs(run(dataclasses.replace(sw, class_size=1)) - ref).max()
    assert rowwise > 30 * F32_TOL * np.abs(ref).max()


def test_oneshot_plain_matches_sor_sweep_tpu5_on_real_pattern(real):
    ej, et, p = real
    nb = et.nrows_pad // 128
    kT_ref = K4.build_oneshot_K(ej, p["omega"], p["mask"])
    with pltpu.force_tpu_interpret_mode():
        ref = K4.sor_sweep_tpu5(K4.prepare_kernel_ell4(ej), jnp.asarray(kT_ref, jnp.float32),
                                jnp.asarray(p["x"].reshape(nb, 128)), jnp.asarray(p["xl"]),
                                _ref_rows(p["b"], nb), _ref_rows(p["lagc"], nb))
    ref = np.asarray(ref).reshape(-1)
    kT = gk.build_oneshot_K(et, p["omega"], p["mask"])
    np.testing.assert_allclose(kT, kT_ref, rtol=0, atol=1e-12 * np.abs(kT_ref).max())
    sw = gk.BlockSweep(A=gk.device_ell(et, torch.float32, "cpu", "spmv4"),
                       kT=torch.from_numpy(kT).float(),
                       lagc=torch.from_numpy(p["lagc"]).float(),
                       order=torch.arange(nb, dtype=torch.int32), phase_ptr=(0, nb),
                       serial=True, role="sweep5")
    out = gk.block_oneshot_sweep(sw, torch.from_numpy(p["x"].copy()), torch.tensor(p["xl"]),
                                 torch.from_numpy(p["b"])).numpy()
    _close(out, ref, F32_TOL)


def test_ell_spmv_plain_matches_spmv_tpu4_on_real_pattern(real):
    ej, et, p = real
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(K4.spmv_tpu4(K4.prepare_kernel_ell4(ej), jnp.asarray(p["x"])))
    A = gk.device_ell(et, torch.float32, "cpu", "spmv4")
    _close(gk.ell_spmv(A, torch.from_numpy(p["x"])).numpy(), ref, F32_TOL)


def test_ktime_host_operator_and_refusal_without_card():
    op = ktime.build_operator(n=4096)
    assert {br: e.block_rows for br, e in op["ells"].items()} == {128: 128, 256: 256}
    assert all((tell.ell_to_csr(e) != op["a"]).nnz == 0 for e in op["ells"].values())
    assert op["kT"].shape == (32, 128, 128)
    with pytest.raises(SystemExit, match="card"):
        ktime.run(n=4096, iters=1)


# ---------------------------------------------------------------------------
# (d): the v6 layout rule
# ---------------------------------------------------------------------------

N_WIDE = 264 * 128  # 264 blocks: room for 257 patches in block 0


def _wide_csr(patches: int, rows: int = N_WIDE):
    """[rows, N_WIDE]: a tridiagonal band (diagonal 4) whose first 128 rows
    also read x patches 1 .. patches - 1 (entries 0.01), so the first
    128-row block reads exactly ``patches`` patches."""
    n = N_WIDE
    r = np.arange(rows)
    lo, hi = r[r > 0], r[r < n - 1]
    p = np.arange(1, patches)
    extra = (p - 1) % 128  # the row of block 0 that reads patch p
    ri = np.concatenate([r, lo, hi, extra])
    ci = np.concatenate([r, lo - 1, hi + 1, p * 128 + extra])
    vi = np.concatenate([np.full(rows, 4.0), np.full(lo.size + hi.size, -1.0),
                         np.full(p.size, 0.01)])
    a = sp.coo_matrix((vi, (ri, ci)), shape=(rows, n)).tocsr()
    a.sum_duplicates()
    return a


def _v6_accepts(ej) -> bool:
    try:
        K6.prepare_kernel_ell6(ej)
    except Ell4Unsupported:
        return False
    return True


@pytest.mark.parametrize("patches,block_rows,accept",
                         [(256, 128, True), (257, 128, False), (3, 64, False)],
                         ids=["256-patches", "257-patches", "64-row-blocks"])
def test_v6_supported_raises_and_accepts_as_prepare_kernel_ell6(patches, block_rows,
                                                                 accept):
    a = _wide_csr(patches, rows=256)
    ej = jell.ell_from_csr(a, block_rows=block_rows)
    et = tell.ell_from_csr(a, block_rows=block_rows)
    if block_rows == 128:  # the first block reads the most patches
        assert gk.block_patches(tell.global_cols(et).numpy(), 2).shape[1] == patches
    assert _v6_accepts(ej) is accept
    assert gk.v6_supported(et) is accept


def _level(ej, n):
    z, one = jnp.zeros(ej.nrows_pad), jnp.ones(ej.nrows_pad)
    return jops.LevelOperator(
        A=ej, bound=jops._empty_compact(ej.nrows_pad, 128),
        cond=jops._empty_compact(ej.nrows_pad, 128), lag_col=z, lag_row=z,
        omega_scale=one, smooth_mask=one, dirichlet_mask=z, neumann_mask=z,
        dirichlet_values=z, neumann_values=z, row_map=jnp.arange(n, dtype=jnp.int32),
        has_lagrange=False, implicit=False, omega=1.4, iters=2, class_size=8, n=n)


@pytest.mark.parametrize("patches", [256, 257])
def test_level_kind_and_transfer_role_follow_tpu_backend(patches):
    """use_v6=None: a level the v6 layout refuses runs v2 in both packages
    (both warn); a refused transfer takes the v2 SpMV, an accepted one v6.
    Storage order: the colored sweep's own refusal tiers (the reference's
    ``prepare_colored_sweep`` slot bounds) are not this rule."""
    a = _wide_csr(patches)
    ej = jell.ell_from_csr(a, block_rows=128)
    tr = jell.ell_from_csr(_wide_csr(patches, rows=256), block_rows=128)
    jh = JHierarchy(levels=(_level(ej, N_WIDE),), restrict=(tr,), prolong=())
    refused = patches > 256
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        th = tb.tpu_hierarchy(jh, sweep="exact")
    th_kind = th.levels[0].kernel_kind
    ht = interop.hierarchy_from_numpy(_numpy_tree(jh))
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        gh = gpu_backend.gpu_hierarchy(ht, "cpu", sweep_order="exact")
    assert (th_kind == "v2-fallback") is refused
    assert gh.levels[0].kernel_kind == th_kind
    assert gh.levels[0].A.role == ("spmv2" if refused else "spmv6")
    v2_warned = [any("v2" in str(w.message) for w in ws) for ws in (wj, wt)]
    assert v2_warned == [refused, refused]
    assert isinstance(th.restrict[0], K6.KernelEll6) is not refused
    assert gh.restrict[0].role == ("spmv2" if refused else "spmv6")


def _clique_csr(clique: int, wide: int):
    """[N_WIDE, N_WIDE]: the tridiagonal band of ``_wide_csr``; the first
    128 rows also read x patches 1 .. ``wide`` - 1 (``wide`` 0: none), and
    each of the first ``clique`` blocks reads every other of them (entries
    0.01), so those blocks take ``clique`` colors of one block each."""
    n = N_WIDE
    r = np.arange(n)
    lo, hi = r[r > 0], r[r < n - 1]
    p = np.arange(1, max(wide, 1))
    i, j = np.meshgrid(np.arange(clique), np.arange(clique), indexing="ij")
    i, j = i[i != j], j[i != j]
    ri = np.concatenate([r, lo, hi, (p - 1) % 128, i * 128 + j % 128])
    ci = np.concatenate([r, lo - 1, hi + 1, p * 128 + (p - 1) % 128,
                         j * 128 + (j + 1) % 128])
    vi = np.concatenate([np.full(n, 4.0), np.full(lo.size + hi.size, -1.0),
                         np.full(p.size + i.size, 0.01)])
    a = sp.coo_matrix((vi, (ri, ci)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("clique,wide,kind,why", [
    (0, 256, "v6-oneshot", "264 scratch slots > 96 at mb=2"),
    (100, 256, "v6-oneshot", "264 scratch slots > 96 at mb=2"),
    (100, 0, "v8-colored", None),
], ids=["slots", "expansion-then-slots", "wide-tier"])
def test_colored_kind_follows_prepare_colored_sweep(clique, wide, kind, why):
    """``sweep_order="colored"`` on 264-block levels: where the reference's
    ``prepare_colored_sweep`` refuses (every mb past 256 slots; or mb 8 and
    4 past the 2.0 expansion, then mb 2 past the slots), both packages run
    the storage-order sweep and name the same kind; where only the wide
    tier fits (mb 2 at 112 slots), both run colored.  The refused levels'
    smooth is held against the reference's own storage-order GS
    (``ops/smoothers.smooth`` on the LevelOperator: the function
    ``sor_sweep_tpu6`` computes, whose interpret mode at 256 patches a block
    takes minutes here); the colored order gives another iterate there."""
    from meshlessmultigridpoisson_tpu.ops import smoothers as jsm

    a = _clique_csr(clique, wide)
    lj = _level(jell.ell_from_csr(a, block_rows=128), N_WIDE)
    assert tb.tpu_level_from_operator(lj).kernel_kind == kind
    lt = interop.hierarchy_from_numpy(_numpy_tree(
        JHierarchy(levels=(lj,), restrict=(), prolong=()))).levels[0]
    gl = gpu_backend.gpu_level_from_operator(lt, "cpu")
    assert gl.kernel_kind == kind
    assert gl.A.role == ("spmv8" if kind == "v8-colored" else "spmv6")
    nb = N_WIDE // 128
    pids = gk.block_patches(tell.global_cols(lt.A).numpy(), nb)
    colors = gk.color_blocks(pids, nb)
    assert gk.colored_refusal(pids, nb, colors) == why
    counts = np.bincount(colors)
    expansion = {mb: (-(-counts // mb) * mb).sum() / nb for mb in (8, 4, 2)}
    # 98 one-block colors: mb 8 and 4 expand past 2.0, mb 2 never can
    assert bool(expansion[4] > 2.0) == bool(clique) and expansion[2] <= 2.0
    if kind == "v8-colored":
        return
    rng = np.random.default_rng(71)
    x, b = _f32(rng, N_WIDE), _f32(rng, N_WIDE)
    rx, _ = jsm.smooth(lj, jnp.asarray(x, jnp.float64), 0.0, jnp.asarray(b, jnp.float64),
                       0.0, iters=1)
    rx = np.asarray(rx)

    def smooth(level):
        return gpu_backend.smooth(level, torch.from_numpy(x), torch.tensor(0.0),
                                  torch.from_numpy(b), torch.tensor(0.0), iters=1)[0].numpy()

    _close(smooth(gl), rx, F32_TOL)
    order, ptr = gk.colored_order(colors)
    sw = dataclasses.replace(gl.sweep, order=torch.from_numpy(order.astype(np.int32)),
                             phase_ptr=ptr, serial=False, role="sweep8")
    colored = smooth(dataclasses.replace(gl, sweep=sw))
    assert np.abs(colored - rx).max() > 30 * F32_TOL * np.abs(rx).max()


# ---------------------------------------------------------------------------
# (e): the v2 solve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_solve():
    """The reference CLI's CPU ``solve --solver bicgstab`` on the small
    Dirichlet slice: its SolveRecord and logical solution."""
    from meshlessmultigridpoisson_tpu.apps import cli as jcli
    from meshlessmultigridpoisson_tpu.models import poisson as jpoisson

    seen = {}
    orig = jpoisson.l1_error

    def spy(prob, x):
        seen["prob"], seen["x"] = prob, x
        return orig(prob, x)

    args = argparse.Namespace(
        platform="cpu", cycles=None, solver="bicgstab", geom=SLICE["geom"],
        sizes=SLICE["sizes"], deg=SLICE["deg"], k=1, neumann=False, seed=0,
        msh=None, ordering=SLICE["ordering"], block_rows=SLICE["block_rows"],
        setup_cache=None, profile=False, write_solution=None, tol=SLICE["tol"])
    ensure_native_geometry()  # both packages sample their clouds natively
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        mp.setattr(jpoisson, "l1_error", spy)
        warnings.simplefilter("ignore")
        rec = jcli._solve(args)
    return rec, np.asarray(seen["prob"].hierarchy.finest.to_logical(seen["x"]))


def test_cpu_v2_solve_matches_reference_cli(reference_solve):
    from meshlessmultigridpoisson_torch.apps import cli

    rec_j, sol_j = reference_solve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec_t, prob_t, x_t, _ = cli.run_solve([
            "solve", "--device", "cpu", "--geom", SLICE["geom"],
            "--sizes", *map(str, SLICE["sizes"]), "--deg", str(SLICE["deg"]),
            "--ordering", SLICE["ordering"],
            "--block-rows", str(SLICE["block_rows"]), "--tol", str(SLICE["tol"])],
            use_v6=False)
    assert rec_t.config["sizes"] == rec_j.config["sizes"]
    assert rec_t.extra["level_kernels"] == ["v2-fallback"] * 3
    assert rec_t.extra["level_k_dtypes"] == [None] * 3
    assert 0 <= rec_j.final_residual < 1e-10
    assert 0 <= rec_t.final_residual < 1e-10
    assert abs(rec_t.l1_error - rec_j.l1_error) <= 0.05 * rec_j.l1_error
    sol_t = prob_t.hierarchy.finest.to_logical(x_t).numpy()
    gap = np.abs(sol_t - sol_j).sum() / np.abs(sol_j).sum()
    assert gap < 1e-6, gap
