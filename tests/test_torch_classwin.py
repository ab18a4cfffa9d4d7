"""The window class sweep's host tables and its plain composition, held
against the plain class sweep and the reference package's class-SOR
kernels, on the CPU.

``class_sor_sweep`` (``csrc/class_sor_sweep.cu``) reorders each row's
nonzero prefix on the host (``class_window_tables``): the chain entries
(columns in [w0 - R, the row's tile start), R = ``class_window(class_size)``
rows a window) first, ``seg`` counting them.  ``window_sweep_plain`` below
is the kernel's composition over those tables in plain tensor code:
window w + 1's bulk terms summed before window w's chain moves x, then
window w's tiles, each gathering its chain entries from the same x before
writing.  Here:

* the tables: the same operator (the row's entries a permutation of its
  own), chain entries first and counted by ``seg``, no second copy of the
  tables, ``lens`` no longer than before, 2 extra bytes a row;
* the composition against ``class_sor_sweep_plain`` on the small slice's
  v2 levels (Dirichlet and Neumann, 128- and 512-row blocks, several
  windows a level; f64 within 1e-12, f32 within 1e-5 of max |x|) and at
  tile sizes 1-32, with frozen rows bit-equal to the input;
* the composition against ``sor_sweep_tpu2`` and ``sor_sweep_tpu4`` in
  interpret mode on ``probes.realsparsity``'s pattern (128-row blocks)
  and against ``sor_sweep_tpu`` (kernel 9, ``sweep1``) on the same
  unpermuted pattern, where rows of one tile couple.

Tolerances: f32 against the interpret-mode kernels 3e-4 x max |output|,
the reference's own bound for its kernels; against the plain sweep (the
same arithmetic in another summation order) 1e-5 (f32) and 1e-12 (f64)
of max |output|.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.ops import ell as jell
from meshlessmultigridpoisson_tpu.ops import kernels as K1
from meshlessmultigridpoisson_tpu.ops import kernels4 as K4

from meshlessmultigridpoisson_torch.mg.gpu_backend import gpu_level_from_operator
from meshlessmultigridpoisson_torch.models.poisson import make_poisson_problem
from meshlessmultigridpoisson_torch.ops import ell as tell
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.probes import realsparsity

torch.set_num_threads(1)

F32_TOL = 3e-4
PLAIN_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * np.abs(ref).max())


def window_sweep_plain(sw: gk.ClassSweep, x, x_lag, b) -> torch.Tensor:
    """The kernel's composition in plain tensor code, over the host-made
    window tables: the bulk terms of window w + 1 (each row's entries past
    ``seg`` to ``lens``, with r0 = b - lag_col x_lag) summed from x as it
    stands before window w's chain, then window w's tiles in order, each
    tile's rows gathering their chain entries (the first ``seg``) from the
    same x before any is written; rows with coef = [mask] omega / d of 0
    never written.  The same function as ``class_sor_sweep_plain`` in
    another summation order.  CPU tensors; ``x`` in place."""
    S, R, n = sw.class_size, sw.window, sw.A.nrows_pad
    coef = torch.where(sw.mask > 0, sw.omega / sw.diag, 0.0).numpy()
    r0 = (b - sw.lagc * x_lag).numpy()
    k = torch.arange(sw.A.width)[None, :]
    seg = sw.seg.long()[:, None]
    chain = torch.where(k < seg, sw.A.vals, 0.0).numpy()
    rest = torch.where((k >= seg) & (k < sw.A.lens[:, None]), sw.A.vals, 0.0).numpy()
    cols, x_ = sw.A.cols.long().numpy(), x.numpy()

    def bulk(w):
        sl = slice(w * R, min((w + 1) * R, n))
        return r0[sl] - (rest[sl] * x_[cols[sl]]).sum(1)

    nw = -(-n // R)
    g_next = bulk(0)
    for w in range(nw):
        g = g_next
        if w + 1 < nw:  # summed before window w's chain moves x
            g_next = bulk(w + 1)
        for t0 in range(w * R, min((w + 1) * R, n), S):
            sl, gl = slice(t0, t0 + S), slice(t0 - w * R, t0 - w * R + S)
            y = (chain[sl] * x_[cols[sl]]).sum(1)
            c = coef[sl]
            x_[sl] = np.where(c != 0, x_[sl] + c * (g[gl] - y), x_[sl])
    return x


@pytest.fixture(scope="module")
def slices():
    """The small slice's host hierarchies (square_with_circle 600/2500,
    deg 4, kd-tile) by (kind, block rows), built on first use: kind
    "dirichlet" or "neumann", 128- or 512-row blocks."""
    cache = {}

    def get(kind, block_rows):
        if (kind, block_rows) not in cache:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                cache[kind, block_rows] = make_poisson_problem(
                    "square_with_circle", sizes=[600, 2500], poly_deg=4, ordering="kdtile",
                    block_rows=block_rows, neumann=kind == "neumann").hierarchy
        return cache[kind, block_rows]

    return get


def _sweep(op, dtype, class_size=None):
    """The v2 level's sweep (its tables at ``class_size``, default the
    level's own)."""
    sw = gpu_level_from_operator(op, "cpu", dtype, use_v6=False).sweep
    if class_size is None:
        return sw
    return gk.class_sweep(sw.A, op.A.diag, op.smooth_mask, op.omega * op.omega_scale,
                          op.lag_col, class_size=class_size)


def _check_composition(sw, dtype, seed):
    """The composition against the plain sweep on one sweep's tables, from
    random x and b with x_lag 0.3: the plain tolerance, frozen rows
    bit-equal, x moved."""
    assert sw.A.nrows_pad > sw.window  # more than one window
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(sw.A.nrows_pad)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(sw.A.nrows_pad)).to(dtype)
    xl = torch.tensor(0.3, dtype=dtype)
    ref = gk.class_sor_sweep_plain(sw, x.clone(), xl, b)
    out = window_sweep_plain(sw, x.clone(), xl, b)
    _close(out.numpy(), ref.numpy(), PLAIN_TOL[dtype])
    frozen = (sw.mask == 0).numpy()
    assert frozen.any() and np.array_equal(out.numpy()[frozen], x.numpy()[frozen])
    assert np.abs(out.numpy() - x.numpy()).max() > 0.1 * np.abs(x.numpy()).max()


@pytest.mark.parametrize("class_size", [1, 8, 32])
@pytest.mark.parametrize("block_rows", [128, 512])
@pytest.mark.parametrize("slice_", ["dirichlet", "neumann"])
def test_window_tables_hold_the_operator_chain_first(slices, slice_, block_rows,
                                                     class_size):
    op = slices(slice_, block_rows).levels[-1]
    A = gk.device_ell(op.A, torch.float64, "cpu", "spmv2")
    A2, seg = gk.class_window_tables(A, class_size)
    n, w = A.nrows_pad, A.width
    window = gk.class_window(class_size)
    assert A2.vals.shape == A.vals.shape and A2.cols.shape == A.cols.shape
    assert seg.dtype == torch.int16 and seg.shape == (n,)
    assert seg.element_size() == 2  # the extra bytes a row
    assert torch.all(A2.lens <= A.lens) and torch.all(A2.lens == gk.row_lens(A2.vals))
    # each row holds its own entries, in another order
    for i in range(0, n, 97):
        assert sorted(zip(A2.cols[i].tolist(), A2.vals[i].tolist())) == sorted(
            zip(A.cols[i].tolist(), A.vals[i].tolist()))
    rows = torch.arange(n)
    lo = (rows // window - 1) * window
    hi = rows // class_size * class_size
    k = torch.arange(w)[None, :]
    c = A2.cols.long()
    in_chain = (c >= lo[:, None]) & (c < hi[:, None]) & (k < A.lens[:, None])
    assert torch.equal(in_chain.sum(1), seg.long())
    assert torch.all(in_chain == (k < seg.long()[:, None]))
    assert n // window > 1 and seg.max() > 0  # several windows, chains to walk
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n))
    _close(gk.ell_spmv(A2, x).numpy(), gk.ell_spmv(A, x).numpy(), 1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("block_rows", [128, 512])
@pytest.mark.parametrize("slice_", ["dirichlet", "neumann"])
def test_window_composition_is_the_plain_class_sweep(slices, slice_, block_rows, dtype):
    for level, op in enumerate(slices(slice_, block_rows).levels):
        _check_composition(_sweep(op, dtype), dtype, 40 + level)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("class_size", [1, 2, 4, 16, 32])
def test_window_composition_at_tile_sizes(slices, class_size, dtype):
    """Tiles of 1-32 rows (the kernel's 32 to 1 chain lanes a row) on the
    Dirichlet fine level, each at its own window."""
    sw = _sweep(slices("dirichlet", 512).levels[-1], dtype, class_size)
    assert sw.window % class_size == 0 and sw.window <= gk.CLASS_WINDOW
    _check_composition(sw, dtype, 50 + class_size)


@pytest.fixture(scope="module")
def real():
    """``probes.realsparsity``'s pattern at 4,096 rows, 128-row blocks, in
    both packages, and sweep inputs: omega 1.4 (1.0 on every 5th row),
    every 7th row frozen, a Lagrange column, x_lag 0.3."""
    a = realsparsity.real_pattern_csr(4096)
    ej, et = jell.ell_from_csr(a, block_rows=128), tell.ell_from_csr(a, block_rows=128)
    n = et.nrows_pad
    rng = np.random.default_rng(93)
    omega = np.full(n, 1.4)
    omega[::5] = 1.0
    mask = np.ones(n)
    mask[::7] = 0.0
    inp = dict(x=rng.standard_normal(n).astype(np.float32),
               b=rng.standard_normal(n).astype(np.float32), omega=omega, mask=mask,
               lagc=rng.standard_normal(n) * 0.01, xl=np.float32(0.3))
    return ej, et, inp


def _composition(et, p, role):
    sw = gk.class_sweep(gk.device_ell(et, torch.float32, "cpu", "spmv2"), et.diag,
                        p["mask"], p["omega"], p["lagc"], role=role)
    assert et.nrows_pad // sw.window > 1
    return window_sweep_plain(sw, torch.from_numpy(p["x"].copy()), torch.tensor(p["xl"]),
                              torch.from_numpy(p["b"])).numpy()


@pytest.mark.parametrize("kernel", ["sor_sweep_tpu2", "sor_sweep_tpu4", "sor_sweep_tpu"])
def test_window_composition_matches_reference_kernels_on_real_pattern(real, kernel):
    ej, et, p = real
    nb = et.nrows_pad // 128
    n = et.nrows_pad
    vecs = [np.asarray(v, np.float32) for v in (1.0 / np.asarray(ej.diag), p["b"], p["mask"],
                                                p["omega"], p["lagc"])]
    xl = jnp.asarray(p["xl"])
    with pltpu.force_tpu_interpret_mode():
        if kernel == "sor_sweep_tpu2":  # [blocks, block_rows / 128, 128] rows
            ref = K1.sor_sweep_tpu2(K1.prepare_kernel_ell2(ej),
                                    jnp.asarray(p["x"].reshape(nb, 128)), xl,
                                    *(jnp.asarray(v.reshape(nb, 1, 128)) for v in vecs))
        elif kernel == "sor_sweep_tpu4":
            ref = K4.sor_sweep_tpu4(K4.prepare_kernel_ell4(ej, split_inblock=True),
                                    jnp.asarray(p["x"].reshape(nb, 128)), xl,
                                    *(jnp.asarray(v.reshape(nb, 128)) for v in vecs))
        else:  # kernel 9: the v1 layout's padded x
            kell = K1.prepare_kernel_ell(ej)
            x2 = np.zeros(kell.x_pad, np.float32)
            x2[:n] = p["x"]
            ref = K1.sor_sweep_tpu(kell, jnp.asarray(x2.reshape(-1, 128)), xl,
                                   *(jnp.asarray(v.reshape(kell.nblocks, 1, 128))
                                     for v in vecs))
    ref = np.asarray(ref).reshape(-1)[:n]
    role = {"sor_sweep_tpu2": "sweep2", "sor_sweep_tpu4": "sweep4",
            "sor_sweep_tpu": "sweep1"}[kernel]
    out = _composition(et, p, role)
    _close(out, ref, F32_TOL)
    frozen = p["mask"] == 0
    assert np.array_equal(out[frozen], p["x"][frozen])


def test_class_sweep_windows_are_whole_tiles_and_bad_arguments_refused(real):
    for class_size in range(1, gk.CLASS_MAX_SIZE + 1):
        window = gk.class_window(class_size)
        assert window % class_size == 0 and gk.CLASS_WINDOW - class_size < window
        assert window <= gk.CLASS_WINDOW
    _, et, p = real
    A = gk.device_ell(et, torch.float32, "cpu", "spmv2")
    sw = gk.class_sweep(A, et.diag, p["mask"], p["omega"], p["lagc"])
    assert sw.window == gk.CLASS_WINDOW and sw.xring >= 3 * sw.window
    assert sw.xring & (sw.xring - 1) == 0
    with pytest.raises(ValueError, match="role"):
        gk.class_sweep(A, et.diag, p["mask"], p["omega"], p["lagc"], role="sweep9")
    with pytest.raises(ValueError, match="whole tiles"):
        gk.class_sweep(A, et.diag, p["mask"], p["omega"], p["lagc"], class_size=3)
