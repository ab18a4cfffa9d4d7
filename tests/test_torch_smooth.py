"""The fused smoother (``ops.gpu_kernels.block_smooth``) on the CPU.

A smoother call on a ``sweep8`` (colored) or ``sweep7`` (coarsest,
storage-order) level is one launch of ``csrc/block_smooth.cu`` on the card.
Its plain version, which the CPU runs, is ``smooth_loop`` over the plain
sweep, Lagrange relax and boundary re-solve.  Held here:

* that plain path (``mg.gpu_backend.smooth``, 2 sweeps, non-zero ``x_lag``
  and ``b_lag``) on the colored fine level and the coarsest level of a
  small Dirichlet and a small Neumann hierarchy (``square_with_circle``,
  600/5000, deg 4: the Neumann levels carry the border and boundary rows)
  and on the coarsest level of a small NS hierarchy (170/600, deg 4, the
  compatible PPE: 188 rows, 2 blocks, 60 boundary rows).  f32 against the
  reference's ``tpu_backend.smooth`` in interpret mode at rtol 2e-4
  (``__graft_entry__.py:118``) with an absolute floor of 2e-4 of max |x|;
  f64 to 1e-12 of max |x| against the reference's host f64 smoother
  (``ops/smoothers.smooth``: tile-ordered SOR, relax, re-solve), whose sweep
  on a colored level walks the 128-row blocks in the colored order (its own
  ``_gs_sweep`` on the level's mask cut to one block at a time): the
  reference's Pallas kernels compute in f32 inside.  The NS level is held
  against that host smoother in f32 too: there the reference's own
  ``tpu_backend.smooth`` departs from it by 1.19 (max |x| ~4) after one
  sweep, while the port agrees with it to 5e-15;
* the repack's rule: a storage-order level whose vectors do not fit
  ``coarse_smooth``'s shared memory runs role ``sweep6`` (the chain of
  ``block_oneshot_sweep``) and keeps its kind, and the limit itself;
* the ``--profile`` shape key of a fused launch, read back by
  ``probes.launchrank``.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.mg import tpu_backend as tb
from meshlessmultigridpoisson_tpu.config import FracStepConfig as JConfig
from meshlessmultigridpoisson_tpu.models import fracstep as jfs
from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake
from meshlessmultigridpoisson_tpu.ops import smoothers as jsm

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.mg import gpu_backend
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.probes import launchrank

# the test workers share the host's cores with the JAX test files: one
# intra-op thread per process keeps torch's thread pool from contending
torch.set_num_threads(1)

SIZES, DEG, ITERS = [600, 5000], 4, 2
F32_RTOL = 2e-4


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


@pytest.fixture(scope="module")
def hosts():
    """name -> the reference's host LevelOperator and the port's, on the same
    operators: the Dirichlet and Neumann slices' fine and coarsest levels
    and the NS problem's coarsest level."""
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for neumann in (False, True):
            pj = jmake("square_with_circle", sizes=SIZES, poly_deg=DEG, neumann=neumann,
                       ordering="kdtile", block_rows=512)
            ht = interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy))
            tag = "neumann" if neumann else "dirichlet"
            for lv, i in (("fine", -1), ("coarsest", 0)):
                out[f"{tag} {lv}"] = (pj.hierarchy.levels[i], ht.levels[i])
        ns = jfs.build_fracstep_problem(sizes=[170, 600], poly_deg=DEG,
                                        config=JConfig())
    out["ns coarsest"] = (ns.hierarchy.levels[0],
                          interop.hierarchy_from_numpy(_numpy_tree(ns.hierarchy)).levels[0])
    return out


def _host_smooth(jop, x, xl, b, bl, block_order=None):
    """The reference's host f64 smoother; with ``block_order`` its sweep
    walks those 128-row blocks in turn, each seeing x as it stands."""
    args = [jnp.asarray(v, jnp.float64) for v in (x, xl, b, bl)]
    if block_order is None:
        return jsm.smooth(jop, *args, iters=ITERS)
    gs = jax.jit(jsm._gs_sweep)

    def colored(op, x, x_lag, b):
        for blk in block_order:
            keep = np.zeros(op.n_pad)
            keep[blk * 128:(blk + 1) * 128] = 1.0
            x = gs(dataclasses.replace(op, smooth_mask=op.smooth_mask * keep), x, x_lag, b)
        return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm, "_gs_sweep", colored)
        return jsm.smooth(jop, *args, iters=ITERS)


CASES = [("dirichlet fine", "sweep8"), ("dirichlet coarsest", "sweep7"),
         ("neumann fine", "sweep8"), ("neumann coarsest", "sweep7"),
         ("ns coarsest", "sweep7")]


@pytest.mark.parametrize("name,role", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fused_smooth_plain_path_matches_tpu_backend_smooth(hosts, name, role, dtype):
    jop, op = hosts[name]
    gl = gpu_backend.gpu_level_from_operator(op, "cpu", dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    tl = tb.tpu_level_from_operator(jop, dtype=jdt)
    assert gl.sweep.role == role and gl.kernel_kind == tl.kernel_kind
    if name.startswith(("neumann", "ns")):
        assert gl.has_lagrange and gl.bound.nrows > 0
    rng = np.random.default_rng(7)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x, b = (rng.standard_normal(op.n_pad).astype(npdt) for _ in range(2))
    xl, bl = npdt(0.37), npdt(-0.81)
    if dtype == torch.float64 or name == "ns coarsest":
        order = None
        if role == "sweep8":  # the executed order: the reference's, padding dropped
            order = gl.sweep.order.numpy()
            ref = list(dict.fromkeys(tl.colored8.block_order().tolist()))
            assert order.tolist() == ref
        rx, rxl = _host_smooth(jop, x, xl, b, bl, order)
    else:
        with pltpu.force_tpu_interpret_mode():
            rx, rxl = tb.smooth(tl, jnp.asarray(x), jnp.asarray(xl), jnp.asarray(b),
                                jnp.asarray(bl), iters=ITERS)
    rx, rxl = np.asarray(rx), float(rxl)
    px, pxl = gpu_backend.smooth(gl, torch.from_numpy(x), torch.tensor(xl),
                                 torch.from_numpy(b), torch.tensor(bl), iters=ITERS)
    assert px.dtype == dtype and pxl.shape == ()
    scale = np.abs(rx).max()
    if dtype == torch.float64:
        np.testing.assert_allclose(px.numpy(), rx, rtol=0, atol=1e-12 * scale)
        assert abs(float(pxl) - rxl) <= 1e-12 * max(abs(rxl), 1.0)
    else:
        np.testing.assert_allclose(px.numpy(), rx, rtol=F32_RTOL, atol=F32_RTOL * scale)
        assert abs(float(pxl) - rxl) <= F32_RTOL * max(abs(rxl), 1.0)
    # the fused wrapper's plain version is that same loop
    fx, fxl = gk.block_smooth(gl.sweep, torch.from_numpy(x), torch.tensor(xl),
                              torch.from_numpy(b), torch.tensor(bl), ITERS, gl.omega,
                              *((gl.lag_row, gl.bound) if gl.has_lagrange else (None, None)))
    assert torch.equal(fx, px) and torch.equal(torch.as_tensor(fxl), pxl)


def test_coarse_smooth_limit():
    """One K tile, four level vectors, the boundary rows' diagonals and
    targets and the fixed scratch within the H100's 232,448 B: f32 up to
    10,240 rows, f64 up to 2,944 (multiples of 128), bf16 K more."""
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    fits = gk.coarse_smooth_fits
    assert fits(10240, f32, f32, 0) and not fits(10368, f32, f32, 0)
    assert fits(2944, f64, f64, 0) and not fits(3072, f64, f64, 0)
    assert fits(10368, f32, bf16, 0)
    assert fits(2560, f64, f64, 512)  # the Neumann slice's coarsest level in f64
    # the layout: mbarriers, tiles, t, partial sums, reduction, vectors, rows
    assert gk.smooth_smem_bytes(1, 0, 0, f32, f32, 2560, 512) == (
        128 + 65536 + 512 + 2048 + 128 + 4 * 2560 * 4 + 2048 + 2048)
    assert gk.smooth_smem_bytes(2, 1, 70, f32, f32) == (
        128 + 2 * 65536 + 128 * 70 * 8 + 512 + 2048 + 128)


def test_repack_gives_a_level_over_the_limit_the_sweep6_chain(hosts, monkeypatch):
    """The coarsest level (640 rows, f32: 78,592 B) fits and runs sweep7;
    with a limit one byte smaller it runs sweep6, still kind v7-exact, and
    smooths the same (both plain on the CPU)."""
    _, op = hosts["neumann coarsest"]
    need = gk.smooth_smem_bytes(1, 0, 0, torch.float32, torch.float32, op.n_pad,
                                op.bound.ell.nrows_pad)
    monkeypatch.setattr(gk, "SMEM_OPTIN", need)
    fits = gpu_backend.gpu_level_from_operator(op, "cpu")
    monkeypatch.setattr(gk, "SMEM_OPTIN", need - 1)
    over = gpu_backend.gpu_level_from_operator(op, "cpu")
    assert (fits.sweep.role, over.sweep.role) == ("sweep7", "sweep6")
    assert fits.kernel_kind == over.kernel_kind == "v7-exact"
    rng = np.random.default_rng(3)
    x, b = (torch.from_numpy(rng.standard_normal(op.n_pad).astype(np.float32))
            for _ in range(2))
    xl, bl = torch.tensor(0.2), torch.tensor(0.4)
    a, al = gpu_backend.smooth(fits, x, xl, b, bl)
    c, cl = gpu_backend.smooth(over, x, xl, b, bl)
    assert torch.equal(a, c) and torch.equal(al, cl)


def test_profile_key_of_a_fused_launch_reads_back_in_launchrank(hosts, monkeypatch):
    """While profiling, a fused launch is counted as ``block_smooth`` calls
    ``_call`` for it (role, n_pad, n_pad, sweeps=iters; the kernel entry
    stubbed: no card here): "role n x n x iters"; launchrank files it
    under part "smooth" of its level with ``iters`` times its one-sweep
    bound."""
    levels = [gpu_backend.gpu_level_from_operator(hosts[f"neumann {n}"][1], "cpu")
              for n in ("coarsest", "fine")]
    monkeypatch.setattr(gk, "SHAPES", {})
    for lv in levels:
        for _ in range(2):
            gk._call(lv.sweep.role, lv.n_pad, lv.n_pad, lambda: 0, sweeps=lv.iters)
    keys = dict(gk.SHAPES)
    assert keys == {f"sweep7 {levels[0].n_pad}x{levels[0].n_pad}x5": 2,
                    f"sweep8 {levels[1].n_pad}x{levels[1].n_pad}x5": 2}
    rec = {"extra": {"per_level": [{"sweep_bound_ms": 0.002, "matvec_bound_ms": 0.001},
                                   {"sweep_bound_ms": 0.03, "matvec_bound_ms": 0.01}],
                     "profile": {"launch_shapes": [
                         {"shape": k, "launches": c, "device_ms": c * 0.1}
                         for k, c in keys.items()]}}}
    rows, _ = launchrank.rank(rec)
    got = {(r["role"], r["level"], r["part"]): r["bound_ms_per_launch"] for r in rows}
    assert got == pytest.approx({("sweep7", 0, "smooth"): 5 * 0.002,
                                 ("sweep8", 1, "smooth"): 5 * 0.03})
