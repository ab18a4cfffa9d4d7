"""The port's Neumann solve held against the reference package, on the CPU.

Configuration: ``square_with_circle``, sizes 600/2500/5000, deg 4, kd-tile
ordering, 512-row blocks, Neumann boundaries (Lagrange border, implicit
condensation): 518 boundary rows and 1,208 condensation rows on the fine
level.  Operators reach the port through ``interop.hierarchy_from_numpy``,
so kernel and level cases compare the same matrices.

* (a) ``compact_rows`` (its plain version: a CPU tensor) in both roles
  against the reference ``spmv_tpu2`` in interpret mode plus its epilogues
  (``tpu_backend.bound_eval_neumann``, ``push_inhomog_to_rhs``);
* (b) one ``GpuLevel.smooth`` sweep (plain path) against
  ``tpu_backend.smooth`` in interpret mode, on the fine v8-colored level and
  the coarsest v7-exact level, with non-zero ``x_lag`` and ``b_lag``;
* (c) the port's ``solve --device cpu --neumann`` against the reference
  CLI's CPU ``solve --solver bicgstab --neumann``.

Tolerances: f32 against the interpret-mode kernels 3e-4 x max |output|, the
reference's own bound for its kernels (measured: ~1e-7 for (a), ~4e-7 for
(b)); (c) both residuals < 1e-10, L1 errors within 5%, gauge-fixed
solutions within 1e-6 relative L1.
"""

import argparse
import dataclasses
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from meshlessmultigridpoisson_tpu.mg import tpu_backend as tb

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.mg import gpu_backend
from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.stencil.operators import CompactRows

# the test workers share the host's cores with the JAX test files: one
# intra-op thread per process keeps torch's thread pool from contending
torch.set_num_threads(1)

SLICE = dict(geom="square_with_circle", sizes=[600, 2500, 5000], deg=4,
             ordering="kdtile", block_rows=512, tol=1e-10)
F32_TOL = 3e-4


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


@pytest.fixture(scope="module")
def reference_solve():
    """The reference CLI's CPU ``solve --solver bicgstab --neumann``: its
    SolveRecord, its problem and its solution (captured where the CLI
    scores it)."""
    from meshlessmultigridpoisson_tpu.apps import cli as jcli
    from meshlessmultigridpoisson_tpu.models import poisson as jpoisson

    seen = {}
    orig = jpoisson.l1_error

    def spy(prob, x):
        seen["prob"], seen["x"] = prob, x
        return orig(prob, x)

    args = argparse.Namespace(
        platform="cpu", cycles=None, solver="bicgstab", geom=SLICE["geom"],
        sizes=SLICE["sizes"], deg=SLICE["deg"], k=1, neumann=True, seed=0,
        msh=None, ordering=SLICE["ordering"], block_rows=SLICE["block_rows"],
        setup_cache=None, profile=False, write_solution=None, tol=SLICE["tol"])
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        mp.setattr(jpoisson, "l1_error", spy)
        warnings.simplefilter("ignore")
        rec = jcli._solve(args)
    return rec, seen["prob"], seen["x"]


@pytest.fixture(scope="module")
def levels(reference_solve):
    """{"fine", "coarsest"}: (reference TpuLevel, port host LevelOperator)
    on the same operators."""
    hj = reference_solve[1].hierarchy
    ht = interop.hierarchy_from_numpy(_numpy_tree(hj))
    return {name: (tb.tpu_level_from_operator(hj.levels[i]), ht.levels[i])
            for name, i in (("fine", -1), ("coarsest", 0))}


def _f32(rng, n):
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("role", ["bound2", "push2"])
def test_compact_rows_plain_matches_spmv_tpu2_epilogues(levels, role):
    tl, op = levels["fine"]
    assert (op.bound.nrows, op.cond.nrows) == (518, 1208)
    rng = np.random.default_rng(31 if role == "bound2" else 32)
    x, b = _f32(rng, op.n_pad), _f32(rng, op.n_pad)
    table = op.bound if role == "bound2" else op.cond
    C = gk.device_compact(table, torch.float32, "cpu", role)
    with pltpu.force_tpu_interpret_mode():
        if role == "bound2":
            ref = tb.bound_eval_neumann(tl, jnp.asarray(x), jnp.asarray(b))
        else:
            ref = tb.push_inhomog_to_rhs(tl, jnp.asarray(b))
    ref = np.asarray(ref)
    xt, bt = torch.from_numpy(x.copy()), torch.from_numpy(b)
    out = gk.compact_rows(C, xt if role == "bound2" else bt, bt).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_TOL * np.abs(ref).max())
    # every target row moved, nothing else did
    moved = np.nonzero(out != (x if role == "bound2" else b))[0]
    assert set(moved) <= set(table.rows[: table.nrows].tolist())
    assert moved.size > 0.9 * table.nrows


@pytest.mark.parametrize("name,kind", [("fine", "v8-colored"),
                                       ("coarsest", "v7-exact")])
def test_gpu_level_smooth_matches_tpu_backend_smooth(levels, name, kind):
    tl, op = levels[name]
    gl = gpu_backend.gpu_level_from_operator(op, "cpu")
    assert gl.kernel_kind == tl.kernel_kind == kind
    assert gl.has_lagrange and gl.bound.nrows == op.bound.nrows > 0
    rng = np.random.default_rng(41)
    x, b = _f32(rng, op.n_pad), _f32(rng, op.n_pad)
    xl, bl = np.float32(0.37), np.float32(-0.81)
    with pltpu.force_tpu_interpret_mode():
        rx, rxl = tb.smooth(tl, jnp.asarray(x), jnp.asarray(xl), jnp.asarray(b),
                            jnp.asarray(bl), iters=1)
    rx, rxl = np.asarray(rx), float(rxl)
    px, pxl = gpu_backend.smooth(gl, torch.from_numpy(x), torch.tensor(xl),
                                 torch.from_numpy(b), torch.tensor(bl), iters=1)
    np.testing.assert_allclose(px.numpy(), rx, rtol=0, atol=F32_TOL * np.abs(rx).max())
    assert pxl.shape == () and pxl.dtype == torch.float32
    assert abs(float(pxl) - rxl) <= F32_TOL * abs(rxl)


def test_repack_refuses_a_resolve_that_reads_another_boundary_row(levels):
    """The in-place re-solve needs boundary rows that read no other
    boundary row: a table that does is refused, never run."""
    _, op = levels["fine"]
    gpu_backend.check_resolve_in_place(op.bound)  # Neumann stencils: fine
    b = op.bound
    lcols = b.ell.lcols.clone()
    vals = b.ell.vals.clone()
    # point row 0's last entry at row 1's target, with a non-zero value
    lcols[0, -1] = int(b.rows[1]) - int(b.ell.win_start[0])
    vals[0, -1] = 1.0
    def table(v):
        return CompactRows(rows=b.rows, nrows=b.nrows,
                           ell=dataclasses.replace(b.ell, lcols=lcols, vals=v))

    with pytest.raises(ValueError, match="in-place"):
        gpu_backend.gpu_level_from_operator(
            dataclasses.replace(op, bound=table(vals)), "cpu", sweep=False)
    vals[0, -1] = 0.0  # a padding entry (value 0) may point anywhere
    gpu_backend.check_resolve_in_place(table(vals))


def test_device_pushdown_matches_host_rhs(levels):
    """``fine_rhs`` on a GpuLevel (the CLI's right-hand side, pushdown
    through ``compact_rows``) equals the host problem's, f64."""
    from meshlessmultigridpoisson_torch.models.poisson import fine_rhs
    from meshlessmultigridpoisson_torch.ops import smoothers as sm

    _, op = levels["fine"]
    src = np.random.default_rng(5).standard_normal(op.n)
    pre = sm.set_neumann_source(op, op.to_padded(torch.from_numpy(src)), coarse=False)
    host = sm.push_inhomog_to_rhs(op, pre)
    assert not torch.equal(host, pre)
    gl = gpu_backend.gpu_level_from_operator(op, "cpu", torch.float64, sweep=False)
    dev = fine_rhs(gl, src, neumann=True)
    np.testing.assert_allclose(dev.numpy(), host.numpy(), rtol=0,
                               atol=1e-13 * host.abs().max().item())


def test_slice_cpu_neumann_solve_matches_reference_cli(reference_solve):
    from meshlessmultigridpoisson_torch.apps import cli

    rec_j, prob_j, x_j = reference_solve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec_t, prob_t, x_t, xl_t = cli.run_solve([
            "solve", "--device", "cpu", "--neumann", "--geom", SLICE["geom"],
            "--sizes", *map(str, SLICE["sizes"]), "--deg", str(SLICE["deg"]),
            "--ordering", SLICE["ordering"],
            "--block-rows", str(SLICE["block_rows"]), "--tol", str(SLICE["tol"])])
    assert rec_t.config["neumann"] is True and rec_j.config["neumann"] is True
    assert rec_t.config["sizes"] == rec_j.config["sizes"]
    assert rec_t.extra["level_kernels"] == ["v7-exact", "v7-exact", "v8-colored"]
    assert 0 <= rec_j.final_residual < 1e-10
    assert 0 <= rec_t.final_residual < 1e-10
    assert abs(rec_t.l1_error - rec_j.l1_error) <= 0.05 * rec_j.l1_error

    def gauge_fixed(sol, exact):  # the reference's Neumann gauge fix
        return sol + (exact.mean() - sol.mean())

    sol_j = gauge_fixed(np.asarray(prob_j.hierarchy.finest.to_logical(x_j)), prob_j.exact)
    sol_t = gauge_fixed(prob_t.hierarchy.finest.to_logical(x_t).numpy(), prob_t.exact)
    gap = np.abs(sol_t - sol_j).sum() / np.abs(sol_j).sum()
    assert gap < 1e-6, gap

    # the returned Lagrange unknown closes the border row: the smoke test's
    # independent re-check (plain f64 SpMV, border row included) agrees
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    assert xl_t.shape == () and xl_t.dtype == torch.float64
    op = prob_t.hierarchy.finest
    b, bl = prob_t.state0.b[-1], prob_t.state0.b_lag[-1]
    recheck = chip_smoke.bordered_residual(op, b, bl, x_t, xl_t)
    assert recheck < 1e-10, recheck
    assert chip_smoke.bordered_residual(op, b, bl, x_t, xl_t + 1e-3) > 10 * recheck
