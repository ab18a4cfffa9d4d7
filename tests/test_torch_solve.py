"""Port solvers held against the reference package, on the CPU.

* V-cycles: the port's plain f64 path on the SAME operators as the reference
  (carried across with ``interop.hierarchy_from_numpy``) reproduces the
  reference ``run_v_cycles`` residual history to 1e-10 relative — both run
  the identical (block, class) tile Gauss-Seidel; only summation order
  differs.
* Level kinds: ``gpu_hierarchy`` picks v8-colored / v7-exact exactly where
  the reference ``tpu_hierarchy`` does, in the same colored block order.
* The slice as a whole: the port's ``solve --device cpu`` (the CUDA flow
  with the kernels' plain versions: f64 outer defect loop, f32 inner
  BiCGStab, colored sweeps on the fine level) against the reference CPU
  ``solve --solver bicgstab`` (all-f64, storage-order sweeps).  The sweep
  orders differ, so the converged solutions are compared, not the
  histories: both below 1e-10, L1 errors within 5%, solutions within 1e-6
  relative L1 (measured gap: 3.3e-12; L1 errors 4.41485e-08 both).
"""

import argparse
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from meshlessmultigridpoisson_tpu.mg.tpu_backend import tpu_hierarchy
from meshlessmultigridpoisson_tpu.mg.vcycle import run_v_cycles as jrun
from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.mg import gpu_backend
from meshlessmultigridpoisson_torch.mg.vcycle import run_v_cycles as trun

# the test workers share the host's cores with the JAX test files: one
# intra-op thread per process keeps torch's thread pool from contending
torch.set_num_threads(1)

SLICE = dict(geom="square_with_circle", sizes=[600, 2500, 5000], deg=4,
             ordering="kdtile", block_rows=512, tol=1e-10)


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


def test_vcycle_histories_match_reference_on_same_operators():
    # the test_poisson_mg.py Dirichlet configuration
    pj = jmake("square", sizes=[300, 1200], poly_deg=3, k1=1, neumann=False)
    _, hist_j = jrun(pj.hierarchy, pj.state0, 8)
    hier = interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy))
    state = interop.state_from_numpy(_numpy_tree(pj.state0))
    st, hist_t = trun(hier, state, 8)
    hist_j = np.asarray(hist_j)
    np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-10, atol=0)
    assert hist_j[-1] < 0.5 * hist_j[0]


@pytest.fixture(scope="module")
def slice_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jmake(SLICE["geom"], sizes=SLICE["sizes"], poly_deg=SLICE["deg"],
                     ordering=SLICE["ordering"], block_rows=SLICE["block_rows"])


def test_level_kinds_and_colored_order_match_tpu_hierarchy(slice_reference):
    hj = slice_reference.hierarchy
    th = tpu_hierarchy(hj)
    gh = gpu_backend.gpu_hierarchy(
        interop.hierarchy_from_numpy(_numpy_tree(hj)), "cpu")
    kinds = [lv.kernel_kind for lv in gh.levels]
    assert kinds == [lv.kernel_kind for lv in th.levels]
    assert kinds[-1] == "v8-colored" and gh.levels[-1].n_pad // 128 >= 32
    for tl, gl in zip(th.levels, gh.levels):
        if tl.colored8 is None:
            continue
        order = tl.colored8.block_order()
        _, first = np.unique(order, return_index=True)
        np.testing.assert_array_equal(gl.sweep.order.numpy(),
                                      order[np.sort(first)])
        assert gl.sweep.nphases == tl.colored8.ncolors


def test_cuda_device_without_card_refuses(monkeypatch):
    from meshlessmultigridpoisson_torch.apps import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="refusing"):
        cli.run_solve(["solve", "--device", "cuda", "--sizes", "170", "600"])


def _reference_cli_solve(monkeypatch):
    """The reference CLI's CPU ``solve --solver bicgstab``; returns its
    SolveRecord and its solution (captured where the CLI scores it)."""
    from meshlessmultigridpoisson_tpu.apps import cli as jcli
    from meshlessmultigridpoisson_tpu.models import poisson as jpoisson

    seen = {}
    orig = jpoisson.l1_error

    def spy(prob, x):
        seen["prob"], seen["x"] = prob, x
        return orig(prob, x)

    monkeypatch.setattr(jpoisson, "l1_error", spy)
    args = argparse.Namespace(
        platform="cpu", cycles=None, solver="bicgstab", geom=SLICE["geom"],
        sizes=SLICE["sizes"], deg=SLICE["deg"], k=1, neumann=False, seed=0,
        msh=None, ordering=SLICE["ordering"], block_rows=SLICE["block_rows"],
        setup_cache=None, profile=False, write_solution=None, tol=SLICE["tol"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = jcli._solve(args)
    prob = seen["prob"]
    return rec, np.asarray(prob.hierarchy.finest.to_logical(seen["x"]))


def test_slice_cpu_solve_matches_reference_cli(monkeypatch):
    from meshlessmultigridpoisson_torch.apps import cli

    rec_j, sol_j = _reference_cli_solve(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec_t, prob_t, x_t, xl_t = cli.run_solve([
            "solve", "--device", "cpu", "--geom", SLICE["geom"],
            "--sizes", *map(str, SLICE["sizes"]), "--deg", str(SLICE["deg"]),
            "--ordering", SLICE["ordering"],
            "--block-rows", str(SLICE["block_rows"]), "--tol", str(SLICE["tol"])])
    assert set(dataclasses.asdict(rec_t)) == set(dataclasses.asdict(rec_j))
    assert rec_t.config["sizes"] == rec_j.config["sizes"]
    assert rec_t.extra["level_kernels"] == ["v7-exact", "v7-exact", "v8-colored"]
    assert rec_t.extra["device"] == "cpu"
    assert rec_t.config["neumann"] is False and float(xl_t) == 0.0
    assert 0 <= rec_j.final_residual < 1e-10
    assert 0 <= rec_t.final_residual < 1e-10
    assert abs(rec_t.l1_error - rec_j.l1_error) <= 0.05 * rec_j.l1_error
    sol_t = prob_t.hierarchy.finest.to_logical(x_t).numpy()
    gap = np.abs(sol_t - sol_j).sum() / np.abs(sol_j).sum()
    assert gap < 1e-6, gap
