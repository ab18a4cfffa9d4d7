"""The port's row-sharded solve held against the reference's, on the CPU.

The reference side runs ``meshlessmultigridpoisson_tpu.parallel`` on the
conftest's virtual CPU devices (a mesh of the first P); the port side runs
P gloo ranks spawned through ``parallel.dryrun.spawn`` (each world once,
its checks batched), on the SAME operators: the reference hierarchy carried
across with ``interop.hierarchy_from_numpy``, the port partitioning it
itself.  The problems are the reference tests' own (``square``, sizes
[600, 2500], deg 4, k1 1, Dirichlet and Neumann; tests/test_parallel.py).
Everything is f64 unless marked.

Tolerances and why:
* the partition: exact (integer layouts and copied values);
* the frontier class sweep against ``_scan_tiles``: 1e-12 of max |x| (the
  same tile updates, each row's sum in another order); the interior pass
  (storage order, interior-masked one-shot K) against ``_scan_tiles``:
  1e-10 (the one-shot K reproduces the tile order only to rounding);
* the V-cycle histories and iterates: 1e-10 relative.  All-reduces and the
  one-shot K sum in another order than ``lax.psum`` and the tile scan
  (measured: 4e-13);
* the solvers: the same cycle / iteration count and x to 1e-9.  The
  iteration count of BiCGStab is held on the Dirichlet problem only: on
  the Neumann problem the reference's own count moves from 38 to 32 when
  b is perturbed by 1e-15 relative (its preconditioner, a V-cycle that
  diverges on its own there, amplifies rounding), so both sides are held
  to the solution bars of tests/test_parallel.py instead (1e-6 of the
  serial BiCGStab's solution, L1 error under 1.5x the serial one's);
* the f32 cycle: 2e-4 relative, the reference kernel tests' tolerance.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from meshlessmultigridpoisson_tpu.mg.krylov import solve_bicgstab as jbicgstab
from meshlessmultigridpoisson_tpu.mg.vcycle import run_v_cycles as jrun
from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake
from meshlessmultigridpoisson_tpu.parallel import partition_hierarchy as jpartition
from meshlessmultigridpoisson_tpu.parallel import sharded as jsh
from meshlessmultigridpoisson_tpu.parallel.partition import hierarchy_to_f32

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.parallel import dryrun, runtime
from meshlessmultigridpoisson_torch.parallel import sharded as tsh
from meshlessmultigridpoisson_torch.parallel.partition import (
    INTER_ARRAYS,
    LEVEL_ARRAYS,
    TRANSFER_ARRAYS,
    partition_hierarchy,
)
from test_torch_native import ensure_native_geometry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [600, 2500]
CYCLES = 25
F32_CYCLES = 4
META = ("n", "n_pad2", "num_shards", "shard_rows", "frontier_rows", "phases",
        "block_rows", "class_size", "width", "has_lagrange", "omega", "iters")


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


@pytest.fixture(scope="module")
def problems():
    """name -> (reference problem, port host hierarchy, logical fine b)."""
    ensure_native_geometry()
    out = {}
    for name, neumann in (("dirichlet", False), ("neumann", True)):
        pj = jmake("square", sizes=SIZES, poly_deg=4, k1=1, neumann=neumann)
        b_log = np.asarray(pj.hierarchy.finest.to_logical(pj.state0.b[-1]))
        out[name] = (pj, interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy)), b_log)
    return out


def _mesh(p):
    return Mesh(np.array(jax.devices()[:p]), (jsh.AXIS,))


# each world's tasks: (P, [(name, problem, task options)])
WORLDS = {
    2: [("vc_dirichlet", "dirichlet", dict(kind="vcycle", cycles=CYCLES)),
        ("solver_dirichlet", "dirichlet", dict(kind="solver", max_cycles=400, tol=1e-8)),
        ("bicgstab_dirichlet", "dirichlet", dict(kind="bicgstab", max_iters=200, tol=1e-8)),
        ("bicgstab_neumann", "neumann", dict(kind="bicgstab", max_iters=200, tol=1e-8,
                                             plain_checks=True)),
        ("vc32_dirichlet", "dirichlet", dict(kind="vcycle", cycles=F32_CYCLES,
                                             dtype="float32"))],
    # both levels sharded (no tail: the coarsest sharded level's double
    # smooth, the inter-level all-reduce and all-gather)
    4: [("vc2_dirichlet", "dirichlet", dict(kind="vcycle", cycles=CYCLES, shard_levels=2,
                                            plain_checks=True)),
        ("vc_neumann", "neumann", dict(kind="vcycle", cycles=CYCLES))],
}


@pytest.fixture(scope="module")
def worlds(problems, tmp_path_factory):
    """P -> rank 0's results of one spawned gloo world of P ranks."""
    out = {}
    for p, tasks in WORLDS.items():
        names = sorted({prob for _, prob, _ in tasks})
        out[p] = dryrun.spawn(
            p, [(problems[n][1], problems[n][2]) for n in names],
            [dict(name=name, problem=names.index(prob), **opts)
             for name, prob, opts in tasks],
            device="cpu", workdir=str(tmp_path_factory.mktemp(f"world{p}")))
    return out


def _reference_cycles(pj, b_log, p, cycles, shard_levels=1, f32=False):
    """The reference's sharded V-cycle: (history, sharded x, shier)."""
    shier = jpartition(pj.hierarchy, p, shard_levels=shard_levels)
    if f32:
        shier = hierarchy_to_f32(shier)
    mesh = _mesh(p)
    cycle = jsh.make_sharded_vcycle(shier, mesh)
    dt = jnp.float32 if f32 else jnp.float64
    bf = jsh.shard_vector(shier, mesh, b_log).astype(dt)
    xf, xl, zero = jnp.zeros_like(bf), jnp.zeros((), dt), jnp.zeros((), dt)
    hist = []
    for _ in range(cycles):
        xf, xl, r = cycle(xf, xl, bf, zero)
        hist.append(float(r))
    return np.asarray(hist), jsh.unshard_vector(shier, np.asarray(xf, np.float64))


# ---------------------------------------------------------------------------
# 1. the partition, array for array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard_levels", [1, 2])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", ["dirichlet", "neumann"])
def test_partition_equals_reference(problems, name, p, shard_levels):
    pj, hier, _ = problems[name]
    ref = jpartition(pj.hierarchy, p, shard_levels=shard_levels)
    got = partition_hierarchy(hier, p, shard_levels=shard_levels)
    tree = interop.sharded_to_numpy(got)
    assert len(tree["sharded"]) == len(ref.sharded) == shard_levels
    np.testing.assert_array_equal(tree["newpos"], ref.newpos)
    for lr, lg in zip(ref.sharded, tree["sharded"]):
        for k in META:
            assert lg[k] == getattr(lr, k), k
        for k in LEVEL_ARRAYS:
            a, b = np.asarray(getattr(lr, k)), lg[k]
            assert b.dtype == a.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=k)
    for k in TRANSFER_ARRAYS:
        np.testing.assert_array_equal(tree[k], np.asarray(getattr(ref, k)), k)
    for k in INTER_ARRAYS:
        assert len(tree[k]) == shard_levels - 1
        for a, b in zip(getattr(ref, k), tree[k]):
            np.testing.assert_array_equal(b, np.asarray(a), k)
    assert len(tree["coarse"]["levels"]) == len(ref.coarse.levels)
    # a rank's pieces are the stacked arrays' slices
    s = p - 1
    piece = got.shard(s)
    np.testing.assert_array_equal(piece.fine.lcols_ext, got.fine.lcols_ext[s])
    np.testing.assert_array_equal(piece.restrict_vals, got.restrict_vals[s])
    assert got.fine.has_bound == (name == "neumann")


# ---------------------------------------------------------------------------
# 2. the frontier and interior passes' plain versions, shard by shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,name", [(2, "dirichlet"), (4, "neumann")])
def test_frontier_and_interior_passes_match_scan_tiles(problems, p, name):
    pj, hier, _ = problems[name]
    ref = jpartition(pj.hierarchy, p).fine
    got = partition_hierarchy(hier, p).fine
    rng = np.random.default_rng(p)
    S, ns, nf = got.class_size, got.shard_rows, got.frontier_rows
    assert nf > 0 and got.phases >= 2
    for s in range(p):
        fs = jax.tree_util.tree_map(lambda a: a[s], ref)
        lv = tsh.shard_level(got.shard(s), "cpu", torch.float64, colored=False)
        assert lv.kind == "v6-oneshot" and lv.front.A.ncols == got.ext_rows
        x_ext = rng.standard_normal(got.ext_rows)
        b = rng.standard_normal(ns)
        xl = 0.37
        # frontier: class SOR over rows [0, nf) of x_ext (rows past nf read)
        out = x_ext.copy()
        out_t = torch.from_numpy(out)
        tsh.gk.class_sor_sweep(lv.front, out_t, torch.tensor(xl, dtype=torch.float64),
                               torch.from_numpy(b[:nf]).contiguous())
        want = np.asarray(jsh._scan_tiles(fs, jnp.asarray(x_ext), xl, jnp.asarray(b), 0,
                                          nf // S, True))
        np.testing.assert_array_equal(out[nf:], x_ext[nf:])
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-12 * np.abs(want).max())
        # interior: the storage-order block sweep with the interior-masked K
        x = torch.from_numpy(x_ext[:ns].copy())
        tsh.interior_sweep(lv, x, torch.tensor(xl, dtype=torch.float64), torch.from_numpy(b))
        x_pad = np.concatenate([x_ext[:ns], np.zeros(got.halo)])
        want = np.asarray(jsh._scan_tiles(fs, jnp.asarray(x_pad), xl, jnp.asarray(b),
                                          nf // S, ns // S, True))[:ns]
        np.testing.assert_array_equal(x.numpy()[:nf], x_ext[:nf])
        np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("field,value", [("class_size", 3), ("block_rows", 200)])
def test_interior_pass_refuses_a_shard_no_block_sweep_takes(problems, field, value):
    """The interior pass is a block sweep (colored or storage order) or
    nothing: a shard that no block sweep takes raises, on every path that
    repacks it."""
    f = partition_hierarchy(problems["dirichlet"][1], 2).fine.shard(0)
    assert tsh.interior_colored(f) in (True, False)
    with pytest.raises(ValueError, match="no block sweep takes this shard"):
        tsh.interior_colored(dataclasses.replace(f, **{field: value}))


@pytest.mark.parametrize("p,task,levels,checks", [
    (2, "bicgstab_neumann", 1, ("frontier", "interior", "spmv_ext", "bound2_ext")),
    (4, "vc2_dirichlet", 2, ("frontier", "interior", "spmv_ext"))])
def test_plain_checks_cover_every_rank_and_level(worlds, p, task, levels, checks):
    """A task's ``plain_checks`` hold every rank's kernels on every level
    the task repacked against their plain versions, gathered to rank 0
    (here the kernels are their plain versions: errors 0)."""
    pc = worlds[p][task]["plain_checks"]
    errs = np.asarray(pc["errors"])
    assert errs.shape == (p, levels, len(dryrun.PLAIN_CHECKS))
    assert np.asarray(pc["levels"]).shape == (levels, 3)
    for k, name in enumerate(dryrun.PLAIN_CHECKS):
        e = errs[:, :, k]
        if name in checks:
            assert np.isfinite(e).any(), name
            assert np.nanmax(e) == 0.0, name
        else:
            assert not np.isfinite(e).any(), name


# ---------------------------------------------------------------------------
# 3. the sharded V-cycle, P = 2 and 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,task,name,shard_levels", [
    (2, "vc_dirichlet", "dirichlet", 1), (4, "vc2_dirichlet", "dirichlet", 2),
    (4, "vc_neumann", "neumann", 1)])
def test_sharded_vcycle_matches_reference(problems, worlds, p, task, name, shard_levels):
    pj, _, b_log = problems[name]
    res = worlds[p][task]
    hist_ref, x_ref = _reference_cycles(pj, b_log, p, CYCLES, shard_levels)
    hist = np.asarray(res["history"])
    assert hist[0] == pytest.approx(1.0) and np.isfinite(hist).all()
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-10, atol=0)
    np.testing.assert_allclose(res["x"], x_ref, rtol=0, atol=1e-10 * np.abs(x_ref).max())
    assert res["launches"] == {}  # plain versions on the CPU: no kernel launched
    # the collectives rank 0 made, as counted from the partition's metadata
    model = {k: CYCLES * v for k, v in res["comm_model"].items()}
    assert res["comm"] == model and model["exchange"] > 0
    assert (model["all_gather"] > 0) == (shard_levels == 2)
    # the serial engine's bar (tests/test_parallel.py:78-112)
    state, hist_serial = jrun(pj.hierarchy, pj.state0, CYCLES)
    hs = np.asarray(hist_serial)
    assert hist[-1] < 10 * hs[-1] + 1e-12
    serial = np.asarray(pj.hierarchy.finest.to_logical(state.x[-1]))
    x = np.asarray(res["x"])
    if name == "neumann":
        x, serial = x - x.mean(), serial - serial.mean()
    assert np.abs(x - serial).max() / np.abs(serial).max() < 10 * max(hist[-1], hs[-1])


# ---------------------------------------------------------------------------
# 4. the solver and BiCGStab, P = 2
# ---------------------------------------------------------------------------


def test_sharded_solver_matches_reference(problems, worlds):
    pj, _, b_log = problems["dirichlet"]
    res = worlds[2]["solver_dirichlet"]
    shier = jpartition(pj.hierarchy, 2)
    mesh = _mesh(2)
    bf = jsh.shard_vector(shier, mesh, b_log)
    xf, _, it, resid = jsh.make_sharded_solver(shier, mesh, max_cycles=400)(
        jnp.zeros_like(bf), jnp.zeros(()), bf, jnp.zeros(()), 1e-8)
    assert float(resid) < 1e-8 and res["resid"] < 1e-8
    assert res["iters"] == int(it)
    x_ref = jsh.unshard_vector(shier, xf)
    np.testing.assert_allclose(res["x"], x_ref, rtol=0, atol=1e-9 * np.abs(x_ref).max())


@pytest.fixture(scope="module")
def serial_solutions(problems):
    """name -> (logical solution, L1 error) of the serial BiCGStab to 1e-10."""
    out = {}
    for name, (pj, _, _) in problems.items():
        st, _, _ = jbicgstab(pj.hierarchy, pj.state0, tol=1e-10)
        x = np.asarray(pj.hierarchy.finest.to_logical(st.x[-1]))
        out[name] = (x, _l1(pj, x))
    return out


def _l1(pj, x):
    if pj.neumann:
        x = x + (pj.exact.mean() - x.mean())
    return float(np.abs(x - pj.exact).mean())


@pytest.mark.parametrize("name", ["dirichlet", "neumann"])
def test_sharded_bicgstab_matches_reference_and_serial(problems, worlds, serial_solutions,
                                                       name):
    pj, _, b_log = problems[name]
    res = worlds[2][f"bicgstab_{name}"]
    shier = jpartition(pj.hierarchy, 2)
    mesh = _mesh(2)
    bf = jsh.shard_vector(shier, mesh, b_log)
    xf, _, it, resid = jsh.make_sharded_bicgstab(shier, mesh, max_iters=200)(
        jnp.zeros_like(bf), jnp.zeros(()), bf, jnp.zeros(()), 1e-8)
    assert 0 <= float(resid) < 1e-8 and 0 <= res["resid"] < 1e-8
    x, x_ref = np.asarray(res["x"]), jsh.unshard_vector(shier, xf)
    if name == "dirichlet":  # well-posed to rounding: the same iterates
        assert res["iters"] == int(it)
        np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-9 * np.abs(x_ref).max())
    serial, l1_serial = serial_solutions[name]
    xs = x - x.mean() if name == "neumann" else x
    ss = serial - serial.mean() if name == "neumann" else serial
    assert np.abs(xs - ss).max() / np.abs(ss).max() < 1e-6
    assert _l1(pj, x) < 1.5 * l1_serial + 1e-12


def test_sharded_bicgstab_from_zero_on_inhomogeneous_dirichlet():
    """From a zero guess on a problem with g != 0 on its Dirichlet rows
    (square_with_circle: sin sin on the circle) the port's sharded
    BiCGStab converges like the serial one: it pins the guess to x_d = g
    first (the reference's stalls there, ROADMAP queue 3).  One rank, in
    process, no process group."""
    from meshlessmultigridpoisson_torch.mg.krylov import solve_bicgstab
    from meshlessmultigridpoisson_torch.models.poisson import l1_error, make_poisson_problem

    prob = make_poisson_problem("square_with_circle", sizes=[600, 2500, 5000], poly_deg=4,
                                ordering="kdtile", block_rows=512)
    op = prob.hierarchy.finest
    assert float(op.dirichlet_values.abs().max()) > 0.5
    mesh = runtime.solver_mesh(device="cpu")
    shier = partition_hierarchy(prob.hierarchy, 1, shard_levels=2)
    bf = tsh.shard_vector(shier, mesh, op.to_logical(prob.state0.b[-1]).numpy())
    x, _, it, resid = tsh.make_sharded_bicgstab(shier, mesh, max_iters=40)(
        torch.zeros_like(bf), 0.0, bf, 0.0, 1e-8)
    assert 0 <= resid < 1e-8 and it < 40
    st, _, _ = solve_bicgstab(prob.hierarchy, prob.state0, tol=1e-10)
    x_pad = op.to_padded(torch.from_numpy(tsh.unshard_vector(shier, x.numpy())))
    assert l1_error(prob, x_pad) < 1.5 * l1_error(prob, st.x[-1]) + 1e-12


# ---------------------------------------------------------------------------
# 5. the f32 instance
# ---------------------------------------------------------------------------


def test_sharded_vcycle_f32_matches_reference(problems, worlds):
    pj, _, b_log = problems["dirichlet"]
    res = worlds[2]["vc32_dirichlet"]
    hist_ref, x_ref = _reference_cycles(pj, b_log, 2, F32_CYCLES, f32=True)
    np.testing.assert_allclose(res["history"], hist_ref, rtol=2e-4)
    np.testing.assert_allclose(res["x"], x_ref, rtol=0, atol=2e-4 * np.abs(x_ref).max())


# ---------------------------------------------------------------------------
# 6. the runtime
# ---------------------------------------------------------------------------


def test_runtime_single_process_and_world(worlds):
    assert runtime.init_distributed() is False
    assert runtime.init_distributed() is False  # a second call is safe
    one = runtime.solver_mesh(device="cpu")
    assert (one.size, one.rank, one.backend) == (1, 0, "none")
    v = torch.arange(3.0)
    assert one.all_reduce(v) is v and one.all_gather(v) is v
    with pytest.raises(ValueError):
        runtime.solver_mesh(2, device="cpu")
    topo = runtime.topology_summary()
    assert set(topo) == {"num_processes", "process_id", "num_devices", "platform",
                         "device_kind", "backend", "staged"}
    assert topo["num_processes"] == 1 and topo["process_id"] == 0
    assert runtime.choose_backend("cpu", 4, 0) == ("gloo", False)
    assert runtime.choose_backend("cuda", 4, 4) == ("nccl", False)
    assert runtime.choose_backend("cuda", 2, 1) == ("gloo", True)
    for p, res in worlds.items():  # inside the spawned worlds
        assert res["topology"]["num_processes"] == p and res["topology"]["process_id"] == 0
        assert res["topology"]["backend"] == "gloo" and not res["topology"]["staged"]
        assert res["group"]["size"] == p
        np.testing.assert_array_equal(res["group"]["ranks"], np.arange(p))


# ---------------------------------------------------------------------------
# 7. the dry run
# ---------------------------------------------------------------------------


def test_dryrun_two_shards_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "meshlessmultigridpoisson_torch.parallel.dryrun",
                          "--shards", "2", "--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "dryrun: ok" in out.stdout and "backend gloo" in out.stdout
    if not torch.cuda.is_available():  # the card by default: no card, no run
        out = subprocess.run([sys.executable, "-m",
                              "meshlessmultigridpoisson_torch.parallel.dryrun", "--shards",
                              "2"], cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and "dryrun: ok" not in out.stdout


def test_spawn_runs_on_the_card_by_default(monkeypatch):
    """``spawn`` without ``device`` asks for the card, and refuses where
    there is none: a world never lands on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.spawn(1, [], [dict(name="v", kind="vcycle", cycles=1)])
