"""``probes.scaling_model`` held against the reference's
``scripts/scaling_model.py`` on the CPU.

* ``comm_model``: the reference's formula on the reference's partition
  against the port's copy on the port's partition of the same hierarchy
  (carried across with ``interop.hierarchy_from_numpy``), at P = 1, 2 and
  4, every count and byte exact, the times to 1e-12 with the reference's
  own rates passed in;
* one point of the curve on a spawned gloo world of 2 ranks (the plain
  versions): the f64 sharded BiCGStab converged and re-checked, the
  collectives counted on rank 0 equal to ``sharded.comm_per_cycle``;
* the f64 sharded BiCGStab's iteration count at P = 1, 2 and 4 on the
  curve's point shape (``ROWS`` rows a shard) against the reference's
  sharded f64 BiCGStab on the same operators (the reference hierarchy
  carried across), within 2 iterations: the count's growth with P is the
  reference's own (the counts of both sides, at this and larger sizes:
  ``results/scaling_iterations_host_vs_reference.json``, written by this
  file run as a script, below).  The Neumann count moves with rounding
  (tests/test_torch_parallel.py), hence the 2;
* the record: the model at the measured figures only (no rate of the
  reference's), the projection's efficiency per measured link.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake
from meshlessmultigridpoisson_tpu.parallel import sharded as jsh
from meshlessmultigridpoisson_tpu.parallel.partition import partition_hierarchy as jpartition

from meshlessmultigridpoisson_torch import interop
from meshlessmultigridpoisson_torch.parallel import dryrun
from meshlessmultigridpoisson_torch.probes import scaling_model as sm
from test_torch_native import ensure_native_geometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 1024  # rows a shard: the reference's point shape at a CPU size


def _reference_script():
    """``scripts/scaling_model.py`` as a module, this process's environment
    (its ``JAX_PLATFORMS`` / ``XLA_FLAGS`` setdefaults) restored after."""
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            "_ref_scaling_model", os.path.join(REPO, "scripts", "scaling_model.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


def _numpy_tree(obj):
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


@pytest.mark.parametrize("P", [1, 2, 4])
def test_comm_model_matches_reference(P):
    ref = _reference_script()
    ensure_native_geometry()
    n = ROWS * P
    pj = jmake("square", sizes=[max(n // 16, 300), max(n // 4, 900), n], poly_deg=4, k1=1,
               neumann=True, ordering="kdtile")
    shj = jpartition(pj.hierarchy, P)
    op = pj.hierarchy.levels[-1]
    nnz = int(np.count_nonzero(np.asarray(op.A.vals)))
    nc = shj.coarse.levels[-1].n_pad if shj.coarse.levels else 0
    want = ref.comm_model(shj.fine, nnz, op.iters, nc)

    facts = sm.partition_facts(interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy)), P)
    assert (facts["nnz_fine"], facts["iters"], facts["nc_tail"]) == (nnz, op.iters, nc)
    rates = dict(sweep_nnz_s=ref.SWEEP_GNNZ_S, spmv_nnz_s=ref.SPMV_GNNZ_S,
                 links=dict(ici=(ref.ICI_BW, ref.LAT_ICI), dcn=(ref.DCN_BW, ref.LAT_DCN)))
    got = sm.comm_model(facts["f"], facts["nnz_fine"], facts["iters"], facts["nc_tail"],
                        rates)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-12), k
    if P > 1:
        assert got["frontier_rows"] > 0 and got["phases"] > 1


def test_point_on_gloo_counts_and_converges():
    row = sm.run_point(2, "cpu", ROWS)
    assert row["backend"] == "gloo" and row["P"] == 2
    assert 0 <= row["solve_residual"] < sm.SOLVE_TOL and row["solve_recheck"] < sm.SOLVE_TOL
    assert row["collectives_counted_per_cycle"] == row["collectives_port_model_per_cycle"]
    assert row["collectives_counted_per_cycle"]["exchange"] > 0
    assert row["exchange"]["bytes"] > 0 and row["all_reduce"]["all_reduce"] == 1


def _iterations(P, n, workdir):
    """(reference, port) (iterations, residual) of the f64 sharded BiCGStab
    at P shards on the curve's problem shape with n fine points, on the
    reference's operators."""
    ensure_native_geometry()
    pj = jmake("square", sizes=[max(n // 16, 300), max(n // 4, 900), n], poly_deg=4, k1=1,
               neumann=True, ordering="kdtile")
    b_log = np.asarray(pj.hierarchy.finest.to_logical(pj.state0.b[-1]))
    shj = jpartition(pj.hierarchy, P)
    mesh = Mesh(np.array(jax.devices()[:P]), (jsh.AXIS,))
    bf = jsh.shard_vector(shj, mesh, b_log)
    _, _, it, resid = jsh.make_sharded_bicgstab(shj, mesh, max_iters=sm.MAX_ITERS)(
        jnp.zeros_like(bf), jnp.zeros(()), bf, jnp.zeros(()), sm.SOLVE_TOL)
    res = dryrun.spawn(P, [(interop.hierarchy_from_numpy(_numpy_tree(pj.hierarchy)), b_log)],
                       [dict(name="bicgstab", kind="bicgstab", max_iters=sm.MAX_ITERS,
                             tol=sm.SOLVE_TOL)], device="cpu", workdir=workdir)
    got = res["bicgstab"]
    return (int(it), float(resid)), (int(got["iters"]), float(got["resid"]))


@pytest.mark.parametrize("P", [1, 2, 4])
def test_bicgstab_iterations_grow_with_shards_as_the_reference(P, tmp_path):
    (ref_it, ref_res), (it, res) = _iterations(P, ROWS * P, str(tmp_path))
    assert 0 <= ref_res < sm.SOLVE_TOL and 0 <= res < sm.SOLVE_TOL
    assert abs(it - ref_it) <= 2, (it, ref_it)


def test_record_uses_only_measured_figures():
    pts = [dict(P=1, backend="nccl", staged=False, frontier_rows=0, phases=1,
                nnz_fine=2_000_000, iters=5, nc_tail=16384, rows_per_shard=65536,
                exchange=dict(seconds=1e-6), all_reduce=dict(seconds=2e-5, all_reduce=1)),
           dict(P=2, backend="gloo", staged=True, frontier_rows=1280, phases=2,
                nnz_fine=4_000_000, iters=5, nc_tail=32768, rows_per_shard=65536,
                exchange=dict(seconds=2e-3, bytes=10240.0, exchange=1, messages=1),
                all_reduce=dict(seconds=1e-3, all_reduce=1, bytes=8.0))]
    rec = sm.assemble(pts, dict(sweep_nnz_s=3e10, spmv_nnz_s=6e10), None)
    assert rec["rates"]["links"] == {"gloo_staged": dict(bytes_s=10240.0 / 2e-3,
                                                         latency_s=1e-3)}
    m = rec["curve"][1]["model"]
    assert m["t_comm_gloo_staged_s"] == pytest.approx(
        m["total_bytes_per_cycle"] / (10240.0 / 2e-3) + m["collective_count"] * 1e-3)
    assert not any("ici" in k or "dcn" in k for k in m)
    assert set(rec["projection_2shards"]) == {str(r) for r in sm.PROJECT_ROWS}
    for row in rec["projection_2shards"].values():
        assert 0 < row["eff"]["gloo_staged"] < 1


if __name__ == "__main__":
    # the iteration counts beside the reference's (not a test): weak
    # scaling at 1,024 and 4,096 rows a shard, and 16,384 fine points split
    # over P = 1, 2, 4; written to results/scaling_iterations_host_vs_reference.json
    #   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    #     PYTHONPATH=. python tests/test_torch_scaling.py
    import json
    import tempfile

    rows = []
    for label, sizes in (("weak, 1024 rows a shard", {P: 1024 * P for P in (1, 2, 4)}),
                         ("weak, 4096 rows a shard", {P: 4096 * P for P in (1, 2, 4)}),
                         ("fixed, 16384 points", {P: 16384 for P in (1, 2, 4)})):
        for P, n in sizes.items():
            with tempfile.TemporaryDirectory() as wd:
                (ri, rr), (pi, pr) = _iterations(P, n, wd)
            rows.append(dict(series=label, P=P, n=n, reference_iters=ri,
                             reference_resid=rr, port_iters=pi, port_resid=pr))
            print(json.dumps(rows[-1]), flush=True)
    with open(os.path.join(REPO, "results", "scaling_iterations_host_vs_reference.json"),
              "w") as f:
        json.dump(dict(solver="f64 sharded BiCGStab, tol 1e-8, from zero", problem=(
            "square deg 4 Neumann kdtile, sizes [n/16, n/4, n]"), rows=rows), f, indent=1)
