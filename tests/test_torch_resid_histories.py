"""``probes.resid_histories`` held against the reference on the CPU.

* host mode: the port's f64 V-cycle loop (``mg/vcycle.run_v_cycles``) on
  its own problem against the reference's ``run_v_cycles`` (x64) on the
  reference's, ``square`` deg 4 Dirichlet and Neumann of the sweep ladder,
  20 cycles, 1e-10 relative per cycle (both build the same clouds and
  operators; the histories differ by rounding only);
* the oracle (the port's numpy copy of ``scripts/resid_histories_oracle.py``)
  against the reference script's own on the same configuration, 1e-12;
* the record comparison: the deviation's floor, the first cycle off.

Run as a script (``PYTHONPATH=. python tests/test_torch_resid_histories.py
HOST OUT``) it holds every configuration of a host-mode record against the
reference's own run and the reference's run against its records
(``compare_all``; ``results/resid_histories_host_vs_reference.json``).
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest

from meshlessmultigridpoisson_tpu.mg.vcycle import run_v_cycles as jrun
from meshlessmultigridpoisson_tpu.models.poisson import make_poisson_problem as jmake

from meshlessmultigridpoisson_torch.probes import resid_histories as rh
from test_torch_native import ensure_native_geometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = rh.SWEEP_SIZES["square"]
CYCLES = 20
ORACLE_CYCLES = 4


def _reference_oracle():
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            "_ref_resid_oracle", os.path.join(REPO, "scripts", "resid_histories_oracle.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


@pytest.mark.parametrize("neumann", [False, True], ids=["dirichlet", "neumann"])
def test_host_history_matches_reference(neumann):
    ensure_native_geometry()
    with jax.enable_x64(True):
        pj = jmake("square", sizes=SIZES, poly_deg=4, k1=1, neumann=neumann)
        _, hj = jrun(pj.hierarchy, pj.state0, CYCLES)
        hj = np.asarray(hj)
    prob = rh.problem("square", SIZES, 4, neumann)
    ht, l1 = rh.host_history(prob, CYCLES)
    assert [c.n for c in prob.clouds] == [c.n for c in pj.clouds]
    assert np.isfinite(l1)
    np.testing.assert_allclose(ht, hj, rtol=1e-10, atol=0)


def test_oracle_matches_reference_oracle():
    ref = _reference_oracle()
    ensure_native_geometry()
    with jax.enable_x64(True):
        pj = jmake("square", sizes=SIZES, poly_deg=4, k1=1, neumann=True)
        want = ref.oracle_v_cycles(pj.hierarchy, np.asarray(pj.state0.b[-1]), ORACLE_CYCLES)
    prob = rh.problem("square", SIZES, 4, True)
    got = rh.oracle_v_cycles(prob.hierarchy, np.asarray(prob.state0.b[-1]), ORACLE_CYCLES)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_deviation_reads_the_record_above_its_floor():
    ref = [1.0, 0.5, 1e-6, 1e-13]
    d = rh.deviation([1.0, 0.5 * (1 + 1e-9), 1e-6 * (1 + 1e-7), 5e-13], ref)
    assert d["first_off"] == dict(cycle=2, dev=pytest.approx(1e-7), record=1e-6)
    assert d["max_before"] == pytest.approx(1e-9)
    assert d["max"] == pytest.approx(1e-7)  # the cycle under the floor is not read
    assert rh.deviation([1.0], [1e-13]) == dict(max=None, first_off=None, max_before=None)


def test_undamped_problem_sets_every_omega_scale_to_one():
    prob = rh.problem("square", [170, 600], 4, False, undamped=True)
    for op in prob.hierarchy.levels:
        assert float(op.omega_scale.min()) == float(op.omega_scale.max()) == 1.0


def compare_all(host_record: str, out: str, cycles: int = 100) -> dict:
    """Every configuration of the slice: the reference's ``run_v_cycles``
    (x64) beside the port's host-mode record ``host_record`` (a ``probes.
    resid_histories --device cpu`` output), and the reference's own run
    beside its records; written to ``out``."""
    ensure_native_geometry()
    with open(host_record) as f:
        port = {(r["geom"], r["deg"], r["neumann"]): r for r in json.load(f)["configs"]}
    rec, orc = rh._records()
    rows = []
    with jax.enable_x64(True):
        for geom, sizes, deg, neumann in rh.configs():
            pj = jmake(geom, sizes=sizes, poly_deg=deg, k1=1, neumann=neumann)
            _, hj = jrun(pj.hierarchy, pj.state0, cycles)
            hj = np.asarray(hj).tolist()
            key = (geom, deg, neumann)
            rows.append(dict(
                geom=geom, deg=deg, neumann=neumann, sizes=[c.n for c in pj.clouds],
                port_vs_reference=rh.deviation(port[key]["residual_history"], hj),
                reference_vs_record=rh.deviation(hj, rec[key]["residual_history"]),
                record_r3_vs_r4=rh.deviation(rec[key]["residual_history"],
                                             orc[key]["framework_history"])))
            print(geom, deg, neumann, {k: v["first_off"] for k, v in rows[-1].items()
                                       if isinstance(v, dict)}, flush=True)
    res = dict(cycles=cycles, rtol=rh.RTOL, floor=rh.FLOOR, host_record=host_record,
               configs=rows)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":  # PYTHONPATH=. python tests/test_torch_resid_histories.py HOST OUT
    import sys

    compare_all(sys.argv[1], sys.argv[2])
