"""``probes.rho`` (the smoother-rate probes) held against the reference's
``scripts/rho_delta.py``, ``rho_colored.py`` and ``rho_stale.py`` on the
CPU: on one operator (``square``, 2,500 points, deg 4, Neumann: the
smallest configuration of ``results/rho_stale_r3.json``) built by both
packages' ``build_op``, 30 power iterations after which the last 15
norms are averaged, each of the port's rho values (f64, the kernels'
plain versions, the reference's K) within 1e-9 relative of the
reference's function:

* ``delta``: the class-parallel sweep (``rho_delta.rho_framework``, the
  reference's ``ops/smoothers.smooth``) and exact sequential SOR
  (``rho_delta.rho_exact``);
* ``colored``: the block one-shot sweep in storage order and in the
  colored order of ``prepare_colored_sweep(..., max_expand=3.0,
  min_blocks=2)`` (``rho_colored.smoother_factory`` / ``rho_of``);
* ``stale``: groups of 8 blocks from the group's start and the
  block-sequential sweep (``rho_stale.measure``).

Also: the row's fields (host values by both K rules, the record beside
them), and the card mode's refusal without a card.
"""

import os
import sys

import numpy as np
import pytest
import torch

from meshlessmultigridpoisson_tpu.ops import kernels6 as k6
from meshlessmultigridpoisson_tpu.ops import kernels8 as k8
from meshlessmultigridpoisson_tpu.ops.kernels4 import build_oneshot_K

from meshlessmultigridpoisson_torch.probes import rho
from test_torch_native import ensure_native_geometry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ("square", 2500, 4, True)
ITERS, BURN = 30, 15
RTOL = 1e-9


@pytest.fixture(scope="module")
def scripts():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import rho_colored
    import rho_delta
    import rho_stale

    return rho_delta, rho_colored, rho_stale


@pytest.fixture(scope="module")
def ops(scripts):
    ensure_native_geometry()
    jop, jconf = scripts[0].build_op(*CFG)
    built = rho.build_op(*CFG)
    assert (built[0].n_pad, built[1]) == (jop.n_pad, jconf)
    return jop, built


def _close(port, ref):
    assert abs(port - ref) <= RTOL * abs(ref), (port, ref)


def test_delta_matches_rho_delta(scripts, ops):
    jop, (op, _) = ops
    port = rho.rho_pair("delta", op, "cpu", ITERS, BURN)
    _close(port["rho_framework"], scripts[0].rho_framework(jop, iters=ITERS, burn=BURN))
    _close(port["rho_exact_gs"], scripts[0].rho_exact(jop, iters=ITERS, burn=BURN))


def test_colored_matches_rho_colored(scripts, ops):
    rho_colored = scripts[1]
    jop, (op, _) = ops
    nb = jop.n_pad // 128
    kell = k6.prepare_kernel_ell6(jop.A)
    kinvT = build_oneshot_K(jop.A, jop.omega * np.asarray(jop.omega_scale),
                            np.asarray(jop.smooth_mask))
    lagc2 = np.zeros((nb, 128), np.float32)
    lagc2.reshape(-1)[: jop.lag_col.shape[0]] = np.asarray(jop.lag_col, np.float32)
    c8 = k8.prepare_colored_sweep(kell, kinvT, lagc2, max_expand=3.0, min_blocks=2)
    port = rho.rho_pair("colored", op, "cpu", ITERS, BURN)
    assert port["refused"] is None and port["ncolors"] == c8.ncolors
    for order, key in ((np.arange(nb), "rho_storage"), (c8.block_order(), "rho_colored")):
        _close(port[key], rho_colored.rho_of(rho_colored.smoother_factory(jop, order),
                                             jop.n_pad, ITERS, BURN))


def test_stale_matches_rho_stale(scripts, ops):
    rho_stale = scripts[2]
    jop, (op, _) = ops
    port = rho.rho_pair("stale", op, "cpu", ITERS, BURN)
    _close(port["rho_stale_program"], rho_stale.measure(jop, rho_stale.MBROWS, ITERS, BURN))
    _close(port["rho_exact_blockseq"], rho_stale.measure(jop, 128, ITERS, BURN))


def test_row_fields_and_card_refusal(ops):
    row = rho.measure("stale", CFG, "cpu", ITERS, BURN, built=ops[1])
    for key in ("host", "host_port_k"):
        assert set(rho.SIDES["stale"]) <= set(row[key]), key
    # the port's K sums duplicate columns: the block-sequential sweep is
    # then exact block GS, which the class-parallel sweep also is here
    exact = rho.rho_pair("delta", ops[1][0], "cpu", ITERS, BURN)["rho_framework"]
    assert abs(row["host_port_k"]["rho_exact_blockseq"] - exact) <= 1e-9
    assert row["record"]["rho_stale_program"] == pytest.approx(1.822002042, abs=1e-9)
    assert "card" not in row and rho.summary(row).startswith("stale square n=2500")
    if not torch.cuda.is_available():
        assert rho.main(["--kinds", "stale", "--device", "cuda"]) == 1


def test_undamped_row_reproduces_the_record(ops):
    """At the full omega on every row (the operator before the reference
    damped its coloring conflicts) and the record's 120 / 60 iterations,
    the host mode gives ``results/rho_stale_r3.json``'s values."""
    row = rho.measure("stale", CFG, "cpu", built=ops[1], undamped=True)
    for side in rho.SIDES["stale"]:
        _close(row["host"][side], row["record"][side])


if __name__ == "__main__":
    # the full comparison (not a test): every configuration of the three
    # records at the scripts' 120 / 60 iterations, the reference's functions
    # beside the port's host mode, written to results/rho_host_vs_reference.json
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_rho.py
    import json

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import rho_colored
    import rho_delta
    import rho_stale

    ensure_native_geometry()
    out = []
    for kind, cfgs in rho.CONFIGS.items():
        for cfg in cfgs:
            jop, jconf = rho_delta.build_op(*cfg)
            built = rho.build_op(*cfg)
            row = rho.measure(kind, cfg, "cpu", built=built)
            nb = jop.n_pad // 128
            if kind == "delta":
                ref = {"rho_framework": rho_delta.rho_framework(jop),
                       "rho_exact_gs": rho_delta.rho_exact(jop)}
            elif kind == "stale":
                ref = {"rho_stale_program": rho_stale.measure(jop, rho_stale.MBROWS),
                       "rho_exact_blockseq": rho_stale.measure(jop, 128)}
            else:
                kell = k6.prepare_kernel_ell6(jop.A)
                kinvT = build_oneshot_K(jop.A, jop.omega * np.asarray(jop.omega_scale),
                                        np.asarray(jop.smooth_mask))
                lagc2 = np.zeros((nb, 128), np.float32)
                lagc2.reshape(-1)[: jop.lag_col.shape[0]] = np.asarray(jop.lag_col,
                                                                       np.float32)
                c8 = k8.prepare_colored_sweep(kell, kinvT, lagc2, max_expand=3.0,
                                              min_blocks=2)
                ref = {k: rho_colored.rho_of(rho_colored.smoother_factory(jop, o),
                                             jop.n_pad, rho.ITERS, rho.BURN)
                       for k, o in (("rho_storage", np.arange(nb)),
                                    ("rho_colored", c8.block_order()))}
            row["reference_here"] = ref
            row["host_minus_reference_here"] = {k: row["host"][k] - v
                                                for k, v in ref.items()}
            print(rho.summary(row), "| reference here:", json.dumps(ref), flush=True)
            out.append(row)
    with open(os.path.join(REPO, "results", "rho_host_vs_reference.json"), "w") as f:
        json.dump(out, f, indent=1)
