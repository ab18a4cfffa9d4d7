"""``cli ns --reference-ppe`` on the host and ``probes.ns_strict_msh``,
held against the reference on the CPU.

* the strict NS run on the committed meshes ``square_170.msh`` /
  ``square_600.msh`` (deg 4, 4 steps): the port's ``cli ns --device cpu
  --reference-ppe`` against the reference CLI's ``--platform cpu
  --reference-ppe`` record, fs_residual per step and the u L1 error to
  1e-10 relative (both the host f64 model with its BiCGStab);
* the generated ``square_2500.msh``: the port's copy of the reference's
  generator writes the same file as the reference's own (points and
  triangles);
* the probe's record check: the divergence step, the compatible run's
  final u L1 error within 1%.
"""

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest

from meshlessmultigridpoisson_torch.probes import ns_strict_msh as nsm
from test_torch_native import ensure_native_geometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSH = [os.path.join(REPO, "tests", "fixtures", f) for f in ("square_170.msh", "square_600.msh")]


def test_cli_ns_strict_matches_reference_cli(tmp_path):
    from meshlessmultigridpoisson_tpu.apps import cli as jcli

    from meshlessmultigridpoisson_torch.apps import cli

    steps, out = 4, tmp_path / "ref.json"
    jcli._ns(argparse.Namespace(
        sizes=[170, 600], deg=4, steps=steps, dt=2e-4, mu=0.025, rho=1.0, ppe_tol=1e-10,
        reference_ppe=True, implicit_diffusion=False, p_relax=0.7, msh=MSH, out=str(out),
        platform="cpu"))
    rj = json.loads(out.read_text())
    rec, prob, last = cli.run_ns(["ns", "--device", "cpu", "--reference-ppe", "--msh", *MSH,
                                  "--deg", "4", "--steps", str(steps)])
    assert rec.config == rj["config"] and rec.config["compatible"] is False
    assert rec.config["sizes"] == [188, 610] and last == {}
    assert len(rec.residual_history) == len(rj["residual_history"]) == steps
    np.testing.assert_allclose(rec.residual_history, rj["residual_history"], rtol=1e-10)
    assert rec.l1_error == pytest.approx(rj["l1_error"], rel=1e-10)


def test_generated_mesh_equals_reference_generator(tmp_path):
    from meshlessmultigridpoisson_tpu.geometry.msh import write_msh
    from meshlessmultigridpoisson_tpu.geometry.pointclouds import make_cloud

    ensure_native_geometry()
    spec = importlib.util.spec_from_file_location(
        "_ref_make_msh_fixtures", os.path.join(REPO, "scripts", "make_msh_fixtures.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    cloud = make_cloud("square", 2500, seed=0)
    ref = tmp_path / "ref.msh"
    write_msh(str(ref), cloud.points, gen.boundary_loops(cloud),
              gen.domain_triangles(cloud.points, "square"))
    mine = tmp_path / "mine" / "square_2500.msh"
    nsm.ensure_msh([(str(mine), 2500)])
    assert mine.read_text() == ref.read_text()
    assert "$Elements" in ref.read_text() and cloud.n == 2355


def test_check_reads_the_record():
    with open(nsm.RECORD) as f:
        record = json.load(f)
    strict = dict(mode="strict-reference", sizes=[188, 610, 2355], diverged_at_step=6)
    compat = dict(mode="compatible", sizes=[188, 610, 2355], diverged_at_step=None,
                  final_u_err=record["runs"][1]["final_u_err"] * 1.005)
    assert nsm.check([strict, compat], record, 200) == []
    assert nsm.check([strict, compat], record, 8) == []  # no final L1 bar off 200 steps
    bad = nsm.check([dict(strict, diverged_at_step=9),
                     dict(compat, final_u_err=compat["final_u_err"] * 1.02)], record, 200)
    assert len(bad) == 2
