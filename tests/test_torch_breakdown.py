"""``probes.vcycle_breakdown`` on the CPU (the kernels' plain versions, the
host clock): on the ``solve`` problem of ``--geom square --sizes 170 600
--deg 4``, every key of the breakdown is there for every level and
transfer, the modelled cycle is the schedule's sum of the parts (two
smoother calls a level, a residual on each level but the coarsest, one
restriction and one prolongation a transfer), the output says it holds no
device time, and the card mode refuses without a card."""

import json

import pytest
import torch

from meshlessmultigridpoisson_torch.probes import vcycle_breakdown as vb

torch.set_num_threads(1)

ARGV = ["--geom", "square", "--sizes", "170", "600", "--deg", "4"]


@pytest.fixture(scope="module")
def res():
    return vb.run(ARGV, "cpu")


def test_every_piece_is_there(res):
    assert [lv["level"] for lv in res["levels"]] == [0, 1]
    for lv in res["levels"]:
        assert {"n", "n_pad", "kernel", "role", "iters", "smooth_ms", "residual_ms"} <= set(lv)
        assert lv["smooth_ms"] > 0 and lv["residual_ms"] > 0
    assert [(t["restrict"], t["prolong"]) for t in res["transfers"]] == [("L1->L0", "L0->L1")]
    for key in ("vcycle_wall_ms", "vcycle_chain_ms", "outer_residual64_ms", "gap_ms"):
        assert isinstance(res[key], float), key
    assert res["sizes"][-1] == res["levels"][-1]["n"]
    assert res["setup_s"]["host_problem"] > 0 and res["setup_cache"] is None
    json.dumps(res)  # one JSON line


def test_model_is_the_schedule_sum(res):
    lv, t = res["levels"], res["transfers"][0]
    want = (2 * lv[0]["smooth_ms"] + 2 * lv[1]["smooth_ms"] + lv[1]["residual_ms"]
            + t["restrict_ms"] + t["prolong_ms"])
    assert res["vcycle_model_ms"] == pytest.approx(want, rel=1e-12)
    assert res["gap_ms"] == pytest.approx(res["vcycle_chain_ms"] - want, rel=1e-12)


def test_a_cpu_run_holds_no_device_time(res):
    assert res["clock"].startswith("host clock")
    assert res["vcycle_device_busy_ms"] == res["host_dispatch_share"] == (
        "not measured (no CUDA device)")
    assert "name" not in res and "device busy not measured" in vb.report(res)
    if not torch.cuda.is_available():
        assert vb.main([*ARGV]) == 1
