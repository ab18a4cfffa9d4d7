"""``probes.ns_long``: the long NS run split over calls through a
checkpoint, on the CPU.

* 2 + 2 steps through ``save`` / ``load`` are bit for bit 4 straight steps
  (``--sizes 170 600 --deg 4``, the plain versions): the fs_residual of
  every step, u, v and the fine pressure;
* the parts' join: continuity, the u L1 targets after steps 1000 and 2000,
  the fs_residual of every 4th step against the record, the step times'
  median and p90 with their count.
"""

import json
import os

import numpy as np
import pytest
import torch

from meshlessmultigridpoisson_torch.probes import ns_long

torch.set_num_threads(1)


def test_split_run_equals_straight_run(tmp_path):
    prob, gfs = ns_long.build([170, 600], 4, "cpu")
    s4, r4 = ns_long.run_part(prob, gfs, 4)
    s2, r2 = ns_long.run_part(prob, gfs, 2)
    path = ns_long.save(str(tmp_path / "state"), s2, 2)
    assert os.path.exists(path)
    state, start = ns_long.load(str(tmp_path / "state"))
    s22, r22 = ns_long.run_part(prob, gfs, 2, state, start)
    assert r22["start"] == 2 and r2["fs_residual"] + r22["fs_residual"] == r4["fs_residual"]
    for a, b in ((s22.u, s4.u), (s22.v, s4.v), (s22.mg.x[-1], s4.mg.x[-1])):
        assert torch.equal(a, b)
    m = ns_long.merge([r2, r22])
    assert m["steps"] == 4 and m["fs_residual"] == r4["fs_residual"]
    assert m["step_time_s"]["count"] == 4 and m["ok"]


def _part(start, steps, hist, l1):
    return dict(start=start, steps=steps, sizes=[188, 598, 2347, 9055], fs_residual=hist,
                u_l1=l1, step_time_s=[1.0 + 0.001 * i for i in range(steps)],
                wall_s=float(steps), platform="cuda", card="card", power_limit="700 W")


def test_merge_holds_the_targets():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ns_long.RECORD)) as f:
        record = json.load(f)
    ref = np.repeat(record["residual_history"], 4)
    a = _part(0, 1000, list(ref[:1000]), [[1000, 0.112 * 1.01]])
    b = _part(1000, 1000, list(ref[1000:]), [[2000, 0.04525 * 0.99]])
    m = ns_long.merge([a, b], record)
    assert m["ok"] and m["steps"] == 2000 and m["step_time_s"]["count"] == 2000
    assert m["checks"]["fs_residual_vs_record"]["n"] == 500
    off = ns_long.merge([a, dict(b, u_l1=[[2000, 0.05]])], record)
    assert not off["ok"] and not off["checks"]["u_l1_at_2000"]["ok"]
    with pytest.raises(ValueError, match="continue"):
        ns_long.merge([a, dict(b, start=999)])
