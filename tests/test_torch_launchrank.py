"""Launch shapes and their ranking (``gpu_kernels.SHAPES``, ``_call``;
``probes.launchrank``), on the CPU with a made-up profile."""

import pytest

from meshlessmultigridpoisson_torch.ops import gpu_kernels as gk
from meshlessmultigridpoisson_torch.probes import launchrank


def test_call_counts_shapes_only_during_a_measurement_run(monkeypatch):
    assert gk.SHAPES is None
    assert gk._call("spmv6", 256, 512, lambda a, b: a + b, 1, 2) == 3
    monkeypatch.setattr(gk, "SHAPES", {})
    for _ in range(3):
        gk._call("sweep8", 128, 512, lambda: 0)
    gk._call("spmv6", 256, 512, lambda: 0)
    assert gk.SHAPES == {"sweep8 128x512": 3, "spmv6 256x512": 1}


def _record():
    shape = lambda key, n, ms: {"shape": key, "launches": n, "device_ms": n * ms,  # noqa: E731
                                "device_ms_per_launch": ms}
    per_level = [{"sweep_bound_ms": 0.001, "matvec_bound_ms": 0.0005},
                 {"sweep_bound_ms": 0.01, "matvec_bound_ms": 0.004}]
    return {"wall_time_s": 1.0, "extra": {"device": "card", "per_level": per_level,
                                          "profile": {"launch_shapes": [
        shape("sweep7 256x256", 10, 0.1),
        shape("sweep8 384x1024", 20, 0.02), shape("sweep8 640x1024", 20, 0.03),
        shape("spmv8 1024x1024", 5, 0.01), shape("spmv6 256x1024", 4, 0.005),
        shape("spmv6 1024x256", 4, 0.006), shape("bound2 128x1024", 8, 0.002)]}}}


def test_launchrank_groups_by_level_and_part():
    rows, ranked = launchrank.rank(_record())
    by = {(r["role"], r["level"], r["part"]): r for r in rows}
    sw = by[("sweep8", 1, "sweep")]
    assert sw["launches"] == 40
    assert sw["device_ms_per_launch"] == pytest.approx((20 * 0.02 + 20 * 0.03) / 40)
    # each color's launch takes its rows' share of the level's sweep bound
    assert sw["bound_ms_per_launch"] == pytest.approx(0.01 * (384 + 640) / 1024 / 2)
    assert by[("spmv8", 1, "matvec")]["bound_ms_per_launch"] == pytest.approx(0.004)
    assert by[("spmv6", 0, "restrict")]["excess_ms"] == pytest.approx(0.02)
    assert by[("spmv6", 1, "prolong")]["launches"] == 4
    assert by[("bound2", 1, "rows")]["excess_ms"] == pytest.approx(0.016)
    assert by[("sweep7", 0, "sweep")]["excess_ms"] == pytest.approx(10 * (0.1 - 0.001))
    assert [role for role, _ in ranked] == ["sweep7", "sweep8", "spmv6", "spmv8", "bound2"]
    assert ranked[1][1] == pytest.approx(1.0 - 0.2)
