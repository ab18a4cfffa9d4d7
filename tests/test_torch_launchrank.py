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


def test_call_keys_a_fused_launch_by_its_sweeps(monkeypatch):
    monkeypatch.setattr(gk, "SHAPES", {})
    gk._call("sweep8", 1024, 1024, lambda: 0, sweeps=5)
    gk._call("sweep8", 1024, 1024, lambda: 0, sweeps=1)
    gk._call("sweep8_percolor", 384, 1024, lambda: 0)
    assert gk.SHAPES == {"sweep8 1024x1024x5": 1, "sweep8 1024x1024x1": 1,
                         "sweep8_percolor 384x1024": 1}


def test_launchrank_charges_a_fused_launch_its_sweeps():
    """A fused smoother launch ("role n x n x iters") is part "smooth" with
    ``iters`` times the level's one-sweep bound; a per-color launch of the
    parent design keeps its rows' share of one sweep."""
    rec = _record()
    shape = lambda key, n, ms: {"shape": key, "launches": n, "device_ms": n * ms,  # noqa: E731
                                "device_ms_per_launch": ms}
    rec["extra"]["profile"]["launch_shapes"] = [
        shape("sweep7 256x256x5", 10, 0.05), shape("sweep8 1024x1024x5", 20, 0.4),
        shape("sweep8 1024x1024x1", 3, 0.1), shape("sweep8_percolor 384x1024", 6, 0.02)]
    rows, ranked = launchrank.rank(rec)
    by = {(r["role"], r["level"], r["part"]): r for r in rows}
    assert by[("sweep7", 0, "smooth")]["bound_ms_per_launch"] == pytest.approx(5 * 0.001)
    fused = by[("sweep8", 1, "smooth")]
    assert fused["launches"] == 23
    assert fused["bound_ms_per_launch"] == pytest.approx((20 * 5 + 3) * 0.01 / 23)
    assert fused["excess_ms"] == pytest.approx(20 * 0.4 + 3 * 0.1 - (20 * 5 + 3) * 0.01)
    per = by[("sweep8_percolor", 1, "sweep")]
    assert per["bound_ms_per_launch"] == pytest.approx(0.01 * 384 / 1024)
    assert [role for role, _ in ranked][0] == "sweep8"


def test_smooth_bytes_and_flops_add_the_relax_and_resolve():
    """A smoother call's bytes: the sweep's, the Lagrange row, the boundary
    rows' nonzeros, targets and diagonals, once whatever its sweeps; its
    operations scale with the sweeps."""
    import numpy as np
    import torch

    from meshlessmultigridpoisson_torch.utils import profiling as pf

    n, w, m = 256, 3, 5
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal((n, w))).float()
    vals[::4, -1] = 0.0
    A = gk.DeviceEll(vals=vals, cols=torch.zeros((n, w), dtype=torch.int32), ncols=n,
                     role="spmv8")
    kT = torch.zeros(n // 128, 128, 128)
    kT[:, :, :7] = 1.0
    sw = gk.BlockSweep(A=A, kT=kT, lagc=torch.zeros(n), order=torch.arange(2, dtype=torch.int32),
                       phase_ptr=(0, 1, 2), serial=False, role="sweep8")
    bv = torch.ones(8, 4)
    bv[m:] = 0.0
    bound = gk.DeviceCompact(vals=bv, cols=torch.zeros((8, 4), dtype=torch.int32),
                             rows=torch.zeros(8, dtype=torch.int32), diag=torch.ones(8),
                             nrows=m, n_pad=n, role="bound2")
    lag = torch.ones(n)
    nnz_a, nnz_k = int((vals != 0).sum()), 2 * 128 * 7
    sweep_b = nnz_a * 8 + nnz_k * 4 + n * 4 + 2 * 4 + 3 * n * 4
    assert pf.sweep_bytes(sw) == sweep_b
    assert pf.smooth_bytes(sw) == sweep_b
    assert pf.smooth_bytes(sw, lag, bound) == sweep_b + n * 4 + m * 4 * 8 + m * 8
    per = 2 * nnz_a + 2 * nnz_k + (2 * n + 4) + (2 * m * 4 + 4 * m)
    assert pf.smooth_flops(sw, 5, lag, bound) == 5 * per
    assert pf.smooth_flops(sw, 1) == pf.sweep_flops(sw)


def test_launchrank_subtracts_the_transfer_and_resolve_bounds():
    """A record whose levels carry the bounds of the transfers into them
    and of their re-solve (``profile_hierarchy``'s ``restrict_bound_ms``,
    ``prolong_bound_ms``, ``resolve_bound_ms``): a transfer's and a
    ``bound2`` launch's excess is their device time less that bound."""
    rec = _record()
    rec["extra"]["per_level"][0]["restrict_bound_ms"] = 0.001
    rec["extra"]["per_level"][1]["prolong_bound_ms"] = 0.002
    rec["extra"]["per_level"][1]["resolve_bound_ms"] = 0.0005
    rows, _ = launchrank.rank(rec)
    by = {(r["role"], r["level"], r["part"]): r for r in rows}
    restrict = by[("spmv6", 0, "restrict")]
    assert restrict["bound_ms_per_launch"] == pytest.approx(0.001)
    assert restrict["excess_ms"] == pytest.approx(4 * (0.005 - 0.001))
    prolong = by[("spmv6", 1, "prolong")]
    assert prolong["excess_ms"] == pytest.approx(4 * (0.006 - 0.002))
    assert by[("bound2", 1, "rows")]["excess_ms"] == pytest.approx(8 * (0.002 - 0.0005))
    # the matvec keeps its own bound
    assert by[("spmv8", 1, "matvec")]["excess_ms"] == pytest.approx(5 * (0.01 - 0.004))
