"""The finest level's smoother call and f32 SpMV as the traced run saw
them: device milliseconds a launch, and the least time by ``roofline``.

A launch is found by the program's own launch-shape range, "role rows x
cols" ("x sweeps" for a fused smoother call), traced while the program's
``gpu_kernels.SHAPES`` is on; the SpMV's range holds the f64 outer
operator's launches too (one role, one shape), so only its f32 kernel
instances count.  None where the run traced no such launch.
"""

from __future__ import annotations

import torch

from benchmark.yardstick import roofline as rl


def _ms_per_launch(ctx, key: str, keep=lambda name: True):
    shapes = ctx.get("shapes")
    if not shapes or key not in shapes["kernels"]:
        return None
    durs = [us for name, us in shapes["kernels"][key] if keep(name)]
    return sum(durs) / len(durs) / 1e3 if durs else None


def smoother(ctx):
    """(device ms a call, least ms a call) of the fine level's fused
    smoother (a sweep with K), or None."""
    fine = ctx["program"].ghier.levels[-1]
    sw = fine.sweep
    if sw is None or not hasattr(sw, "kT"):
        return None
    ms = _ms_per_launch(ctx, f"{sw.role} {fine.n_pad}x{fine.n_pad}x{fine.iters}")
    if ms is None:
        return None
    lag = fine.lag_row if fine.has_lagrange else None
    bound = fine.bound if fine.bound.nrows else None
    least = rl.bound_ms(rl.smooth_bytes(sw, lag, bound),
                        rl.smooth_flops(sw, fine.iters, lag, bound),
                        sw.A.vals.dtype, ctx["card"])
    return ms, least


def spmv(ctx):
    """(device ms a launch, least ms a launch) of the fine level's f32
    matvec, or None."""
    A = ctx["program"].ghier.levels[-1].A
    ms = _ms_per_launch(ctx, f"{A.role} {A.nrows_pad}x{A.ncols}",
                        lambda name: "float" in name and "double" not in name)
    if ms is None:
        return None
    return ms, rl.bound_ms(rl.spmv_bytes(A), rl.spmv_flops(A), torch.float32, ctx["card"])
