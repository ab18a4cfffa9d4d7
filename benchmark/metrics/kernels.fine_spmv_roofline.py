"""kernels.fine_spmv_roofline: the finest f32 matvec's least time (its
table in its own column format, x read once, y written once, over the
card's peaks) over its device time, in %."""

from benchmark.yardstick import fine


def read(ctx):
    got = fine.spmv(ctx)
    return None if got is None else 100.0 * got[1] / got[0]
