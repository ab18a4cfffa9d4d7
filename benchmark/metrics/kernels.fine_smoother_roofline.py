"""kernels.fine_smoother_roofline: the finest smoother call's least time
(its inputs read once, its outputs written once, over the card's peaks)
over its device time, in %."""

from benchmark.yardstick import fine


def read(ctx):
    got = fine.smoother(ctx)
    return None if got is None else 100.0 * got[1] / got[0]
