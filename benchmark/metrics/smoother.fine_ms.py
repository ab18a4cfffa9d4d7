"""smoother.fine_ms: device milliseconds of one fused smoother call on the
finest level (profiler, under its launch-shape range)."""

from benchmark.yardstick import fine


def read(ctx):
    got = fine.smoother(ctx)
    return None if got is None else got[0]
