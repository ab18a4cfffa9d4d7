"""device.idle_share: the share of the traced window in which no operation
ran on the device (1 - union of device intervals / window), in %."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
