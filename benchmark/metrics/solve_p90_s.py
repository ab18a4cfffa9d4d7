"""solve_p90_s: the 90th percentile of the window's solve times, each from
its call to its synchronisation (host clock)."""

import statistics


def read(ctx):
    times = [a.seconds for a in ctx["solves"]]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10, method="inclusive")[8]
