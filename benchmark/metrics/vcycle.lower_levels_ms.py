"""vcycle.lower_levels_ms: device milliseconds a V-cycle on every level below
the finest: the kernels inside the program's profiler ranges "vcycle L{i}
down|coarse|up" for i below the finest level, traced while
``gpu_kernels.SHAPES`` is on, over the V-cycles of the solves traced with
the ranges (``utils.trace.SOLVES``: the last records with ``shapes``).
The empty kernels that mark the ranges' ends (``trace.MARK_KERNEL``) are
left out.  None where the program has no such ranges or records."""

import re

RANGE = re.compile(r"vcycle L(\d+) (down|coarse|up)")


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    shapes = ctx.get("shapes")
    ranges = {m: us for m, us in ((RANGE.fullmatch(k), v) for k, v in
                                  (shapes or {}).get("kernels", {}).items()) if m}
    vcycles = 0
    for r in reversed(trace.SOLVES):
        if not r.shapes:
            break
        vcycles += r.vcycles
    if not ranges or not vcycles:
        return None
    fine = max(int(m.group(1)) for m in ranges)
    us = sum(d for m, ks in ranges.items() if int(m.group(1)) < fine
             for name, d in ks if trace.MARK_KERNEL not in name)
    return us / 1e3 / vcycles
