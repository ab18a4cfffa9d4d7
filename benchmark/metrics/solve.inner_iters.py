"""solve.inner_iters: the program's BiCGStab iterations, summed over each
solve's outer passes (``utils.trace.SOLVES``), over the window's solves.
The window's records are the last ``len(ctx["solves"])`` taken with no
profiler recording.  None where the program keeps no such records."""


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    n = len(ctx["solves"])
    recs = [r for r in trace.SOLVES if not r.profiled][-n:]
    if not n or len(recs) < n:
        return None
    return sum(r.iters for r in recs) / n
