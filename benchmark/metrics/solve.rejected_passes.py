"""solve.rejected_passes: the program's outer passes rolled back because
they made the residual worse (``solve_mixed_stepped``;
``utils.trace.SOLVES``), over the window's solves.  The window's records
are the last ``len(ctx["solves"])`` taken with no profiler recording.
None where the program keeps no such records or counter."""


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    n = len(ctx["solves"])
    recs = [r for r in trace.SOLVES if not r.profiled][-n:]
    if not n or len(recs) < n or not all(hasattr(r, "rejected") for r in recs):
        return None
    return sum(r.rejected for r in recs) / n
