"""solve.escalations: the program's escalations of the inner solve
(``solve_mixed_stepped``: inner tolerance / 10, iteration cap x 2, on a
pass that cut the residual by less than its stall factor;
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
    if not n or len(recs) < n or not all(hasattr(r, "escalations") for r in recs):
        return None
    return sum(r.escalations for r in recs) / n
