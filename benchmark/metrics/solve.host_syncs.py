"""solve.host_syncs: the program's host reads of device values on the
solve path (each residual and breakdown read, the source's copy to the
card; ``utils.trace.SOLVES``), over the window's solves.  The window's
records are the last ``len(ctx["solves"])`` taken with no profiler
recording.  None where the program keeps no such records."""


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    n = len(ctx["solves"])
    recs = [r for r in trace.SOLVES if not r.profiled][-n:]
    if not n or len(recs) < n:
        return None
    return sum(r.syncs for r in recs) / n
