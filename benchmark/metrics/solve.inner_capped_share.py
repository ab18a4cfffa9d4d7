"""solve.inner_capped_share: the share of the window's inner solves (one an
outer pass) that stopped at their iteration cap with their residual still
at or above their tolerance (``utils.trace.SOLVES``: ``capped`` over
``passes``), in %.  The window's records are the last
``len(ctx["solves"])`` taken with no profiler recording.  None where the
program keeps no such records or counter."""


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    n = len(ctx["solves"])
    recs = [r for r in trace.SOLVES if not r.profiled][-n:]
    if not n or len(recs) < n or not all(hasattr(r, "capped") for r in recs):
        return None
    passes = sum(r.passes for r in recs)
    return 100.0 * sum(r.capped for r in recs) / passes if passes else None
