"""solve.host_blocked_share: the seconds the program's host spent blocked
in its reads of device values (``utils.trace.SOLVES``) over the window's
solve seconds (host clock, each call to its synchronisation), in %: the
share of the window in which the host was ahead of the card, with no
profiler.  The window's records are the last ``len(ctx["solves"])`` taken
with no profiler recording.  None where the program keeps no such
records."""


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    n = len(ctx["solves"])
    recs = [r for r in trace.SOLVES if not r.profiled][-n:]
    seconds = sum(a.seconds for a in ctx["solves"])
    if not n or len(recs) < n or seconds <= 0:
        return None
    return 100.0 * sum(r.blocked_s for r in recs) / seconds
