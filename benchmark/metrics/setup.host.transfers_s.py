"""setup.host.transfers_s: the program's span ``setup.transfers`` of the last
hierarchy build (``utils.trace.SPANS``; host clock, summed over levels):
both ``build_interp_operator`` calls of each level pair.  None where the
program keeps no such span."""


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    return trace.SPANS.get("setup.transfers")
