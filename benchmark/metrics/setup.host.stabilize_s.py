"""setup.host.stabilize_s: the program's span ``setup.stabilize`` of the last
hierarchy build (``utils.trace.SPANS``; host clock, summed over levels):
``stabilize_level``: the host power iterations that set each level's
smoother damping.  None where the program keeps no such span."""


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    return trace.SPANS.get("setup.stabilize")
