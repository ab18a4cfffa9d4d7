"""setup.host.stencils_s: the program's span ``setup.stencils`` of the last
hierarchy build (``utils.trace.SPANS``; host clock, summed over levels):
boundary flags and values, and ``build_level_operator``: neighbours,
RBF-FD weights, block-class permutation, ELL.  None where the program keeps
no such span."""


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    return trace.SPANS.get("setup.stencils")
