"""solve.boundary_rows_ms: device milliseconds a solve of the ``compact_rows``
launches of roles ``bound2`` (the Neumann rows' re-solves outside the fused
smoother) and ``push2`` (the condensation's pushdown into the right-hand
side): the kernels inside their launch-shape ranges "bound2 ..." and
"push2 ...", traced while ``gpu_kernels.SHAPES`` is on, over the solves
traced with the ranges (``utils.trace.SOLVES``: the last records with
``shapes``).  None where the run traced no such launch."""

ROLES = ("bound2 ", "push2 ")


def read(ctx):
    try:
        from meshlessmultigridpoisson_torch.utils import trace
    except ImportError:
        return None
    shapes = ctx.get("shapes")
    kernels = [us for key, ks in (shapes or {}).get("kernels", {}).items()
               if key.startswith(ROLES) for _, us in ks]
    solves = 0
    for r in reversed(trace.SOLVES):
        if not r.shapes:
            break
        solves += 1
    if not kernels or not solves:
        return None
    return sum(kernels) / 1e3 / solves
