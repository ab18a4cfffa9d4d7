"""solve.outer_passes: ``solve_mixed_stepped``'s returned outer passes, over
the window's solves."""


def read(ctx):
    return sum(a.passes for a in ctx["solves"]) / len(ctx["solves"])
