"""solve_s: the window's seconds over the solves it completed (host clock;
each solve ends in a device synchronisation)."""


def read(ctx):
    return ctx["spans"]["window"] / len(ctx["solves"])
