"""solve.launches: the program's kernel launches (``gpu_kernels.COUNTS``,
every role) over the window, a solve."""


def read(ctx):
    return sum(ctx["launches"].values()) / len(ctx["solves"])
