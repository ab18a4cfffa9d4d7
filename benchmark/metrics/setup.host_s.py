"""setup.host_s: ``mg.setup.build_hierarchy`` on the benchmark's clouds
(neighbours, stencil weights, ordering, coloring, stabilisation,
transfers), host clock."""


def read(ctx):
    return ctx["spans"]["setup.host"]
