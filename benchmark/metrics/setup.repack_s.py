"""setup.repack_s: ``gpu_hierarchy``, the f64 outer operator and the defect
hierarchy, host clock to a synchronisation."""


def read(ctx):
    return ctx["spans"]["setup.repack"]
