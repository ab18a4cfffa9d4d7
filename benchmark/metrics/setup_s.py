"""setup_s: the port's set-up, host clock: the hierarchy's host build, the
repack to the card, and one warm-up solve of each of the mix's sources (the
kernel library loads at the first; its nvcc build, in a checkout's first
run, is timed apart)."""


def read(ctx):
    s = ctx["spans"]
    return s["setup.host"] + s["setup.repack"] + s["setup.warmup"]
