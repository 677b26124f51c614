"""From process start to the first timed step: imports, CUDA init, kernel
builds or loads, scenes, weights, the ring or the loader's fill, the proof
and warm-up steps."""


def read(ctx):
    return ctx.setup_s
