"""Device idle per traced step (ms) while the step thread is in the train
step's preparation (``lgs.step.prep``: the batch to the device, its
inverse tiling, the generators, the zeroed gradients)."""

from lgsb import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, ("lgs.step.prep",))
