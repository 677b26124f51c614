"""Device idle per traced step (ms) while the step thread takes the gradient
norm, the optimizer's update and the metrics (``lgs.step.update``)."""

from lgsb import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, ("lgs.step.update",))
