"""Device idle per traced step (ms) while the step thread runs the model's
forward or the objective (``lgs.step.forward``, ``lgs.step.loss``)."""

from lgsb import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, ("lgs.step.forward", "lgs.step.loss"))
