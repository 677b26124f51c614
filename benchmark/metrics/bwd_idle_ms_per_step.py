"""Device idle per traced step (ms) while the step thread waits on the
backward (``lgs.step.backward``; autograd's own thread does its work) or
averages the gradients over ranks (``lgs.step.allreduce``)."""

from lgsb import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, ("lgs.step.backward", "lgs.step.allreduce"))
