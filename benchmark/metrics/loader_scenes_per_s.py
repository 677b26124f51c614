"""Scenes of every step completed in the window over the window's time,
in a cell the port's loader feeds (an iteration: ``next(it)``, the step,
its sync)."""


def read(ctx):
    w = ctx.window
    if ctx.resident or not w.steps or w.seconds <= 0:
        return None
    return w.scenes / w.seconds
