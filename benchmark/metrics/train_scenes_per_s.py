"""Scenes of every step completed in the window over the window's time,
in a cell whose batches are resident on the card (an iteration: the step
and its sync)."""


def read(ctx):
    w = ctx.window
    if not ctx.resident or not w.steps or w.seconds <= 0:
        return None
    return w.scenes / w.seconds
