"""The consumer's time waiting for the next batch (``next(it)``), summed
over the window, per step."""


def read(ctx):
    w = ctx.window
    if ctx.resident or not w.steps:
        return None
    return 1e3 * sum(w.wait_s) / w.steps
