"""Share of the traced steps' wall time in which no device operation
runs: the complement of the union of their intervals."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
