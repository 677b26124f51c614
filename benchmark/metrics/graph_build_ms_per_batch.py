"""Worker milliseconds per ``BatchBuilder.build_host`` call (the fused
host graph build of one batch), over the calls that ended in the window."""


def read(ctx):
    xs = ctx.build_s
    return 1e3 * sum(xs) / len(xs) if xs and not ctx.resident else None
