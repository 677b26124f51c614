"""The traced steps' ``dw`` launches: their least time (bytes once at the
memory rate against operations at the dense bf16 tensor-core peak, the
larger, summed over the launches the model makes on each batch) over their
summed device time, in percent."""

from lgsb import work


def read(ctx):
    if ctx.trace is None or ctx.traced_works is None:
        return None
    names = ctx.names("kernels_dw")
    t = ctx.trace.device_seconds(lambda n: any(k in n for k in names))
    if t <= 0:
        return None
    least = sum(sum(work.dw_bounds(ctx.arch, w, ctx.bw, ctx.bf16_peak,
                                   ctx.representation))
                for w in ctx.traced_works)
    return 100.0 * least / t if least > 0 else None
