"""The traced steps' ``sel_fwd`` launches: their least time (bytes once
at the memory rate against operations at the f32 peak, the larger, summed
over the launches the model makes on each batch) over their summed device
time, in percent."""

from lgsb import work


def read(ctx):
    if ctx.trace is None or ctx.traced_works is None:
        return None
    names = ctx.names("kernels_sel_fwd")
    t = ctx.trace.device_seconds(lambda n: any(k in n for k in names))
    if t <= 0:
        return None
    least = sum(sum(work.sel_fwd_bounds(ctx.arch, w, ctx.bw, ctx.f32_peak,
                                        ctx.representation))
                for w in ctx.traced_works)
    return 100.0 * least / t if least > 0 else None
