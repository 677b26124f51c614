"""Model FLOPs the traced steps require (counted from each batch's voxel
coordinates, backward twice the forward, no recomputation) over the traced
steps' wall time, over the dense bf16 tensor-core peak, in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced_flops or tr.window_s <= 0 or tr.busy_s() <= 0:
        return None
    return 100.0 * sum(ctx.traced_flops) / ctx.trace.window_s / ctx.bf16_peak
