"""The traced steps' contrastive-loss kernels (``contrast_fwd``,
``contrast_bwd``): their least time over their summed device time, in
percent. The least time is bytes once at the memory rate: per traced
step, the features read by the forward (level-0 capacity x D f32) and,
by the backward, read again and their gradient written (x 2), D the last
decoder's width. The labels, the negatives' indices, the anchors (which
stay in cache) and the per-row scalars are left out, which lowers the
bound. None where the trace holds no such kernel (a program without the
node) or a traced batch's level 0 has no windowed map to read its
capacity from."""

F32 = 4


def least_seconds(caps, width: int, bw: float) -> float:
    """Bytes once at the memory rate of one forward and one backward of
    the node over each level-0 capacity of ``caps``."""
    return sum(cap * width * F32 * 3 for cap in caps) / bw


def read(ctx):
    if ctx.trace is None or not ctx.traced_works or not ctx.representation:
        return None
    names = ctx.names("kernels_contrast")
    t = ctx.trace.device_seconds(lambda n: any(k in n for k in names))
    if t <= 0:
        return None
    caps = [w.get(0) and w[0]["cap"] for w in ctx.traced_works]
    if not all(caps):
        return None
    return 100.0 * least_seconds(caps, ctx.arch.planes[-1], ctx.bw) / t
