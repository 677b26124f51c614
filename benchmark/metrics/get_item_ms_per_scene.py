"""Worker milliseconds per ``get_item`` call (augmentation and
voxelization of one scene), over the calls that ended in the window."""


def read(ctx):
    xs = ctx.get_item_s
    return 1e3 * sum(xs) / len(xs) if xs and not ctx.resident else None
