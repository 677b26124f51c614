"""``LoaderCounters``' level-0 fill: valid rows over capacity, the mean
over the batches the loader built, in percent."""


def read(ctx):
    v = ctx.counters.get("loader_fill_l0")
    return 100.0 * v if v else None
