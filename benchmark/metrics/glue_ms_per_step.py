"""Device milliseconds a traced step spends in kernels that are neither
the port's hand-written kernels nor library GEMMs nor copies: elementwise
ops, reductions, gathers and scatters."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced_steps or tr.busy_s() <= 0:
        return None
    skip = [k.lower() for k in ctx.names("kernels_handwritten") + ctx.names("kernels_gemm")]

    def glue(name):
        low = name.lower()
        return not (low.startswith(("memcpy", "memset"))
                    or any(k in low for k in skip))

    return 1e3 * tr.device_seconds(glue) / ctx.traced_steps
