"""Device memcpy time (uploads and downloads) per request of the window,
in ms, from the trace."""


def read(ctx, suffix):
    if ctx.trace is None or not ctx.requests:
        return None
    return ctx.trace.sum_us("gpu_memcpy") * 1e-3 / len(ctx.requests)
