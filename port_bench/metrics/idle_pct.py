"""The share of the traced window in which no kernel, memcpy or memset
ran on the device, in %."""


def read(ctx, suffix):
    if ctx.trace is None:
        return None
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
