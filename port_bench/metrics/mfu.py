"""The whole step's share of the chip's peaks: the model's least time
over the images' own LR pixels completed in the window (no tiles, no
halo; its family's operations per LR pixel, the path's low-precision
part at the int8 peak, the rest at bf16; EDSR: the folded form, the
int8 path's residual blocks and tail conv at int8), over the window's
seconds, in %."""

from port_bench.reference.counts import model_seconds


def read(ctx, suffix):
    if ctx.trace is None or ctx.window_s <= 0:
        return None
    px = sum(r.images * r.lr_hw[0] * r.lr_hw[1] for r in ctx.requests)
    return 100.0 * model_seconds(ctx.model, ctx.mix["path"], px) / ctx.window_s
