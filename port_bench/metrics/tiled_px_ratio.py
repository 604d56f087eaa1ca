"""The tiling engine's LR pixels through the trunk (tiles with their
halos and edge padding, as its grid says) over the images' own LR
pixels, over the window's requests."""


def read(ctx, suffix):
    done = own = 0
    for r in ctx.requests:
        nh, nw, th, tw = r.grid
        ovh, ovw = r.halos
        done += r.images * nh * nw * (th + 2 * ovh) * (tw + 2 * ovw)
        own += r.images * r.lr_hw[0] * r.lr_hw[1]
    return done / own if own else None
