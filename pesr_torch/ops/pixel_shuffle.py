"""Sub-pixel (PixelShuffle) depth-to-space in NHWC.

Counterpart of ``pesr_tpu/ops/pixel_shuffle.py``.  Channel-order
contract (torch checkpoint parity): torch's NCHW pixel_shuffle maps input
channel ``c*r*r + i*r + j`` to output channel ``c`` at spatial offset
``(i, j)``; the same order holds here in NHWC:

    out[b, h*r + i, w*r + j, c] == x[b, h, w, c*r*r + i*r + j]
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space: [B, H, W, C*r^2] -> [B, H*r, W*r, C] (NHWC)."""
    if r == 1:
        return x
    b, h, w, c_in = x.shape
    if c_in % (r * r) != 0:
        raise ValueError(f"channels {c_in} not divisible by r^2={r * r}")
    c = c_in // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)  # B,H,i,W,j,C
    return x.reshape(b, h * r, w * r, c)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Space-to-depth, the inverse of :func:`pixel_shuffle`:
    [B, H*r, W*r, C] -> [B, H, W, C*r^2] (NHWC)."""
    if r == 1:
        return x
    b, hr, wr, c = x.shape
    if hr % r or wr % r:
        raise ValueError(f"spatial dims {(hr, wr)} not divisible by r={r}")
    h, w = hr // r, wr // r
    x = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)  # B,H,W,C,i,j
    return x.reshape(b, h, w, c * r * r)
