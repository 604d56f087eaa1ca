"""Frozen operation and byte counts, and the chip's published peaks
(NVIDIA H100 SXM data sheet, dense): the yardstick of the roofline and
MFU readers.  Counts are of the useful work at the shapes given,
whatever a schedule computes: a 3x3 conv of ``cin -> cout`` channels is
``9 cin cout`` multiply-adds (2 operations each) per output pixel."""

from __future__ import annotations

import math

from port_bench.reference.weights import upsample_stages

PEAK_BF16 = 989e12      # FLOP/s
PEAK_INT8 = 1979e12     # OP/s
PEAK_HBM = 3.35e12      # B/s


def conv_ops(cin: int, cout: int, k: int = 3) -> int:
    """Operations of one conv per output pixel."""
    return 2 * k * k * cin * cout


def fold_support(scale: int) -> int:
    """Side, in LR px, of the folded upsampler's kernel: the union over
    the output phases of the LR pixels that the stages' and the out
    conv's 3x3 windows reach."""
    stages = upsample_stages(scale)
    lo_all, hi_all = 0, 0
    for phase in range(math.prod(stages)):
        lo, hi = phase - 1, phase + 1
        for f in reversed(stages):
            lo, hi = lo // f - 1, hi // f + 1
        lo_all, hi_all = min(lo_all, lo), max(hi_all, hi)
    return hi_all - lo_all + 1


def model_ops_per_lr_px(model: dict, path: str):
    """``(low, bf16)`` operations per LR pixel of the folded form: the
    residual blocks and the tail conv at the path's low precision (int8
    on the int8 path, else nothing), the head conv and the folded
    upsampler (``3 s^2`` outputs) in bf16."""
    c, img, s = model["num_channels"], model["img_channels"], model["scale"]
    trunk = 2 * model["num_blocks"] * conv_ops(c, c) + conv_ops(c, c)
    k = fold_support(s)
    edge = conv_ops(img, c) + conv_ops(c, img * s * s, k)
    if path == "int8":
        return trunk, edge
    return 0, trunk + edge


def model_seconds(model: dict, path: str, lr_px: float) -> float:
    """The folded model's least time over ``lr_px`` LR pixels at the
    peaks."""
    low, bf16 = model_ops_per_lr_px(model, path)
    return lr_px * (low / PEAK_INT8 + bf16 / PEAK_BF16)


def resblock_seconds(b: int, h: int, w: int, c: int, int8: bool) -> float:
    """Least time of one residual block launch on a [b, h, w, c] carry:
    the larger of its two convs' operations over the peak and of its
    bytes (the bf16 carry read once and written once, both kernels
    once, the per-channel vectors) over the HBM rate."""
    px = b * h * w
    ops = 2 * conv_ops(c, c) * px
    wbytes = 2 * 9 * c * c * (1 if int8 else 2)
    nbytes = 2 * px * c * 2 + wbytes + (5 if int8 else 2) * c * 4
    return max(ops / (PEAK_INT8 if int8 else PEAK_BF16), nbytes / PEAK_HBM)
