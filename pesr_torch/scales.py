"""SR scale -> sub-pixel stage factorization: the port's own copy of
``pesr_tpu/scales.py`` (which it may not import)."""

from __future__ import annotations

from typing import Tuple


def upsample_stages(scale: int) -> Tuple[int, ...]:
    """Factor an SR scale into per-stage sub-pixel factors.

    Powers of two become x2 stages ((2, 2) for x4, the reference's two
    [conv->4C, PixelShuffle(2)] stages) and a factor of 3 becomes one x3
    stage ([conv->9C, PixelShuffle(3)], the torch EDSR convention for the
    DIV2K X3 track): x2 stages first, then x3.  Raises ValueError for any
    scale that is not 2^a * 3^b (e.g. 5).
    """
    if scale < 1:
        raise ValueError(f"scale must be >= 1, got {scale}")
    stages = []
    s = scale
    while s % 2 == 0:
        stages.append(2)
        s //= 2
    while s % 3 == 0:
        stages.append(3)
        s //= 3
    if s != 1:
        raise ValueError(
            f"scale must factor into 2s and 3s (1/2/3/4/6/8/...), "
            f"got {scale}")
    return tuple(stages)


def fold_min_halo(scale: int) -> int:
    """Correctness floor (LR px) of a folded upsampler: exact only
    R = num_stages + 1 LR pixels away from a zero-padded border (one 3x3
    conv of radius <= 1 LR px per stage plus the out conv)."""
    return 0 if scale == 1 else len(upsample_stages(scale)) + 1
