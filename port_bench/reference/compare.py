"""The comparison that decides ``correct`` for an upscaled image: the
program's uint8 output against the reference's unrounded output on the
0..255 scale, clamped to it.

* ``rms_lsb``: root mean square of the difference, in LSB (uint8 steps);
  rounding alone gives ~0.29;
* ``off_pct``: the share of subpixels off by more than 1.5 LSB, in %;
* ``max_lsb``: the widest difference.

``clamped_pct`` (printed, not judged) is the share of reference
subpixels outside [-0.5, 255.5]: where the output saturates, the
comparison sees nothing.
"""

from __future__ import annotations

from typing import Dict

import torch

NAMES = ("rms_lsb", "off_pct", "max_lsb")


class Tally:
    """Sums over the compared images."""

    def __init__(self) -> None:
        self.sq = self.n = self.off = self.clamped = 0.0
        self.max = 0.0
        self.images = 0

    def add(self, out_u8: torch.Tensor, ref: torch.Tensor) -> None:
        d = out_u8.to(ref.device).float() - ref.clamp(0.0, 255.0)
        self.sq += float((d * d).double().sum())
        self.n += d.numel()
        self.off += float((d.abs() > 1.5).sum())
        self.max = max(self.max, float(d.abs().max()))
        self.clamped += float(((ref < -0.5) | (ref > 255.5)).sum())
        self.images += 1

    def numbers(self) -> Dict[str, float]:
        n = max(self.n, 1.0)
        return {"rms_lsb": (self.sq / n) ** 0.5,
                "off_pct": 100.0 * self.off / n, "max_lsb": self.max}

    def clamped_pct(self) -> float:
        return 100.0 * self.clamped / max(self.n, 1.0)
