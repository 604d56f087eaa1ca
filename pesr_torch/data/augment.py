"""uint8 <-> model-space conversion (counterpart of the first two functions
of ``pesr_tpu/data/augment.py``)."""

from __future__ import annotations

import torch


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [-1,1] (the model-space convention)."""
    return x.to(torch.float32) / 127.5 - 1.0


def denormalize_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """float [-1,1] -> uint8 with round-half-away like MATLAB im2uint8.

    ``floor(y + 0.5)``, NOT ``torch.round`` -- that is round-half-to-EVEN,
    which writes 128 where MATLAB/PIL write 129 for an exact 128.5
    (negative ties are moot: anything below 0.5 clips to 0)."""
    y = (x.to(torch.float32) + 1.0) * 127.5
    return torch.clamp(torch.floor(y + 0.5), 0.0, 255.0).to(torch.uint8)
