"""uint8 <-> model-space conversion and the training batch stage
(counterpart of ``pesr_tpu/data/augment.py``).

A training batch crosses to the device as raw uint8 and one function
(:func:`prepare_train_batch`) does the rest there: uint8 -> [-1, 1],
MATLAB-bicubic LR synthesis when there are no LR files, and a per-sample
dihedral symmetry (vertical flip, horizontal flip, transpose: three bits
per sample, the 8 symmetries of the reference's flip/rot90 set).

The bits come from an explicit ``torch.Generator`` (:func:`dihedral_bits`)
seeded from ``--seed``; the JAX package draws them with
``jax.random.bernoulli``, which the port does not reproduce, so the
functions here take the bits as an argument.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pesr_torch.ops.resize import imresize
from pesr_torch.utils.device import host_to_device


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


def dihedral_bits(generator: torch.Generator, batch: int,
                  device=None, block: slice = slice(None)) -> torch.Tensor:
    """[3, batch] bool (vflip, hflip, transpose), each bit a fair coin,
    drawn on the CPU from ``generator``; the samples ``block`` of them (a
    rank's block of the global batch) moved to ``device``."""
    bits = torch.randint(0, 2, (3, batch), generator=generator).bool()
    bits = bits[:, block].contiguous()
    return bits if device is None else host_to_device(bits,
                                                      torch.device(device))


def _dihedral(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Apply per-sample dihedral ops to NHWC ``x``; ``bits`` is [3, B]
    bool (vflip, hflip, transpose).  The transpose bit needs square
    spatial dims (training patches are square)."""
    v, h, t = (bits[i][:, None, None, None] for i in range(3))
    x = torch.where(v, x.flip(1), x)
    x = torch.where(h, x.flip(2), x)
    return torch.where(t, x.transpose(1, 2), x)


def augment_batch(bits: torch.Tensor, lr: torch.Tensor, hr: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same dihedral symmetry on each aligned LR/HR pair."""
    return _dihedral(lr, bits), _dihedral(hr, bits)


def prepare_train_batch(bits: torch.Tensor, hr_u8: torch.Tensor, scale: int,
                        lr_u8: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize (+ synthesize LR) + augment, on the device of ``hr_u8``.

    ``lr_u8=None``: LR is the MATLAB-bicubic downsample of the HR crop,
    in f32 with no uint8 requantization (as the JAX package; LR files of
    the DIV2K bicubic track are quantized)."""
    hr = normalize_uint8(hr_u8)
    if lr_u8 is None:
        lr = imresize(hr, (hr.shape[1] // scale, hr.shape[2] // scale))
    else:
        lr = normalize_uint8(lr_u8)
    return augment_batch(bits, lr, hr)
