"""Pixel losses of the L1 pretrain phase (counterpart of the pixel-loss
part of ``pesr_tpu/losses.py``).  Both are means over every element,
computed in float32 whatever the dtype of ``sr``.  The GAN, TV and
perceptual losses come with the GAN phase."""

from __future__ import annotations

import torch


def l1_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(sr.float() - hr.float()))


def l2_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    d = sr.float() - hr.float()
    return torch.mean(d * d)
