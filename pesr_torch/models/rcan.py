"""RCAN, the residual channel-attention network of Zhang et al., "Image
Super-Resolution Using Very Deep Residual Channel Attention Networks",
ECCV 2018 (arXiv:1807.02758; code github.com/yulunzhang/RCAN): the
plain PyTorch module of the port.

    x255 -> sub_mean -> head conv3x3 (3 -> C)
         -> ``num_groups`` residual groups, each g + conv3x3(RCAB_n(...RCAB_1(g)))
         -> conv3x3, plus the head's output (the long skip)
         -> x2 / x3 sub-pixel stages [conv C -> f^2 C, PixelShuffle(f)]
         -> conv3x3 (C -> 3) -> add_mean

An RCAB is ``h + s * r`` with ``r = conv3x3(relu(conv3x3(h)))`` and the
channel attention ``s = sigmoid(conv1x1(relu(conv1x1(mean_hw(r)))))``
(C -> C / reduction -> C), no residual scaling.  ``sub_mean`` and
``add_mean`` are RCAN's MeanShift: 1x1 convs with fixed weights
(identity over the RGB std 1) and biases -+255 (0.4488, 0.4371, 0.4040),
which training leaves alone.

Submodule names are the official checkpoints' (``RCAN_BIX4.pt``):
``sub_mean``, ``add_mean``, ``head.0``, ``body.{g}.body.{b}.body.{0,2}``,
``body.{g}.body.{b}.body.3.conv_du.{0,2}``, ``body.{g}.body.{n}``,
``body.{G}``, ``tail.0.{2s}``, ``tail.1``; so ``load_state_dict(strict=
True)`` takes such a state dict.  The defaults are RCAN x4's: 10 groups x
20 RCAB x 64 channels, reduction 16, 15,592,355 parameters (the
MeanShifts' 24 fixed numbers not counted: :func:`count_parameters`).

I/O contract as the port's EDSR :class:`~pesr_torch.models.generator.
Generator`: NHWC in [-1, 1] in, NHWC float32 on the same scale out;
internally the [0, 255] scale RCAN was trained on.  The bf16 inference
path is :class:`~pesr_torch.models.rcan_apply.RCANKernelApply`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from pesr_torch.models.generator import Upsampler, _conv3x3, init_weights
from pesr_torch.scales import upsample_stages
from pesr_torch.utils.device import resolve_device

RGB_MEAN = (0.4488, 0.4371, 0.4040)  # DIV2K's, as RCAN's MeanShift
RGB_RANGE = 255.0


class MeanShift(nn.Conv2d):
    """RCAN's fixed 1x1 conv: ``sign * 255 * mean`` added per channel."""

    def __init__(self, sign: int, **kw) -> None:
        super().__init__(3, 3, 1, **kw)
        self.sign = sign
        self.reset()
        self.requires_grad_(False)

    @torch.no_grad()
    def reset(self) -> None:
        self.weight.copy_(torch.eye(3).view(3, 3, 1, 1))
        self.bias.copy_(self.sign * RGB_RANGE * torch.tensor(RGB_MEAN))


class CALayer(nn.Module):
    """Channel attention: ``x * sigmoid(W2 relu(W1 mean_hw(x)))``."""

    def __init__(self, num_channels: int, reduction: int, **kw) -> None:
        super().__init__()
        self.conv_du = nn.Sequential(
            nn.Conv2d(num_channels, num_channels // reduction, 1, **kw),
            nn.ReLU(),
            nn.Conv2d(num_channels // reduction, num_channels, 1, **kw),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv_du(x.mean((2, 3), keepdim=True))


class RCAB(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 -> channel attention, plus the input."""

    def __init__(self, num_channels: int, reduction: int, **kw) -> None:
        super().__init__()
        self.body = nn.Sequential(_conv3x3(num_channels, num_channels, **kw),
                                  nn.ReLU(),
                                  _conv3x3(num_channels, num_channels, **kw),
                                  CALayer(num_channels, reduction, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class ResidualGroup(nn.Module):
    """``num_blocks`` RCABs and a conv3x3, plus the group's input."""

    def __init__(self, num_channels: int, reduction: int, num_blocks: int,
                 **kw) -> None:
        super().__init__()
        self.body = nn.Sequential(
            *[RCAB(num_channels, reduction, **kw) for _ in range(num_blocks)],
            _conv3x3(num_channels, num_channels, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class RCAN(nn.Module):
    """RCAN (plain PyTorch; the reference of the kernel path)."""

    def __init__(self, scale: int = 4, num_groups: int = 10,
                 num_blocks: int = 20, num_channels: int = 64,
                 reduction: int = 16, img_channels: int = 3, device="cuda",
                 seed: Optional[int] = 0) -> None:
        """``seed``: initialise the weights from this seed
        (:func:`~pesr_torch.models.generator.init_weights`, the
        MeanShifts kept); ``None`` leaves torch's default init, for
        weights that are loaded next anyway."""
        super().__init__()
        if img_channels != 3:
            raise ValueError("RCAN's MeanShift takes 3 channels")
        if num_channels % reduction:
            raise ValueError(f"num_channels {num_channels} is not a multiple "
                             f"of reduction {reduction}")
        kw = dict(device=resolve_device(device))
        self.scale, self.num_groups, self.num_blocks = (scale, num_groups,
                                                        num_blocks)
        self.num_channels, self.reduction = num_channels, reduction
        c = num_channels
        self.sub_mean = MeanShift(-1, **kw)
        self.add_mean = MeanShift(+1, **kw)
        self.head = nn.Sequential(_conv3x3(img_channels, c, **kw))
        self.body = nn.Sequential(
            *[ResidualGroup(c, reduction, num_blocks, **kw)
              for _ in range(num_groups)],
            _conv3x3(c, c, **kw))
        self.tail = nn.Sequential(
            Upsampler(c, upsample_stages(scale), **kw),
            _conv3x3(c, img_channels, **kw))
        if seed is not None:
            init_weights(self, seed)
            self.sub_mean.reset()
            self.add_mean.reset()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [-1, 1] -> NHWC float32 on the same scale."""
        x = (x.permute(0, 3, 1, 2).float() + 1.0) * 127.5
        h = self.head(self.sub_mean(x))
        y = self.add_mean(self.tail(self.body(h) + h))
        return (y / 127.5 - 1.0).permute(0, 2, 3, 1)


def count_parameters(model: nn.Module) -> int:
    """Trainable parameters: without the MeanShifts' fixed ones."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
