"""EDSR-style residual generator with sub-pixel upsampler: the plain
PyTorch reference module of the port (counterpart of
``pesr_tpu/models/generator.py``).

head conv3x3 -> ``num_blocks`` residual blocks (conv-ReLU-conv, residual
scaled by ``res_scale``) -> tail conv + global skip -> per-stage
[conv C -> f^2*C, PixelShuffle(f)] -> 3-channel output conv.

Submodule names follow the EDSR ``Sequential`` convention of
``pesr_tpu.convert.export_torch_generator``: ``head.0``,
``body.{i}.body.{0,2}``, ``body.{num_blocks}`` (the tail conv),
``tail.0.{2s}`` (upsampler convs) and ``tail.1`` (output conv), so
``load_state_dict(strict=True)`` takes that function's output and
EDSR-style ``.pth`` files.

I/O contract (as the JAX module): input NHWC in [-1, 1]; output NHWC
float32, unclamped.  Internally NCHW float32; the bf16 inference path is
:class:`~pesr_torch.models.kernel_apply.KernelApply`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from pesr_torch.scales import upsample_stages
from pesr_torch.utils.device import resolve_device


def _conv3x3(cin: int, cout: int, **kw) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, **kw)


class ResBlock(nn.Module):
    """conv3x3 -> ReLU -> conv3x3, residual scaled by ``res_scale``."""

    def __init__(self, num_channels: int, res_scale: float = 0.1,
                 **kw) -> None:
        super().__init__()
        self.body = nn.Sequential(_conv3x3(num_channels, num_channels, **kw),
                                  nn.ReLU(),
                                  _conv3x3(num_channels, num_channels, **kw))
        self.res_scale = res_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.res_scale * self.body(x)


class Upsampler(nn.Sequential):
    """Sub-pixel stages: [conv C -> f^2*C, PixelShuffle(f)] per stage."""

    def __init__(self, num_channels: int, stages, **kw) -> None:
        layers = []
        for f in stages:
            layers += [_conv3x3(num_channels, f * f * num_channels, **kw),
                       nn.PixelShuffle(f)]
        super().__init__(*layers)


class Generator(nn.Module):
    """The PESR generator (plain PyTorch; the kernels' reference)."""

    def __init__(self, scale: int = 4, num_blocks: int = 32,
                 num_channels: int = 256, res_scale: float = 0.1,
                 img_channels: int = 3, device="cuda",
                 seed: Optional[int] = 0) -> None:
        """``seed``: initialise the weights from this seed
        (:func:`init_weights`); ``None`` leaves torch's default init, for
        weights that are loaded next anyway."""
        super().__init__()
        kw = dict(device=resolve_device(device))
        self.scale, self.num_blocks = scale, num_blocks
        self.num_channels, self.res_scale = num_channels, res_scale
        c = num_channels
        self.head = nn.Sequential(_conv3x3(img_channels, c, **kw))
        self.body = nn.Sequential(
            *[ResBlock(c, res_scale, **kw) for _ in range(num_blocks)],
            _conv3x3(c, c, **kw))
        self.tail = nn.Sequential(
            Upsampler(c, upsample_stages(scale), **kw),
            _conv3x3(c, img_channels, **kw))
        if seed is not None:
            init_weights(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [-1, 1] -> NHWC float32."""
        x = x.permute(0, 3, 1, 2).float()
        h = self.head(x)
        y = self.body(h) + h
        return self.tail(y).permute(0, 2, 3, 1).float()


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> None:
    """Random init from ``seed``: every conv or dense kernel (a module's
    ``weight`` of 2 or more dims) truncated-normal at +-2 sigma with
    variance 1/fan_in (flax's default ``lecun_normal``, the JAX modules'
    init), its bias zero; norm scales keep their ones.  Drawn on the CPU
    with one ``torch.Generator``, in module order, so the same seed gives
    the same weights on every device."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        weight = getattr(m, "weight", None)
        if isinstance(weight, nn.Parameter) and weight.dim() >= 2:
            fan_in = weight[0].numel()
            # 0.8796... = std of a unit normal truncated at +-2
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
            weight.copy_(w)
            m.bias.zero_()
