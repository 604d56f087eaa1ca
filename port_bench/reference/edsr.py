"""The plain float32 EDSR forward (Lim et al. 2017; thangvubk/PESR's
generator): head conv, residual blocks ``x + res_scale conv(relu(conv
x))``, tail conv plus the global skip, sub-pixel stages ``[conv C ->
f^2 C, pixel_shuffle(f)]`` and the 3-channel out conv, every conv 3x3
with zero padding 1.  ``torch.nn.functional`` only, TF32 off on the
card (the caller's :func:`no_tf32` scope)."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference.weights import upsample_stages


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and cuDNN convs in full float32 for the block."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def conv(x: torch.Tensor, sd: Dict[str, torch.Tensor], name: str
         ) -> torch.Tensor:
    return F.conv2d(x, sd[f"{name}.weight"].to(x.dtype),
                    sd[f"{name}.bias"].to(x.dtype), padding=1)


def upsample(y: torch.Tensor, sd: Dict[str, torch.Tensor], model: dict
             ) -> torch.Tensor:
    """NCHW trunk output -> NCHW image (the stages and the out conv)."""
    for s, f in enumerate(upsample_stages(model["scale"])):
        y = F.pixel_shuffle(conv(y, sd, f"tail.0.{2 * s}"), f)
    return conv(y, sd, "tail.1")


@torch.no_grad()
def forward(x: torch.Tensor, sd: Dict[str, torch.Tensor], model: dict
            ) -> torch.Tensor:
    """NHWC [-1, 1] float -> NHWC float32 SR, in float32."""
    x = x.permute(0, 3, 1, 2).float()
    h = conv(x, sd, "head.0")
    y = h
    for i in range(model["num_blocks"]):
        t = torch.relu(conv(y, sd, f"body.{i}.body.0"))
        y = y + model["res_scale"] * conv(t, sd, f"body.{i}.body.2")
    y = conv(y, sd, f"body.{model['num_blocks']}") + h
    return upsample(y, sd, model).permute(0, 2, 3, 1)
