"""The plain float32 RCAN forward (Zhang et al., "Image Super-Resolution
Using Very Deep Residual Channel Attention Networks", ECCV 2018,
arXiv:1807.02758; github.com/yulunzhang/RCAN, ``RCAN_BIX4``), from the
published description:

* ``x0 = conv3x3(3 -> C)(sub_mean(x255))``, ``sub_mean`` subtracting 255
  (0.4488, 0.4371, 0.4040);
* ``num_groups`` residual groups, each ``g + conv3x3(RCAB_n(...RCAB_1(g)))``;
* an RCAB: ``r = conv3x3(relu(conv3x3(h)))``, ``s = sigmoid(W2 relu(W1
  mean_hw(r) + b1) + b2)`` (1x1 convs, C -> C / reduction -> C), output
  ``h + s * r``: no residual scaling;
* the trunk ``conv3x3(groups(x0)) + x0``; the EDSR upsampler's stages
  ``[conv C -> f^2 C, pixel_shuffle(f)]``, the out conv ``C -> 3``, then
  ``add_mean``.

Every 3x3 conv pads with zeros, in RCAN's domain (after ``sub_mean``).
``torch.nn.functional`` only, TF32 off on the card (the caller's
:func:`~port_bench.reference.edsr.no_tf32` scope).  Departures, each
the benchmark's and not the model's:

* input and output are NHWC on the [-1, 1] scale (the engine's
  contract), mapped to and from RCAN's [0, 255] here;
* ``sub_mean`` / ``add_mean`` are adds of the mean: RCAN's MeanShift is
  a 1x1 conv whose weight is the identity (RGB std 1);
* the mean of the channel attention covers the tile it is given (halo
  and edge padding included), as RCAN's ``forward_chop`` pools its
  chops;
* the output is neither quantised nor clamped (the comparison clamps).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference.edsr import conv
from port_bench.reference.weights import upsample_stages

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def _mean255(x: torch.Tensor) -> torch.Tensor:
    return 255.0 * torch.tensor(RGB_MEAN, dtype=x.dtype,
                                device=x.device)[None, :, None, None]


def _conv1x1(x: torch.Tensor, sd: Dict[str, torch.Tensor], name: str
             ) -> torch.Tensor:
    return F.conv2d(x, sd[f"{name}.weight"].to(x.dtype),
                    sd[f"{name}.bias"].to(x.dtype))


def rcab(h: torch.Tensor, sd: Dict[str, torch.Tensor], name: str,
         conv_fn=conv) -> torch.Tensor:
    """One RCAB ``name`` (``body.{g}.body.{b}``) on NCHW ``h``."""
    r = conv_fn(torch.relu(conv_fn(h, sd, f"{name}.body.0")), sd,
                f"{name}.body.2")
    m = r.mean((2, 3), keepdim=True)
    z = torch.relu(_conv1x1(m, sd, f"{name}.body.3.conv_du.0"))
    s = torch.sigmoid(_conv1x1(z, sd, f"{name}.body.3.conv_du.2"))
    return h + s * r


def upsample(y: torch.Tensor, sd: Dict[str, torch.Tensor], model: dict,
             conv_fn=conv) -> torch.Tensor:
    """NCHW trunk output -> NCHW image (the stages and the out conv)."""
    for s, f in enumerate(upsample_stages(model["scale"])):
        y = F.pixel_shuffle(conv_fn(y, sd, f"tail.0.{2 * s}"), f)
    return conv_fn(y, sd, "tail.1")


@torch.no_grad()
def forward(x: torch.Tensor, sd: Dict[str, torch.Tensor], model: dict,
            conv_fn=conv) -> torch.Tensor:
    """NHWC [-1, 1] float -> NHWC SR on the same scale, in float32
    (``conv_fn(x, sd, name)``: every 3x3 conv; the control rounds its
    operands)."""
    x = (x.permute(0, 3, 1, 2).float() + 1.0) * 127.5
    h = conv_fn(x - _mean255(x), sd, "head.0")
    g = h
    groups, blocks = model["num_groups"], model["num_blocks"]
    for i in range(groups):
        y = g
        for b in range(blocks):
            y = rcab(y, sd, f"body.{i}.body.{b}", conv_fn)
        g = g + conv_fn(y, sd, f"body.{i}.body.{blocks}")
    out = upsample(conv_fn(g, sd, f"body.{groups}") + h, sd, model, conv_fn)
    return ((out + _mean255(out)) / 127.5 - 1.0).permute(0, 2, 3, 1)
