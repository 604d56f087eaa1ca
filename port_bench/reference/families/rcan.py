"""RCAN (Zhang et al., ECCV 2018; yulunzhang/RCAN ``RCAN_BIX4``): the
plain float32 forward (``reference/rcan.py``), its control with every
conv's operands in float8, and the folded model's operation counts.
The parameter names are the official checkpoints' (``head.0``,
``body.{g}.body.{b}.body.{0,2}``, ``body.{g}.body.{b}.body.3.conv_du.
{0,2}``, ``body.{g}.body.{n}``, ``body.{G}``, ``tail.0.{2s}``,
``tail.1``), which ``pesr_torch.models.rcan.RCAN`` takes; its two fixed
MeanShifts are no parameters here.

The weights are drawn as EDSR's (``weights.draw_convs``: every kernel at
variance 1 / fan_in, the 1x1 convs of the channel attention too), and
then the last conv of every residual branch (:func:`branch_ends`: each
RCAB's second conv, each group's conv and the trunk conv) is scaled by
``branch_gain`` (kernel and bias): with no residual scaling, 200 blocks
and 10 groups of unscaled branches at that variance would grow the
residual stream by orders of magnitude and saturate every output pixel
(a trained RCAN's branches are small)."""

from __future__ import annotations

from typing import List, Tuple

import torch

from port_bench.reference import edsr, rcan
from port_bench.reference.counts import (conv_ops, fold_support,
                                         resblock_seconds)
from port_bench.reference.weights import (conv_params, draw_convs,
                                          upsample_stages)

KEYS = ("num_groups", "num_blocks", "num_channels", "reduction",
        "img_channels", "bias_std", "branch_gain")
F8_MAX = 448.0  # the largest finite float8_e4m3fn


def conv_shapes(model: dict) -> List[Tuple[str, Tuple[int, int, int, int]]]:
    """``(prefix, OIHW shape)`` of every conv, in RCAN's module order."""
    c, img = model["num_channels"], model["img_channels"]
    cr = c // model["reduction"]
    groups, blocks = model["num_groups"], model["num_blocks"]
    shapes = [("head.0", (c, img, 3, 3))]
    for g in range(groups):
        for b in range(blocks):
            p = f"body.{g}.body.{b}.body"
            shapes += [(f"{p}.0", (c, c, 3, 3)), (f"{p}.2", (c, c, 3, 3)),
                       (f"{p}.3.conv_du.0", (cr, c, 1, 1)),
                       (f"{p}.3.conv_du.2", (c, cr, 1, 1))]
        shapes.append((f"body.{g}.body.{blocks}", (c, c, 3, 3)))
    shapes.append((f"body.{groups}", (c, c, 3, 3)))
    for s, f in enumerate(upsample_stages(model["scale"])):
        shapes.append((f"tail.0.{2 * s}", (f * f * c, c, 3, 3)))
    shapes.append(("tail.1", (img, c, 3, 3)))
    return shapes


def param_shapes(model: dict) -> list:
    return conv_params(conv_shapes(model))


def make_state_dict(model: dict, seed: int, device: torch.device) -> dict:
    sd = draw_convs(conv_shapes(model), model["bias_std"], seed, device)
    for name in branch_ends(model):
        for leaf in ("weight", "bias"):
            sd[f"{name}.{leaf}"].mul_(model["branch_gain"])
    return sd


def branch_ends(model: dict) -> List[str]:
    """The last conv of every residual branch: each RCAB's second conv,
    each group's conv and the trunk conv (before the long skip)."""
    groups, blocks = model["num_groups"], model["num_blocks"]
    return ([f"body.{g}.body.{b}.body.2" for g in range(groups)
             for b in range(blocks)]
            + [f"body.{g}.body.{blocks}" for g in range(groups)]
            + [f"body.{groups}"])


def reference(model: dict, mix: dict, sd, crops, device):
    """float32 RCAN with TF32 off (the "bf16" path)."""
    def f32(x):
        with edsr.no_tf32():
            return rcan.forward(x, sd, model)
    return f32


def _conv_f8(x: torch.Tensor, sd, name: str) -> torch.Tensor:
    """A 3x3 conv whose input and kernel are rounded to float8_e4m3fn
    (saturated at its largest finite value), summed in float32."""
    def f8(t):
        return (t.float().clamp(-F8_MAX, F8_MAX)
                .to(torch.float8_e4m3fn).float())
    return torch.nn.functional.conv2d(f8(x), f8(sd[f"{name}.weight"]),
                                      sd[f"{name}.bias"].float(), padding=1)


def control(model: dict, mix: dict, sd, crops, device):
    """The same forward with every 3x3 conv's input and kernel in
    float8_e4m3fn, summed in float32: the precision below bf16 (the
    program has no int8 RCAN path)."""
    def f8(x):
        with edsr.no_tf32():
            return rcan.forward(x, sd, model, conv_fn=_conv_f8)
    return f8


def ops_per_lr_px(model: dict, path: str):
    """``(0, bf16)`` operations per LR pixel of the folded form: the head
    conv, two convs per RCAB, each group's conv, the trunk conv and the
    folded upsampler (``3 s^2`` outputs), all bf16.  The channel
    attention's pool, excite and squeeze (~4 C operations per pixel, off
    the tensor cores) are not counted."""
    c, img, s = model["num_channels"], model["img_channels"], model["scale"]
    groups, blocks = model["num_groups"], model["num_blocks"]
    body = (2 * groups * blocks + groups + 1) * conv_ops(c, c)
    edge = conv_ops(img, c) + conv_ops(c, img * s * s, fold_support(s))
    return 0, body + edge


def rcab_seconds(model: dict, b: int, h: int, w: int) -> float:
    """Least time of one RCAB on a [b, h, w, C] tile batch: a residual
    block's yardstick (``counts.resblock_seconds``: two convs at the bf16
    peak, or the carry read once and written once and the weights once
    at the HBM rate), whatever the kernel design moves besides."""
    return resblock_seconds(b, h, w, model["num_channels"], False)
