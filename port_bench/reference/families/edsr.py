"""EDSR (Lim et al. 2017; thangvubk/PESR's generator): the plain float32
forward (``reference/edsr.py``), the W8A8 forward of the int8 path and
its W4A4 control (``reference/w8a8.py``), the folded model's operation
counts.  The parameter names are EDSR's ``Sequential`` ones
(``head.0``, ``body.{i}.body.{0,2}``, ``body.{n}``, ``tail.0.{2s}``,
``tail.1``), which ``torch.nn.Module.load_state_dict`` takes."""

from __future__ import annotations

from typing import List, Tuple

import torch

from port_bench.reference import edsr, w8a8
from port_bench.reference.counts import conv_ops, fold_support
from port_bench.reference.weights import (conv_params, draw_convs,
                                          upsample_stages)

KEYS = ("num_blocks", "num_channels", "res_scale", "img_channels",
        "bias_std")


def conv_shapes(model: dict) -> List[Tuple[str, Tuple[int, int, int, int]]]:
    """``(prefix, OIHW shape)`` of every conv, in forward order."""
    c, img = model["num_channels"], model["img_channels"]
    shapes = [("head.0", (c, img, 3, 3))]
    for i in range(model["num_blocks"]):
        shapes += [(f"body.{i}.body.0", (c, c, 3, 3)),
                   (f"body.{i}.body.2", (c, c, 3, 3))]
    shapes.append((f"body.{model['num_blocks']}", (c, c, 3, 3)))
    for s, f in enumerate(upsample_stages(model["scale"])):
        shapes.append((f"tail.0.{2 * s}", (f * f * c, c, 3, 3)))
    shapes.append(("tail.1", (img, c, 3, 3)))
    return shapes


def param_shapes(model: dict) -> list:
    return conv_params(conv_shapes(model))


def make_state_dict(model: dict, seed: int, device: torch.device) -> dict:
    return draw_convs(conv_shapes(model), model["bias_std"], seed, device)


def reference(model: dict, mix: dict, sd, crops, device):
    """float32 EDSR with TF32 off for "bf16"; the W8A8 forward with its
    own calibration on ``crops`` for "int8"."""
    if mix["path"] == "int8":
        return w8a8.W8A8(sd, model, torch.from_numpy(crops).to(device))

    def f32(x):
        with edsr.no_tf32():
            return edsr.forward(x, sd, model)
    return f32


def control(model: dict, mix: dict, sd, crops, device):
    """The W4A4 forward on the int8 path (int4, the precision below
    int8); None on bf16, whose control is the program's int8 path."""
    if mix["path"] != "int8":
        return None
    return w8a8.W8A8(sd, model, torch.from_numpy(crops).to(device), 4)


def ops_per_lr_px(model: dict, path: str):
    """``(low, bf16)`` operations per LR pixel of the folded form: the
    residual blocks and the tail conv at the path's low precision (int8
    on the int8 path, else nothing), the head conv and the folded
    upsampler (``3 s^2`` outputs) in bf16."""
    c, img, s = model["num_channels"], model["img_channels"], model["scale"]
    trunk = 2 * model["num_blocks"] * conv_ops(c, c) + conv_ops(c, c)
    k = fold_support(s)
    edge = conv_ops(img, c) + conv_ops(c, img * s * s, k)
    if path == "int8":
        return trunk, edge
    return 0, trunk + edge
