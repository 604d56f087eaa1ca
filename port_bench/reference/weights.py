"""The benchmark's weights: an EDSR-layout state dict drawn on the device
from the run's seed, handed alike to the program and the references.

Every conv kernel is truncated-normal at +-2 sigma with variance
1 / fan_in (flax's ``lecun_normal``, the scale of the port's own
initialisation), drawn as one flat tensor by one ``torch.Generator`` on
the device and cut into the leaves; the biases are one more draw,
normal with ``bias_std``.  The names are EDSR's ``Sequential`` ones
(``head.0``, ``body.{i}.body.{0,2}``, ``body.{n}``, ``tail.0.{2s}``,
``tail.1``), which ``torch.nn.Module.load_state_dict`` takes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# std of a unit normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


def upsample_stages(scale: int) -> Tuple[int, ...]:
    """x2 stages for each factor 2, then one x3 stage per factor 3."""
    stages, s = [], scale
    while s % 2 == 0:
        stages.append(2)
        s //= 2
    while s % 3 == 0:
        stages.append(3)
        s //= 3
    if s != 1 or scale < 2:
        raise ValueError(f"scale must be 2^a 3^b >= 2, got {scale}")
    return tuple(stages)


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


@torch.no_grad()
def make_state_dict(model: dict, seed: int, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """float32 state dict of ``model`` (a configuration's sizes) on
    ``device``, drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    shapes = conv_shapes(model)
    sizes = [math.prod(s) for _, s in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    biases = torch.randn(sum(s[0] for _, s in shapes), generator=g,
                         device=device) * float(model["bias_std"])
    sd, at, bat = {}, 0, 0
    for (name, shape), n in zip(shapes, sizes):
        std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / _TRUNC_STD
        sd[f"{name}.weight"] = (flat[at:at + n] * std).view(shape)
        sd[f"{name}.bias"] = biases[bat:bat + shape[0]].clone()
        at, bat = at + n, bat + shape[0]
    return sd
