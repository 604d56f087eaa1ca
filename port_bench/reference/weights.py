"""The benchmark's weights: a state dict of convolutions drawn on the
device from the run's seed, handed alike to the program and the
references.  A family lists its convs (``reference/families/``); the
draw is the same for all.

Every conv kernel is truncated-normal at +-2 sigma with variance
1 / fan_in (flax's ``lecun_normal``, the scale of the port's own
initialisation), drawn as one flat tensor by one ``torch.Generator`` on
the device and cut into the leaves in the order listed; the biases are
one more draw, normal with ``bias_std``.  Leaf ``p`` of the list is
``<p>.weight`` and ``<p>.bias``.
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


def conv_params(convs: List[Tuple[str, Tuple[int, int, int, int]]]
                ) -> List[Tuple[str, tuple]]:
    """``(name, shape)`` of every parameter of ``convs`` (``(prefix,
    OIHW shape)``): each conv's kernel, then its bias."""
    return [p for name, shape in convs
            for p in ((f"{name}.weight", shape), (f"{name}.bias", shape[:1]))]


@torch.no_grad()
def draw_convs(convs: List[Tuple[str, Tuple[int, int, int, int]]],
               bias_std: float, seed: int, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """float32 state dict of ``convs`` (``(prefix, OIHW shape)``) on
    ``device``, drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(s) for _, s in convs]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    biases = torch.randn(sum(s[0] for _, s in convs), generator=g,
                         device=device) * float(bias_std)
    sd, at, bat = {}, 0, 0
    for (name, shape), n in zip(convs, sizes):
        std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / _TRUNC_STD
        sd[f"{name}.weight"] = (flat[at:at + n] * std).view(shape)
        sd[f"{name}.bias"] = biases[bat:bat + shape[0]].clone()
        at, bat = at + n, bat + shape[0]
    return sd
