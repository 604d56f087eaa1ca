"""VGG-19 feature trunk of the perceptual loss (counterpart of
``pesr_tpu/models/vgg.py``).

The trunk of torchvision's ``vgg19().features`` (3x3 convs with ReLU,
2x2 max-pools between the five stages), truncated at the requested
layer and returning that conv's PRE-activation output in float32 ("54"
= stage 5, conv 4: the SRGAN/ESRGAN "VGG54").  Inputs are model-space
NHWC images in [-1, 1], mapped to ImageNet-normalised [0, 1] RGB first.

Submodules follow torchvision's ``features.{i}`` indices, so a
torchvision VGG-19 state_dict cut to the prefix loads as it is
(``pesr_torch.convert.load_vgg19_pth``).  The trunk is frozen
(``requires_grad`` off) but passes gradients to its input, and computes
in the dtype of its weights: the constructor casts them to ``dtype``
once (the JAX module casts its f32 kernels on every call; the values are
the same).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from pesr_torch.models.generator import init_weights
from pesr_torch.utils.device import resolve_device

# (stage, convs in the stage, channels) of VGG-19.
VGG19_CFG: Tuple[Tuple[int, int, int], ...] = (
    (1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_layer_indices() -> Dict[str, int]:
    """Layer shorthand ("11" ... "54") -> index of its conv in torchvision's
    ``vgg19().features`` (each conv is followed by a ReLU, each stage by a
    max-pool)."""
    out, i = {}, 0
    for stage, n_convs, _ in VGG19_CFG:
        for conv in range(1, n_convs + 1):
            out[f"{stage}{conv}"] = i
            i += 2
        i += 1
    return out


def vgg_preprocess(x: torch.Tensor) -> torch.Tensor:
    """Model-space NHWC images in [-1, 1] -> ImageNet-normalised, in f32."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x.float() + 1.0) * 0.5 - mean) / std


class VGG19Features(nn.Module):
    """The VGG-19 trunk up to ``layer``, frozen: NHWC [-1, 1] -> the
    layer's pre-activation features, NHWC float32.  Random weights from
    ``seed`` (``None``: torch's default init, for weights loaded next)."""

    def __init__(self, layer: str = "54", dtype: torch.dtype = torch.bfloat16,
                 device="cuda", seed: Optional[int] = 0) -> None:
        super().__init__()
        indices = vgg_layer_indices()
        if layer not in indices:
            raise ValueError(f"layer {layer!r} not in the VGG-19 trunk "
                             f"(one of {sorted(indices)})")
        self.layer = layer
        dev = resolve_device(device)
        layers: List[nn.Module] = []
        cin = 3
        for stage, n_convs, ch in VGG19_CFG:
            for _ in range(n_convs):
                layers += [nn.Conv2d(cin, ch, 3, padding=1, device=dev),
                           nn.ReLU()]
                cin = ch
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers[:indices[layer] + 1])
        if seed is not None:
            init_weights(self, seed)
        self.to(dtype)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.features[0].weight.dtype
        y = self.features(vgg_preprocess(x).to(dt).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).float()
