"""Generator weights carried into the port (its own copy of the layout
logic of ``pesr_tpu/convert.py``).

The port's :class:`~pesr_torch.models.generator.Generator` state_dict
uses the EDSR ``Sequential`` names of
``pesr_tpu.convert.export_torch_generator``, in registration order:

    head.0, body.{i}.body.0 / body.{i}.body.2 (i < num_blocks),
    body.{num_blocks} (tail conv), tail.0.{2s} (upsampler convs), tail.1

* :func:`state_dict_from_jax` takes the JAX ``Generator``'s params tree
  (nested dicts of numpy arrays: HWIO kernels, per-block weights stacked
  on a leading axis) and returns that state_dict (OIHW float32).
* :func:`load_generator_pth` reads an EDSR-style ``.pth`` and maps its
  convs POSITIONALLY onto those names (any naming scheme works as long
  as the architecture matches; a mismatch raises with both lists).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List

import numpy as np
import torch

from pesr_torch.scales import upsample_stages


def generator_conv_names(num_blocks: int, scale: int) -> List[str]:
    """The generator's conv names in registration order."""
    n_stages = len(upsample_stages(scale))
    return (["head.0"]
            + [f"body.{i}.body.{k}" for i in range(num_blocks) for k in (0, 2)]
            + [f"body.{num_blocks}"]
            + [f"tail.0.{2 * s}" for s in range(n_stages)]
            + ["tail.1"])


def _hwio_to_oihw(w: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def state_dict_from_jax(params: Dict[str, Any],
                        scale: int) -> "OrderedDict[str, torch.Tensor]":
    """JAX Generator params (numpy leaves) -> the port's state_dict."""
    blk = params["body"]["block"]
    num_blocks = int(np.shape(blk["conv1"]["kernel"])[0])
    leaves = [params["head"]]
    for i in range(num_blocks):
        for conv in ("conv1", "conv2"):
            leaves.append({"kernel": blk[conv]["kernel"][i],
                           "bias": blk[conv]["bias"][i]})
    leaves.append(params["tail"])
    leaves += [params["upsampler"][f"conv{s}"]
               for s in range(len(upsample_stages(scale)))]
    leaves.append(params["out"])
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, leaf in zip(generator_conv_names(num_blocks, scale), leaves):
        sd[f"{name}.weight"] = _hwio_to_oihw(leaf["kernel"])
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(leaf["bias"], np.float32).copy())
    return sd


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """Load a .pth/.pt state_dict (unwrapping common wrapper keys)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "params", "generator"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"{path} does not contain a state_dict")
    return obj


def state_dict_from_torch(state_dict: Dict[str, Any], num_blocks: int,
                          scale: int) -> "OrderedDict[str, torch.Tensor]":
    """Map an EDSR-style state_dict's 4-D conv weights (and their sibling
    biases), in registration order, onto the port's names."""
    convs = []
    for key, val in state_dict.items():
        if key.endswith("weight") and getattr(val, "dim", lambda: 0)() == 4:
            bkey = key[: -len("weight")] + "bias"
            if bkey not in state_dict:
                raise ValueError(f"conv {key} has no matching bias {bkey}")
            convs.append((key, val, state_dict[bkey]))
    names = generator_conv_names(num_blocks, scale)
    if len(convs) != len(names):
        raise ValueError(
            f"expected {len(names)} convs (head + 2x{num_blocks} body + tail"
            f" + {len(names) - 3 - 2 * num_blocks} upsample + out), found "
            f"{len(convs)}: {[c[0] for c in convs]}")
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, (_, w, b) in zip(names, convs):
        sd[f"{name}.weight"] = w.detach().float()
        sd[f"{name}.bias"] = b.detach().float()
    return sd


def load_generator_pth(path: str, num_blocks: int,
                       scale: int) -> "OrderedDict[str, torch.Tensor]":
    """EDSR-style generator ``.pth`` -> the port's state_dict."""
    return state_dict_from_torch(load_torch_state_dict(path), num_blocks,
                                 scale)
