"""Weights carried into the port (its own copy of the layout logic of
``pesr_tpu/convert.py``): the generator, the discriminator and the VGG-19
trunk.

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
* :func:`load_rcan_pth` reads an RCAN state_dict (the official
  ``RCAN_BIX4.pt`` naming, :func:`rcan_conv_names`) BY NAME for
  :class:`~pesr_torch.models.rcan.RCAN`.
* :func:`discriminator_state_dict_from_jax` / :func:`load_discriminator_pth`
  and :func:`vgg_state_dict_from_jax` / :func:`load_vgg19_pth` do the
  same for the GAN phase's networks (:mod:`pesr_torch.models.discriminator`
  registers in the SRGAN order; :mod:`pesr_torch.models.vgg` uses
  torchvision's ``features.{i}`` names).

The port cannot read orbax directories (no JAX): a loader given one
raises with what to pass instead.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from pesr_torch.models.discriminator import head_side
from pesr_torch.models.vgg import vgg_layer_indices
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


def _pairs(state_dict: Dict[str, Any], ndim: int, what: str
           ) -> List[Tuple[str, torch.Tensor, torch.Tensor]]:
    """(name, weight, bias) of every ``ndim``-D ``*weight`` entry with its
    sibling bias, in registration order: 4-D convs, 2-D dense layers, 1-D
    norm scales (running statistics are not ``*weight`` entries)."""
    out = []
    for key, val in state_dict.items():
        if key.endswith("weight") and getattr(val, "dim", lambda: 0)() == ndim:
            bkey = key[: -len("weight")] + "bias"
            if bkey not in state_dict:
                raise ValueError(f"{what} {key} has no matching bias {bkey}")
            out.append((key, val, state_dict[bkey]))
    return out


def _renamed(names: List[str], pairs, what: str
             ) -> "OrderedDict[str, torch.Tensor]":
    if len(pairs) != len(names):
        raise ValueError(f"expected {len(names)} {what}, found {len(pairs)}: "
                         f"{[p[0] for p in pairs]}")
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, (_, w, b) in zip(names, pairs):
        sd[f"{name}.weight"] = w.detach().float()
        sd[f"{name}.bias"] = b.detach().float()
    return sd


def state_dict_from_torch(state_dict: Dict[str, Any], num_blocks: int,
                          scale: int) -> "OrderedDict[str, torch.Tensor]":
    """Map an EDSR-style state_dict's 4-D conv weights (and their sibling
    biases), in registration order, onto the port's names."""
    names = generator_conv_names(num_blocks, scale)
    return _renamed(names, _pairs(state_dict, 4, "conv"),
                    f"convs (head + 2x{num_blocks} body + tail + "
                    f"{len(names) - 3 - 2 * num_blocks} upsample + out)")


def load_generator_pth(path: str, num_blocks: int,
                       scale: int) -> "OrderedDict[str, torch.Tensor]":
    """EDSR-style generator ``.pth`` -> the port's state_dict."""
    return state_dict_from_torch(load_torch_state_dict(path), num_blocks,
                                 scale)


def rcan_conv_names(num_groups: int, num_blocks: int,
                    scale: int) -> List[str]:
    """RCAN's conv names in registration order (the official
    checkpoints' and :class:`~pesr_torch.models.rcan.RCAN`'s), the
    MeanShifts left out: ``head.0``; per group, per RCAB
    ``body.{g}.body.{b}.body.{0,2}`` and ``...body.3.conv_du.{0,2}``,
    then the group's conv ``body.{g}.body.{num_blocks}``; the trunk conv
    ``body.{num_groups}``; ``tail.0.{2s}``; ``tail.1``."""
    names = ["head.0"]
    for g in range(num_groups):
        for b in range(num_blocks):
            p = f"body.{g}.body.{b}.body"
            names += [f"{p}.0", f"{p}.2", f"{p}.3.conv_du.0",
                      f"{p}.3.conv_du.2"]
        names.append(f"body.{g}.body.{num_blocks}")
    names.append(f"body.{num_groups}")
    names += [f"tail.0.{2 * s}" for s in range(len(upsample_stages(scale)))]
    return names + ["tail.1"]


MEAN_SHIFTS = ("sub_mean", "add_mean")


def rcan_state_dict_from_torch(state_dict: Dict[str, Any], num_groups: int,
                               num_blocks: int, scale: int
                               ) -> "OrderedDict[str, torch.Tensor]":
    """An RCAN state_dict in the official names (``RCAN_BIX4.pt``; the
    ``module.`` prefix of a ``DataParallel`` save dropped) -> the port's,
    float32: every conv of :func:`rcan_conv_names` by name, and the
    MeanShifts' entries where it has them.  Raises, naming them, on
    missing or unknown entries."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    names = rcan_conv_names(num_groups, num_blocks, scale)
    want = [f"{n}.{leaf}" for n in names for leaf in ("weight", "bias")]
    shifts = [f"{m}.{leaf}" for m in MEAN_SHIFTS for leaf in ("weight", "bias")]
    missing = [k for k in want if k not in sd]
    unknown = [k for k in sd if k not in want and k not in shifts]
    if missing or unknown:
        raise ValueError(f"not an RCAN {num_groups} x {num_blocks} x{scale} "
                         f"state_dict: missing {missing[:8]}, unknown "
                         f"{unknown[:8]}")
    return OrderedDict((k, torch.as_tensor(sd[k]).detach().float())
                       for k in shifts + want if k in sd)


def load_rcan_pth(path: str, num_groups: int, num_blocks: int,
                  scale: int) -> "OrderedDict[str, torch.Tensor]":
    """An RCAN ``.pt`` / ``.pth`` (e.g. the official ``RCAN_BIX4.pt``) ->
    the port's state_dict."""
    return rcan_state_dict_from_torch(load_torch_state_dict(path), num_groups,
                                      num_blocks, scale)


def _no_orbax(path: str, what: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, not a torch .pth: the port cannot read "
            f"an orbax checkpoint (that needs JAX); pass {what}")


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------


def discriminator_names(n_stages: int) -> Tuple[List[str], List[str]]:
    """The port discriminator's conv and norm names, each in registration
    order (:class:`pesr_torch.models.discriminator.Discriminator`)."""
    convs, norms = ["conv0", "conv0s"], ["bn0"]
    for i in range(1, n_stages):
        convs += [f"conv{i}", f"conv{i}s"]
        norms += [f"bn{i}a", f"bn{i}b"]
    return convs, norms


def discriminator_state_dict_from_jax(params: Dict[str, Any], hr_size: int
                                      ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``Discriminator`` params (numpy leaves) -> the port's
    state_dict: HWIO kernels to OIHW, norm ``scale`` to ``weight``, dense
    kernels transposed.  The JAX head flattens (H, W, C), the port's (C,
    H, W): ``fc0``'s input axis is permuted here, once."""
    n_stages = sum(1 for k in params if k.startswith("conv")) // 2
    conv_names, norm_names = discriminator_names(n_stages)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(name, w, b):
        sd[f"{name}.weight"] = torch.from_numpy(np.array(w, np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(b, np.float32).copy())

    for name in conv_names:
        put(name, np.asarray(params[name]["kernel"], np.float32)
            .transpose(3, 2, 0, 1), params[name]["bias"])
    for name in norm_names:
        put(name, np.asarray(params[name]["scale"], np.float32),
            params[name]["bias"])
    c = np.shape(params[conv_names[-1]]["kernel"])[-1]
    side = head_side(hr_size, n_stages)
    k0 = np.asarray(params["fc0"]["kernel"], np.float32)   # [H*W*C, out]
    if k0.shape[0] != c * side * side:
        raise ValueError(f"fc0 takes {k0.shape[0]} features, but hr_size="
                         f"{hr_size} gives {c}x{side}x{side}")
    w0 = (k0.T.reshape(-1, side, side, c).transpose(0, 3, 1, 2)
          .reshape(k0.shape[1], -1))
    put("fc0", w0, params["fc0"]["bias"])
    put("fc1", np.asarray(params["fc1"]["kernel"], np.float32).T,
        params["fc1"]["bias"])
    return _ordered_like_module(sd, conv_names, norm_names)


def _ordered_like_module(sd, conv_names, norm_names):
    """``sd`` in the module's registration order: conv0, conv0s, bn0,
    then conv{i}, bn{i}a, conv{i}s, bn{i}b, then fc0, fc1."""
    order = conv_names[:2] + norm_names[:1]
    for i in range(1, len(conv_names) // 2):
        order += [conv_names[2 * i], norm_names[2 * i - 1],
                  conv_names[2 * i + 1], norm_names[2 * i]]
    order += ["fc0", "fc1"]
    return OrderedDict((f"{n}.{p}", sd[f"{n}.{p}"]) for n in order
                       for p in ("weight", "bias"))


def discriminator_state_dict_from_torch(
        state_dict: Dict[str, Any], hr_size: int
) -> "OrderedDict[str, torch.Tensor]":
    """Map an SRGAN-style torch discriminator state_dict POSITIONALLY onto
    the port's names: its 4-D convs (2 per stage), its 1-D norm scales (2
    per stage less one) and its 2 dense layers, each in registration
    order (norm running statistics are dropped: the port's norm uses batch
    statistics only).  The dense head is already in torch's (C, H, W)
    order; ``hr_size`` checks its width."""
    convs = _pairs(state_dict, 4, "conv")
    if len(convs) % 2:
        raise ValueError(f"expected an even number of discriminator convs, "
                         f"found {len(convs)}: {[c[0] for c in convs]}")
    conv_names, norm_names = discriminator_names(len(convs) // 2)
    sd = _renamed(conv_names, convs, "discriminator convs")
    sd.update(_renamed(norm_names, _pairs(state_dict, 1, "norm"),
                       "norm layers"))
    sd.update(_renamed(["fc0", "fc1"], _pairs(state_dict, 2, "dense"),
                       "dense layers"))
    c = sd[f"{conv_names[-1]}.weight"].shape[0]
    side = head_side(hr_size, len(conv_names) // 2)
    if sd["fc0.weight"].shape[1] != c * side * side:
        raise ValueError(f"dense fc0 takes {sd['fc0.weight'].shape[1]} "
                         f"features, but hr_size={hr_size} gives "
                         f"{c}x{side}x{side}")
    return _ordered_like_module(sd, conv_names, norm_names)


def load_discriminator_pth(path: str, hr_size: int
                           ) -> "OrderedDict[str, torch.Tensor]":
    """An SRGAN-style discriminator ``.pth`` (as
    ``pesr_tpu.convert.convert_torch_discriminator`` reads it) -> the
    port's state_dict."""
    _no_orbax(path, "an SRGAN-order discriminator .pth")
    return discriminator_state_dict_from_torch(load_torch_state_dict(path),
                                               hr_size)


# ---------------------------------------------------------------------------
# VGG-19
# ---------------------------------------------------------------------------


def vgg_state_dict_from_jax(params: Dict[str, Any]
                            ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``VGG19Features`` params (``conv{s}_{c}``, numpy leaves) -> the
    torchvision ``features.{i}`` state_dict of the same prefix."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for layer, i in vgg_layer_indices().items():
        name = f"conv{layer[0]}_{layer[1]}"
        if name in params:
            sd[f"features.{i}.weight"] = _hwio_to_oihw(params[name]["kernel"])
            sd[f"features.{i}.bias"] = torch.from_numpy(
                np.asarray(params[name]["bias"], np.float32).copy())
    return sd


def load_vgg19_pth(path: str, layer: str = "54"
                   ) -> "OrderedDict[str, torch.Tensor]":
    """``--vgg_weights``: a torchvision-layout VGG-19 ``.pth`` (the 16
    feature convs in trunk order, any names; classifier weights are 2-D
    and skipped) -> the ``features.{i}`` state_dict of the prefix up to
    ``layer``; the later convs are dropped."""
    _no_orbax(path, "a torchvision-layout VGG-19 .pth (torch.save of "
                    "torchvision.models.vgg19(...).state_dict())")
    convs = _pairs(load_torch_state_dict(path), 4, "conv")
    indices = vgg_layer_indices()
    if len(convs) != len(indices):
        raise ValueError(f"need exactly {len(indices)} 4-D convs for the "
                         f"VGG-19 trunk, found {len(convs)}: "
                         f"{[c[0] for c in convs]}")
    if layer not in indices:
        raise ValueError(f"layer {layer!r} not in the VGG-19 trunk")
    keep = [i for i in indices.values() if i <= indices[layer]]
    return _renamed([f"features.{i}" for i in keep], convs[:len(keep)],
                    "VGG-19 convs")
