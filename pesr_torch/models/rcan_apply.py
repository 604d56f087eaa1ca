"""RCAN's forward on the hand-written kernels: the path the batch engine
(``ops/tiling.py``) calls for ``--arch rcan``.

:class:`RCANKernelApply` takes the weights of the plain
:class:`~pesr_torch.models.rcan.RCAN` and keeps the engines' I/O
contract: NHWC [-1, 1] in, NHWC float32 on the same scale out.  It maps
the input to [0, 255] and applies ``sub_mean`` element-wise before the
head conv (so the head's zero padding is RCAN's own, in the mean-shifted
domain), then runs in ``dtype`` (bf16):

* the head conv (``F.conv2d``);
* each residual group as one ``fused_rcab`` launch per RCAB, which leaves
  the block's ``h + s * r`` pending for the next (``ops/kernels/rcab.py``),
  one ``rcab_excite`` launch for the group's last block, the group's
  conv and its skip; a ``pesr.group`` range around each group;
* the trunk conv plus the long skip;
* the upsampler and out conv folded into one conv (``models/fold.py``:
  RCAN's tail has EDSR's names and shapes), then ``add_mean`` and the
  map back to [-1, 1], in float32.

Channel attention pools over the whole [H, W] of the tile the apply
receives, the engine's halo and edge padding included (RCAN's own
``forward_chop`` pools its chops the same way), and over nothing that a
kernel pads internally.  It carries ``min_halo`` and
``uint8_variant`` as ``KernelApply`` does, so ``BatchTiledUpscaler`` and
``select_uint8_apply`` take it unchanged.  On a CPU device the kernel
wrappers run their plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from pesr_torch.data.augment import denormalize_to_uint8
from pesr_torch.models.fold import Fold, fold_upsampler, folded_conv
from pesr_torch.models.rcan import RCAN, MeanShift
from pesr_torch.ops.kernels import (fused_rcab, pack_resblock, pack_squeeze,
                                    rcab_excite)
from pesr_torch.ops.kernels.common import conv3x3_nhwc
from pesr_torch.ops.pixel_shuffle import pixel_shuffle
from pesr_torch.scales import fold_min_halo
from pesr_torch.utils.spans import span


def _shift(m: MeanShift) -> tuple:
    """A MeanShift as ``(scale, bias)`` per channel (float32), which it
    is: its weight must be diagonal."""
    w = m.weight.detach().float().reshape(3, 3)
    if not torch.equal(w, torch.diag(torch.diagonal(w))):
        raise ValueError("a MeanShift with a non-diagonal weight")
    return torch.diagonal(w).contiguous(), m.bias.detach().float()


class RCANKernelApply:
    """``apply(x)`` interchangeable with ``RCAN.forward``, on the weights
    packed at construction (inference: no autograd).  ``folded``: the
    ``fold_upsampler`` result when the caller has it."""

    def __init__(self, model: RCAN, dtype: torch.dtype = torch.bfloat16,
                 folded: Optional[Fold] = None) -> None:
        self.scale, self.dtype = model.scale, dtype
        self.forwards = 0

        def conv(m):
            return m.weight.detach().to(dtype), m.bias.detach().to(dtype)

        self.sub = _shift(model.sub_mean)
        # add_mean per output channel: the folded conv's channel c s^2 + k
        # is colour c (before its pixel shuffle)
        self.add = tuple(t.repeat_interleave(self.scale ** 2)
                         for t in _shift(model.add_mean))
        self.head = conv(model.head[0])
        self.groups = []
        for grp in model.body[:-1]:
            blocks = []
            for rcab in grp.body[:-1]:
                c1, c2, ca = rcab.body[0], rcab.body[2], rcab.body[3]
                blocks.append((pack_resblock(c1.weight, c1.bias, c2.weight,
                                             c2.bias, dtype),
                               pack_squeeze(ca.conv_du[0].weight,
                                            ca.conv_du[0].bias,
                                            ca.conv_du[2].weight,
                                            ca.conv_du[2].bias)))
            self.groups.append((blocks, conv(grp.body[-1])))
        self.trunk = conv(model.body[-1])
        kernel, bias, self.pads = folded or fold_upsampler(
            model.state_dict(), self.scale)
        self.fold = (kernel.to(dtype), bias.to(dtype))
        self.min_halo = fold_min_halo(self.scale)
        self.uint8_variant = self._uint8

    @staticmethod
    def _group(g: torch.Tensor, blocks, gconv) -> torch.Tensor:
        """One residual group: its RCABs, each applying the one before as
        it loads its input, the last one's excite, the conv and the
        skip."""
        h, r, pool = g, None, None
        squeeze = blocks[0][1]  # unread by the first block
        for convs, sq in blocks:
            h, r, pool = fused_rcab(h, r, pool, *squeeze, *convs)
            squeeze = sq
        y = rcab_excite(h, r, pool, *squeeze)
        return conv3x3_nhwc(y, *gconv) + g

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [-1, 1] -> the trunk's output (long skip added), in
        ``dtype``, on RCAN's mean-shifted [0, 255] scale."""
        self.forwards += 1
        with span("pesr.head"):
            x255 = (x.float() + 1.0) * 127.5
            head = conv3x3_nhwc((x255 * self.sub[0] + self.sub[1])
                                .to(self.dtype), *self.head)
        g = head
        with span("pesr.trunk"):
            for blocks, gconv in self.groups:
                with span("pesr.group"):
                    g = self._group(g, blocks, gconv)
        with span("pesr.tail"):
            return conv3x3_nhwc(g, *self.trunk) + head

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        """``add_mean`` and the map back to [-1, 1], float32."""
        return (y.float() * self.add[0] + self.add[1]) / 127.5 - 1.0

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = self._trunk(x)
        with span("pesr.upsample"):
            return pixel_shuffle(
                self._out(folded_conv(y, *self.fold, self.pads)), self.scale)

    @torch.no_grad()
    def _uint8(self, x: torch.Tensor) -> torch.Tensor:
        """The folded apply with uint8 output, quantised before the pixel
        shuffle (per element: bitwise the same as after it)."""
        y = self._trunk(x)
        with span("pesr.upsample"):
            y = self._out(folded_conv(y, *self.fold, self.pads))
            return pixel_shuffle(denormalize_to_uint8(y), self.scale)
