"""Generator forward with the body and the x2 stages on the hand-written
kernels (counterpart of ``pesr_tpu/models/pallas_apply.py``).

Both applies take the weights of the plain :class:`Generator` (the same
state_dict) and keep its I/O contract: NHWC [-1, 1] in, NHWC float32
out.  The residual body is a loop of ``fused_resblock`` over the blocks
and each x2 upsampler stage is one ``fused_upsampler_stage``; the head,
tail and output convs stay ``F.conv2d``, as the JAX package leaves them
to XLA, and so does an x3 stage (conv + pixel shuffle).  Compute is in
``dtype`` (bf16 by default) with f32 accumulation in the kernels.

* :class:`KernelApply` (inference) packs the weights once, at
  construction, into the layouts the kernels take; no call repacks them.
* :class:`KernelTrainApply` (training) reads the generator's live
  parameters on every call, casts them to ``dtype`` (gradients reach the
  f32 parameters through the cast, as JAX's ``w.astype(dtype)``) and
  runs the differentiable kernels, whose backward is recomputed through
  the plain versions.

On a CPU device the kernel wrappers run their plain versions.  Both
count their calls in ``forwards``, so a run can check that each forward
launched the body kernel ``num_blocks`` times and the upsampler kernel
once per x2 stage.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from pesr_torch.models.generator import Generator
from pesr_torch.ops.kernels import (fused_resblock, fused_resblock_train,
                                    fused_upsampler_stage,
                                    fused_upsampler_stage_train,
                                    pack_resblock, pack_upsampler_stage)
from pesr_torch.ops.kernels.common import conv3x3_nhwc
from pesr_torch.ops.pixel_shuffle import pixel_shuffle
from pesr_torch.scales import upsample_stages

Conv = Tuple[torch.Tensor, torch.Tensor]


def generator_convs(g: Generator):
    """The convs of ``g`` in chain order: ``(head, [(conv1, conv2) per
    residual block], tail, [(factor, conv) per upsampler stage], out)``,
    the one place that reads the generator's module layout."""
    blocks = [(b.body[0], b.body[2]) for b in g.body[:-1]]
    stages = [(f, g.tail[0][2 * s])
              for s, f in enumerate(upsample_stages(g.scale))]
    return g.head[0], blocks, g.body[-1], stages, g.tail[1]


def _forward(x: torch.Tensor, head: Conv, blocks: Sequence[tuple],
             block_fn: Callable, tail: Conv, stages: Sequence[tuple],
             stage_fn: Callable, out: Conv) -> torch.Tensor:
    """The generator chain; ``block_fn(y, *blk)`` runs a residual block,
    ``stage_fn(y, *p)`` an x2 stage, on the weights as each apply holds
    them."""
    head_y = conv3x3_nhwc(x, *head)
    y = head_y
    for blk in blocks:
        y = block_fn(y, *blk)
    y = conv3x3_nhwc(y, *tail) + head_y
    for f, p in stages:
        if f == 2:
            y = stage_fn(y, *p)
        else:
            y = pixel_shuffle(conv3x3_nhwc(y, *p), f).contiguous()
    return conv3x3_nhwc(y, *out).float()


class KernelApply:
    """``apply(x)`` interchangeable with ``Generator.forward``, on the
    weights packed at construction (inference: no autograd)."""

    def __init__(self, generator: Generator,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        self.scale, self.res_scale = generator.scale, generator.res_scale
        self.num_blocks, self.dtype = generator.num_blocks, dtype
        self.forwards = 0

        def conv(m):
            return m.weight.detach().to(dtype), m.bias.detach().to(dtype)

        head, blocks, tail, stages, out = generator_convs(generator)
        self.head, self.tail, self.out = conv(head), conv(tail), conv(out)
        self.blocks = [pack_resblock(c1.weight, c1.bias, c2.weight, c2.bias,
                                     dtype) for c1, c2 in blocks]
        self.stages = []
        for f, m in stages:
            w, b = conv(m)
            if f == 2:
                self.stages.append(
                    (f, pack_upsampler_stage(w.permute(2, 3, 1, 0), b, dtype)))
            else:
                self.stages.append((f, (w, b)))

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        rs = self.res_scale
        y = _forward(x.to(self.dtype), self.head, self.blocks,
                     lambda y, *p: fused_resblock(y, *p, res_scale=rs),
                     self.tail, self.stages, fused_upsampler_stage, self.out)
        self.forwards += 1
        return y


class KernelTrainApply:
    """Differentiable ``apply(x)`` on the live parameters of
    ``generator`` (the training counterpart of :class:`KernelApply`)."""

    def __init__(self, generator: Generator,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        self.generator, self.dtype = generator, dtype
        self.forwards = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        g, dt = self.generator, self.dtype

        def conv(m):
            return m.weight.to(dt), m.bias.to(dt)

        head, blocks, tail, stages, out = generator_convs(g)
        rs = g.res_scale
        y = _forward(x.to(dt), conv(head),
                     [conv(c1) + conv(c2) for c1, c2 in blocks],
                     lambda y, *p: fused_resblock_train(y, *p, res_scale=rs),
                     conv(tail), [(f, conv(m)) for f, m in stages],
                     fused_upsampler_stage_train, conv(out))
        self.forwards += 1
        return y
