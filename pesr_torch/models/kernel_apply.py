"""Generator inference with the body and the x2 stages on the hand-written
kernels (counterpart of ``pesr_tpu/models/pallas_apply.py``).

Takes the same weights as the plain :class:`Generator` (the same
state_dict) and keeps its I/O contract: NHWC [-1, 1] in, NHWC float32
out.  The residual body is a loop of ``fused_resblock`` over the blocks
and each x2 upsampler stage is one ``fused_upsampler_stage``; the head,
tail and output convs stay ``F.conv2d``, as the JAX package leaves them
to XLA, and so does an x3 stage (conv + pixel shuffle).  Compute is in
``dtype`` (bf16 by default) with f32 accumulation in the kernels.

The weights are repacked once, here, into the layouts the kernels take;
no call repacks them.  On a CPU device the kernel wrappers run their
plain versions.  Inference only: the kernels have no backward yet.
"""

from __future__ import annotations

import torch

from pesr_torch.models.generator import Generator
from pesr_torch.ops.kernels import (fused_resblock, fused_upsampler_stage,
                                    pack_resblock, pack_upsampler_stage)
from pesr_torch.ops.kernels.common import conv3x3_nhwc
from pesr_torch.ops.pixel_shuffle import pixel_shuffle
from pesr_torch.scales import upsample_stages


class KernelApply:
    """``apply(x)`` interchangeable with ``Generator.forward``.

    ``forwards`` counts calls, so a run can check that each forward
    launched the body kernel ``num_blocks`` times and the upsampler
    kernel once per x2 stage."""

    def __init__(self, generator: Generator,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        sd = generator.state_dict()
        n = generator.num_blocks
        self.scale, self.res_scale = generator.scale, generator.res_scale
        self.num_blocks, self.dtype = n, dtype
        self.forwards = 0

        def conv(name):
            return (sd[f"{name}.weight"].detach().to(dtype),
                    sd[f"{name}.bias"].detach().to(dtype))

        self.head = conv("head.0")
        self.blocks = [pack_resblock(sd[f"body.{i}.body.0.weight"],
                                     sd[f"body.{i}.body.0.bias"],
                                     sd[f"body.{i}.body.2.weight"],
                                     sd[f"body.{i}.body.2.bias"], dtype)
                       for i in range(n)]
        self.tail = conv(f"body.{n}")
        self.stages = []
        for s, f in enumerate(upsample_stages(self.scale)):
            w, b = conv(f"tail.0.{2 * s}")
            if f == 2:
                self.stages.append(
                    (f, pack_upsampler_stage(w.permute(2, 3, 1, 0), b, dtype)))
            else:
                self.stages.append((f, (w, b)))
        self.out = conv("tail.1")

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        head = conv3x3_nhwc(x, *self.head)
        y = head
        for blk in self.blocks:
            y = fused_resblock(y, *blk, res_scale=self.res_scale)
        y = conv3x3_nhwc(y, *self.tail) + head
        for f, p in self.stages:
            if f == 2:
                y = fused_upsampler_stage(y, *p)
            else:
                y = pixel_shuffle(conv3x3_nhwc(y, *p), f).contiguous()
        self.forwards += 1
        return conv3x3_nhwc(y, *self.out).float()
