"""Generator forward with the body and the x2 stages on the hand-written
kernels (counterpart of ``pesr_tpu/models/pallas_apply.py``, and of the
folded applies of ``pesr_tpu/models/fold.py``).

Both applies take the weights of the plain :class:`Generator` (the same
state_dict) and keep its I/O contract: NHWC [-1, 1] in, NHWC float32
out.  The trunk (head conv, the residual body as a loop of
``fused_resblock`` over the blocks, tail conv + skip) is shared; after
it, either the upsampler chain, each x2 stage one
``fused_upsampler_stage`` (an x3 stage conv + pixel shuffle) and the out
conv, or, with ``fold=True``, the folded upsampler: one conv with the
composite kernel of ``models/fold.py`` and one pixel shuffle.  The head,
tail, out and folded convs stay ``F.conv2d``, as the JAX package leaves
them to XLA.  Compute is in ``dtype`` (bf16 by default) with f32
accumulation in the kernels.

* :class:`KernelApply` (inference) packs the weights once, at
  construction, into the layouts the kernels take; no call repacks them.
  Folded, it derives the composite once by impulse probing and carries
  ``min_halo`` (the fold's border band, which the engines pad and crop)
  and ``uint8_variant`` (quantised before the pixel shuffle).
* :class:`Float32Apply` (``--compute_dtype float32``) is the same
  forward in float32 on plain PyTorch convs with TF32 off: the kernels
  take bf16 only, so it launches none.
* :class:`KernelTrainApply` (training) reads the generator's live
  parameters on every call, casts them to ``dtype`` (gradients reach the
  parameters, f32 or bf16 by ``--param_dtype``, through the cast, as
  JAX's ``w.astype(dtype)``) and runs the differentiable kernels, whose
  backward runs library convolution gradients (``resblock_backward``,
  ``upsampler_stage_backward``).  Folded
  (``--fold_train``), it composes the fold analytically from the live
  upsampler and out weights on every call, so the optimizer updates them
  through it; snapshots keep them.
* :class:`Float32TrainApply` (``--compute_dtype float32`` training on
  the card) is that forward with the plain versions in f32, TF32 off:
  no kernel launch.

On a CPU device the kernel wrappers run their plain versions.  Both
count their calls in ``forwards``, so a run can check that each forward
launched the body kernel ``num_blocks`` times and the upsampler kernel
once per x2 stage (never, folded).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

import torch

from pesr_torch.data.augment import denormalize_to_uint8
from pesr_torch.models.fold import (Fold, analytic_fold_upsampler,
                                    fold_upsampler, folded_conv)
from pesr_torch.models.generator import Generator
from pesr_torch.ops.kernels import (fused_resblock, fused_resblock_train,
                                    fused_upsampler_stage,
                                    fused_upsampler_stage_train,
                                    pack_resblock, pack_upsampler_stage,
                                    resblock_reference,
                                    upsampler_stage_reference)
from pesr_torch.ops.kernels.common import conv3x3_nhwc
from pesr_torch.ops.pixel_shuffle import pixel_shuffle
from pesr_torch.scales import fold_min_halo, upsample_stages
from pesr_torch.utils.device import full_f32

Conv = Tuple[torch.Tensor, torch.Tensor]


def generator_convs(g: Generator):
    """The convs of ``g`` in chain order: ``(head, [(conv1, conv2) per
    residual block], tail, [(factor, conv) per upsampler stage], out)``,
    the one place that reads the generator's module layout."""
    blocks = [(b.body[0], b.body[2]) for b in g.body[:-1]]
    stages = [(f, g.tail[0][2 * s])
              for s, f in enumerate(upsample_stages(g.scale))]
    return g.head[0], blocks, g.body[-1], stages, g.tail[1]


def _trunk(x: torch.Tensor, head: Conv, blocks: Sequence[tuple],
           block_fn: Callable, tail: Conv) -> torch.Tensor:
    """Head conv, the residual blocks (``block_fn(y, *blk)`` runs one on
    the weights as each apply holds them), tail conv + global skip."""
    head_y = conv3x3_nhwc(x, *head)
    y = head_y
    for blk in blocks:
        y = block_fn(y, *blk)
    return conv3x3_nhwc(y, *tail) + head_y


def _upsample(y: torch.Tensor, stages: Sequence[tuple], stage_fn: Callable,
              out: Conv) -> torch.Tensor:
    """The upsampler chain and the out conv; ``stage_fn(y, *p)`` runs an
    x2 stage."""
    for f, p in stages:
        if f == 2:
            y = stage_fn(y, *p)
        else:
            y = pixel_shuffle(conv3x3_nhwc(y, *p), f).contiguous()
    return conv3x3_nhwc(y, *out).float()


class KernelApply:
    """``apply(x)`` interchangeable with ``Generator.forward``, on the
    weights packed at construction (inference: no autograd).  ``fold``:
    the folded upsampler (``test.py --fold``) in place of the chain;
    ``folded``: its ``fold_upsampler`` result when the caller has it."""

    def __init__(self, generator: Generator,
                 dtype: torch.dtype = torch.bfloat16,
                 fold: bool = False, folded: Optional[Fold] = None) -> None:
        self.scale, self.res_scale = generator.scale, generator.res_scale
        self.num_blocks, self.dtype = generator.num_blocks, dtype
        self.forwards = 0

        def conv(m):
            return m.weight.detach().to(dtype), m.bias.detach().to(dtype)

        head, blocks, tail, stages, out = generator_convs(generator)
        self.head, self.tail = conv(head), conv(tail)
        self.blocks = [pack_resblock(c1.weight, c1.bias, c2.weight, c2.bias,
                                     dtype) for c1, c2 in blocks]
        self.min_halo, self.uint8_variant = 0, None
        if fold:
            kernel, bias, self.pads = folded or fold_upsampler(
                generator.state_dict(), self.scale)
            self.fold = (kernel.to(dtype), bias.to(dtype))
            self.min_halo = fold_min_halo(self.scale)
            self.uint8_variant = self._uint8
            return
        self.fold, self.out = None, conv(out)
        self.stages = []
        for f, m in stages:
            w, b = conv(m)
            if f == 2:
                self.stages.append(
                    (f, pack_upsampler_stage(w.permute(2, 3, 1, 0), b, dtype)))
            else:
                self.stages.append((f, (w, b)))

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        self.forwards += 1
        rs = self.res_scale
        return _trunk(x.to(self.dtype), self.head, self.blocks,
                      lambda y, *p: fused_resblock(y, *p, res_scale=rs),
                      self.tail)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = self._trunk(x)
        if self.fold is None:
            return _upsample(y, self.stages, fused_upsampler_stage, self.out)
        return pixel_shuffle(folded_conv(y, *self.fold, self.pads),
                             self.scale).float()

    @torch.no_grad()
    def _uint8(self, x: torch.Tensor) -> torch.Tensor:
        """The folded apply with uint8 output, quantised BEFORE the pixel
        shuffle: ``denormalize_to_uint8`` is per element, so this equals
        quantising after bit for bit, and the shuffle's copy of the HR
        tensor moves 1-byte pixels."""
        y = folded_conv(self._trunk(x), *self.fold, self.pads)
        return pixel_shuffle(denormalize_to_uint8(y), self.scale)


class Float32Apply:
    """The forward of ``--compute_dtype float32`` (JAX's float32 paths):
    the plain :class:`Generator` in f32, or with ``fold`` its trunk and
    the folded conv in f32, all on plain PyTorch convs under
    :func:`~pesr_torch.utils.device.full_f32` (TF32 off).  No
    hand-written kernel runs: they take bf16 only.  Carries
    ``forwards``, and ``min_halo`` / ``uint8_variant`` when folded, as
    :class:`KernelApply`."""

    def __init__(self, generator: Generator, fold: bool = False,
                 folded: Optional[Fold] = None) -> None:
        if next(generator.parameters()).dtype != torch.float32:
            generator = copy.deepcopy(generator).float()  # bf16 parameters
        self.generator, self.scale = generator, generator.scale
        self.forwards, self.fold = 0, None
        self.min_halo, self.uint8_variant = 0, None
        if fold:
            kernel, bias, self.pads = folded or fold_upsampler(
                generator.state_dict(), self.scale)
            self.fold = (kernel.float(), bias.float())
            self.min_halo = fold_min_halo(self.scale)
            self.uint8_variant = self._uint8

    def _folded(self, x: torch.Tensor) -> torch.Tensor:
        """Trunk and folded conv, NHWC f32, before the pixel shuffle."""
        g = self.generator
        with full_f32(x.device):
            h = g.head(x.permute(0, 3, 1, 2).float())
            y = (g.body(h) + h).permute(0, 2, 3, 1)
            return folded_conv(y, *self.fold, self.pads)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.forwards += 1
        if self.fold is None:
            with full_f32(x.device):
                return self.generator(x)
        return pixel_shuffle(self._folded(x), self.scale)

    @torch.no_grad()
    def _uint8(self, x: torch.Tensor) -> torch.Tensor:
        self.forwards += 1
        return pixel_shuffle(denormalize_to_uint8(self._folded(x)),
                             self.scale)


class KernelTrainApply:
    """Differentiable ``apply(x)`` on the live parameters of
    ``generator`` (the training counterpart of :class:`KernelApply`);
    ``fold``: through the analytic fold (``--fold_train``)."""

    def __init__(self, generator: Generator,
                 dtype: torch.dtype = torch.bfloat16,
                 fold: bool = False) -> None:
        self.generator, self.dtype, self.fold = generator, dtype, fold
        self.min_halo = fold_min_halo(generator.scale) if fold else 0
        self.forwards = 0

    def _block(self, y, w1, b1, w2, b2):
        return fused_resblock_train(y, w1, b1, w2, b2,
                                    res_scale=self.generator.res_scale)

    @staticmethod
    def _stage(y, w, b):
        return fused_upsampler_stage_train(y, w, b)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        g, dt = self.generator, self.dtype

        def conv(m):
            return m.weight.to(dt), m.bias.to(dt)

        head, blocks, tail, stages, out = generator_convs(g)
        y = _trunk(x.to(dt), conv(head),
                   [conv(c1) + conv(c2) for c1, c2 in blocks], self._block,
                   conv(tail))
        self.forwards += 1
        if not self.fold:
            return _upsample(y, [(f, conv(m)) for f, m in stages],
                             self._stage, conv(out))
        kernel, bias, pads = analytic_fold_upsampler(
            [(m.weight, m.bias) for _, m in stages], (out.weight, out.bias),
            g.scale)
        return pixel_shuffle(folded_conv(y, kernel, bias, pads),
                             g.scale).float()


class Float32TrainApply(KernelTrainApply):
    """The train apply of ``--compute_dtype float32`` on a CUDA device
    (the training counterpart of :class:`Float32Apply`): the same
    forward as :class:`KernelTrainApply` (chain, or trunk plus the
    analytic fold), with each residual block and x2 stage the plain
    PyTorch version the kernels' backward differentiates, in float32 on
    library convs under :func:`~pesr_torch.utils.device.full_f32` (TF32
    off), so no hand-written kernel launches: they take bf16 only.  The
    parameters are read in float32 whatever their dtype.  The step's
    backward must run under ``full_f32`` too (``training/steps.py`` holds
    both in it)."""

    def __init__(self, generator: Generator, fold: bool = False) -> None:
        super().__init__(generator, torch.float32, fold)

    def _block(self, y, w1, b1, w2, b2):
        return resblock_reference(y, w1.permute(2, 3, 1, 0), b1,
                                  w2.permute(2, 3, 1, 0), b2,
                                  self.generator.res_scale)

    @staticmethod
    def _stage(y, w, b):
        return upsampler_stage_reference(y, w.permute(2, 3, 1, 0), b)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with full_f32(x.device):
            return super().__call__(x)
