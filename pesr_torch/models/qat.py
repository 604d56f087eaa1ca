"""Quantization-aware training (``--phase qat``): a W8A8 fake-quant
generator forward with straight-through gradients (counterpart of
``pesr_tpu/models/qat.py``).

The forward runs the int8 inference path's quantization: per-input-
channel activation scales folded into a kernel quantized per output
channel, but with float carriers and straight-through rounding, so the
L1 objective pulls the weights onto the int8 grid.  A QAT snapshot is a
plain generator state_dict.

The fake-quantized operands are integers <= 127, which bf16 holds
exactly, and the convs accumulate in f32, so the bf16 conv computes the
integer product exactly.  Scales come from this batch's amax (no
gradient), as in JAX; on a mesh (data parallel) the GLOBAL batch's, as
under JAX's jit over a sharded batch: one all-reduce (max) per conv.  The convs are ``F.conv2d`` (cuDNN on the card),
as JAX's are ``lax.conv``: no hand-written kernel runs here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pesr_torch import parallel
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import generator_convs
from pesr_torch.ops.kernels.common import conv3x3_nhwc
from pesr_torch.ops.pixel_shuffle import pixel_shuffle


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() forward, identity backward."""
    return x + (torch.round(x) - x).detach()


def _clip127(x: torch.Tensor) -> torch.Tensor:
    """Clip to [-127, 127] as ``jnp.clip`` does, gradient included: a
    value on a bound (every channel's amax lands on 127) passes half the
    gradient, as ``torch.maximum`` / ``minimum`` split a tie like JAX's
    max / min.  The bounds are filled on the device: a tensor made from a
    Python number on a CUDA device is a copy the host waits for."""
    return torch.minimum(torch.maximum(x, x.new_full((), -127.0)),
                         x.new_full((), 127.0))


def fake_quant_conv(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, dtype=torch.bfloat16, mesh=None
                    ) -> torch.Tensor:
    """W8A8 fake-quant SAME 3x3 conv of NHWC ``x`` with OIHW ``weight``:
    quantize ``x`` per input channel (scale amax / 127 over this batch),
    fold those scales into the weight, quantize it per output channel,
    convolve the integer-valued operands in ``dtype``, dequantize in f32
    and add the bias; the result in ``dtype``.  ``mesh``: the amax is
    taken over every rank's batch."""
    xf = x.float()
    amax = parallel.max_all_(mesh, xf.detach().abs().amax(dim=(0, 1, 2)))
    s_in = amax.clamp_min(1e-6) / 127.0
    xq = _clip127(_ste_round(xf / s_in))
    w_fold = weight.float() * s_in[None, :, None, None]
    s_w = (w_fold.detach().abs().amax(dim=(1, 2, 3)).clamp_min(1e-12)
           / 127.0)
    wq = _clip127(_ste_round(w_fold / s_w[:, None, None, None]))
    y = F.conv2d(xq.to(dtype).permute(0, 3, 1, 2), wq.to(dtype), padding=1)
    return (y.permute(0, 2, 3, 1).float() * s_w
            + bias.float()).to(dtype)


class QatApply:
    """``apply(x)`` of ``generator``'s live parameters with the body and
    tail convs fake-quantized (the int8 path's endpoint policy: head,
    upsampler and out stay float), in ``dtype``; NHWC [-1, 1] in, NHWC
    float32 out.  JAX's ``make_qat_apply``.  Folds nothing, so its
    ``min_halo`` is 0 and it has no ``uint8_variant``.  ``mesh``: the
    activation scales over the global batch of a data-parallel step."""

    min_halo = 0

    def __init__(self, generator: Generator,
                 dtype: torch.dtype = torch.bfloat16, mesh=None) -> None:
        self.generator, self.dtype, self.mesh = generator, dtype, mesh
        self.forwards = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        head, blocks, tail, stages, out = generator_convs(self.generator)

        def conv(y, m):
            return conv3x3_nhwc(y, m.weight.to(dt), m.bias.to(dt))

        self.forwards += 1
        rs = torch.full((), self.generator.res_scale, dtype=dt,
                        device=x.device)
        zero = torch.zeros((), dtype=dt, device=x.device)
        head_y = conv(x.to(dt), head)
        y = head_y
        for c1, c2 in blocks:
            # JAX's jnp.maximum(y, 0): an exact 0 passes half the gradient
            h = torch.maximum(fake_quant_conv(y, c1.weight, c1.bias, dt,
                                              mesh=self.mesh), zero)
            y = y + rs * fake_quant_conv(h, c2.weight, c2.bias, dt,
                                         mesh=self.mesh)
        y = fake_quant_conv(y, tail.weight, tail.bias, dt,
                            mesh=self.mesh) + head_y
        for f, m in stages:
            y = pixel_shuffle(conv(y, m), f)
        return conv(y, out).float()
