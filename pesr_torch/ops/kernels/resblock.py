"""Fused residual block: ``x + res_scale * (conv3x3(relu(conv3x3(x) + b1)) + b2)``.

Replaces the TPU kernel ``pesr_tpu/ops/pallas/resblock.py``
(``_resblock_kernel`` via ``fused_resblock``).  The CUDA kernel is
``pesr_torch/csrc/resblock.cu``; its header note gives the tile, the
shared-memory budget and what bounds it on the H100 (the tensor cores).

Layouts follow the JAX package: ``x`` is NHWC, ``w1``/``w2`` are HWIO
``(3, 3, C, C)``, ``b1``/``b2`` are ``(C,)``.  For the kernel the
weights are bf16 and the biases float32 (:func:`pack_resblock` makes
them once, from torch OIHW weights, when the weights are loaded).

:func:`fused_resblock` launches the kernel for a CUDA tensor and runs
:func:`resblock_reference`, the plain PyTorch version, for a CPU
tensor.  ``fused_resblock.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pesr_torch.ops.kernels import build
from pesr_torch.ops.kernels.common import conv3x3_nhwc

KERNEL_CHANNELS = (64, 128, 256)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def resblock_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor,
                       res_scale: float = 0.1) -> torch.Tensor:
    """Plain PyTorch version: the exact math of one generator ResBlock
    (SAME convs, ReLU between, scaled residual), computed in x.dtype."""
    y = torch.relu(conv3x3_nhwc(x, w1.permute(3, 2, 0, 1), b1))
    y = conv3x3_nhwc(y, w2.permute(3, 2, 0, 1), b2)
    return x + res_scale * y


def pack_resblock(conv1_w: torch.Tensor, conv1_b: torch.Tensor,
                  conv2_w: torch.Tensor, conv2_b: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, ...]:
    """Torch OIHW conv weights -> ``(w1, b1, w2, b2)`` for
    :func:`fused_resblock`: HWIO weights in ``dtype``, biases rounded to
    ``dtype`` and held as float32 (the kernel adds them in f32, as the
    TPU kernel adds its bf16 biases)."""
    def w(t):
        return t.detach().permute(2, 3, 1, 0).to(dtype).contiguous()

    def b(t):
        return t.detach().to(dtype).float().contiguous()

    return w(conv1_w), b(conv1_b), w(conv2_w), b(conv2_b)


def _check(x, w1, b1, w2, b2) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_resblock kernel takes C in {KERNEL_CHANNELS},"
                         f" got C={c}")
    if min(bsz, h, w) < 1 or bsz > 65535:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be contiguous bf16 NHWC")
    for name, t, shape, dt in (("w1", w1, (3, 3, c, c), torch.bfloat16),
                               ("w2", w2, (3, 3, c, c), torch.bfloat16),
                               ("b1", b1, (c,), torch.float32),
                               ("b2", b2, (c,), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"shape {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_resblock(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   res_scale: float = 0.1) -> torch.Tensor:
    """NHWC ``x`` -> ``x + res_scale * conv2(relu(conv1(x)))``.

    CUDA tensor: the hand-written kernel (bf16 x, weights from
    :func:`pack_resblock`); raises on anything it does not take.  CPU
    tensor: :func:`resblock_reference`."""
    if x.device.type == "cpu":
        return resblock_reference(x, w1, b1, w2, b2, res_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    _check(x, w1, b1, w2, b2)
    bsz, h, w, c = x.shape
    out = torch.empty_like(x)
    fn = build.c_function("resblock", "pesr_fused_resblock", _ARGTYPES)
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), bsz, h, w, c, float(res_scale),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_resblock kernel launch failed: CUDA error "
                           f"{rc} at x {tuple(x.shape)}")
    fused_resblock.launches += 1
    return out


fused_resblock.launches = 0
