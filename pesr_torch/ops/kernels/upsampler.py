"""Fused x2 upsampler stage: ``pixel_shuffle(conv3x3_SAME(x, w) + b, 2)``.

Replaces the TPU kernel ``pesr_tpu/ops/pallas/upsampler.py``
(``_upsampler_kernel`` via ``fused_upsampler_stage``).  The CUDA kernel
is ``pesr_torch/csrc/upsampler.cu``; its header note gives the design and
what bounds it on the H100 (the tensor cores).

``x`` [B, H, W, C] NHWC -> [B, 2H, 2W, C]; in torch order the conv's
weights are HWIO ``(3, 3, C, 4C)`` and its bias ``(4C,)``, column
``c*4 + i*2 + j`` feeding output channel ``c`` at offset ``(i, j)``.  The
kernel wants the columns regrouped per 64 output channels as
[phase][channel]; :func:`pack_upsampler_stage` does that once, when the
weights are loaded, and :func:`fused_upsampler_stage` takes the packed
pair.

:func:`fused_upsampler_stage` launches the kernel for a CUDA tensor and
runs :func:`upsampler_stage_reference`, the plain PyTorch version, for a
CPU tensor.  ``fused_upsampler_stage.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pesr_torch.ops.kernels import build
from pesr_torch.ops.kernels.common import conv3x3_nhwc
from pesr_torch.ops.kernels.resblock import KERNEL_CHANNELS
from pesr_torch.ops.pixel_shuffle import pixel_shuffle

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_GROUP = 64  # output channels per kernel block (x 4 phases = 256 columns)


def upsampler_stage_reference(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: SAME conv + bias + pixel_shuffle(2) in
    x.dtype, torch-order HWIO weights -- one generator Upsampler stage."""
    return pixel_shuffle(conv3x3_nhwc(x, w.permute(3, 2, 0, 1), b), 2)


def _packed_order(c: int) -> torch.Tensor:
    """Packed column k -> torch-order column: group g, phase q, channel t
    (k = g*4n + q*n + t, n = 64 channels per group) reads column
    (g*n + t)*4 + q.  A width the kernel does not take (C % 64 != 0,
    CPU path only) is one group of C channels."""
    n = _GROUP if c % _GROUP == 0 else c
    g, q, t = torch.meshgrid(torch.arange(c // n), torch.arange(4),
                             torch.arange(n), indexing="ij")
    return ((g * n + t) * 4 + q).reshape(-1)


def pack_upsampler_stage(w_hwio: torch.Tensor, b: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch-order HWIO ``(3, 3, C, 4C)`` weights and ``(4C,)`` bias ->
    the packed pair :func:`fused_upsampler_stage` takes: weights in
    ``dtype``, bias rounded to ``dtype`` and held as float32."""
    c = w_hwio.shape[2]
    if tuple(w_hwio.shape) != (3, 3, c, 4 * c):
        raise ValueError(f"upsampler weights must be (3, 3, C, 4C), got "
                         f"{tuple(w_hwio.shape)}")
    order = _packed_order(c).to(w_hwio.device)
    wp = w_hwio.detach().index_select(3, order).to(dtype).contiguous()
    bp = b.detach().index_select(0, order).to(dtype).float().contiguous()
    return wp, bp


def unpack_upsampler_stage(wp: torch.Tensor, bp: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_upsampler_stage` (the column order only)."""
    inv = torch.argsort(_packed_order(wp.shape[2])).to(wp.device)
    return wp.index_select(3, inv), bp.index_select(0, inv)


def fused_upsampler_stage(x: torch.Tensor, wp: torch.Tensor,
                          bp: torch.Tensor) -> torch.Tensor:
    """One x2 stage on the packed weights of :func:`pack_upsampler_stage`.

    CUDA tensor: the hand-written kernel (bf16 x); raises on anything it
    does not take.  CPU tensor: :func:`upsampler_stage_reference`."""
    if x.device.type == "cpu":
        return upsampler_stage_reference(x, *unpack_upsampler_stage(wp, bp))
    if x.device.type != "cuda":
        raise ValueError(f"fused_upsampler_stage: unsupported device "
                         f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_upsampler_stage kernel takes C in "
                         f"{KERNEL_CHANNELS}, got C={c}")
    if min(bsz, h, w) < 1 or bsz * (c // _GROUP) > 65535:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be contiguous bf16 NHWC")
    for name, t, shape, dt in (("w", wp, (3, 3, c, 4 * c), torch.bfloat16),
                               ("b", bp, (4 * c,), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous packed {dt} tensor"
                             f" of shape {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((bsz, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    fn = build.c_function("upsampler", "pesr_fused_upsampler_stage",
                          _ARGTYPES)
    rc = fn(x.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(), bsz,
            h, w, c, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_upsampler_stage kernel launch failed: CUDA "
                           f"error {rc} at x {tuple(x.shape)}")
    fused_upsampler_stage.launches += 1
    return out


fused_upsampler_stage.launches = 0
