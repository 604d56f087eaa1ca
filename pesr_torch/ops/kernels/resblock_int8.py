"""Fused int8 (W8A8) residual block: the block of the int8 inference path
(``--quant int8``) in one launch.

Counterpart of no Pallas kernel: the JAX block
(``pesr_tpu/models/quant_apply.py:235-262``, ``body_fn``) is two
``lax.conv(int8, int8) -> int32`` with the quantize, the conv1 -> conv2
requant, the dequant and the residual fused around them by XLA.  The CUDA
kernel is ``pesr_torch/csrc/resblock_int8.cu`` (s8 ``wgmma``, the bf16
carry quantized into shared memory by producer warps off the MMA path, an
int8 hidden ring); its header note gives the design and what bounds it on
the H100.

On the bf16 carry ``y`` [B, H, W, C] NHWC, with int8 weights and the f32
per-channel vectors of :class:`~pesr_torch.models.quant_apply.Int8Apply`
(``qin1``, ``mq = m1 qin2``, ``bq = bias1 qin2``, ``m2``, ``b2``)::

    q1  = clip(rint(f32(y) qin1), -127, 127)                   int8
    h   = clip(rint(max(f32(conv(q1, w1)) mq + bq, 0)), .., 127) int8
    y2  = bf16(f32(conv(h, w2)) m2 + b2)
    out = y + bf16(res_scale) y2                 (bf16 ops, two roundings)

each float operation rounded on its own.  :func:`int8_resblock_reference`
is the plain version (OHWI weights, the layout of
:func:`~pesr_torch.ops.int8_conv.int8_conv`), bitwise JAX's ``body_fn``
run op by op.  The kernel takes the weights packed once by
:func:`pack_int8_block_weights` (K-major, the output channels in the
orders of :func:`output_channel_orders`); :func:`fused_resblock_int8`
calls the custom op ``pesr::fused_resblock_int8``, which launches the
kernel for a CUDA tensor (counted in ``fused_resblock_int8.launches``)
and runs the plain version for a CPU tensor; its fake implementation
lets ``torch.export`` trace through it.  :func:`resblock_int8_schedule`
and :func:`resblock_int8_work` give the kernel's decomposition (the
bf16 kernel's line mode) for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Tuple, Union

import torch

from pesr_torch.ops.int8_conv import int8_conv_reference
from pesr_torch.ops.kernels import build
from pesr_torch.ops.kernels.resblock import (CLUSTER, KERNEL_CHANNELS,
                                             ResblockSchedule, _line,
                                             _steps)

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_VECTORS = ("qin1", "mq", "bq", "m2", "b2")


def quantize_act(x: torch.Tensor, qin: torch.Tensor) -> torch.Tensor:
    """``clip(round(x f32 * qin), -127, 127)`` as int8 (round half to
    even, as ``jnp.round``)."""
    return torch.clamp(torch.round(x.float() * qin), -127, 127).to(
        torch.int8)


def requant(acc1: torch.Tensor, mq: torch.Tensor, bq: torch.Tensor
            ) -> torch.Tensor:
    """conv1's int32 accumulator -> conv2's int8 input:
    ``clip(round(max(acc1 f32 * mq + bq, 0)))`` with the f32 vectors ``mq
    = m1 qin2`` and ``bq = bias1 qin2``; a multiply, then an add (two
    roundings, as XLA computes it)."""
    t = acc1.float() * mq + bq
    return torch.clamp(torch.round(torch.clamp_min(t, 0.0)), -127, 127).to(
        torch.int8)


def _bf16_scalar(res_scale: Union[float, torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    if torch.is_tensor(res_scale):
        return res_scale.to(device=device, dtype=torch.bfloat16)
    return torch.full((), res_scale, dtype=torch.bfloat16, device=device)


def int8_resblock_reference(y: torch.Tensor, w1: torch.Tensor,
                            qin1: torch.Tensor, mq: torch.Tensor,
                            bq: torch.Tensor, w2: torch.Tensor,
                            m2: torch.Tensor, b2: torch.Tensor,
                            res_scale: Union[float, torch.Tensor],
                            conv: Callable = int8_conv_reference
                            ) -> torch.Tensor:
    """The plain version on the bf16 carry ``y``: int8 conv1 (OHWI
    ``w1``), the fused requant, int8 conv2, the dequant, ``y +
    bf16(res_scale) y2`` in bf16.  ``conv``: the int8 conv
    (:func:`~pesr_torch.ops.int8_conv.int8_conv_reference`, exact on any
    device; ``int8_conv_im2col`` gives the library route)."""
    acc1 = conv(quantize_act(y, qin1), w1)
    acc2 = conv(requant(acc1, mq, bq), w2)
    y2 = (acc2.float() * m2 + b2).to(torch.bfloat16)
    return y + _bf16_scalar(res_scale, y.device) * y2


@functools.lru_cache(maxsize=None)
def output_channel_orders(c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's orders of conv1's and conv2's output channels: entry
    ``n`` is the channel that the wgmma accumulator's column ``n`` holds.
    A lane of the accumulator holds columns ``8 j + 2 r + e`` (``r`` =
    lane % 4, ``e`` = 0, 1) for every 8-column group ``j``; the orders
    give it channels that lie side by side in memory: conv1's column ``64
    u + 8 i + 2 r + e`` is channel ``64 u + 16 r + 2 i + e`` (16 channels
    of the int8 hidden ring, one 16-byte store), conv2's column ``32 i + 8
    e + 2 r + f`` is channel ``32 i + 8 r + 2 e + f`` (8 channels of the
    bf16 carry and output, one 16-byte vector).  The identities when
    ``c`` is not a multiple of 64 (no kernel width)."""
    n = torch.arange(c)
    if c % 64:
        return n, n
    u, i, r, e = n // 64, n % 64 // 8, n % 8 // 2, n % 2
    first = 64 * u + 16 * r + 2 * i + e
    i, e, r, f = n // 32, n % 32 // 8, n % 8 // 2, n % 2
    return first, 32 * i + 8 * r + 2 * e + f


def pack_int8_block_weights(w1: torch.Tensor, w2: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OHWI int8 ``w1``, ``w2`` -> the kernel's K-major ``(3, 3, C_out,
    C_in)`` int8 pair: per tap one row of input channels per output
    channel, the output channels in :func:`output_channel_orders`."""
    o1, o2 = output_channel_orders(w1.shape[0])
    return (w1.index_select(0, o1.to(w1.device)).permute(1, 2, 0, 3)
            .contiguous(),
            w2.index_select(0, o2.to(w2.device)).permute(1, 2, 0, 3)
            .contiguous())


def unpack_int8_block_weights(w1: torch.Tensor, w2: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`pack_int8_block_weights`: OHWI int8."""
    o1, o2 = (torch.argsort(o) for o in output_channel_orders(w1.shape[2]))
    return (w1.index_select(2, o1.to(w1.device)).permute(2, 0, 1, 3)
            .contiguous(),
            w2.index_select(2, o2.to(w2.device)).permute(2, 0, 1, 3)
            .contiguous())


@functools.lru_cache(maxsize=None)
def resblock_int8_schedule(bsz: int, h: int, w: int,
                           clusters: int = 66) -> ResblockSchedule:
    """The kernel's decomposition: ``fused_resblock``'s line mode (strip
    segments of 62 output columns x ``rows`` rows, the rows per segment
    of least (waves) x (steps per CTA)) for every shape; ``clusters``
    clusters of :data:`CLUSTER` CTAs run at once (66 on the H100)."""
    return _line(bsz, h, w, clusters)[0]


class Int8BlockWork(NamedTuple):
    """One launch's CTAs, their waves (``ctas`` over the CTAs that run at
    once) and its conv MACs: computed (every CTA's conv steps on 64-pixel
    warpgroup tiles, inside the image or not) and useful (2 x 9 C^2 per
    pixel)."""
    ctas: int
    waves: int
    computed: int
    useful: int


def resblock_int8_work(bsz: int, h: int, w: int, c: int = 256,
                       clusters: int = 66) -> Int8BlockWork:
    sched = resblock_int8_schedule(bsz, h, w, clusters)
    return Int8BlockWork(
        sched.ctas, -(-sched.ctas // (CLUSTER * clusters)),
        sched.ctas * sum(_steps(sched)) * 64 * 9 * c * c,
        2 * bsz * h * w * 9 * c * c)


@functools.lru_cache(maxsize=None)
def _max_clusters(c: int, device: torch.device) -> int:
    """Clusters of the C-channel kernel the device runs at once."""
    fn = build.c_function("resblock_int8", "pesr_resblock_int8_max_clusters",
                          [ctypes.c_int])
    with torch.cuda.device(device):
        n = fn(c)
    if n <= 0:
        raise RuntimeError(f"fused_resblock_int8: no cluster of {CLUSTER} "
                           f"fits (CUDA error {-n})")
    return n


@functools.lru_cache(maxsize=None)
def _bf16_value(res_scale: float) -> float:
    return float(torch.tensor(res_scale, dtype=torch.bfloat16))


def _check(y, w1, w2, vectors) -> None:
    if y.dim() != 4:
        raise ValueError(f"y must be [B, H, W, C], got {tuple(y.shape)}")
    bsz, h, w, c = y.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_resblock_int8 kernel takes C in "
                         f"{KERNEL_CHANNELS}, got C={c}")
    if min(bsz, h, w) < 1:
        raise ValueError(f"unsupported shape {tuple(y.shape)}")
    if y.dtype != torch.bfloat16 or not y.is_contiguous():
        raise ValueError("y must be contiguous bf16 NHWC")
    for name, t, shape, dt in (
            ("w1", w1, (3, 3, c, c), torch.int8),
            ("w2", w2, (3, 3, c, c), torch.int8),
            *((n, v, (c,), torch.float32) for n, v in zip(_VECTORS,
                                                          vectors))):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != y.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"shape {shape} on {y.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if y.data_ptr() % 16:
        raise ValueError("y must be 16-byte aligned (TMA, vector loads)")


def fused_resblock_int8(y: torch.Tensor, w1: torch.Tensor, qin1: torch.Tensor,
                        mq: torch.Tensor, bq: torch.Tensor, w2: torch.Tensor,
                        m2: torch.Tensor, b2: torch.Tensor,
                        res_scale: float) -> torch.Tensor:
    """One int8 residual block on the bf16 carry ``y`` (NHWC), weights as
    :func:`pack_int8_block_weights` gives them, ``res_scale`` rounded to
    bf16.  Calls the custom op ``pesr::fused_resblock_int8``: on a CUDA
    tensor the hand-written kernel (raises on anything it does not
    take), on a CPU tensor the plain version; any other device raises."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_resblock_int8: unsupported device "
                         f"{y.device}")
    return torch.ops.pesr.fused_resblock_int8(y, w1, qin1, mq, bq, w2, m2,
                                              b2, float(res_scale))


fused_resblock_int8.launches = 0


@torch.library.custom_op("pesr::fused_resblock_int8", mutates_args=(),
                         device_types="cpu")
def _resblock_int8_op(y: torch.Tensor, w1: torch.Tensor, qin1: torch.Tensor,
                      mq: torch.Tensor, bq: torch.Tensor, w2: torch.Tensor,
                      m2: torch.Tensor, b2: torch.Tensor,
                      res_scale: float) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    a, b = unpack_int8_block_weights(w1, w2)
    return int8_resblock_reference(y, a, qin1, mq, bq, b, m2, b2, res_scale)


@_resblock_int8_op.register_kernel("cuda")
def _resblock_int8_cuda(y, w1, qin1, mq, bq, w2, m2, b2, res_scale):
    """The op's CUDA implementation: one launch of the kernel, counted in
    ``fused_resblock_int8.launches``."""
    vectors = (qin1, mq, bq, m2, b2)
    _check(y, w1, w2, vectors)
    bsz, h, w, c = y.shape
    sched = resblock_int8_schedule(bsz, h, w, _max_clusters(c, y.device))
    out = torch.empty_like(y)
    fn = build.c_function("resblock_int8", "pesr_fused_resblock_int8",
                          _ARGTYPES)
    rc = fn(y.data_ptr(), w1.data_ptr(), *(v.data_ptr() for v in vectors[:3]),
            w2.data_ptr(), *(v.data_ptr() for v in vectors[3:]),
            out.data_ptr(), bsz, h, w, c, _bf16_value(float(res_scale)),
            sched.rows, sched.strips, sched.segs, sched.ctas,
            torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_resblock_int8 kernel launch failed: CUDA "
                           f"error {rc} at y {tuple(y.shape)}")
    fused_resblock_int8.launches += 1
    return out


@_resblock_int8_op.register_fake
def _resblock_int8_fake(y, w1, qin1, mq, bq, w2, m2, b2, res_scale):
    """Shape and dtype of the output, for ``torch.export``: the carry's."""
    return torch.empty_like(y)
