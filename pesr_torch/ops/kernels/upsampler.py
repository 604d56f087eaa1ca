"""Fused x2 upsampler stage: ``pixel_shuffle(conv3x3_SAME(x, w) + b, 2)``.

Replaces the TPU kernel ``pesr_tpu/ops/pallas/upsampler.py``
(``_upsampler_kernel`` via ``fused_upsampler_stage``).  The CUDA kernel
is ``pesr_torch/csrc/upsampler.cu``; its header note gives the design
(persistent clusters, wgmma, a multicast TMA weight ring, a TMA store of
each shuffled tile) and what bounds it on the H100.

``x`` [B, H, W, C] NHWC -> [B, 2H, 2W, C]; in torch order the conv's
weights are HWIO ``(3, 3, C, 4C)`` and its bias ``(4C,)``, column
``c*4 + i*2 + j`` feeding output channel ``c`` at offset ``(i, j)``.  The
kernel wants the columns regrouped per 64 output channels as
[phase][channel], and the weights K-major, ``(3, 3, 4C, C)``: per tap one
row of input channels per packed column.  :func:`pack_upsampler_stage`
does that once, when the weights are loaded, and
:func:`fused_upsampler_stage` takes the packed pair.
:func:`upsampler_schedule` is the kernel's tile list, computed here so
that the CPU tests can check it.

:func:`fused_upsampler_stage` calls the custom op
``pesr::fused_upsampler_stage`` (``torch.library``), which launches the
kernel for a CUDA tensor and runs :func:`upsampler_stage_reference`, the
plain PyTorch version, for a CPU tensor (its fake implementation lets
``torch.export`` trace through it).  ``fused_upsampler_stage.launches``
counts kernel launches.
:func:`fused_upsampler_stage_train` is the differentiable form training
uses: the kernel forward on weights packed per call, and
:func:`upsampler_stage_backward`, which recomputes nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from pesr_torch.ops.kernels import build
from pesr_torch.ops.kernels.common import conv3x3_nhwc, conv3x3_nhwc_backward
from pesr_torch.ops.kernels.resblock import CLUSTER, KERNEL_CHANNELS
from pesr_torch.ops.pixel_shuffle import pixel_shuffle

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_GROUP = 64  # output channels per kernel tile (x 4 phases = 256 columns)
TILE_W = 64  # conv pixels per row of a tile


def upsampler_stage_reference(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: SAME conv + bias + pixel_shuffle(2) in
    x.dtype, torch-order HWIO weights -- one generator Upsampler stage."""
    return pixel_shuffle(conv3x3_nhwc(x, w.permute(3, 2, 0, 1), b), 2)


@functools.lru_cache(maxsize=None)
def _packed_order(c: int, device: torch.device) -> torch.Tensor:
    """Packed column k -> torch-order column: group g, phase q, channel t
    (k = g*4n + q*n + t, n = 64 channels per group) reads column
    (g*n + t)*4 + q.  A width the kernel does not take (C % 64 != 0,
    CPU path only) is one group of C channels.  Cached per device: a
    training step packs every call."""
    n = _GROUP if c % _GROUP == 0 else c
    g, q, t = torch.meshgrid(torch.arange(c // n), torch.arange(4),
                             torch.arange(n), indexing="ij")
    return ((g * n + t) * 4 + q).reshape(-1).to(device)


def pack_upsampler_stage(w_hwio: torch.Tensor, b: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch-order HWIO ``(3, 3, C, 4C)`` weights and ``(4C,)`` bias ->
    the packed pair :func:`fused_upsampler_stage` takes: weights
    ``(3, 3, 4C, C)`` in ``dtype`` with the packed column order, bias in
    the same order, rounded to ``dtype`` and held as float32."""
    c = w_hwio.shape[2]
    if tuple(w_hwio.shape) != (3, 3, c, 4 * c):
        raise ValueError(f"upsampler weights must be (3, 3, C, 4C), got "
                         f"{tuple(w_hwio.shape)}")
    order = _packed_order(c, w_hwio.device)
    wp = (w_hwio.detach().index_select(3, order).permute(0, 1, 3, 2)
          .to(dtype).contiguous())
    bp = b.detach().index_select(0, order).to(dtype).float().contiguous()
    return wp, bp


def unpack_upsampler_stage(wp: torch.Tensor, bp: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_upsampler_stage` (layout and column order;
    not the dtype): torch-order HWIO weights and bias."""
    inv = torch.argsort(_packed_order(wp.shape[3], wp.device))
    return (wp.permute(0, 1, 3, 2).index_select(3, inv),
            bp.index_select(0, inv))


class UpsamplerSchedule(NamedTuple):
    """The kernel's tile list.  A CTA tile is image ``b``, conv rows
    ``2 rp, 2 rp + 1`` and 64-pixel segment ``seg`` of those rows, numbered
    ``u = (b * rpairs + rp) * segs + seg``; cluster tile ``t`` (of
    ``tiles``) gives CTA ``rank`` of the cluster the CTA tile ``u =
    CLUSTER * (t // groups) + rank`` and both CTAs output-channel group
    ``g = t % groups`` (64 channels), so the two share every weight box.
    Where ``segs`` is even the pair is two neighbouring segments of one
    row pair (the tile list of the wide images); where it is odd, a pair
    may take the same segment of two row pairs or images, and no CTA
    takes a segment outside the image (at W = 48, one segment per row
    pair).  A CTA tile past the last one computes on zeros and stores
    nothing.  Cluster ``k`` of ``ctas // CLUSTER`` takes tiles ``k, k +
    ctas // CLUSTER, ...``."""
    tiles: int
    rpairs: int
    segs: int
    ctas: int


@functools.lru_cache(maxsize=None)
def upsampler_schedule(bsz: int, h: int, w: int, c: int,
                       clusters: int = 66) -> UpsamplerSchedule:
    """As many persistent clusters as run at once (on the H100, 66:
    one CTA per SM), or fewer when there are fewer tiles."""
    rpairs, segs = -(-h // 2), -(-w // TILE_W)
    tiles = -(-bsz * rpairs * segs // CLUSTER) * max(1, c // _GROUP)
    return UpsamplerSchedule(tiles, rpairs, segs,
                             CLUSTER * min(tiles, max(1, clusters)))


def upsampler_work(bsz: int, h: int, w: int, c: int,
                   clusters: int = 66) -> Tuple[int, int]:
    """(computed, useful) conv MACs of one launch: every CTA tile of the
    schedule computes 2 rows x 64 pixels x 256 packed columns x 9 C,
    whether or not its pixels lie in the image."""
    sched = upsampler_schedule(bsz, h, w, c, clusters)
    computed = sched.tiles * CLUSTER * 2 * TILE_W * 4 * _GROUP * 9 * c
    return computed, bsz * h * w * 4 * c * 9 * c


@functools.lru_cache(maxsize=None)
def _max_clusters(device: torch.device) -> int:
    """Clusters of the kernel the device runs at once."""
    fn = build.c_function("upsampler", "pesr_upsampler_max_clusters", [])
    with torch.cuda.device(device):
        n = fn()
    if n <= 0:
        raise RuntimeError(f"fused_upsampler_stage: no cluster of {CLUSTER} "
                           f"fits (CUDA error {-n})")
    return n


def upsampler_tiles(sched: UpsamplerSchedule, bsz: int, h: int, w: int,
                    c: int) -> Iterator[Tuple[int, int, int, int, int, int]]:
    """``(cta, b, g, y, x0, x1)``: each conv row segment a consumer
    warpgroup stores, as the kernel decodes its tiles (clipped to the
    image; rows and CTA tiles past it are computed on zeros and not
    stored)."""
    groups = max(1, c // _GROUP)
    for cta in range(sched.ctas):
        rank = cta % CLUSTER
        for t in range(cta // CLUSTER, sched.tiles, sched.ctas // CLUSTER):
            pair, g = divmod(t, groups)
            rest, seg = divmod(CLUSTER * pair + rank, sched.segs)
            b, rp = divmod(rest, sched.rpairs)
            x0 = seg * TILE_W
            for y in (2 * rp, 2 * rp + 1):
                if b < bsz and y < h:
                    yield cta, b, g, y, x0, min(x0 + TILE_W, w)


def fused_upsampler_stage(x: torch.Tensor, wp: torch.Tensor,
                          bp: torch.Tensor) -> torch.Tensor:
    """One x2 stage on the packed weights of :func:`pack_upsampler_stage`.

    Calls the custom op ``pesr::fused_upsampler_stage``: on a CUDA tensor
    the hand-written kernel (bf16 x; raises on anything it does not
    take), on a CPU tensor :func:`upsampler_stage_reference`; any other
    device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_upsampler_stage: unsupported device "
                         f"{x.device}")
    return torch.ops.pesr.fused_upsampler_stage(x, wp, bp)


fused_upsampler_stage.launches = 0


@torch.library.custom_op("pesr::fused_upsampler_stage", mutates_args=(),
                         device_types="cpu")
def _upsampler_op(x: torch.Tensor, wp: torch.Tensor,
                  bp: torch.Tensor) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return upsampler_stage_reference(x, *unpack_upsampler_stage(wp, bp))


@_upsampler_op.register_kernel("cuda")
def _upsampler_cuda(x, wp, bp):
    """The op's CUDA implementation: one launch of the kernel, counted in
    ``fused_upsampler_stage.launches``."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_upsampler_stage kernel takes C in "
                         f"{KERNEL_CHANNELS}, got C={c}")
    if min(bsz, h, w) < 1:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be contiguous bf16 NHWC")
    for name, t, shape, dt in (("w", wp, (3, 3, 4 * c, c), torch.bfloat16),
                               ("b", bp, (4 * c,), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous packed {dt} tensor"
                             f" of shape {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("x", x), ("w", wp), ("b", bp)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA, "
                             f"vector loads)")
    sched = upsampler_schedule(bsz, h, w, c, _max_clusters(x.device))
    out = torch.empty((bsz, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    fn = build.c_function("upsampler", "pesr_fused_upsampler_stage",
                          _ARGTYPES)
    rc = fn(x.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(), bsz,
            h, w, c, *sched, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_upsampler_stage kernel launch failed: CUDA "
                           f"error {rc} at x {tuple(x.shape)}")
    fused_upsampler_stage.launches += 1
    return out


@_upsampler_op.register_fake
def _upsampler_fake(x, wp, bp):
    """Shape and dtype of the output: [B, 2H, 2W, C] in x.dtype."""
    bsz, h, w, c = x.shape
    return x.new_empty((bsz, 2 * h, 2 * w, c))


def upsampler_stage_backward(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, g: torch.Tensor,
                             need: Sequence[bool]
                             ) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of :func:`upsampler_stage_reference` (OIHW weight ``(4C,
    C, 3, 3)``, in x.dtype) for the cotangent ``g`` of its [B, 2H, 2W, C]
    output: ``(dx, dw, db)``, None where ``need`` asks for none.  The
    stage is linear, so nothing is recomputed: the shuffle's adjoint
    gives the conv's cotangent, and one ``convolution_backward`` the
    gradients."""
    bsz, h2, w2, c = g.shape
    gy = (g.reshape(bsz, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
          .reshape(bsz, h2 // 2, w2 // 2, 4 * c))
    return conv3x3_nhwc_backward(gy, x, w, need)


class FusedUpsamplerStage(torch.autograd.Function):
    """:func:`fused_upsampler_stage` with a backward (counterpart of the
    JAX kernel's ``custom_vjp``, ``_upsampler_fwd`` / ``_upsampler_bwd``).

    Takes the torch OIHW conv weight ``(4C, C, 3, 3)`` and bias ``(4C,)``
    in x.dtype.  Forward: packs them (no grad) and runs the kernel; saves
    ``x`` and the unpacked weights.  Backward:
    :func:`upsampler_stage_backward` from the saved tensors in x.dtype."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return fused_upsampler_stage(x, *pack_upsampler_stage(
            w.permute(2, 3, 1, 0), b, w.dtype))

    @staticmethod
    def backward(ctx, g):
        return upsampler_stage_backward(*ctx.saved_tensors, g,
                                        ctx.needs_input_grad)


def fused_upsampler_stage_train(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`fused_upsampler_stage` on the OIHW weight and
    bias in x.dtype (:class:`FusedUpsamplerStage`)."""
    return FusedUpsamplerStage.apply(x, w, b)
