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

:func:`fused_upsampler_stage` launches the kernel for a CUDA tensor and
runs :func:`upsampler_stage_reference`, the plain PyTorch version, for a
CPU tensor.  ``fused_upsampler_stage.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Tuple

import torch

from pesr_torch.ops.kernels import build
from pesr_torch.ops.kernels.common import conv3x3_nhwc
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
    the packed pair :func:`fused_upsampler_stage` takes: weights
    ``(3, 3, 4C, C)`` in ``dtype`` with the packed column order, bias in
    the same order, rounded to ``dtype`` and held as float32."""
    c = w_hwio.shape[2]
    if tuple(w_hwio.shape) != (3, 3, c, 4 * c):
        raise ValueError(f"upsampler weights must be (3, 3, C, 4C), got "
                         f"{tuple(w_hwio.shape)}")
    order = _packed_order(c).to(w_hwio.device)
    wp = (w_hwio.detach().index_select(3, order).permute(0, 1, 3, 2)
          .to(dtype).contiguous())
    bp = b.detach().index_select(0, order).to(dtype).float().contiguous()
    return wp, bp


def unpack_upsampler_stage(wp: torch.Tensor, bp: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_upsampler_stage` (layout and column order;
    not the dtype): torch-order HWIO weights and bias."""
    inv = torch.argsort(_packed_order(wp.shape[3])).to(wp.device)
    return (wp.permute(0, 1, 3, 2).index_select(3, inv),
            bp.index_select(0, inv))


class UpsamplerSchedule(NamedTuple):
    """The kernel's tile list.  Tile ``t`` (of ``tiles``) is image
    ``b``, conv rows ``2 rp, 2 rp + 1``, the :data:`CLUSTER` 64-pixel
    segments ``CLUSTER * xg + rank`` (one per CTA of a cluster) and
    output-channel group ``g`` (64 channels), with ``t = ((b * rpairs +
    rp) * xgroups + xg) * groups + g``.  Cluster ``k`` of ``ctas //
    CLUSTER`` takes tiles ``k, k + ctas // CLUSTER, ...``."""
    tiles: int
    rpairs: int
    xgroups: int
    ctas: int


@functools.lru_cache(maxsize=None)
def upsampler_schedule(bsz: int, h: int, w: int, c: int,
                       clusters: int = 66) -> UpsamplerSchedule:
    """As many persistent clusters as run at once (on the H100, 66:
    one CTA per SM), or fewer when there are fewer tiles."""
    rpairs = -(-h // 2)
    xgroups = -(-(-(-w // TILE_W)) // CLUSTER)
    tiles = bsz * rpairs * xgroups * max(1, c // _GROUP)
    return UpsamplerSchedule(tiles, rpairs, xgroups,
                             CLUSTER * min(tiles, max(1, clusters)))


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
    warpgroup computes, as the kernel decodes its tiles (clipped to the
    image; rows and segments past it are computed on zeros and not
    stored)."""
    groups = max(1, c // _GROUP)
    for cta in range(sched.ctas):
        rank = cta % CLUSTER
        for t in range(cta // CLUSTER, sched.tiles, sched.ctas // CLUSTER):
            rest, g = divmod(t, groups)
            rest, xg = divmod(rest, sched.xgroups)
            b, rp = divmod(rest, sched.rpairs)
            x0 = (CLUSTER * xg + rank) * TILE_W
            for y in (2 * rp, 2 * rp + 1):
                if b < bsz and y < h and x0 < w:
                    yield cta, b, g, y, x0, min(x0 + TILE_W, w)


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


fused_upsampler_stage.launches = 0
