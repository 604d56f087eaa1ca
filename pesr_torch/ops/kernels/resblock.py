"""Fused residual block: ``x + res_scale * (conv3x3(relu(conv3x3(x) + b1)) + b2)``.

Replaces the TPU kernel ``pesr_tpu/ops/pallas/resblock.py``
(``_resblock_kernel`` via ``fused_resblock``).  The CUDA kernel is
``pesr_torch/csrc/resblock.cu``; its header note gives the design (a line
buffer walking down strip segments, wgmma, a TMA weight ring multicast
across a cluster of CTAs) and what bounds it on the H100.

Layouts follow the JAX package at the plain version: ``x`` is NHWC,
``w1``/``w2`` are HWIO ``(3, 3, C, C)``, ``b1``/``b2`` are ``(C,)``.  The
kernel takes the weights packed K-major, ``(3, 3, C_out, C_in)`` bf16
(the layout its TMA boxes want), and the biases as float32;
:func:`pack_resblock` makes them once, from torch OIHW weights, when the
weights are loaded, and :func:`unpack_resblock` turns them back to HWIO.

:func:`fused_resblock` calls the custom op ``pesr::fused_resblock``
(``torch.library``), which launches the kernel for a CUDA tensor and
runs :func:`resblock_reference`, the plain PyTorch version, for a CPU
tensor; its fake implementation gives ``torch.export`` the output's
shape, so an exported program calls the op instead of tracing into the
ctypes launch.  ``fused_resblock.launches`` counts kernel launches.
:func:`resblock_schedule` is the kernel's work decomposition, computed
here so that the CPU tests can check it.  :func:`fused_resblock_train`
is the differentiable form training uses: the kernel forward on weights
packed per call, and :func:`resblock_backward`, which recomputes only
the hidden activation.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from pesr_torch.ops.kernels import build
from pesr_torch.ops.kernels.common import conv3x3_nhwc, conv3x3_nhwc_backward

KERNEL_CHANNELS = (64, 128, 256)
CLUSTER = 2     # CTAs sharing each weight fetch (kCluster, conv3x3_tile.cuh)
STRIP_OUT = 62  # output columns of a strip: a 64-pixel hidden row - halo
FLAT_W = (2, 48)  # widths flat mode takes (kFlatMaxW, resblock.cu)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])


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
    :func:`fused_resblock`: weights ``(3, 3, C_out, C_in)`` in ``dtype``
    (per tap, one row of input channels per output channel), biases
    rounded to ``dtype`` and held as float32 (the kernel adds them in f32,
    as the TPU kernel adds its bf16 biases)."""
    def w(t):
        return t.detach().permute(2, 3, 0, 1).to(dtype).contiguous()

    def b(t):
        return t.detach().to(dtype).float().contiguous()

    return w(conv1_w), b(conv1_b), w(conv2_w), b(conv2_b)


def unpack_resblock(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Packed ``(w1, b1, w2, b2)`` -> HWIO weights and the biases, as
    :func:`resblock_reference` takes them."""
    return (w1.permute(0, 1, 3, 2).contiguous(), b1,
            w2.permute(0, 1, 3, 2).contiguous(), b2)


class ResblockSchedule(NamedTuple):
    """The kernel's decomposition, in one of two modes.

    Line mode (``span == 0``): CTA i (of ``ctas``, a multiple of
    :data:`CLUSTER`) owns image ``i // (strips * segs)``, strip
    ``i % strips`` (output columns ``[62 s, 62 s + 62)``) and segment
    ``(i // strips) % segs`` (output rows ``[rows g, rows g + rows)``);
    it runs ``rows / 2 + 1`` conv1 and ``rows / 2`` conv2 steps of 128
    pixels.  A CTA past the last item computes on zeros and stores
    nothing.

    Flat mode (``span > 0``, narrow images): the batch's pixels are one
    flat sequence ``(b * H + y) * W + x``, and CTA i owns outputs
    ``[span i, span i + span)`` (``rows = strips = segs = 0``); it runs
    ``span / 128 + 1`` conv1 and ``span / 128`` conv2 steps, rounded up,
    the last step of each by one warpgroup of 64 pixels where ``span`` is
    an odd multiple of 64."""
    rows: int
    strips: int
    segs: int
    ctas: int
    span: int = 0


def _ctas(bsz: int, strips: int, segs: int) -> int:
    return -(-bsz * strips * segs // CLUSTER) * CLUSTER


def _line(bsz: int, h: int, w: int, clusters: int):
    """Line mode's schedule and its cost in half steps (64-pixel MMA
    passes per CTA, times the waves of CTAs).  The rows per segment
    minimise (waves) x (conv1 steps per CTA)."""
    strips = -(-w // STRIP_OUT)
    slots = CLUSTER * max(1, clusters)
    best_cost, best_rows = None, 2
    for rows in range(2, h + (h % 2) + 1, 2):
        cost = (-(-_ctas(bsz, strips, -(-h // rows)) // slots)
                * (rows // 2 + 1))
        if best_cost is None or cost <= best_cost:
            best_cost, best_rows = cost, rows
    segs = -(-h // best_rows)
    ctas = _ctas(bsz, strips, segs)
    return (ResblockSchedule(best_rows, strips, segs, ctas),
            -(-ctas // slots) * 2 * (best_rows + 1))


def _flat(bsz: int, h: int, w: int, clusters: int):
    """Flat mode's best schedule and its cost in half steps: spans of
    64 k pixels cost 2 k + 2 half steps each (conv2's k, conv1's k + 2).
    Ties go to longer spans (fewer CTAs, less L2 weight traffic)."""
    total, slots = bsz * h * w, CLUSTER * max(1, clusters)
    best = None
    for k in range(1, -(-total // 64) + 1):
        ctas = -(-total // (64 * k) // CLUSTER) * CLUSTER
        cost = -(-ctas // slots) * (2 * k + 2)
        if best is None or cost <= best[1]:
            best = (ResblockSchedule(0, 0, 0, ctas, 64 * k), cost)
    return best


@functools.lru_cache(maxsize=None)
def resblock_schedule(bsz: int, h: int, w: int,
                      clusters: int = 66) -> ResblockSchedule:
    """The cheaper of the two modes in (waves of CTAs) x (steps per CTA),
    ``clusters`` clusters of :data:`CLUSTER` CTAs running at once (on
    the H100, 66: one CTA per SM); ties keep line mode.  Line mode takes
    the rows per segment of least cost, ties going to longer segments
    (less vertical halo): the main path's [2, 336, 510] gets 9 strips x 7
    segments of 48 rows x 2 images = 126 CTAs, one wave.  Flat mode
    takes only widths in :data:`FLAT_W`: the training patches'
    [16, 48, 48] get 116 CTAs of 320 pixels (6 steps each, line mode 7)."""
    line, line_cost = _line(bsz, h, w, clusters)
    if FLAT_W[0] <= w <= FLAT_W[1]:
        flat, flat_cost = _flat(bsz, h, w, clusters)
        if flat_cost < line_cost:
            return flat
    return line


def _steps(sched: ResblockSchedule) -> Tuple[int, int]:
    """(conv1, conv2) half steps (64-pixel MMA passes) of one CTA."""
    if sched.span:
        return sched.span // 64 + 2, sched.span // 64
    return sched.rows + 2, sched.rows


def resblock_work(bsz: int, h: int, w: int, c: int = 256,
                  clusters: int = 66) -> Tuple[int, int]:
    """(computed, useful) conv MACs of one launch: every CTA of the
    schedule, past the last item too, runs its conv steps on 64-pixel
    warpgroup tiles of 9 C x C MACs per pixel, whether or not the pixels
    lie in the image."""
    sched = resblock_schedule(bsz, h, w, clusters)
    computed = sched.ctas * sum(_steps(sched)) * 64 * 9 * c * c
    return computed, 2 * bsz * h * w * 9 * c * c


@functools.lru_cache(maxsize=None)
def _max_clusters(c: int, device: torch.device) -> int:
    """Clusters of the C-channel kernel the device runs at once."""
    fn = build.c_function("resblock", "pesr_resblock_max_clusters",
                          [ctypes.c_int])
    with torch.cuda.device(device):
        n = fn(c)
    if n <= 0:
        raise RuntimeError(f"fused_resblock: no cluster of {CLUSTER} fits "
                           f"(CUDA error {-n})")
    return n


def resblock_tiles(sched: ResblockSchedule, bsz: int, h: int, w: int
                   ) -> Iterator[Tuple[int, int, int, int, int, int]]:
    """``(cta, b, y0, y1, x0, x1)``: the output rectangles each CTA
    writes, as the kernel decodes its block index (clipped to the image;
    in flat mode, one per row its span touches)."""
    if sched.span:
        total = bsz * h * w
        for i in range(sched.ctas):
            o, end = i * sched.span, min((i + 1) * sched.span, total)
            while o < end:
                r, x0 = divmod(o, w)
                x1 = min(w, x0 + end - o)
                yield i, r // h, r % h, r % h + 1, x0, x1
                o += x1 - x0
        return
    per_img = sched.strips * sched.segs
    for i in range(sched.ctas):
        b, r = divmod(i, per_img)
        y0 = (r // sched.strips) * sched.rows
        x0 = (r % sched.strips) * STRIP_OUT
        if b < bsz and y0 < h and x0 < w:
            yield i, b, y0, min(y0 + sched.rows, h), x0, min(x0 + STRIP_OUT, w)


def _check(x, w1, b1, w2, b2) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_resblock kernel takes C in {KERNEL_CHANNELS},"
                         f" got C={c}")
    if min(bsz, h, w) < 1:
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
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA, "
                             f"vector loads)")


def fused_resblock(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   res_scale: float = 0.1) -> torch.Tensor:
    """NHWC ``x`` -> ``x + res_scale * conv2(relu(conv1(x)))``.

    Weights as :func:`pack_resblock` gives them.  Calls the custom op
    ``pesr::fused_resblock``: on a CUDA tensor the hand-written kernel
    (bf16 x; raises on anything it does not take), on a CPU tensor
    :func:`resblock_reference`; any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    return torch.ops.pesr.fused_resblock(x, w1, b1, w2, b2,
                                         float(res_scale))


fused_resblock.launches = 0


@torch.library.custom_op("pesr::fused_resblock", mutates_args=(),
                         device_types="cpu")
def _resblock_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor,
                 res_scale: float) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return resblock_reference(x, *unpack_resblock(w1, b1, w2, b2), res_scale)


@_resblock_op.register_kernel("cuda")
def _resblock_cuda(x, w1, b1, w2, b2, res_scale):
    """The op's CUDA implementation: one launch of the kernel, counted in
    ``fused_resblock.launches``."""
    _check(x, w1, b1, w2, b2)
    bsz, h, w, c = x.shape
    sched = resblock_schedule(bsz, h, w, _max_clusters(c, x.device))
    out = torch.empty_like(x)
    fn = build.c_function("resblock", "pesr_fused_resblock", _ARGTYPES)
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), bsz, h, w, c, float(res_scale),
            *sched, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_resblock kernel launch failed: CUDA error "
                           f"{rc} at x {tuple(x.shape)}")
    fused_resblock.launches += 1
    return out


@_resblock_op.register_fake
def _resblock_fake(x, w1, b1, w2, b2, res_scale):
    """Shape and dtype of the output, for ``torch.export`` and other
    tracers: the input's."""
    return torch.empty_like(x)


def resblock_backward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor, res_scale: float,
                      g: torch.Tensor, need: Sequence[bool]
                      ) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of :func:`resblock_reference` (OIHW weights, in x.dtype)
    for the cotangent ``g``: ``(dx, dw1, db1, dw2, db2)``, None where
    ``need`` asks for none.  Only what a gradient reads is recomputed:
    conv1 -> bias -> ReLU gives the hidden activation (conv2's input and
    the ReLU mask); conv2's forward is read by nothing, as XLA drops it
    from JAX's ``jax.vjp`` of the same reference inside a jitted step.
    One convolution and two ``convolution_backward`` calls, the ones
    autograd of the reference makes."""
    first = any(need[:3])
    h = torch.relu(conv3x3_nhwc(x, w1, b1))
    gh, gw2, gb2 = conv3x3_nhwc_backward(g * res_scale, h, w2,
                                         (first, need[3], need[4]))
    if not first:
        return None, None, None, gw2, gb2
    gx, gw1, gb1 = conv3x3_nhwc_backward(
        torch.ops.aten.threshold_backward(gh, h, 0), x, w1, need[:3])
    return (g + gx if need[0] else None), gw1, gb1, gw2, gb2


class FusedResblock(torch.autograd.Function):
    """:func:`fused_resblock` with a backward (counterpart of the JAX
    kernel's ``custom_vjp``, ``_resblock_fwd`` / ``_resblock_bwd``).

    Takes unpacked torch OIHW weights and biases in x.dtype.  Forward:
    packs them (no grad) and runs :func:`fused_resblock`; saves only
    ``x`` and the unpacked weights.  Backward: :func:`resblock_backward`
    from the saved tensors in x.dtype -- the hidden activation is never
    stored, so the body keeps one activation per block between forward
    and backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, res_scale):
        ctx.res_scale = res_scale
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return fused_resblock(x, *pack_resblock(w1, b1, w2, b2, w1.dtype),
                              res_scale=res_scale)

    @staticmethod
    def backward(ctx, g):
        return (*resblock_backward(*ctx.saved_tensors, ctx.res_scale, g,
                                   ctx.needs_input_grad[:5]), None)


def fused_resblock_train(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         res_scale: float = 0.1) -> torch.Tensor:
    """Differentiable :func:`fused_resblock` on OIHW weights and biases in
    x.dtype (:class:`FusedResblock`).  The same launch counter counts its
    forwards; a backward launches no kernel of this module."""
    return FusedResblock.apply(x, w1, b1, w2, b2, float(res_scale))
