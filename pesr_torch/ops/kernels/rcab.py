"""Fused residual channel-attention block (RCAB) of RCAN (Zhang et al.,
ECCV 2018), one launch per block, and the excite of a residual group's
last block.

An RCAB maps its input ``x`` to ``x + s * r``, with ``r =
conv3x3(relu(conv3x3(x) + b1)) + b2`` and ``s = sigmoid(Wu relu(Wd
mean_hw(r) + bd) + bu)`` per image and channel (the squeeze MLP, two 1x1
convs through ``C / reduction`` channels).  The mean covers the whole
tile, so ``s`` exists only once the whole of ``r`` does; the kernel
(``pesr_torch/csrc/rcab.cu``, whose header note gives the design) leaves
each block's output pending: :func:`fused_rcab` takes the previous
block's carry ``h``, branch ``r`` and pooled sums ``pool``, makes its own
input ``x = bf16(h + s r)`` as it loads it, and returns ``(x, r_new,
pool_new)``, the pending state of the next block.  ``r`` None: no
pending block (the first block of a group; ``x`` is ``h``).
:func:`rcab_excite` applies the pending state, ``bf16(h + s r)``, where
no block follows (the end of a residual group).

``pool`` is ``[B, P, C]`` float32: partial sums of ``r`` over the tile,
whose sum over ``P`` is the tile's (the kernel writes one row per CTA,
``P`` = strips x segments of its schedule; the plain version one).  The
squeeze's weights are float32: ``wd [C/red, C]``, ``bd [C/red]``, ``wu
[C, C/red]``, ``bu [C]`` (:func:`pack_squeeze`); the convs' as
:func:`~pesr_torch.ops.kernels.resblock.pack_resblock` packs them.

Both are ``torch.library`` custom ops (``pesr::fused_rcab``,
``pesr::rcab_excite``): the kernel on a CUDA tensor (bf16 NHWC, C = 64),
the plain version on a CPU tensor.  ``fused_rcab.launches`` and
``rcab_excite.launches`` count launches.  The library builds at the
first launch, alone (``build.ON_DEMAND``).  :func:`rcab_schedule` is the
kernel's decomposition (``resblock.py``'s line mode in steps of four
rows), computed here so that the CPU tests can check it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from pesr_torch.ops.kernels import build
from pesr_torch.ops.kernels.common import conv3x3_nhwc
from pesr_torch.ops.kernels.resblock import (CLUSTER, STRIP_OUT,
                                             ResblockSchedule,
                                             unpack_resblock)

KERNEL_CHANNELS = (64,)
STEP_ROWS = 4     # output rows of a step (kStepRows, rcab.cu)
MAX_REDUCED = 64  # widest squeeze the kernel takes (kMaxReduced, rcab.cu)
_P = ctypes.c_void_p
_I = ctypes.c_int
_RCAB_ARGS = ([_P] * 3 + [_I] + [_P] * 4 + [_I] + [_P] * 7 + [_I] * 8 + [_P])
_EXCITE_ARGS = [_P] * 3 + [_I] + [_P] * 4 + [_I] + [_P] + [_I] * 4 + [_P]


def pack_squeeze(down_w: torch.Tensor, down_b: torch.Tensor,
                 up_w: torch.Tensor, up_b: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """The squeeze's 1x1 convs (torch OIHW ``[C/red, C, 1, 1]`` and ``[C,
    C/red, 1, 1]``) -> contiguous float32 ``(wd, bd, wu, bu)``."""
    def f(t, *shape):
        return t.detach().float().reshape(*shape).contiguous()

    cr, c = down_w.shape[:2]
    return f(down_w, cr, c), f(down_b, cr), f(up_w, c, cr), f(up_b, c)


def squeeze_excite(pool: torch.Tensor, hw: int, wd: torch.Tensor,
                   bd: torch.Tensor, wu: torch.Tensor, bu: torch.Tensor
                   ) -> torch.Tensor:
    """``s [B, C]`` float32 from the partial sums ``pool [B, P, C]`` over
    ``hw`` pixels: sigmoid(Wu relu(Wd mean + bd) + bu)."""
    mean = pool.float().sum(1) / float(hw)
    z = torch.relu(mean @ wd.t() + bd)
    return torch.sigmoid(z @ wu.t() + bu)


def excite_reference(h: torch.Tensor, r: torch.Tensor, pool: torch.Tensor,
                     wd, bd, wu, bu) -> torch.Tensor:
    """Plain version of :func:`rcab_excite`: ``h + s r`` in float32 (the
    product and the sum each rounded to float32), rounded to h.dtype."""
    s = squeeze_excite(pool, h.shape[1] * h.shape[2], wd, bd, wu, bu)
    return (h.float() + s[:, None, None, :] * r.float()).to(h.dtype)


def rcab_reference(h: torch.Tensor, r: Optional[torch.Tensor],
                   pool: Optional[torch.Tensor], wd, bd, wu, bu,
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`fused_rcab` (HWIO conv weights): ``x`` (``h``
    where ``r`` is None, else :func:`excite_reference`), then ``r_new =
    conv2(relu(conv1(x)))`` in x.dtype and its sums ``[B, 1, C]`` in
    float32."""
    x = h.clone() if r is None else excite_reference(h, r, pool, wd, bd, wu,
                                                     bu)
    t = torch.relu(conv3x3_nhwc(x, w1.permute(3, 2, 0, 1), b1))
    rn = conv3x3_nhwc(t, w2.permute(3, 2, 0, 1), b2)
    return x, rn, rn.float().sum((1, 2))[:, None, :]


@functools.lru_cache(maxsize=None)
def rcab_schedule(bsz: int, h: int, w: int,
                  clusters: int = 66) -> ResblockSchedule:
    """The kernel's decomposition, ``resblock_schedule``'s line mode with
    steps of :data:`STEP_ROWS` rows (two per consumer warpgroup): CTA i
    owns image ``i // (strips * segs)``, strip ``i % strips`` (62 output
    columns) and segment ``(i // strips) % segs`` of ``rows`` rows, a
    multiple of 4; it runs ``rows / 4 + 1`` conv1 and ``rows / 4`` conv2
    steps.  The rows per segment minimise (waves of ``2 clusters`` CTAs)
    x (conv1 steps), ties going to longer segments.  The pooled partials
    are one per CTA that owns pixels, ``strips * segs`` per image."""
    strips = -(-w // STRIP_OUT)
    slots = CLUSTER * max(1, clusters)
    best = None
    for rows in range(STEP_ROWS, -(-h // STEP_ROWS) * STEP_ROWS + 1,
                      STEP_ROWS):
        segs = -(-h // rows)
        ctas = -(-bsz * strips * segs // CLUSTER) * CLUSTER
        cost = -(-ctas // slots) * (rows // STEP_ROWS + 1)
        if best is None or cost <= best[0]:
            best = (cost, ResblockSchedule(rows, strips, segs, ctas))
    return best[1]


@functools.lru_cache(maxsize=None)
def _max_clusters(device: torch.device) -> int:
    fn = build.c_function("rcab", "pesr_rcab_max_clusters", [])
    with torch.cuda.device(device):
        n = fn()
    if n <= 0:
        raise RuntimeError(f"fused_rcab: no cluster of 2 fits (CUDA error "
                           f"{-n})")
    return n


def _check(name: str, h, r, pool, squeeze, convs=()) -> None:
    if h.dim() != 4 or min(h.shape) < 1:
        raise ValueError(f"{name}: h must be [B, H, W, C], got "
                         f"{tuple(h.shape)}")
    bsz, hh, ww, c = h.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"{name}: the kernel takes C in {KERNEL_CHANNELS}, "
                         f"got C={c}")
    cr = squeeze[0].shape[0]
    if not 1 <= cr <= MAX_REDUCED:
        raise ValueError(f"{name}: the squeeze's width must be 1..{MAX_REDUCED}"
                         f", got {cr}")
    want = [("h", h, tuple(h.shape), torch.bfloat16)]
    if r is not None:
        want += [("r", r, tuple(h.shape), torch.bfloat16),
                 ("pool", pool, (bsz, pool.shape[1], c), torch.float32)]
    want += [(n, t, s, torch.float32) for n, t, s in zip(
        ("wd", "bd", "wu", "bu"), squeeze, ((cr, c), (cr,), (c, cr), (c,)))]
    want += [(n, t, s, d) for (n, t), (s, d) in zip(
        convs, [((3, 3, c, c), torch.bfloat16), ((c,), torch.float32)] * 2)]
    for n, t, shape, dt in want:
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != h.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {n} must be a contiguous, 16-byte "
                             f"aligned {dt} tensor of shape {shape} on "
                             f"{h.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def fused_rcab(h: torch.Tensor, r: Optional[torch.Tensor],
               pool: Optional[torch.Tensor], wd: torch.Tensor,
               bd: torch.Tensor, wu: torch.Tensor, bu: torch.Tensor,
               w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One RCAB on the pending state ``(h, r, pool)`` of the block before
    (``r``, ``pool`` None for a group's first block) -> ``(x, r_new,
    pool_new)``.  ``(wd, bd, wu, bu)``: the previous block's squeeze
    (:func:`pack_squeeze`; unread without ``r``); ``(w1, b1, w2, b2)``:
    this block's convs as ``pack_resblock`` gives them.  Calls
    ``pesr::fused_rcab``: the kernel on a CUDA tensor, :func:`rcab_reference`
    on a CPU tensor; any other device raises."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_rcab: unsupported device {h.device}")
    return torch.ops.pesr.fused_rcab(h, r, pool, wd, bd, wu, bu, w1, b1, w2,
                                     b2)


fused_rcab.launches = 0


@torch.library.custom_op("pesr::fused_rcab", mutates_args=(),
                         device_types="cpu")
def _rcab_op(h: torch.Tensor, r: Optional[torch.Tensor],
             pool: Optional[torch.Tensor], wd: torch.Tensor, bd: torch.Tensor,
             wu: torch.Tensor, bu: torch.Tensor, w1: torch.Tensor,
             b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's CPU implementation: the plain version."""
    return rcab_reference(h, r, pool, wd, bd, wu, bu,
                          *unpack_resblock(w1, b1, w2, b2))


@_rcab_op.register_kernel("cuda")
def _rcab_cuda(h, r, pool, wd, bd, wu, bu, w1, b1, w2, b2):
    """One launch of the kernel, counted in ``fused_rcab.launches``."""
    sq = (wd, bd, wu, bu)
    _check("fused_rcab", h, r, pool, sq,
           zip(("w1", "b1", "w2", "b2"), (w1, b1, w2, b2)))
    bsz, hh, ww, c = h.shape
    sched = rcab_schedule(bsz, hh, ww, _max_clusters(h.device))
    x, rn = torch.empty_like(h), torch.empty_like(h)
    pool_new = torch.empty((bsz, sched.strips * sched.segs, c),
                           dtype=torch.float32, device=h.device)
    fn = build.c_function("rcab", "pesr_fused_rcab", _RCAB_ARGS)
    rc = fn(h.data_ptr(), None if r is None else r.data_ptr(),
            None if r is None else pool.data_ptr(),
            0 if r is None else pool.shape[1],
            *(t.data_ptr() for t in sq), wd.shape[0],
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            x.data_ptr(), rn.data_ptr(), pool_new.data_ptr(), bsz, hh, ww, c,
            sched.rows, sched.strips, sched.segs, sched.ctas,
            torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_rcab kernel launch failed: CUDA error {rc} "
                           f"at h {tuple(h.shape)}")
    fused_rcab.launches += 1
    return x, rn, pool_new


@_rcab_op.register_fake
def _rcab_fake(h, r, pool, wd, bd, wu, bu, w1, b1, w2, b2):
    """Shapes and dtypes of the outputs (the pooled partials as the
    kernel's schedule at 66 clusters gives them)."""
    bsz, hh, ww, c = h.shape
    sched = rcab_schedule(bsz, hh, ww)
    return (torch.empty_like(h), torch.empty_like(h),
            h.new_empty((bsz, sched.strips * sched.segs, c),
                        dtype=torch.float32))


def rcab_excite(h: torch.Tensor, r: torch.Tensor, pool: torch.Tensor,
                wd: torch.Tensor, bd: torch.Tensor, wu: torch.Tensor,
                bu: torch.Tensor) -> torch.Tensor:
    """``bf16(h + s r)``, ``s`` the squeeze of ``pool``: the output of the
    block whose pending state ``(h, r, pool)`` is.  Calls
    ``pesr::rcab_excite``: one kernel launch on a CUDA tensor,
    :func:`excite_reference` on a CPU tensor."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rcab_excite: unsupported device {h.device}")
    return torch.ops.pesr.rcab_excite(h, r, pool, wd, bd, wu, bu)


rcab_excite.launches = 0


@torch.library.custom_op("pesr::rcab_excite", mutates_args=(),
                         device_types="cpu")
def _excite_op(h: torch.Tensor, r: torch.Tensor, pool: torch.Tensor,
               wd: torch.Tensor, bd: torch.Tensor, wu: torch.Tensor,
               bu: torch.Tensor) -> torch.Tensor:
    return excite_reference(h, r, pool, wd, bd, wu, bu)


@_excite_op.register_kernel("cuda")
def _excite_cuda(h, r, pool, wd, bd, wu, bu):
    """One launch of ``rcab_excite_kernel``, counted in
    ``rcab_excite.launches``."""
    sq = (wd, bd, wu, bu)
    _check("rcab_excite", h, r, pool, sq)
    bsz, hh, ww, c = h.shape
    out = torch.empty_like(h)
    fn = build.c_function("rcab", "pesr_rcab_excite", _EXCITE_ARGS)
    rc = fn(h.data_ptr(), r.data_ptr(), pool.data_ptr(), pool.shape[1],
            *(t.data_ptr() for t in sq), wd.shape[0], out.data_ptr(), bsz, hh,
            ww, c, torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rcab_excite kernel launch failed: CUDA error "
                           f"{rc} at h {tuple(h.shape)}")
    rcab_excite.launches += 1
    return out


@_excite_op.register_fake
def _excite_fake(h, r, pool, wd, bd, wu, bu):
    return torch.empty_like(h)
