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
whose sum over ``P`` is the tile's (the kernel writes one row per segment
of its schedule and zeros in the rows of an image that no segment fills,
``P`` = the schedule's ``pool_rows``; the plain version one row).  The
squeeze's weights are float32: ``wd [C/red, C]``, ``bd [C/red]``, ``wu
[C, C/red]``, ``bu [C]`` (:func:`pack_squeeze`); the convs' as
:func:`~pesr_torch.ops.kernels.resblock.pack_resblock` packs them.

Both are ``torch.library`` custom ops (``pesr::fused_rcab``,
``pesr::rcab_excite``): the kernel on a CUDA tensor (bf16 NHWC, C = 64),
the plain version on a CPU tensor.  ``fused_rcab.launches`` and
``rcab_excite.launches`` count launches, ``fused_rcab.waves`` the block's
waves of CTAs.  The library builds at the first launch, alone
(``build.ON_DEMAND``).  :func:`rcab_schedule` is the kernel's schedule
(one wave of CTAs, each running a contiguous run of 4-row steps that may
cross strips and images), computed here so that the CPU tests can check
it; :func:`rcab_work` counts its steps.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import torch

from pesr_torch.ops.kernels import build
from pesr_torch.ops.kernels.common import conv3x3_nhwc
from pesr_torch.ops.kernels.resblock import (CLUSTER, STRIP_OUT,
                                             unpack_resblock)

KERNEL_CHANNELS = (64,)
STEP_ROWS = 4     # output rows of a step (kStepRows, rcab.cu)
MAX_REDUCED = 64  # widest squeeze the kernel takes (kMaxReduced, rcab.cu)
_P = ctypes.c_void_p
_I = ctypes.c_int
_RCAB_ARGS = ([_P] * 3 + [_I] + [_P] * 4 + [_I] + [_P] * 7 + [_I] * 7
              + [_P] * 2)
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


class RcabSchedule(NamedTuple):
    """The kernel's schedule: one wave of ``ctas`` CTAs (the clusters of
    :data:`CLUSTER` the device runs at once), CTA i running the segments
    ``segments[i]`` in order.  The work is the batch's image-strips
    (image-strip g: image ``g // strips``, output columns ``[62 (g %
    strips), +62)``), each ``steps`` steps of :data:`STEP_ROWS` output
    rows.  A segment ``(g, j0, n, row, fill)`` runs steps ``[j0, j0 +
    n)`` of image-strip g: one conv1-only step that fills the hidden
    ring, then n steps of conv1 and conv2 (rows past the image and g past
    the batch are computed on zeros and not stored).  It writes its
    pooled partial sums to row ``row`` of its image's ``pool_rows`` and
    zeros to the ``fill`` rows after it (its image's last segment), so
    every row is written once.  ``critical``: the most conv1 + conv2
    steps of a CTA."""
    ctas: int
    strips: int
    steps: int
    pool_rows: int
    critical: int
    segments: Tuple[Tuple[Tuple[int, int, int, int, int], ...], ...]


def _cost(segs) -> int:
    return sum(2 * n + 1 for _, n in segs)


def _runs(total: int, steps: int, half: int, clusters: int) -> list:
    """Rank 0 of each cluster takes offsets of ``[0, half)`` of the
    batch's steps in order, rank 1 the same offsets from ``half`` on
    (past ``total``: nothing to store).  Cluster c takes one contiguous
    range, cut into segments wherever either rank starts an image-strip,
    so that both ranks run the same sequence of steps (one multicast
    weight stream).  The ranges are the longest within the least largest
    cost at which ``clusters`` of them cover ``[0, half)``: greedy, which
    is optimal for contiguous ranges.  -> each CTA's ``(position,
    steps)`` segments."""
    cut = [u % steps == 0 or ((u + half) % steps == 0 and u + half < total)
           for u in range(half)]

    def deal(limit):
        runs, start, cost = [], 0, 0
        for u in range(half):
            add = 3 if u == start or cut[u] else 2
            if cost + add > limit:
                runs.append((start, u))
                start, cost = u, 3
            else:
                cost += add
        return runs + [(start, half)]

    lo, hi = 3, 3 * half
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if len(deal(mid)) <= clusters else (mid + 1, hi)
    per = []
    for a, e in deal(lo):
        edges = [a] + [u for u in range(a + 1, e) if cut[u]] + [e]
        per += [[(u + rank * half, v - u) for u, v in zip(edges, edges[1:])]
                for rank in range(CLUSTER)]
    return per


def _equal(bsz: int, strips: int, steps: int, clusters: int) -> list:
    """Segments of one length n that cover each image-strip, dealt to
    the CTAs in turn, n minimising (turns) x (2 n + 1): at a few shapes
    and cluster counts its busiest CTA runs fewer steps than under runs
    (past the last image-strip: nothing to store)."""
    def turns(n):
        items = -(-bsz * strips * -(-steps // n) // CLUSTER) * CLUSTER
        return -(-items // (CLUSTER * clusters)), items

    n = min(range(1, steps + 1), key=lambda n: turns(n)[0] * (2 * n + 1))
    segs, items = -(-steps // n), turns(n)[1]
    per = [[] for _ in range(CLUSTER * clusters)]
    for i in range(items):
        g, k = divmod(i, segs)
        per[i % len(per)].append((g * steps + k * n, n))
    return per


@functools.lru_cache(maxsize=None)
def rcab_schedule(bsz: int, h: int, w: int,
                  clusters: int = 66) -> RcabSchedule:
    """The schedule of ``fused_rcab`` on ``[bsz, h, w]`` with ``clusters``
    clusters running at once (the H100: 66, one CTA per SM): of the
    cluster runs (:func:`_runs`, rank 1 from the batch's middle or from
    its middle image-strip) and equal segments (:func:`_equal`), the one
    whose busiest CTA runs the fewest steps."""
    clusters = max(1, clusters)
    strips, steps = -(-w // STRIP_OUT), -(-h // STEP_ROWS)
    total = bsz * strips * steps
    halves = dict.fromkeys((-(-bsz * strips // CLUSTER) * steps,
                            -(-total // CLUSTER)))
    per = min([_runs(total, steps, half, clusters) for half in halves]
              + [_equal(bsz, strips, steps, clusters)],
              key=lambda per: max(map(_cost, per)))
    per += [[] for _ in range(CLUSTER * clusters - len(per))]
    images = {}
    for i, segs in enumerate(per):
        for k, (q, _) in enumerate(segs):
            if q < total:
                images.setdefault(q // (strips * steps), []).append((q, i, k))
    rows = max(map(len, images.values()))
    place = {}
    for items in images.values():
        for row, (_, i, k) in enumerate(sorted(items)):
            place[i, k] = (row, rows - 1 - row if row == len(items) - 1 else 0)
    return RcabSchedule(
        len(per), strips, steps, rows, max(map(_cost, per)),
        tuple(tuple((q // steps, q % steps, n, *place.get((i, k), (0, 0)))
                    for k, (q, n) in enumerate(segs))
              for i, segs in enumerate(per)))


def rcab_work(bsz: int, h: int, w: int, clusters: int = 66
              ) -> Tuple[int, int, int, int, int]:
    """``(ctas, waves, critical_steps, computed_steps, useful_steps)`` of
    one launch, in 4-row conv steps of one CTA (a conv1 or a conv2 over
    4 x 64 pixels): the CTAs and waves of :func:`rcab_schedule` on
    ``clusters`` clusters, the steps of its busiest CTA, the steps all
    CTAs run (hidden-ring fills and rows past the image included), and
    the steps the batch needs (one conv1 and one conv2 per image-strip
    and step)."""
    s = rcab_schedule(bsz, h, w, clusters)
    computed = sum(2 * seg[2] + 1 for segs in s.segments for seg in segs)
    return (s.ctas, -(-s.ctas // (CLUSTER * max(1, clusters))), s.critical,
            computed, 2 * bsz * s.strips * s.steps)


@functools.lru_cache(maxsize=None)
def _segment_table(bsz: int, h: int, w: int, clusters: int,
                   device: torch.device) -> torch.Tensor:
    """The schedule as the kernel reads it, int32 on ``device``: CTA i's
    segments are entries ``[t[i], t[i + 1])`` of the 5-int entries after
    the ``ctas + 1`` offsets."""
    s = rcab_schedule(bsz, h, w, clusters)
    offsets = [0, *itertools.accumulate(map(len, s.segments))]
    flat = [v for segs in s.segments for seg in segs for v in seg]
    return torch.tensor(offsets + flat, dtype=torch.int32).to(device)


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
fused_rcab.waves = 0


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
    """One launch of the kernel, counted in ``fused_rcab.launches`` (and
    its waves of CTAs in ``fused_rcab.waves``)."""
    sq = (wd, bd, wu, bu)
    _check("fused_rcab", h, r, pool, sq,
           zip(("w1", "b1", "w2", "b2"), (w1, b1, w2, b2)))
    bsz, hh, ww, c = h.shape
    clusters = _max_clusters(h.device)
    sched = rcab_schedule(bsz, hh, ww, clusters)
    table = _segment_table(bsz, hh, ww, clusters, h.device)
    x, rn = torch.empty_like(h), torch.empty_like(h)
    pool_new = torch.empty((bsz, sched.pool_rows, c), dtype=torch.float32,
                           device=h.device)
    fn = build.c_function("rcab", "pesr_fused_rcab", _RCAB_ARGS)
    rc = fn(h.data_ptr(), None if r is None else r.data_ptr(),
            None if r is None else pool.data_ptr(),
            0 if r is None else pool.shape[1],
            *(t.data_ptr() for t in sq), wd.shape[0],
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            x.data_ptr(), rn.data_ptr(), pool_new.data_ptr(), bsz, hh, ww, c,
            sched.strips, sched.pool_rows, sched.ctas, table.data_ptr(),
            torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_rcab kernel launch failed: CUDA error {rc} "
                           f"at h {tuple(h.shape)}")
    fused_rcab.launches += 1
    fused_rcab.waves += -(-sched.ctas // (CLUSTER * clusters))
    return x, rn, pool_new


@_rcab_op.register_fake
def _rcab_fake(h, r, pool, wd, bd, wu, bu, w1, b1, w2, b2):
    """Shapes and dtypes of the outputs (the pooled partials as the
    kernel's schedule at 66 clusters gives them)."""
    bsz, hh, ww, c = h.shape
    return (torch.empty_like(h), torch.empty_like(h),
            h.new_empty((bsz, rcab_schedule(bsz, hh, ww).pool_rows, c),
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
