"""Folded upsampler: the generator's linear upsampler -> out chain as ONE
conv at LR resolution and one pixel shuffle (counterpart of
``pesr_tpu/models/fold.py``).

The chain ``conv -> PixelShuffle(f) [-> conv -> PixelShuffle(f) ...] ->
out conv`` has no activation, so the map from the C-channel trunk output
to RGB is one linear operator: a ``[3 s^2, C, S, S]`` conv (torch OIHW)
followed by ``pixel_shuffle(s)``, channel ``col s^2 + i s + j`` landing at
offset ``(i, j)`` of output channel ``col``.  At x4 32 x 256 that is
~0.2 TFLOP per two 336 x 510 images instead of ~8.2 for the chain.

Exactness: the composite equals the chain on the interior; within
``fold_min_halo(scale)`` LR pixels of a zero-padded border it differs,
because the chain zero-pads each intermediate and the folded conv only
its input.  The folded applies carry that band as ``min_halo`` and the
engines (``ops/tiling.py``) replicate-pad and crop it on every border.

Two derivations of the same composite:

* :func:`fold_upsampler` probes the chain with impulses (inference: the
  weights are folded once, and the fold cannot get a convention wrong);
* :func:`analytic_fold_upsampler` composes the kernels, differentiably
  (training: ``--fold_train`` derives the fold from the live upsampler
  and out weights on every step, so the optimizer updates them).

Both run in full float32 (float64 for float64 weights) with TF32 off.
Weights are torch OIHW; the composite is built in HWIO internally, where
the JAX package's index algebra reads directly.  The folded applies
themselves (JAX's ``make_folded_apply`` / ``make_fold_train_apply``) are
``KernelApply(..., fold=True)`` / ``KernelTrainApply(..., fold=True)``
in ``models/kernel_apply.py``, on the trunk of the kernel path.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pesr_torch.ops.kernels.common import conv3x3_nhwc
from pesr_torch.ops.pixel_shuffle import pixel_shuffle
from pesr_torch.scales import upsample_stages
from pesr_torch.utils.device import full_f32

Conv = Tuple[torch.Tensor, torch.Tensor]
Fold = Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]


def tail_params(sd: Dict[str, torch.Tensor], scale: int
                ) -> Tuple[List[Conv], Conv]:
    """``(up, out)`` of a generator state_dict: ``(weight, bias)`` of each
    upsampler stage's conv (``tail.0.{2 s}``) and of the out conv
    (``tail.1``), as :class:`~pesr_torch.models.generator.Generator`
    names them."""
    up = [(sd[f"tail.0.{2 * s}.weight"], sd[f"tail.0.{2 * s}.bias"])
          for s in range(len(upsample_stages(scale)))]
    return up, (sd["tail.1.weight"], sd["tail.1.bias"])


def _chain_apply(up: Sequence[Conv], out: Conv, stages: Sequence[int],
                 x: torch.Tensor) -> torch.Tensor:
    """The chain as written, NHWC in x.dtype: per stage [SAME conv,
    pixel_shuffle(f)], then the SAME out conv."""
    y = x
    with full_f32(x.device):
        for (w, b), f in zip(up, stages):
            y = pixel_shuffle(conv3x3_nhwc(y, w, b), f)
        return conv3x3_nhwc(y, *out)


def _fold_dtype(w: torch.Tensor) -> torch.dtype:
    return torch.promote_types(w.dtype, torch.float32)


def _fold_bias(up: Sequence[Conv], out: Conv, scale: int,
               radius: int) -> torch.Tensor:
    """The composite's bias ``[3 s^2]``: the chain is affine, so the bias
    is the chain of a zero input, constant per output phase on the
    interior.  Evaluated on a zero input just big enough that its centre
    LR pixel is ``radius`` + 1 pixels from the border, read at that
    pixel's s^2 phases (differentiable)."""
    w_out = out[0]
    c = up[0][0].shape[1] if up else w_out.shape[1]
    p_in = 2 * (radius + 1) + 1
    zero = torch.zeros((1, p_in, p_in, c), dtype=_fold_dtype(w_out),
                       device=w_out.device)
    field = _chain_apply(up, out, upsample_stages(scale), zero)[0]
    cy = (p_in // 2) * scale
    patch = field[cy:cy + scale, cy:cy + scale, :]        # [i, j, col]
    return patch.permute(2, 0, 1).reshape(-1)


def fold_upsampler(sd: Dict[str, torch.Tensor], scale: int) -> Fold:
    """Fold the upsampler and out conv of generator state_dict ``sd`` into
    one conv by impulse probing.

    Returns ``(kernel [3 s^2, C, S, S], bias [3 s^2], (pad_lo, pad_hi))``
    on the weights' device, in float32 (float64 for float64 weights),
    such that ``pixel_shuffle(conv(x, kernel, padding (pad_lo, pad_hi)) +
    bias, s)`` reproduces the chain on the interior (:func:`folded_conv`
    applies it).  The support is trimmed to its nonzero bounding box,
    kept square: pads may differ between the sides."""
    up, out = tail_params(sd, scale)
    stages = upsample_stages(scale)
    w_out = out[0]
    dt, dev = _fold_dtype(w_out), w_out.device
    c = up[0][0].shape[1] if up else w_out.shape[1]
    img_ch, s = w_out.shape[0], scale
    # All C channel impulses in one image on a grid spaced so that their
    # responses (radius <= r LR px) cannot overlap; the linear part is
    # the chain with its biases zeroed.
    r = len(stages) + 1
    size, spacing, m0 = 2 * r + 1, 2 * r + 2, r + 2
    cols = int(np.ceil(np.sqrt(c)))
    p_in = 2 * m0 + cols * spacing
    ci = torch.arange(c, device=dev)
    my, mx = m0 + (ci // cols) * spacing, m0 + (ci % cols) * spacing
    with torch.no_grad():
        impulse = torch.zeros((1, p_in, p_in, c), dtype=dt, device=dev)
        impulse[0, my, mx, ci] = 1.0
        resp = _chain_apply([(w, torch.zeros_like(b)) for w, b in up],
                            (w_out, torch.zeros_like(out[1])), stages,
                            impulse)[0]                # [p_in s, p_in s, 3]
        # y[p] = sum_u K[u] x[p + u - r]  =>  K[u] = y[m + r - u] for an
        # impulse at m; phase (i, j) of LR pixel p is HR pixel p s + (i, j).
        u = torch.arange(size, device=dev)
        ph = torch.arange(s, device=dev)
        pu = (my[:, None, None] + r - u[None, :, None]) * s + ph   # [c, u, i]
        qv = (mx[:, None, None] + r - u[None, :, None]) * s + ph   # [c, v, j]
        k = resp[pu[:, :, None, :, None], qv[:, None, :, None, :]]
        kernel = k.permute(5, 3, 4, 0, 1, 2).reshape(img_ch * s * s, c,
                                                     size, size)
        bias = _fold_bias(up, out, scale, r)
    # Trim the zero fringe.  A conv algorithm may leave rounding-level
    # values (~1e-7 relative) where the exact composite has zeros, so
    # "zero" is below 1e-5 of the largest tap.
    mag = kernel.abs().amax(dim=(0, 1))
    nz = torch.nonzero(mag > 1e-5 * mag.max()).tolist()
    lo, hi = min(min(p) for p in nz), max(max(p) for p in nz)
    kernel = kernel[:, :, lo:hi + 1, lo:hi + 1].contiguous()
    return kernel, bias, (r - lo, hi - r)


@functools.lru_cache(maxsize=None)
def _placement(g: int, f: int, kk: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """One-hot ``R[p, i, u, i', t]`` (``[h, f, g, f, kk]``) of one axis of
    :func:`_absorb`: tap ``t`` of the absorbed conv, read at output phase
    ``i``, takes source phase ``i'`` of composite row ``u`` and lands at
    row ``p`` of the new composite.  With ``di = t - rho``, ``i + di = f a
    + i'`` (``a`` the LR shift) and ``p = rh - rg + a + u``."""
    rg, rho = (g - 1) // 2, (kk - 1) // 2
    rh = rg + (rho + f - 1) // f       # the LR shift a is within +-that
    r = np.zeros((2 * rh + 1, f, g, f, kk), np.float32)
    for i in range(f):
        for t in range(kk):
            a, ip = divmod(i + t - rho, f)
            for u in range(g):
                r[rh - rg + a + u, i, u, ip, t] = 1.0
    return torch.from_numpy(r).to(device=device, dtype=dtype)


def _absorb(g_hwio: torch.Tensor, f: int, k: torch.Tensor) -> torch.Tensor:
    """Absorb the SAME conv ``k`` (HWIO ``[kk, kk, M, N]``) that runs at
    f x LR on the composite ``G`` (``[g, g, C, f^2 M]``, pixel-shuffle
    channel order ``m f^2 + i f + j``) -> ``[h, h, C, f^2 N]``:

        H[rh+a+u, rh+b+v, c, (n, i, j)]
            += k[rho+di, rho+dj, m, n] G[rg+u, rg+v, c, (m, i', j')]

    with ``i + di = f a + i'`` and ``j + dj = f b + j'``.  Three batched
    contractions: every (tap, source phase) product at once, then the
    one-hot placements of rows and of columns."""
    g, _, c, _ = g_hwio.shape
    kk, _, m, n = k.shape
    gp = g_hwio.reshape(g, g, c, m, f, f)
    prod = torch.einsum("uvcmab,xymn->uvcabxyn", gp, k)
    rows = _placement(g, f, kk, k.device, k.dtype)
    t = torch.einsum("piuax,uvcabxyn->pivcbyn", rows, prod)
    h = torch.einsum("qjvby,pivcbyn->pqcnij", rows, t)
    return h.reshape(h.shape[0], h.shape[1], c, n * f * f)


def _ps_remap(h: torch.Tensor, f_prev: int, f: int) -> torch.Tensor:
    """Channel layout ``n F^2 + i1 F + j1`` with ``n = m f^2 + i2 f + j2``
    -> ``m (F f)^2 + (f i1 + i2)(F f) + (f j1 + j2)``: a following
    pixel_shuffle(f) folded into the phases."""
    hh, _, c, _ = h.shape
    m = h.shape[3] // (f_prev * f_prev * f * f)
    x = h.reshape(hh, hh, c, m, f, f, f_prev, f_prev)  # m, i2, j2, i1, j1
    x = x.permute(0, 1, 2, 3, 6, 4, 7, 5)               # m, i1, i2, j1, j2
    return x.reshape(hh, hh, c, m * (f_prev * f) ** 2)


def _fold_radius(up: Sequence[Conv], out: Conv, stages: Sequence[int]) -> int:
    """LR radius of the composite's true support: a conv of radius rho at
    F x LR reaches rho / F LR pixels, so ceil(sum_t rho_t / F_t)."""
    def radius(w):
        return (w.shape[-1] - 1) // 2

    r, ft = Fraction(radius(up[0][0])), stages[0]
    for (w, _), f in zip(up[1:], stages[1:]):
        r += Fraction(radius(w), ft)
        ft *= f
    r += Fraction(radius(out[0]), ft)
    return -(-r.numerator // r.denominator)


def analytic_fold_upsampler(up: Sequence[Conv], out: Conv,
                            scale: int) -> Fold:
    """Differentiable fold of the chain by kernel composition: the
    composite of :func:`fold_upsampler` (equal to it up to float32
    rounding), built from ``up`` (``(weight, bias)`` per stage, OIHW) and
    ``out`` with gradients flowing back to them.  Returns ``(kernel
    [3 s^2, C, S, S], bias [3 s^2], (r, r))`` in float32 (float64 for
    float64 weights), trimmed to the true support (radius r)."""
    stages = upsample_stages(scale)
    w_out, b_out = out
    dt = _fold_dtype(w_out)
    if not stages:
        return w_out.to(dt), b_out.to(dt), ((w_out.shape[-1] - 1) // 2,) * 2

    def hwio(w):
        return w.to(dt).permute(2, 3, 1, 0)

    with full_f32(w_out.device):
        comp, f_acc = hwio(up[0][0]), stages[0]
        for (w, _), f in zip(up[1:], stages[1:]):
            comp = _ps_remap(_absorb(comp, f_acc, hwio(w)), f_acc, f)
            f_acc *= f
        comp = _absorb(comp, f_acc, hwio(w_out))
    rh, rt = (comp.shape[0] - 1) // 2, _fold_radius(up, out, stages)
    comp = comp[rh - rt:rh + rt + 1, rh - rt:rh + rt + 1]
    kernel = comp.permute(3, 2, 0, 1).contiguous()
    return kernel, _fold_bias(up, out, scale, rt), (rt, rt)


def folded_conv(y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                pads: Tuple[int, int]) -> torch.Tensor:
    """The folded conv of NHWC ``y`` in y.dtype, before the pixel shuffle:
    zero padding ``pads = (lo, hi)`` on both spatial axes (an explicit
    pad when the sides differ), then a VALID conv and the bias."""
    lo, hi = pads
    x = y.permute(0, 3, 1, 2)
    if lo != hi:
        x = F.pad(x, (lo, hi, lo, hi))
        lo = 0
    out = F.conv2d(x, kernel.to(y.dtype), bias.to(y.dtype), padding=lo)
    return out.permute(0, 2, 3, 1)
