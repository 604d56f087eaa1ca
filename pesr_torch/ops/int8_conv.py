"""int8 x int8 -> int32 convolution of the W8A8 inference path
(counterpart of ``pesr_tpu/models/quant_apply.py::_conv_int8``, which is
``lax.conv`` with int32 accumulation, not a Pallas kernel).

Layouts: the input is NHWC int8, the weights are OHWI int8
``[N, kh, kw, C]`` (one row of ``kh * kw * C`` taps per output channel,
the GEMM's K-major layout), the result is NHWC int32.  ``pads``: None
for SAME padding, or ``(lo, hi)`` zero rows and columns on both spatial
axes (the folded upsampler's asymmetric pads).

* :func:`int8_conv_reference` is the plain version: a float64
  ``F.conv2d`` (cuDNN off, so no FFT or Winograd transform), exact
  because every partial sum is an integer below 9 C 127^2 << 2^53.
* :func:`int8_conv_im2col` is the card's route, callable on any device
  (``torch._int_mm`` also runs on the CPU, so the tests hold its layout
  to the plain version bitwise): an int8 im2col built from the
  ``kh * kw`` shifted slices of the padded input (``F.unfold`` takes no
  int8 on CUDA) in chunks of at most ``max_bytes``, each one
  ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32 on the card).
* :func:`int8_conv` runs the plain version for a CPU tensor and the
  im2col route for a CUDA tensor; any other device raises.

This is a library GEMM, not a hand-written kernel: an int8 residual
block on Hopper (s8 ``wgmma``, quantize on load, the requant in the
epilogue) is later work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# The im2col of one chunk stays under this many bytes.  At the folded x4
# tile batch [2, 342, 516, 256] one body conv's im2col is 813 MB (one
# chunk); the x8 upfold's K = 81 x 256 would need several GB unchunked.
IM2COL_MAX_BYTES = 1 << 30
# torch._int_mm on CUDA takes M > 16 rows and K, N multiples of 8.
_MIN_ROWS, _ALIGN = 17, 8


def _pads(w: torch.Tensor, pads: Optional[Tuple[int, int]]
          ) -> Tuple[int, int]:
    kh, kw = w.shape[1:3]
    if kh != kw:
        raise ValueError(f"int8_conv: square kernels only, got {kh}x{kw}")
    return ((kh - 1) // 2, kh // 2) if pads is None else tuple(pads)


def _check(xq: torch.Tensor, w: torch.Tensor) -> None:
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv: int8 input and weights, got {xq.dtype} "
                        f"and {w.dtype}")
    if xq.dim() != 4 or w.dim() != 4 or xq.shape[3] != w.shape[3]:
        raise ValueError(f"int8_conv: x NHWC and w OHWI with one C, got "
                         f"{tuple(xq.shape)} and {tuple(w.shape)}")


def int8_conv_reference(xq: torch.Tensor, w: torch.Tensor,
                        pads: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """The plain version: float64 ``F.conv2d`` of the integers, cast to
    int32 (exact, see the module note)."""
    _check(xq, w)
    lo, hi = _pads(w, pads)
    x = F.pad(xq.permute(0, 3, 1, 2).double(), (lo, hi, lo, hi))
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x, w.permute(0, 3, 1, 2).double())
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _gemm(col: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """``col [M, K] @ wmat.T`` in int32 through ``torch._int_mm``, with
    the rows padded to more than 16 and K and N to multiples of 8 by
    zeros (dropped from the result)."""
    m, k = col.shape
    n = wmat.shape[0]
    kp, np_ = _round_up(k, _ALIGN), _round_up(n, _ALIGN)
    mp = max(m, _MIN_ROWS)
    if (mp, kp) != (m, k):
        col = F.pad(col, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        wmat = F.pad(wmat, (0, kp - k, 0, np_ - n))
    # mat2 [K, N] column-major: the transpose of the contiguous [N, K]
    acc = torch._int_mm(col, wmat.t())
    return acc[:m, :n]


def int8_conv_im2col(xq: torch.Tensor, w: torch.Tensor,
                     pads: Optional[Tuple[int, int]] = None,
                     max_bytes: int = IM2COL_MAX_BYTES) -> torch.Tensor:
    """The GEMM route on any device: im2col in chunks of whole images, or
    of rows of one image when an image's im2col passes ``max_bytes``,
    each chunk one ``torch._int_mm``.  Returns NHWC int32.

    The im2col copies each pixel's C channels as C / 8 int64 words when
    8 divides C: a stack of int8 slices copies byte by byte, and was
    70% of the conv's time on the H100 (``chip_smoke.py``'s parts)."""
    _check(xq, w)
    lo, hi = _pads(w, pads)
    n, k, _, c = w.shape
    xp = F.pad(xq, (0, 0, lo, hi, lo, hi))
    if c % 8 == 0:
        xp = xp.view(torch.int64)
    bsz, hp, wp, _ = xp.shape
    ho, wo = hp - k + 1, wp - k + 1
    kk = k * k * c
    wmat = w.reshape(n, kk)
    rows = max(1, max_bytes // (wo * kk))   # output rows per chunk
    imgs = max(1, rows // ho)
    rows = min(rows, ho)
    chunks = [(b0, min(b0 + imgs, bsz), r0, min(r0 + rows, ho))
              for b0 in range(0, bsz, imgs) for r0 in range(0, ho, rows)]
    int8_conv_im2col.gemms += len(chunks)
    out = None
    for b0, b1, r0, r1 in chunks:
        col = torch.stack([xp[b0:b1, r0 + dy:r1 + dy, dx:dx + wo]
                           for dy in range(k) for dx in range(k)], dim=3)
        acc = _gemm(col.view(torch.int8).reshape(-1, kk), wmat)
        acc = acc.reshape(b1 - b0, r1 - r0, wo, n)
        if len(chunks) == 1:
            return acc
        if out is None:
            out = torch.empty((bsz, ho, wo, n), dtype=torch.int32,
                              device=xq.device)
        out[b0:b1, r0:r1] = acc
    return out


int8_conv_im2col.gemms = 0


def int8_conv(xq: torch.Tensor, w: torch.Tensor,
              pads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """int8 NHWC ``xq`` conv int8 OHWI ``w`` -> int32 NHWC.  CPU tensor:
    :func:`int8_conv_reference`; CUDA tensor: :func:`int8_conv_im2col`;
    anything else raises."""
    if xq.device.type == "cpu":
        return int8_conv_reference(xq, w, pads)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {xq.device}")
    return int8_conv_im2col(xq, w, pads)
