"""Plain PyTorch versions of the shared pieces of the TPU conv kernels
(``pesr_tpu/ops/pallas/common.py``): the shift-accumulate VALID 3x3 conv
and the halo tiling; the SAME NHWC conv the plain versions and the
generator's library convs share, and its backward, which the kernels'
autograd Functions call.

On the card these live inside the kernels: ``csrc/conv3x3_tile.cuh``
runs the conv as an implicit GEMM (wgmma) from shared-memory windows that
TMA loads straight from the unpadded tensor (zero fill at the edges), so
no windowed copy is made in device memory.  The versions here state the
same semantics in PyTorch, for the tests.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv + bias of NHWC ``x`` with torch OIHW weights, in
    x.dtype.  The NCHW view of an NHWC tensor is channels_last, so the
    conv reads and writes NHWC memory with no copy."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype),
                 padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_shift_acc(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 conv of an (hin, win, Cin) tile as nine full-tile
    matmuls; returns (hin-2, win-2, Cout) float32.  ``w`` is HWIO."""
    hin, win, cin = x.shape
    cout = w.shape[-1]
    hout, wout = hin - 2, win - 2
    xf = x.reshape(hin * win, cin).float()
    acc = torch.zeros((hout, wout, cout), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            y = (xf @ w[dy, dx].float()).reshape(hin, win, cout)
            acc = acc + y[dy:dy + hout, dx:dx + wout]
    return acc + b.float()


def halo_tiles(x: torch.Tensor, th: int, tw: int, halo: int
               ) -> Tuple[torch.Tensor, int, int]:
    """Zero-pad [B,H,W,C] by ``halo`` + to tile multiples, then expand
    into overlapping windows [B*nh*nw, TH+2*halo, TW+2*halo, C].
    Returns (tiles, nh, nw)."""
    b, h, w, c = x.shape
    nh, nw = -(-h // th), -(-w // tw)
    xp = F.pad(x, (0, 0, halo, nw * tw - w + halo, halo, nh * th - h + halo))
    win = xp.unfold(1, th + 2 * halo, th).unfold(2, tw + 2 * halo, tw)
    # [B, nh, nw, C, TH+2h, TW+2h] -> [B*nh*nw, TH+2h, TW+2h, C]
    return (win.permute(0, 1, 2, 4, 5, 3).reshape(
        b * nh * nw, th + 2 * halo, tw + 2 * halo, c), nh, nw)


def untile(tiles: torch.Tensor, b: int, nh: int, nw: int, h: int, w: int
           ) -> torch.Tensor:
    """Reassemble [B*nh*nw, TH, TW, C] tiles into [B, H, W, C] (cropping
    the grid padding)."""
    th, tw, c = tiles.shape[1:]
    out = tiles.reshape(b, nh, nw, th, tw, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, nh * th, nw * tw, c)[:, :h, :w]


def conv3x3_nhwc_backward(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                          need: Sequence[bool]
                          ) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of :func:`conv3x3_nhwc` (``x`` NHWC, ``w`` OIHW, a bias)
    for the cotangent ``g`` of its NHWC output: ``(dx, dw, db)``, None
    where ``need`` asks for none.  One ``convolution_backward`` on the
    same NCHW views autograd gives it, each gradient in the dtype of its
    input."""
    gx, gw, gb = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.to(x.dtype),
        [w.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, list(need))
    return (gx.permute(0, 2, 3, 1) if need[0] else None,
            gw.to(w.dtype) if need[1] else None,
            gb if need[2] else None)
