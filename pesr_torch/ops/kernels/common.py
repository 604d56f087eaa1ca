"""Plain PyTorch versions of the shared pieces of the TPU conv kernels
(``pesr_tpu/ops/pallas/common.py``): the shift-accumulate VALID 3x3 conv
and the halo tiling; the SAME NHWC conv the plain versions and the
generator's library convs share; and the recompute backward of the
kernels' autograd Functions.

On the card these live inside the kernels: ``csrc/conv3x3_tile.cuh``
runs the conv as an implicit GEMM (wgmma) from shared-memory windows that
TMA loads straight from the unpadded tensor (zero fill at the edges), so
no windowed copy is made in device memory.  The versions here state the
same semantics in PyTorch, for the tests.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

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


def recompute_backward(ctx, plain: Callable, g: torch.Tensor
                       ) -> List[Optional[torch.Tensor]]:
    """Backward of a kernel's autograd Function: autograd of its plain
    version, recomputed from the tensors the forward saved, in their
    dtype (the JAX kernels' ``custom_vjp`` backward).  Returns one
    gradient per saved tensor, None where none was asked for."""
    saved = [t.detach().requires_grad_(need) for t, need in
             zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        out = plain(*saved)
    grads = iter(torch.autograd.grad(
        out, [t for t in saved if t.requires_grad], g))
    return [next(grads) if t.requires_grad else None for t in saved]
