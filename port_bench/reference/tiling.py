"""The tiled upscaling that the engine's geometry stands for, done
plainly: the uint8 batch edge-replicated by a halo (``max(overlap,
min_halo)`` LR px on a dimension cut into several tiles, ``min_halo``
on one that is whole) and up to the tile grid, each tile normalised to
[-1, 1] and run through ``forward``, each tile's core written into the
canvas.  The grid (``nh, nw, th, tw``) is taken as the engine reports
it, so a better grid in the program stays correct; it is checked to
cover the image exactly."""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def check_grid(grid: Tuple[int, int, int, int], h: int, w: int) -> None:
    nh, nw, th, tw = grid
    if not (0 < th <= h and 0 < tw <= w and nh == math.ceil(h / th)
            and nw == math.ceil(w / tw)):
        raise ValueError(f"grid {grid} does not tile a {h} x {w} image")


def halos(grid, overlap: int, min_halo: int) -> Tuple[int, int]:
    nh, nw = grid[:2]
    return tuple(max(overlap, min_halo) if n > 1 else min_halo
                 for n in (nh, nw))


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Edge-replicate pad of NHWC ``x`` by a clamped-index gather."""
    for axis, lo, hi in ((1, top, bottom), (2, left, right)):
        n = x.shape[axis]
        idx = torch.arange(-lo, n + hi, device=x.device).clamp_(0, n - 1)
        x = x.index_select(axis, idx)
    return x


@torch.no_grad()
def upscale(imgs_u8: torch.Tensor, grid, overlap: int, min_halo: int,
            scale: int, forward: Callable[[torch.Tensor], torch.Tensor]
            ) -> torch.Tensor:
    """[B, h, w, 3] uint8 -> [B, h s, w s, 3] float32 on the 0..255
    scale, unrounded and unclamped."""
    b, h, w = imgs_u8.shape[:3]
    check_grid(grid, h, w)
    nh, nw, th, tw = grid
    ovh, ovw = halos(grid, overlap, min_halo)
    s = scale
    x = edge_pad(imgs_u8, ovh, nh * th - h + ovh, ovw, nw * tw - w + ovw)
    canvas = torch.empty((b, nh * th * s, nw * tw * s, 3),
                         dtype=torch.float32, device=imgs_u8.device)
    for i in range(nh):
        for j in range(nw):
            tile = x[:, i * th:i * th + th + 2 * ovh,
                     j * tw:j * tw + tw + 2 * ovw]
            out = forward(tile.float() / 127.5 - 1.0)
            core = out[:, ovh * s:(ovh + th) * s, ovw * s:(ovw + tw) * s]
            canvas[:, i * th * s:(i + 1) * th * s,
                   j * tw * s:(j + 1) * tw * s] = (core.float() + 1.0) * 127.5
    return canvas[:, :h * s, :w * s]
