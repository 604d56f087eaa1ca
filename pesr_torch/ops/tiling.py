"""Tiled whole-image inference with overlap-stitch, on one device
(counterpart of ``pesr_tpu/ops/tiling.py``: ``BatchTiledUpscaler``,
``WholeImageUpscaler``, ``required_min_halo``, ``_edge_pad_capped``).

The engine:

  * edge-replicate pads the LR batch to a fixed tile grid,
  * cuts tiles with a halo of ``overlap`` LR pixels on every side where
    the dimension has more than one tile,
  * runs the generator on each tile position with the image batch as the
    batch dimension (uint8 goes up once, normalize/denormalize run on the
    device),
  * writes back only each tile's core.

Not ported (yet): the multi-device mesh modes, the geometric
self-ensemble and the uint8-variant applies of folded/int8 paths.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from pesr_torch.data.augment import denormalize_to_uint8, normalize_uint8
from pesr_torch.utils.device import resolve_device


def required_min_halo(apply_fn: Callable) -> int:
    """Correctness floor for the border halo of an apply function: its
    ``min_halo`` attribute, 0 for the plain chain (only folded upsampler
    paths, not ported yet, are exact only away from padded borders)."""
    return int(getattr(apply_fn, "min_halo", 0))


def _edge_pad_capped(x: torch.Tensor, pads: Tuple[int, int, int, int],
                     h_axis: int = 1, w_axis: int = 2) -> torch.Tensor:
    """Edge-replicate pad (top, bottom, left, right) of a tensor along
    ``h_axis`` / ``w_axis``, for ANY pad size.  The JAX reference steps
    numpy/jnp edge pads in chunks capped at the current extent; repeated
    edge padding only ever copies the outermost row, so a clamped-index
    gather gives the identical result in one step."""
    top, bottom, left, right = pads
    for axis, (lo, hi) in ((h_axis, (top, bottom)), (w_axis, (left, right))):
        if lo or hi:
            n = x.shape[axis]
            idx = torch.arange(-lo, n + hi, device=x.device).clamp_(0, n - 1)
            x = x.index_select(axis, idx)
    return x


def _as_device_batch(imgs_u8, device: torch.device, ndim: int) -> torch.Tensor:
    t = imgs_u8 if isinstance(imgs_u8, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(imgs_u8))
    if t.dtype != torch.uint8 or t.dim() != ndim:
        raise ValueError(f"expected {'BHWC' if ndim == 4 else 'HWC'} uint8")
    return t.to(device)


class WholeImageUpscaler:
    """One whole-image forward per image, no tiling (the reference's
    inference mode; ``--tile_size 0``)."""

    def __init__(self, apply_fn: Callable, scale: int,
                 device="cuda") -> None:
        self.scale = scale
        self.device = resolve_device(device)
        self._apply_fn = apply_fn

    def warmup_many(self, imgs) -> None:
        """One forward per distinct image shape (kernel builds, cuDNN
        algorithm searches) before a timing loop."""
        for shape in {im.shape for im in imgs}:
            self.upscale(np.zeros(shape, np.uint8))

    @torch.no_grad()
    def upscale(self, lr_u8: np.ndarray) -> np.ndarray:
        x = normalize_uint8(_as_device_batch(lr_u8, self.device, 3))[None]
        return denormalize_to_uint8(self._apply_fn(x)[0]).cpu().numpy()

    def upscale_many(self, imgs) -> list:
        return [self.upscale(img) for img in imgs]


class BatchTiledUpscaler:
    """Device-resident tiled SR over a batch of SAME-SIZE images.

    ``apply_fn(x)`` maps an NHWC [-1, 1] float batch to the NHWC float SR
    batch (a ``Generator`` or a ``KernelApply``).  ``tile_size``: int
    (square tiles), (th, tw) tuple, or "auto" -- the rectangular tile
    splitting each image into the fewest near-equal parts whose input
    area stays under the budget, minimising halo + grid waste."""

    # "auto" LR-pixel budget for one forward, summed over the image batch:
    # at most this many LR pixels (halo included) go through the
    # generator at once.  On the port's kernel path the largest buffers
    # are at HR resolution: the last x2 stage's output [b, 4th, 4tw, 256]
    # bf16 is 16 x 256 = 4,096 elements = 8,192 B per LR pixel, and its
    # input (the first stage's output) another 2,048 B, so a forward
    # holds about 10 KB per LR pixel.  An 80 GB H100 would take ~7.8M
    # LR px on memory alone (80e9 / 10,240 B), but the 4,096 elements per
    # LR px must stay below 2^31 in one tensor (32-bit element indexing
    # in library convs and indexing ops): 2^31 / 4,096 = 524,288 LR px.
    # 500,000 keeps that margin; the peak is then ~5 GB, and a whole
    # DIV2K validation LR image (510 x 339 = 173k px) still goes in one
    # tile at batch 2.  The v5e budget of the JAX package (1.5M, 16 GB
    # HBM, folded upsampler) does not carry over.
    _AUTO_PIXEL_BUDGET = 500_000

    def __init__(self, apply_fn: Callable, scale: int, tile_size=128,
                 overlap: int = 8, device="cuda") -> None:
        if tile_size != "auto":
            th, tw = (tile_size if isinstance(tile_size, tuple)
                      else (tile_size, tile_size))
            if th <= 0 or tw <= 0:
                raise ValueError(f"tile_size must be > 0 (or 'auto'), "
                                 f"got {tile_size!r}")
        if overlap < 0:
            raise ValueError(f"overlap must be >= 0, got {overlap}")
        self.scale, self.tile, self.ov = scale, tile_size, overlap
        self.min_halo = required_min_halo(apply_fn)
        self.device = resolve_device(device)
        self._apply_fn = apply_fn

    def _tile_hw(self, h: int, w: int, b: int = 8) -> Tuple[int, int]:
        if self.tile == "auto":
            max_area = max(self._AUTO_PIXEL_BUDGET // max(b, 1), 136 * 96)
            best = None
            for nh in range(1, 17):
                for nw in range(1, 17):
                    th = math.ceil(h / nh)
                    tw = math.ceil(w / nw)
                    # single-tile dims carry only the min_halo floor
                    area_in = ((th + 2 * self._ov_for(nh))
                               * (tw + 2 * self._ov_for(nw)))
                    if area_in > max_area:
                        continue
                    waste = nh * nw * area_in  # total input px
                    if best is None or waste < best[0]:
                        best = (waste, th, tw)
            if best is None:
                # Image larger than any budgeted 16x16 grid: the
                # halo-inclusive square the budget allows, with a hard
                # positive floor (a big overlap against a small budget
                # would otherwise go negative).
                ov_eff = max(self.ov, self.min_halo)
                side = max(int(math.sqrt(max_area)) - 2 * ov_eff, 32)
                return side, side
            return best[1], best[2]
        if isinstance(self.tile, tuple):
            return self.tile
        return self.tile, self.tile

    def _ov_for(self, n_tiles: int) -> int:
        """Halo for a dimension split into ``n_tiles``.  Halos hide SEAMS
        between tiles; a dimension covered by a single tile has no seam,
        so its halo drops to the ``min_halo`` floor (0 for the plain
        chain: the single-tile case is then exactly the whole-image
        zero-pad SAME forward).  Multi-tile dims never go below it."""
        return (max(self.ov, self.min_halo) if n_tiles > 1
                else self.min_halo)

    def grid(self, b: int, h: int, w: int) -> Tuple[int, int, int, int]:
        """``(nh, nw, th, tw)`` for a batch of ``b`` images of h x w."""
        th, tw = self._tile_hw(h, w, b)
        # Clamp to the image: an oversized fixed tile would replicate-fill
        # the grid remainder, so SAME convs would see replicated context
        # at the true image border and the single-tile zero-pad exactness
        # of _ov_for would not hold.  Clamped, th == h exactly.
        th, tw = min(th, h), min(tw, w)
        return math.ceil(h / th), math.ceil(w / tw), th, tw

    @torch.no_grad()
    def upscale_batch_device(self, imgs_u8) -> torch.Tensor:
        """[B, H, W, 3] uint8 (numpy or tensor) -> padded-canvas uint8
        tensor on the device (crop to H*s x W*s for the true image)."""
        imgs = _as_device_batch(imgs_u8, self.device, 4)
        bsz, h, w = imgs.shape[:3]
        s = self.scale
        nh, nw, th, tw = self.grid(bsz, h, w)
        ov_h, ov_w = self._ov_for(nh), self._ov_for(nw)
        x = _edge_pad_capped(normalize_uint8(imgs),
                             (ov_h, nh * th - h + ov_h,
                              ov_w, nw * tw - w + ov_w))
        canvas = torch.zeros((bsz, nh * th * s, nw * tw * s, 3),
                             dtype=torch.uint8, device=self.device)
        for i in range(nh):
            for j in range(nw):
                tiles = x[:, i * th:i * th + th + 2 * ov_h,
                          j * tw:j * tw + tw + 2 * ov_w]
                sr = self._apply_fn(tiles)
                core = sr[:, ov_h * s:(ov_h + th) * s,
                          ov_w * s:(ov_w + tw) * s]
                canvas[:, i * th * s:(i + 1) * th * s,
                       j * tw * s:(j + 1) * tw * s] = \
                    denormalize_to_uint8(core)
        return canvas

    def upscale_batch(self, imgs_u8) -> np.ndarray:
        """Host-side convenience: returns [B, H*s, W*s, 3] uint8."""
        h, w = imgs_u8.shape[1:3]
        canvas = self.upscale_batch_device(imgs_u8)
        return canvas[:, :h * self.scale, :w * self.scale].cpu().numpy()

    @staticmethod
    def _chunks(imgs, batch_size: int):
        """Group image indices by shape, then split into batches."""
        groups: dict = {}
        for idx, im in enumerate(imgs):
            groups.setdefault(im.shape, []).append(idx)
        for shape, idxs in groups.items():
            for start in range(0, len(idxs), batch_size):
                yield shape, idxs[start:start + batch_size]

    def warmup_many(self, imgs, batch_size: int = 8) -> None:
        """Run one batch of every distinct (batch, shape) that
        :meth:`upscale_many` will see, so kernel builds, cuDNN algorithm
        searches and allocator growth land before a timing loop."""
        seen = set()
        for shape, chunk in self._chunks(imgs, batch_size):
            key = (len(chunk),) + tuple(shape)
            if key not in seen:
                seen.add(key)
                self.upscale_batch_device(np.zeros(key, np.uint8))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def upscale_many(self, imgs, batch_size: int = 8) -> list:
        """Upscale a list of HWC uint8 images of possibly mixed sizes,
        one device batch per same-shape chunk; order is preserved."""
        results: list = [None] * len(imgs)
        for shape, chunk in self._chunks(imgs, batch_size):
            batch = np.stack([imgs[i] for i in chunk])
            h, w = shape[:2]
            out = self.upscale_batch_device(batch)[
                :, :h * self.scale, :w * self.scale].cpu().numpy()
            for k, i in enumerate(chunk):
                results[i] = out[k]
        return results
