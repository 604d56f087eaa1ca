"""Tiled whole-image inference with overlap-stitch, on one device
(counterpart of ``pesr_tpu/ops/tiling.py``: ``TiledUpscaler``,
``BatchTiledUpscaler``, ``WholeImageUpscaler``, ``self_ensemble_upscale``,
``select_uint8_apply``, ``required_min_halo``, ``_edge_pad_capped``).

The batch engine (``BatchTiledUpscaler``, inference):

  * edge-replicate pads the LR batch to a fixed tile grid,
  * cuts tiles with a halo of ``overlap`` LR pixels on every side where
    the dimension has more than one tile,
  * runs the generator on each tile position with the image batch as the
    batch dimension (uint8 goes up once, normalize/denormalize run on the
    device),
  * writes back only each tile's core.

A folded apply (``models/fold.py``) is exact only ``min_halo`` LR pixels
away from a zero-padded border, so both engines replicate-pad and crop
at least that much on every border, and ride its ``uint8_variant`` for
uint8 output.  The x8 geometric self-ensemble averages the float outputs
of the eight dihedral transforms and rounds once.

``TiledUpscaler`` (the training self-validation's engine, as in the JAX
package) cuts every image into fixed square tiles with ``overlap`` px of
edge-replicated context on every border, image edges included, runs the
tiles of all images in batches of a fixed size and stitches the cores on
the host.

On a ``pesr_torch.parallel`` mesh the batch engine splits the image
batch (``mesh_axis="batch"``) or each image's tile positions
(``"tiles"``) over the processes, as the JAX engine splits them over
devices (see :class:`BatchTiledUpscaler`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pesr_torch import parallel
from pesr_torch.data.augment import denormalize_to_uint8, normalize_uint8
from pesr_torch.utils.device import resolve_device
from pesr_torch.utils.spans import span


def self_ensemble_upscale(engine: "WholeImageUpscaler",
                          lr_u8: np.ndarray) -> np.ndarray:
    """Geometric x8 self-ensemble of one HWC uint8 image on the host:
    upscale the eight dihedral transforms (``engine.upscale_float``),
    invert each on its output, average in float64, round once with
    ``floor(x + 0.5)`` (as ``denormalize_to_uint8``).  The branches are
    averaged unquantised: rounding each first would add eight half-LSB
    errors to the mean."""
    acc = None
    for t in range(8):
        img = lr_u8
        if t & 1:
            img = img[::-1]
        if t & 2:
            img = img[:, ::-1]
        if t & 4:
            img = np.swapaxes(img, 0, 1)
        sr = engine.upscale_float(np.ascontiguousarray(img)).astype(np.float64)
        if t & 4:
            sr = np.swapaxes(sr, 0, 1)
        if t & 2:
            sr = sr[:, ::-1]
        if t & 1:
            sr = sr[::-1]
        acc = sr if acc is None else acc + sr
    return np.clip(np.floor(acc / 8.0 + 0.5), 0, 255).astype(np.uint8)


def select_uint8_apply(apply_fn: Callable, float_out: bool = False
                       ) -> Tuple[Callable, bool]:
    """``(forward, use_u8)`` for an engine path: the apply's
    ``uint8_variant`` (quantised before its pixel shuffle, bitwise equal
    to quantising after) for uint8 output, else the float apply."""
    u8_fn = getattr(apply_fn, "uint8_variant", None)
    use_u8 = u8_fn is not None and not float_out
    return (u8_fn if use_u8 else apply_fn), use_u8


def _to_255(sr: torch.Tensor) -> torch.Tensor:
    """Model-space [-1, 1] -> unquantised float32 on the [0, 255] scale."""
    return (sr.float() + 1.0) * 127.5


def required_min_halo(apply_fn: Callable) -> int:
    """Correctness floor for the border halo of an apply function: its
    ``min_halo`` attribute (a folded upsampler's border band), 0 for the
    plain chain.  The engines pad at least this much on EVERY border,
    outer image borders of a single tile included, and crop it."""
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


def assemble_canvas(cores: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """[nh * nw, B, TH, TW, 3] cores, row-major positions -> the
    [B, nh * TH, nw * TW, 3] canvas."""
    _, bsz, th, tw, c = cores.shape
    return (cores.reshape(nh, nw, bsz, th, tw, c)
            .permute(2, 0, 3, 1, 4, 5).reshape(bsz, nh * th, nw * tw, c))


def spatial_positions(mesh, n_tiles: int) -> torch.Tensor:
    """This rank's share of ``n_tiles`` tile positions in spatial mode:
    ``ceil(n_tiles / P)`` contiguous ones from ``rank * ceil(n_tiles /
    P)``, those past the last position clamped to it (their cores are
    dropped after the gather), on the rank's device."""
    per = -(-n_tiles // mesh.size)
    pos = torch.arange(mesh.rank * per, (mesh.rank + 1) * per)
    return pos.clamp_(max=n_tiles - 1).to(mesh.device)


def gather_canvas(mesh, cores: torch.Tensor, nh: int, nw: int
                  ) -> torch.Tensor:
    """Every rank's share of the cores (:func:`spatial_positions`)
    gathered and assembled into the whole canvas, on every rank."""
    cores = parallel.all_gather_batch(mesh, cores)
    return assemble_canvas(cores[:nh * nw], nh, nw)


def _as_device_batch(imgs_u8, device: torch.device, ndim: int) -> torch.Tensor:
    t = imgs_u8 if isinstance(imgs_u8, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(imgs_u8))
    if t.dtype != torch.uint8 or t.dim() != ndim:
        raise ValueError(f"expected {'BHWC' if ndim == 4 else 'HWC'} uint8")
    return t.to(device)


class WholeImageUpscaler:
    """One whole-image forward per image, no tiling (the reference's
    inference mode; ``--tile_size 0``).  A folded apply's ``min_halo`` is
    replicate-padded around the image and cropped off its output."""

    def __init__(self, apply_fn: Callable, scale: int,
                 device="cuda") -> None:
        self.scale = scale
        self.device = resolve_device(device)
        self.min_halo = required_min_halo(apply_fn)
        self._apply_fn = apply_fn

    def warmup_many(self, imgs, se: bool = False) -> None:
        """One forward per distinct image shape (kernel builds, cuDNN
        algorithm searches) before a timing loop; ``se``: the float
        forwards of the self-ensemble, transposed shapes included."""
        shapes = {im.shape for im in imgs}
        if se:
            shapes |= {(w, h, c) for h, w, c in shapes}
        for shape in shapes:
            img = np.zeros(shape, np.uint8)
            if se:
                self.upscale_float(img)
            else:
                self.upscale(img)

    def _sr(self, lr_u8: np.ndarray, fn: Callable) -> torch.Tensor:
        x = normalize_uint8(_as_device_batch(lr_u8, self.device, 3))[None]
        mh, s = self.min_halo, self.scale
        if not mh:
            return fn(x)[0]
        sr = fn(_edge_pad_capped(x, (mh, mh, mh, mh)))[0]
        return sr[mh * s:sr.shape[0] - mh * s, mh * s:sr.shape[1] - mh * s]

    @torch.no_grad()
    def upscale(self, lr_u8: np.ndarray) -> np.ndarray:
        fn, use_u8 = select_uint8_apply(self._apply_fn)
        sr = self._sr(lr_u8, fn)
        return (sr if use_u8 else denormalize_to_uint8(sr)).cpu().numpy()

    @torch.no_grad()
    def upscale_float(self, lr_u8: np.ndarray) -> np.ndarray:
        """HWC uint8 -> unquantised float32 SR on the [0, 255] scale (the
        self-ensemble averages these and rounds once)."""
        return _to_255(self._sr(lr_u8, self._apply_fn)).cpu().numpy()

    def upscale_many(self, imgs, se: bool = False) -> list:
        if se:
            return [self_ensemble_upscale(self, img) for img in imgs]
        return [self.upscale(img) for img in imgs]


class BatchTiledUpscaler:
    """Device-resident tiled SR over a batch of SAME-SIZE images.

    ``apply_fn(x)`` maps an NHWC [-1, 1] float batch to the NHWC float SR
    batch (a ``Generator`` or a ``KernelApply``).  ``tile_size``: int
    (square tiles), (th, tw) tuple, or "auto" -- the rectangular tile
    splitting each image into the fewest near-equal parts whose input
    area stays under the budget, minimising halo + grid waste.

    ``mesh`` (``pesr_torch.parallel.Mesh``, one process per device) and
    ``mesh_axis`` pick the multi-device mode; every rank calls the engine
    with the same (replicated) batch and gets the whole canvas:

    * ``"batch"``: data parallel; each rank upscales its contiguous block
      of the batch (a batch that P does not divide is padded by repeating
      its last image), and an all-gather assembles the canvases.  The
      auto tile chooser sees the per-rank batch.
    * ``"tiles"``: spatial; every rank cuts the whole tile stack from the
      input, the T tile positions are split into P contiguous shares of
      ``ceil(T / P)`` (the last share padded with copies of the last
      position, whose output is dropped), each rank runs its share, and
      an all-gather of the cores assembles the canvas on every rank.  The
      auto chooser counts ``ceil(T / P)`` positions per rank.

    Each position runs ``apply_fn`` once on the image batch, in every
    mode, so a spatial canvas is bitwise the single-process engine's at
    the same geometry, and a batch-mode rank's images are bitwise the
    single-process engine's on that block (on the card the whole batch
    through one engine may differ in the last bits: the kernels'
    schedules and cuDNN's choices depend on the batch).

    Host staging (:meth:`upscale_many`): the engine owns one input and
    one output buffer of flat uint8 host memory, page-locked when the
    device is CUDA, so a large chunk's upload and download run at the
    host link's rate (a chunk whose result has fewer than
    ``_STAGED_BYTES`` takes pageable copies instead).  A chunk uses a
    view of a buffer's first bytes; a buffer is replaced by a fresh,
    larger one only when a chunk needs more bytes than it holds
    (``staging_grows`` counts these allocations, ``staged`` the chunks
    served), so the page-locked bytes are at most the largest staged
    chunk's input plus its output.  Invariant: a staging view is
    rewritten only after the copy that read it has been waited on, since
    each chunk's upload and download wait on the host before the next
    chunk starts; and no result aliases the staging."""

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

    # A chunk whose result has at least this many bytes goes through the
    # host staging (:meth:`upscale_many`); a smaller one takes pageable
    # copies.  On the H100's host the staging cut a 66 MB result's
    # download from ~32 ms to ~4 ms, but made single photos of 0.46-8.3
    # MB of result 1.2-1.9% slower a request; alone, its copies beat the
    # pageable one from ~16 MB on (16.6 MB: 1.06 against 1.45 ms).
    _STAGED_BYTES = 16 << 20

    def __init__(self, apply_fn: Callable, scale: int, tile_size=128,
                 overlap: int = 8, device="cuda", mesh=None,
                 mesh_axis: str = "batch") -> None:
        if mesh_axis not in ("batch", "tiles"):
            raise ValueError(f"mesh_axis must be 'batch' or 'tiles', "
                             f"got {mesh_axis!r}")
        if mesh_axis == "tiles" and mesh is None:
            raise ValueError("mesh_axis='tiles' requires a mesh")
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
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self._apply_fn = apply_fn
        self.stage: dict = {"in": None, "out": None}   # flat uint8
        self.staging_grows = 0
        self.staged = 0

    def _staging(self, name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        """A ``shape`` view of the first bytes of staging buffer ``name``,
        which is first replaced by a fresh one of exactly the bytes
        needed when it holds fewer."""
        n = math.prod(shape)
        buf = self.stage[name]
        if buf is None or buf.numel() < n:
            with span("pesr.pin"):
                self.stage[name] = None     # the old buffer goes first
                buf = self.stage[name] = torch.empty(
                    n, dtype=torch.uint8,
                    pin_memory=self.device.type == "cuda")
            self.staging_grows += 1
        return buf[:n].view(shape)

    def _ranks(self, axis: str) -> int:
        """P when the engine splits ``axis`` over a mesh, else 1."""
        return (self.mesh.size if self.mesh is not None
                and self.mesh_axis == axis else 1)

    def _tile_hw(self, h: int, w: int, b: int = 8) -> Tuple[int, int]:
        if self.tile == "auto":
            # Spatial mode: the budget covers a rank's ceil(T / P) tiles
            # of the batch, and the padded grid's positions count as
            # computed (JAX's chooser).
            ndev = self._ranks("tiles")
            max_area = max(self._AUTO_PIXEL_BUDGET // max(b, 1), 136 * 96)
            best = None
            for nh in range(1, 17):
                for nw in range(1, 17):
                    th = math.ceil(h / nh)
                    tw = math.ceil(w / nw)
                    # single-tile dims carry only the min_halo floor
                    area_in = ((th + 2 * self._ov_for(nh))
                               * (tw + 2 * self._ov_for(nw)))
                    if ndev > 1:
                        per_dev = math.ceil(nh * nw / ndev)
                        if (area_in * per_dev * max(b, 1)
                                > self._AUTO_PIXEL_BUDGET):
                            continue
                        waste = per_dev * ndev * area_in
                    else:
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
        """``(nh, nw, th, tw)`` for a batch of ``b`` images of h x w (the
        chooser sees a batch-mode rank's ``ceil(b / P)``)."""
        th, tw = self._tile_hw(h, w, -(-b // self._ranks("batch")))
        # Clamp to the image: an oversized fixed tile would replicate-fill
        # the grid remainder, so SAME convs would see replicated context
        # at the true image border and the single-tile zero-pad exactness
        # of _ov_for would not hold.  Clamped, th == h exactly.
        th, tw = min(th, h), min(tw, w)
        return math.ceil(h / th), math.ceil(w / tw), th, tw

    def _build(self, b: int, h: int, w: int, float_out: bool = False):
        """``(run, (nh, nw, th, tw))`` for images of h x w, the grid
        chosen for a batch of ``b``.  ``run(imgs_u8)``: [B, h, w, 3]
        uint8 on the device (any B) -> the padded canvas [B, nh * th * s,
        nw * tw * s, 3], each position's core written into it;
        ``run(imgs_u8, pos)``, ``pos`` a 1-D index tensor into the
        ``nh * nw`` positions (row-major, spatial mode) -> their cores
        ``[len(pos), B, th * s, tw * s, 3]``.  uint8, or float32 on the
        [0, 255] scale with ``float_out``.  The uint8 input is
        replicate-padded and cut into tiles (edge padding and slicing
        commute with the normalisation), then each position runs the
        apply once on the image batch."""
        s = self.scale
        nh, nw, th, tw = self.grid(b, h, w)
        ov_h, ov_w = self._ov_for(nh), self._ov_for(nw)
        tile_fn, use_u8 = select_uint8_apply(self._apply_fn, float_out)

        def core(tile: torch.Tensor) -> torch.Tensor:
            with span("pesr.forward"):
                out = tile_fn(normalize_uint8(tile))[
                    :, ov_h * s:(ov_h + th) * s, ov_w * s:(ov_w + tw) * s]
                return (out if use_u8 else _to_255(out) if float_out
                        else denormalize_to_uint8(out))

        def run(imgs_u8: torch.Tensor,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
            with span("pesr.cut"):
                x = _edge_pad_capped(imgs_u8, (ov_h, nh * th - h + ov_h,
                                               ov_w, nw * tw - w + ov_w))
                cuts = [x[:, i * th:i * th + th + 2 * ov_h,
                          j * tw:j * tw + tw + 2 * ov_w]
                        for i in range(nh) for j in range(nw)]
            if pos is not None:
                # a tensor (an input of the exported spatial program), so
                # its tiles are selected on the device
                tiles = torch.stack(cuts).index_select(0, pos)
                return torch.stack([core(tiles[k])
                                    for k in range(tiles.shape[0])])
            canvas = None
            for k, tile in enumerate(cuts):
                out = core(tile)
                with span("pesr.canvas"):
                    if canvas is None:
                        canvas = out.new_empty((out.shape[0], nh * th * s,
                                                nw * tw * s, 3))
                    i, j = divmod(k, nw)
                    canvas[:, i * th * s:(i + 1) * th * s,
                           j * tw * s:(j + 1) * tw * s] = out
            return canvas

        return run, (nh, nw, th, tw)

    @torch.no_grad()
    def upscale_batch_device(self, imgs_u8,
                             float_out: bool = False) -> torch.Tensor:
        """[B, H, W, 3] uint8 (numpy or tensor) -> padded-canvas uint8
        tensor on the device (crop to H*s x W*s for the true image); with
        ``float_out`` the canvas is unquantised float32 on the [0, 255]
        scale (the self-ensemble's branches).  On a mesh, every rank
        passes the whole batch and gets the whole canvas."""
        with span("pesr.upload"):
            imgs = _as_device_batch(imgs_u8, self.device, 4)
        bsz, h, w = imgs.shape[:3]
        with span("pesr.plan"):
            run, (nh, nw, _, _) = self._build(bsz, h, w, float_out)
        if self._ranks("tiles") > 1:
            return gather_canvas(self.mesh, run(
                imgs, spatial_positions(self.mesh, nh * nw)), nh, nw)
        p = self._ranks("batch")
        if p > 1:
            pad = -bsz % p
            if pad:
                imgs = torch.cat([imgs, imgs[-1:].expand(pad, -1, -1, -1)])
            imgs = imgs[parallel.batch_sharding(self.mesh, bsz + pad)]
        return parallel.all_gather_batch(self.mesh, run(imgs))[:bsz]

    @torch.no_grad()
    def upscale_batch_se_device(self, imgs_u8) -> torch.Tensor:
        """Geometric x8 self-ensemble of a batch on the device: the eight
        dihedral transforms through the float canvas, each inverted,
        averaged unquantised in float32 at the true image size (a
        transposed branch has another padded grid), rounded once.
        Returns [B, H*s, W*s, 3] uint8, already cropped."""
        x0 = _as_device_batch(imgs_u8, self.device, 4)
        h, w = x0.shape[1:3]
        s = self.scale
        acc = None
        for t in range(8):
            img = x0
            if t & 1:
                img = torch.flip(img, (1,))
            if t & 2:
                img = torch.flip(img, (2,))
            if t & 4:
                img = img.transpose(1, 2)
            h2, w2 = (w, h) if t & 4 else (h, w)
            sr = self.upscale_batch_device(img, float_out=True)[
                :, :h2 * s, :w2 * s]
            if t & 4:
                sr = sr.transpose(1, 2)
            if t & 2:
                sr = torch.flip(sr, (2,))
            if t & 1:
                sr = torch.flip(sr, (1,))
            acc = sr if acc is None else acc + sr
        return torch.clamp(torch.floor(acc / 8.0 + 0.5), 0.0, 255.0
                           ).to(torch.uint8)

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

    def warmup_many(self, imgs, batch_size: int = 8,
                    se: bool = False) -> None:
        """Run one batch of every distinct (batch, shape) that
        :meth:`upscale_many` will see, on its path, so kernel builds,
        cuDNN algorithm searches, allocator and staging growth land
        before a timing loop; ``se``: the self-ensemble's (both
        orientations) instead."""
        seen = set()
        for shape, chunk in self._chunks(imgs, batch_size):
            key = (len(chunk),) + tuple(shape)
            if key not in seen:
                seen.add(key)
                self._upscale_chunk(list(np.zeros(key, np.uint8)), se)

    @torch.no_grad()
    def _upscale_chunk(self, imgs: list, se: bool) -> np.ndarray:
        """Same-shape HWC uint8 images -> [B, H*s, W*s, 3] uint8 in fresh
        host memory.  From ``_STAGED_BYTES`` of result on, through the
        staging (see the class docstring): the images stacked straight
        into the input view and uploaded in one copy, the cropped canvas
        downloaded in one copy into the output view, then copied out;
        below it, the stack uploaded and the crop downloaded as they
        are.  Every copy waits on the host."""
        h, w = imgs[0].shape[:2]
        s = self.scale
        shape = (len(imgs), h * s, w * s, 3)
        staged = math.prod(shape) >= self._STAGED_BYTES
        with span("pesr.stack"):
            if staged:
                batch = self._staging("in",
                                      (len(imgs),) + tuple(imgs[0].shape))
                np.stack(imgs, out=batch.numpy(), casting="no")
            else:
                batch = np.stack(imgs)
        out = (self.upscale_batch_se_device(batch) if se
               else self.upscale_batch_device(batch))[:, :h * s, :w * s]
        with span("pesr.download"):
            if not staged:
                return out.cpu().numpy()
            # zeroed now, while the device computes: its first-touch page
            # faults (~22 ms for 66 MB on the H100's host) then stay out
            # of the copy-out after the wait
            res = torch.zeros(shape, dtype=torch.uint8)
            stage = self._staging("out", shape)
            stage.copy_(out)
            res.copy_(stage)
        self.staged += 1
        return res.numpy()

    def upscale_many(self, imgs, batch_size: int = 8,
                     se: bool = False) -> list:
        """Upscale a list of HWC uint8 images of possibly mixed sizes,
        one device batch per same-shape chunk (``se``: its x8
        self-ensemble); order is preserved.  A chunk of ``_STAGED_BYTES``
        of result or more goes up and comes back through the engine's
        host staging (page-locked on CUDA; a staging view is rewritten
        only after the copy that read it was waited on), and each result
        is a view of a fresh array of its chunk, never of the staging.
        Under a running profiler the call is one ``pesr.request`` range,
        and each chunk's steps are ranges inside it (``pesr.stack``,
        ``pesr.upload``, ``pesr.plan``, ``pesr.cut``, a ``pesr.forward``
        and a ``pesr.canvas`` per tile position, ``pesr.download``;
        ``pesr.pin`` where a staging buffer grows)."""
        results: list = [None] * len(imgs)
        with span("pesr.request"):
            for _, chunk in self._chunks(imgs, batch_size):
                out = self._upscale_chunk([imgs[i] for i in chunk], se)
                for k, i in enumerate(chunk):
                    results[i] = out[k]
        return results


class TiledUpscaler:
    """Fixed-shape tiled SR with a host stitch (the JAX package's
    ``TiledUpscaler``, which its training self-validation runs).

    Every image is edge-replicate padded by ``overlap`` LR px on every
    border (an image that fits one tile included) and up to a multiple of
    ``tile_size``, then cut into square tiles of ``tile_size + 2 *
    overlap``.  The tiles of all images go through ``apply_fn`` in
    batches of ``batch_size`` (the tail batch padded with copies of its
    last tile), each tile's core is cropped on the device and copied to
    the host, where the cores are stitched.  ``overlap`` is raised to the
    apply's ``min_halo``, and the raised value drives both the cut and
    the crop."""

    def __init__(self, apply_fn: Callable, scale: int, tile_size: int = 96,
                 overlap: int = 8, batch_size: int = 8,
                 device="cuda") -> None:
        if tile_size <= 0 or overlap < 0 or batch_size <= 0:
            raise ValueError("tile_size and batch_size must be > 0 and "
                             "overlap >= 0")
        self.scale, self.tile, self.batch = scale, tile_size, batch_size
        self.ov = max(overlap, required_min_halo(apply_fn))
        self.device = resolve_device(device)
        self._apply_fn = apply_fn

    def update_apply(self, apply_fn: Callable) -> None:
        """Swap the apply (new weights) without rebuilding the engine,
        the counterpart of JAX's ``update_variables``.  Its ``min_halo``
        must fit the overlap this engine cuts with."""
        if required_min_halo(apply_fn) > self.ov:
            raise ValueError(f"apply needs a halo of "
                             f"{required_min_halo(apply_fn)} px, this engine "
                             f"cuts {self.ov}")
        self._apply_fn = apply_fn

    def upscale(self, lr_u8: np.ndarray) -> np.ndarray:
        """HWC uint8 LR -> HWC uint8 SR (H*scale, W*scale)."""
        return self.upscale_many([lr_u8])[0]

    def upscale_float(self, lr_u8: np.ndarray) -> np.ndarray:
        """HWC uint8 LR -> unquantised float32 SR on the [0, 255] scale."""
        return self.upscale_many([lr_u8], float_out=True)[0]

    def upscale_many(self, imgs, float_out: bool = False) -> list:
        """Upscale a list of HWC uint8 images, batching tiles ACROSS
        images, so only the last batch of the list is padded."""
        tiles, metas = [], []
        for img in imgs:
            cut, grid, hw = self._cut(img)
            metas.append((len(tiles), len(cut), grid, hw))
            tiles.extend(cut)
        cores = self._run(tiles, float_out)
        return [self._stitch(cores[o:o + n], grid, hw)
                for o, n, grid, hw in metas]

    def _cut(self, lr_u8: np.ndarray):
        """The tiles of one image, views of its padded copy on the
        device."""
        x = _as_device_batch(lr_u8, self.device, 3)
        h, w = x.shape[:2]
        t, ov = self.tile, self.ov
        nh, nw = math.ceil(h / t), math.ceil(w / t)
        padded = _edge_pad_capped(x, (ov, nh * t - h + ov, ov, nw * t - w + ov),
                                  0, 1)
        tiles = [padded[i * t:(i + 1) * t + 2 * ov,
                        j * t:(j + 1) * t + 2 * ov]
                 for i in range(nh) for j in range(nw)]
        return tiles, (nh, nw), (h, w)

    @torch.no_grad()
    def _forward(self, tiles_u8: torch.Tensor, float_out: bool
                 ) -> torch.Tensor:
        """uint8 tiles -> their cores: uint8, or float32 on the [0, 255]
        scale with ``float_out``."""
        fn, use_u8 = select_uint8_apply(self._apply_fn, float_out)
        lo = self.ov * self.scale
        hi = lo + self.tile * self.scale
        core = fn(normalize_uint8(tiles_u8))[:, lo:hi, lo:hi]
        if use_u8:
            return core
        return _to_255(core) if float_out else denormalize_to_uint8(core)

    def _run(self, tiles, float_out: bool) -> np.ndarray:
        n, b = len(tiles), self.batch
        out = None
        for start in range(0, n, b):
            chunk = tiles[start:start + b]
            k = len(chunk)
            chunk = chunk + [chunk[-1]] * (b - k)  # the tail at full size
            res = self._forward(torch.stack(chunk), float_out)[:k]
            res = res.cpu().numpy()
            if out is None:
                out = np.empty((n,) + res.shape[1:], res.dtype)
            out[start:start + k] = res
        return out

    def _stitch(self, cores: np.ndarray, grid, hw) -> np.ndarray:
        nh, nw = grid
        h, w = hw
        ts = self.tile * self.scale
        canvas = np.empty((nh * ts, nw * ts, 3), cores.dtype)
        for k in range(nh * nw):
            i, j = divmod(k, nw)
            canvas[i * ts:(i + 1) * ts, j * ts:(j + 1) * ts] = cores[k]
        return canvas[:h * self.scale, :w * self.scale]
