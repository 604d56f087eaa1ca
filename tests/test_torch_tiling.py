"""The port's tiled engine against the JAX package's, on the CPU.

Same weights (JAX init carried across), same uint8 images from numpy,
both in float32.  The uint8 outputs may differ by 1 LSB where a value
sits within float32 summation noise of a rounding tie (x.5 LSB); any
structural fault (grid shift, halo, padding, crop) shows up as tens of
LSB.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pesr_tpu.models import Generator as JaxGenerator
from pesr_tpu.ops.tiling import BatchTiledUpscaler as JaxTiler
from pesr_tpu.ops.tiling import _pad_replicate
from pesr_torch.convert import state_dict_from_jax
from pesr_torch.models.generator import Generator
from pesr_torch.ops.tiling import (BatchTiledUpscaler, WholeImageUpscaler,
                                   _edge_pad_capped)

_OVERLAP = 8


def _pair(scale, seed):
    jgen = JaxGenerator(scale=scale, num_blocks=2, num_channels=8,
                        dtype=jnp.float32)
    variables = jgen.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))
    gen = Generator(scale, 2, 8, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), scale))
    return jgen, variables, gen


# (seed, scale, H, W, tile, batch): odd dims, grids that do not divide the
# image, single-tile dims, an image smaller than the tile, "auto".
@pytest.mark.parametrize("seed,scale,h,w,tile,batch", [
    (0, 2, 37, 53, 16, 1),
    (1, 3, 41, 30, (24, 16), 2),
    (3, 2, 19, 64, "auto", 2),
    (5, 4, 48, 21, 16, 3),
])
def test_port_engine_matches_jax_engine(seed, scale, h, w, tile, batch):
    jgen, variables, gen = _pair(scale, seed)
    imgs = np.random.default_rng(seed).integers(0, 256, (batch, h, w, 3),
                                                dtype=np.uint8)
    ref = JaxTiler(jgen.apply, variables, scale, tile_size=tile,
                   overlap=_OVERLAP).upscale_batch(imgs)
    ours = BatchTiledUpscaler(gen, scale, tile, _OVERLAP,
                              device="cpu").upscale_batch(imgs)
    assert ours.shape == ref.shape == (batch, h * scale, w * scale, 3)
    d = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1
    assert np.mean(d > 0) < 1e-3


@pytest.mark.parametrize("seed,scale,h,w,tile,batch", [
    (10, 2, 37, 53, 16, 1),
    (11, 3, 15, 13, 32, 1),   # whole image smaller than one tile
    (12, 4, 48, 21, 16, 2),
])
def test_tiled_matches_whole_image_on_the_interior(seed, scale, h, w, tile,
                                                   batch):
    gen = Generator(scale, 2, 8, device="cpu", seed=seed)
    imgs = np.random.default_rng(seed).integers(0, 256, (batch, h, w, 3),
                                                dtype=np.uint8)
    tiled = BatchTiledUpscaler(gen, scale, tile, _OVERLAP,
                               device="cpu").upscale_batch(imgs)
    whole = WholeImageUpscaler(gen, scale, device="cpu")
    m = _OVERLAP * scale
    for b in range(batch):
        full = whole.upscale(imgs[b])
        assert full.shape == tiled[b].shape
        inner_t = tiled[b, m:-m, m:-m].astype(np.int16)
        inner_w = full[m:-m, m:-m].astype(np.int16)
        if inner_t.size == 0:
            # a single tile IS the whole-image forward
            np.testing.assert_array_equal(tiled[b], full)
            continue
        assert np.max(np.abs(inner_t - inner_w)) <= 1
        assert np.mean(inner_t != inner_w) < 0.02


@pytest.mark.parametrize("h,w,b", [(336, 510, 2), (336, 510, 8),
                                   (1356, 2040, 1), (120, 120, 5),
                                   (3000, 4000, 8)])
def test_auto_chooser_stays_within_its_budget(h, w, b):
    eng = BatchTiledUpscaler(lambda x: x, 4, "auto", _OVERLAP, device="cpu")
    nh, nw, th, tw = eng.grid(b, h, w)
    assert nh * th >= h and nw * tw >= w and th <= h and tw <= w
    area_in = (th + 2 * eng._ov_for(nh)) * (tw + 2 * eng._ov_for(nw))
    assert area_in <= max(eng._AUTO_PIXEL_BUDGET // b, 136 * 96)
    # the x4 kernel path's largest tensor, [b, 4th', 4tw', 256], stays
    # under 2^31 elements
    assert b * area_in * 16 * 256 < 2 ** 31
    if b * h * w <= eng._AUTO_PIXEL_BUDGET:
        assert (nh, nw) == (1, 1)  # whole images fit: no halo waste


def test_single_tile_dims_get_no_halo_and_tiles_clamp_to_the_image():
    eng = BatchTiledUpscaler(lambda x: x, 2, 128, _OVERLAP, device="cpu")
    assert eng.grid(1, 100, 300) == (1, 3, 100, 128)
    assert eng._ov_for(1) == 0 and eng._ov_for(3) == _OVERLAP


@pytest.mark.parametrize("pads", [(3, 0, 1, 2), (9, 12, 20, 7)])
def test_edge_pad_matches_the_reference_stepped_pad(pads):
    img = np.random.default_rng(0).integers(0, 256, (4, 5, 3),
                                            dtype=np.uint8)
    ours = _edge_pad_capped(torch.from_numpy(img), pads, 0, 1).numpy()
    np.testing.assert_array_equal(ours, _pad_replicate(img, pads))


def test_engines_raise_without_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchTiledUpscaler(lambda x: x, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WholeImageUpscaler(lambda x: x, 4)
