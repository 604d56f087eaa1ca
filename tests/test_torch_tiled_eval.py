"""The port's host-stitch ``TiledUpscaler`` and the self-validation that
runs it, against the JAX package's, on the CPU.

Weights are the JAX init carried across with ``state_dict_from_jax``;
both sides compute in float32.  Tolerances:

* uint8 engine outputs: at most 1 LSB on fewer than 0.1% of the values,
  where a value sits within float32 summation noise of a rounding tie; a
  grid, halo, pad or crop fault shows as tens of LSB (the batch engine,
  which zero-pads the outer border of a single tile, differs from JAX's
  by up to 207 LSB at LR 60 x 70);
* float outputs on the [0, 255] scale: atol 3e-3 (the folded applies'
  2e-5 on [-1, 1], times 127.5);
* ``evaluate``: PSNR atol 1e-3 dB, SSIM 1e-4, as the earlier evaluate
  tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu import config as jax_config
from pesr_tpu.models import Generator as JaxGenerator
from pesr_tpu.models import fold as jfold
from pesr_tpu.models.fold import make_fold_train_apply
from pesr_tpu.ops import tiling as jtiling
from pesr_tpu.training import loop as jax_loop
from pesr_torch.config import Opts
from pesr_torch.convert import state_dict_from_jax
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.ops.tiling import BatchTiledUpscaler, TiledUpscaler
from pesr_torch.training import loop
from pesr_torch.utils.image_io import imwrite_uint8

_BLOCKS, _CH = 2, 8


def _pair(scale, seed=0):
    jgen = JaxGenerator(scale=scale, num_blocks=_BLOCKS, num_channels=_CH,
                        dtype=jnp.float32)
    variables = jgen.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    gen = Generator(scale, _BLOCKS, _CH, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(params, scale))
    return jgen, variables, gen


def _u8_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d > 0) < 1e-3


def _engines(scale, fold, seed):
    jgen, variables, gen = _pair(scale, seed)
    if fold:
        fn, fvars = jfold.folded_inference(variables["params"], scale,
                                           dtype=jnp.float32)
    else:
        fn, fvars = jgen.apply, variables
    want = jtiling.TiledUpscaler(fn, fvars, scale, 96, 8, 8)
    apply_fn = KernelApply(gen, torch.float32, fold=fold)
    return want, TiledUpscaler(apply_fn, scale, 96, 8, 8, device="cpu"), \
        apply_fn


# (scale, h, w): LR 60 x 70 at x2 (one tile: the fault the batch engine
# had), one tile at x4 and x8, 3 x 3 tiles at x2 (18 tiles over two
# images: a tail batch of 2 padded to 8).
@pytest.mark.parametrize("fold", [False, True], ids=["chain", "fold"])
@pytest.mark.parametrize("scale,h,w", [(2, 60, 70), (4, 70, 60),
                                       (8, 40, 30), (2, 240, 240)])
def test_tiled_upscaler_matches_jax(scale, h, w, fold):
    want_eng, eng, apply_fn = _engines(scale, fold, seed=scale + h)
    assert eng.ov == want_eng.ov == 8
    rng = np.random.default_rng(h)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 256, (w, h, 3), dtype=np.uint8)]
    got, want = eng.upscale_many(imgs), want_eng.upscale_many(imgs)
    for g, wnt, img in zip(got, want, imgs):
        assert g.shape == (img.shape[0] * scale, img.shape[1] * scale, 3)
        _u8_close(g, wnt)
    tiles = 2 * -(-h // 96) * -(-w // 96)
    assert apply_fn.forwards == -(-tiles // 8)
    f_got, f_want = eng.upscale_float(imgs[0]), want_eng.upscale_float(
        imgs[0])
    assert f_got.dtype == np.float32 and f_got.shape == f_want.shape
    np.testing.assert_allclose(f_got, f_want, atol=3e-3)


def test_tiled_upscaler_pads_a_single_tile_unlike_the_batch_engine():
    """The outer border of an image that fits one tile sees replicated
    context here and zeros in the batch engine: they differ there and
    agree in the middle."""
    _, eng, apply_fn = _engines(2, False, seed=1)
    img = np.random.default_rng(2).integers(0, 256, (60, 70, 3),
                                            dtype=np.uint8)
    ours = eng.upscale(img)
    batch = BatchTiledUpscaler(apply_fn, 2, 96, 8,
                               device="cpu").upscale_batch(img[None])[0]
    d = np.abs(ours.astype(np.int16) - batch.astype(np.int16))
    assert d.max() > 8
    # the chain's reach: 2 * _BLOCKS + 3 LR convs, then the out conv at HR
    r = 2 * (2 * _BLOCKS + 3) + 1
    assert d[r:-r, r:-r].max() <= 1


def test_update_apply_swaps_the_weights_without_a_rebuild():
    _, _, gen_a = _pair(2, seed=3)
    _, _, gen_b = _pair(2, seed=4)
    img = np.random.default_rng(5).integers(0, 256, (50, 30, 3),
                                            dtype=np.uint8)
    eng = TiledUpscaler(KernelApply(gen_a, torch.float32), 2, 96, 8, 8,
                        device="cpu")
    before = eng.upscale(img)
    eng.update_apply(KernelApply(gen_b, torch.float32))
    fresh = TiledUpscaler(KernelApply(gen_b, torch.float32), 2, 96, 8, 8,
                          device="cpu")
    assert np.array_equal(eng.upscale(img), fresh.upscale(img))
    assert not np.array_equal(before, fresh.upscale(img))
    # the fold's halo at x8 (4 px) does not fit an overlap of 2
    _, _, gen8 = _pair(8, seed=6)
    small = TiledUpscaler(KernelApply(gen_a, torch.float32), 2, 96, 2, 8,
                          device="cpu")
    with pytest.raises(ValueError, match="halo"):
        small.update_apply(KernelApply(gen8, torch.float32, fold=True))
    with pytest.raises(ValueError):
        TiledUpscaler(KernelApply(gen_a, torch.float32), 2, 0, 8, 8,
                      device="cpu")


def _small_set(root, scale):
    """Two HR images whose LR sides are <= 96 px (LR 60 x 70, 40 x 96)."""
    rng = np.random.default_rng(7)
    for i, (h, w) in enumerate(((60, 70), (40, 96))):
        hr = rng.integers(0, 256, (h * scale, w * scale, 3), dtype=np.uint8)
        imwrite_uint8(root / "small" / "HR" / f"{i}.png", hr)


# synthetic at x6 and x8 (HR 480: LR 80 and 60, one tile each), x4 (LR
# 120: four tiles), and a folder whose LR sides are <= 96 px at x2.
@pytest.mark.parametrize("fold", [False, True], ids=["chain", "fold"])
@pytest.mark.parametrize("dataset,scale", [("synthetic", 6),
                                           ("synthetic", 8),
                                           ("synthetic", 4), ("small", 2)])
def test_evaluate_matches_jax(tmp_path, dataset, scale, fold):
    if dataset == "small":
        _small_set(tmp_path, scale)
    kw = dict(scale=scale, num_blocks=_BLOCKS, num_channels=_CH,
              valid_dataset=dataset, num_valids=2, data_root=str(tmp_path))
    jopts = jax_config.Opts(**kw, compute_dtype="float32")
    jgen = jax_loop.build_generator(jopts)
    params = jgen.init(jax.random.key(scale),
                       jnp.zeros((1, 8, 8, 3)))["params"]
    japply = (make_fold_train_apply(scale, dtype=jnp.float32) if fold
              else jgen.apply)
    want = jax_loop.evaluate(jopts, japply, params, compute_pi=False)
    gen = Generator(scale, _BLOCKS, _CH, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), scale))
    got = loop.evaluate(Opts(**kw, device="cpu"),
                        KernelApply(gen, torch.float32, fold=fold),
                        compute_pi=False)
    assert set(got) == set(want) == {"val_psnr", "val_ssim"}
    assert got["val_psnr"] == pytest.approx(want["val_psnr"], abs=1e-3)
    assert got["val_ssim"] == pytest.approx(want["val_ssim"], abs=1e-4)
