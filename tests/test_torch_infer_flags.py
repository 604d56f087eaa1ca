"""The rest of ``test.py``'s single-device flow in the port, against the
JAX package on the CPU: the x8 self-ensemble in both engines, network
interpolation, and the CLI's fold / self-ensemble / interpolation flags.

Weights are the JAX init carried across; both sides compute in float32.
uint8 outputs of the two packages may differ by 1 LSB on fewer than
0.1% of the values, where an average sits within float32 summation
noise of a rounding tie (x.5 LSB); a wrong transform, crop or rounding
rule shows as tens of LSB on most pixels.  Within the port, where both
sides see the same float values, results are compared bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu.models import Generator as JaxGenerator
from pesr_tpu.models import fold as jfold
from pesr_tpu.ops import tiling as jtiling
from pesr_tpu.training import checkpoint as jckpt
from pesr_torch import test as cli
from pesr_torch.convert import state_dict_from_jax
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.ops.tiling import (BatchTiledUpscaler, WholeImageUpscaler,
                                   self_ensemble_upscale)
from pesr_torch.training.checkpoint import interpolate_params

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = ["--num_blocks", "2", "--num_channels", "8", "--dataset",
         "synthetic", "--device", "cpu"]


def _pair(scale, seed, blocks=2, ch=8):
    jgen = JaxGenerator(scale=scale, num_blocks=blocks, num_channels=ch,
                        dtype=jnp.float32)
    variables = jgen.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))
    gen = Generator(scale, blocks, ch, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), scale))
    return jgen, variables, gen


def _u8_close(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d > 0) < 1e-3


def _applies(scale, seed, fold):
    """(JAX apply, its variables, port apply) of one generator."""
    jgen, variables, gen = _pair(scale, seed)
    if fold:
        fn, fvars = jfold.folded_inference(variables["params"], scale,
                                           dtype=jnp.float32)
        return fn, fvars, KernelApply(gen, torch.float32, fold=True)
    return jgen.apply, variables, KernelApply(gen, torch.float32)


# Non-square images (the transposed branches take another grid), a
# multi-tile grid and a single tile, folded and not.
@pytest.mark.parametrize("fold,scale,h,w,tile", [
    (True, 4, 21, 30, 16), (False, 2, 17, 26, "auto"), (True, 3, 12, 19, 32)])
def test_batch_engine_self_ensemble_matches_jax(fold, scale, h, w, tile):
    fn, fvars, ours = _applies(scale, h, fold)
    imgs = np.random.default_rng(h).integers(0, 256, (2, h, w, 3),
                                             dtype=np.uint8)
    want = np.asarray(jtiling.BatchTiledUpscaler(
        fn, fvars, scale, tile_size=tile, overlap=8
    ).upscale_batch_se_device(imgs))
    eng = BatchTiledUpscaler(ours, scale, tile, 8, device="cpu")
    got = eng.upscale_batch_se_device(imgs).numpy()
    assert got.shape == want.shape == (2, h * scale, w * scale, 3)
    _u8_close(got, want)
    # the same average from the port's own float canvases, bitwise
    acc = 0.0
    for t in range(8):
        img = imgs[:, ::-1] if t & 1 else imgs
        img = img[:, :, ::-1] if t & 2 else img
        img = img.transpose(0, 2, 1, 3) if t & 4 else img
        hh, ww = img.shape[1:3]
        sr = eng.upscale_batch_device(np.ascontiguousarray(img),
                                      float_out=True
                                      ).numpy()[:, :hh * scale, :ww * scale]
        sr = sr.transpose(0, 2, 1, 3) if t & 4 else sr
        sr = sr[:, :, ::-1] if t & 2 else sr
        acc = acc + (sr[:, ::-1] if t & 1 else sr)
    np.testing.assert_array_equal(
        got, np.clip(np.floor(acc / np.float32(8.0) + np.float32(0.5)),
                     0, 255).astype(np.uint8))
    assert np.abs(got.astype(int) - eng.upscale_batch(imgs)).max() > 0


@pytest.mark.parametrize("fold", [False, True])
def test_whole_image_self_ensemble_matches_jax(fold):
    fn, fvars, ours = _applies(2, 7, fold)
    img = np.random.default_rng(7).integers(0, 256, (15, 22, 3),
                                            dtype=np.uint8)
    want = jtiling.self_ensemble_upscale(
        jtiling.WholeImageUpscaler(fn, fvars, 2), img)
    whole = WholeImageUpscaler(ours, 2, device="cpu")
    got = self_ensemble_upscale(whole, img)
    assert got.shape == want.shape == (30, 44, 3)
    _u8_close(got, want)
    np.testing.assert_array_equal(whole.upscale_many([img], se=True)[0], got)


def test_upscale_many_with_se_keeps_order_and_mixed_shapes():
    _, _, ours = _applies(2, 8, True)
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8)
            for s in ((10, 14, 3), (9, 9, 3), (10, 14, 3))]
    eng = BatchTiledUpscaler(ours, 2, "auto", 8, device="cpu")
    eng.warmup_many(imgs, 2, se=True)
    outs = eng.upscale_many(imgs, 2, se=True)
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(
            out, eng.upscale_batch_se_device(img[None])[0].numpy())


def test_interpolate_params_matches_jax():
    _, va, ga = _pair(2, 0)
    _, vb, gb = _pair(2, 1)
    for alpha in (0.0, 0.3, 1.0):
        want = state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, jckpt.interpolate_params(va["params"], vb["params"],
                                                 alpha)), 2)
        got = interpolate_params(ga.state_dict(), gb.state_dict(), alpha)
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), k)
    other = Generator(2, 3, 8, device="cpu", seed=0).state_dict()
    with pytest.raises(ValueError, match="unexpected in checkpoint"):
        interpolate_params(ga.state_dict(), other, 0.5)


def _save(tmp_path, name, seed):
    path = str(tmp_path / name)
    torch.save(Generator(4, 2, 8, device="cpu", seed=seed).state_dict(),
               path)
    return path


def test_cli_network_interpolation(tmp_path, capsys):
    """--interp_model blends --model_path's weights toward it: a = 0 and
    a = 1 give either checkpoint's output, 0.5 the interpolated
    generator's; the JAX CLI's errors for a missing base or a out of
    [0, 1]."""
    a, b = _save(tmp_path, "a.pth", 1), _save(tmp_path, "b.pth", 2)

    def psnr(*extra):
        return cli.run(_TINY + ["--output_dir", str(tmp_path / "o")]
                       + list(extra))["psnr"]

    pa, pb = psnr("--model_path", a), psnr("--model_path", b)
    assert pa != pb
    assert psnr("--model_path", a, "--interp_model", b,
                "--interp_alpha", "0") == pa
    assert psnr("--model_path", a, "--interp_model", b,
                "--interp_alpha", "1") == pb
    assert "network interpolation" in capsys.readouterr().out
    opts = cli.opts_from_args(_TINY + ["--model_path", a, "--interp_model",
                                       b, "--interp_alpha", "0.25"])
    gen = cli.build_generator(opts, torch.device("cpu"))
    want = interpolate_params(torch.load(a), torch.load(b), 0.25)
    for k, v in gen.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(SystemExit, match="needs --model_path"):
        cli.main(_TINY + ["--interp_model", b])
    with pytest.raises(SystemExit, match="outside"):
        cli.main(_TINY + ["--model_path", a, "--interp_model", b,
                          "--interp_alpha", "1.5"])


def test_cli_fold_and_self_ensemble_flags(tmp_path, capsys):
    """Tiled mode folds unless --no_fold (and whole-image mode never);
    --self_ensemble runs in both engines: eight forwards per batch of the
    five 120 x 120 images (one tile each) in the tiled engine, eight per
    image in whole-image mode, plus the warm-up's (one shape: the
    transposed one is the same)."""
    def run(*extra):
        res = cli.run(_TINY + ["--output_dir", str(tmp_path / "o")]
                      + list(extra))
        return res, capsys.readouterr().out

    res, out = run()
    assert "using folded upsampler" in out and res["forwards"] == 2
    res_nf, out = run("--no_fold")
    assert "folded" not in out and res_nf["psnr"] != res["psnr"]
    res0, out = run("--tile_size", "0")
    assert "folded" not in out and res0["psnr"] == res_nf["psnr"]
    se, out = run("--self_ensemble")
    assert "x8 self-ensemble" in out and se["forwards"] == 16
    se0, out = run("--self_ensemble", "--tile_size", "0")
    assert "x8 self-ensemble" in out and se0["forwards"] == 1 + 8 * 5
    assert np.isfinite(se["psnr"]) and se["psnr"] != res["psnr"]
    assert np.isfinite(se0["psnr"]) and se0["psnr"] != res0["psnr"]


def test_demo_checkpoint_without_the_fold(tmp_path):
    """The demo checkpoint (x4, 8 x 64) through the kernel upsampler
    chain (--no_fold): within 0.05 dB of demo/README.md's 44.11 dB."""
    from pesr_tpu.convert import save_generator_torch
    from pesr_tpu.training.checkpoint import restore_generator_params
    params, _ = restore_generator_params(os.path.join(_REPO, "demo",
                                                      "checkpoint"))
    pth = str(tmp_path / "demo.pth")
    save_generator_torch(params, 4, pth)
    res = cli.run(["--dataset", "synthetic", "--model_path", pth,
                   "--num_blocks", "8", "--num_channels", "64", "--device",
                   "cpu", "--no_fold", "--output_dir", str(tmp_path)])
    assert abs(res["psnr"] - 44.11) <= 0.05, res
