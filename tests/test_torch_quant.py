"""The port's int8 W8A8 inference (``pesr_torch/models/quant_apply.py``,
``pesr_torch/ops/int8_conv.py``) against the JAX package's
``quant_apply.py``, on the CPU.

Weights are JAX inits carried across with ``state_dict_from_jax`` (tiny
models, 2-3 blocks x 16 channels) or the demo checkpoints converted
through ``pesr_tpu.convert``.  Tolerances:

* integers and the quantizer's float32 vectors: bitwise (the same
  float64 numpy arithmetic; the same folded kernel on both sides, since
  the two packages' probe folds differ in their last bits);
* calibration amax: within 2^-7 relative (the amax of bf16 tensors; the
  head, body and tail agree bitwise, the upfold input can move by one
  bf16 step where XLA and eager torch round the tail conv + skip apart);
* the requantized int8 activations from the same accumulators: bitwise
  (measured: no value differs by +-1);
* the whole apply against JAX evaluated op by op (``jax.disable_jit``,
  one bf16 rounding per op, as the port computes): uint8 bitwise;
  against JAX's jitted apply, whose XLA fusion keeps some bf16 values in
  f32 (the head conv's output feeds the first quantizer unrounded),
  interior uint8 within 3 LSB with a mean below 0.5 (measured at most 3
  and 0.38 on these random-weight models, whose outputs of O(1-3) make
  one bf16 step 2-4 LSB);
* the demo checkpoints: PSNR within 0.02 dB of JAX's int8 and within
  0.05 dB of the port's bf16 folded path, on two synthetic images.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu.models import Generator as JaxGenerator
from pesr_tpu.models import fold as jfold
from pesr_tpu.models import quant_apply as jq
from pesr_tpu.ops import tiling as jtiling
from pesr_torch.convert import load_generator_pth, state_dict_from_jax
from pesr_torch.data.augment import denormalize_to_uint8
from pesr_torch.metrics import calc_psnr
from pesr_torch.models import quant_apply as tq
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.ops.int8_conv import (int8_conv, int8_conv_im2col,
                                      int8_conv_reference)
from pesr_torch.ops.pixel_shuffle import pixel_shuffle
from pesr_torch.ops.tiling import BatchTiledUpscaler
from pesr_torch.scales import fold_min_halo

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


def _pair(scale, blocks=3, ch=16, seed=0):
    jgen = JaxGenerator(scale=scale, num_blocks=blocks, num_channels=ch,
                        dtype=jnp.float32)
    variables = jgen.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # nonzero biases, so that every bias path is exercised
    rng = np.random.default_rng(seed + 10)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32)) if p[-1].key == "bias" else a, params)
    gen = Generator(scale, blocks, ch, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(params, scale))
    return params, gen


def _tiles(seed=1, n=4, tile=24):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)
            for _ in range(2)]
    return tq.default_calib_tiles(imgs, tile=tile, max_tiles=n)


def _flat(jcalib):
    """JAX's nested calibration tree under the port's flat keys."""
    return {"body/in1": np.asarray(jcalib["body"]["in1"]),
            "body/in2": np.asarray(jcalib["body"]["in2"]),
            "tail_in": np.asarray(jcalib["tail_in"]),
            "up_in": np.asarray(jcalib["up_in"])}


def _jax_fold(params, scale):
    """JAX's probe fold as the port's ``Fold`` (OIHW kernel)."""
    k, b, pads = jfold.fold_upsampler(params, scale)
    return (T(np.asarray(k).transpose(3, 2, 0, 1).copy()),
            T(np.asarray(b).copy()), tuple(pads))


def _assert_qconv_equal(got, want):
    for key in ("w_q", "qin", "m", "bias"):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and np.array_equal(a, b), key


def test_quantize_conv_folded_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    for cin, cout, k in ((16, 16, 3), (64, 48, 5), (8, 192, 9)):
        kernel = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
        bias = rng.standard_normal(cout).astype(np.float32)
        amax = rng.uniform(0.0, 4.0, cin).astype(np.float32)
        amax[0] = 0.0      # a dead channel: the 1e-6 floor
        _assert_qconv_equal(tq._quantize_conv_folded(kernel, bias, amax),
                            jq._quantize_conv_folded(kernel, bias, amax))


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_quantize_generator_params_matches_jax_bitwise(scale):
    """From the same calibration tree and folded kernel, every quantized
    conv (body, tail, and the upfold: bf16 below x8, int8 at x8) equals
    JAX's bit for bit; the head stays bf16."""
    params, gen = _pair(scale)
    jcalib = jq.collect_calibration(params, _tiles())
    qf = scale >= 8
    want = jq.quantize_generator_params(params, jcalib, scale,
                                        quant_fold=qf)
    got = tq.quantize_generator_params(gen.state_dict(), _flat(jcalib),
                                       scale, quant_fold=qf,
                                       folded=_jax_fold(params, scale))
    blk = want["body"]["block"]
    for i, (c1, c2) in enumerate(got["body"]):
        for c, name in ((c1, "conv1"), (c2, "conv2")):
            _assert_qconv_equal(c, {k: np.asarray(v)[i]
                                    for k, v in blk[name].items()})
    _assert_qconv_equal(got["tail"], want["tail"])
    assert got["pads"] == tuple(want["_pads"])
    hw, hb = got["head"]
    assert hw.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        hw.float().permute(2, 3, 1, 0).numpy(),
        np.asarray(want["head"]["kernel"], np.float32))
    np.testing.assert_array_equal(hb.float().numpy(),
                                  np.asarray(want["head"]["bias"],
                                             np.float32))
    if qf:
        _assert_qconv_equal(got["upfold"], want["upfold"])
    else:
        uk, ub = got["upfold"]
        np.testing.assert_array_equal(
            uk.float().permute(2, 3, 1, 0).numpy(),
            np.asarray(want["upfold"]["kernel"], np.float32))
        np.testing.assert_array_equal(ub.float().numpy(),
                                      np.asarray(want["upfold"]["bias"],
                                                 np.float32))


def test_int8_upfold_from_the_ports_own_fold_is_within_one_step():
    """At x8 with the port's own probe fold (last bits apart from JAX's)
    the int8 upfold weights differ from JAX's by at most one step, on
    fewer than 0.1% of the taps; scales within 1e-5 relative."""
    params, gen = _pair(8)
    jcalib = jq.collect_calibration(params, _tiles())
    want = jq.quantize_generator_params(params, jcalib, 8, quant_fold=True)
    got = tq.quantize_generator_params(gen.state_dict(), _flat(jcalib), 8,
                                       quant_fold=True)["upfold"]
    d = np.abs(got["w_q"].astype(int)
               - np.asarray(want["upfold"]["w_q"]).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    np.testing.assert_allclose(got["m"], np.asarray(want["upfold"]["m"]),
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_calibration_matches_jax(seed):
    params, gen = _pair(4, seed=seed)
    tiles = _tiles(seed=seed + 1) + _tiles(seed=seed + 5, n=2, tile=16)
    want = _flat(jq.collect_calibration(params, tiles))
    got = tq.collect_calibration(gen, tiles)
    assert set(got) == set(want)
    assert got["body/in1"].shape == (3, 16) and got["up_in"].shape == (16,)
    for key in ("body/in1", "body/in2", "tail_in"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["up_in"], want["up_in"], rtol=2.0 ** -7)


_CONV_CASES = [  # (b, h, w, c, n, k, pads)
    (2, 9, 11, 16, 16, 3, None), (1, 5, 7, 64, 64, 3, None),
    (1, 4, 6, 128, 128, 3, None), (1, 3, 5, 256, 256, 3, None),
    (2, 7, 6, 16, 48, 5, (2, 2)), (1, 6, 9, 16, 192, 9, (4, 4)),
    (2, 8, 5, 24, 27, 5, (1, 3)), (1, 2, 3, 16, 12, 3, None),
    (2, 6, 7, 12, 10, 3, None), (1, 5, 6, 12, 10, 3, (0, 2)),
]


def _int8(shape, rng):
    return rng.integers(-127, 128, shape, dtype=np.int8)


@pytest.mark.parametrize("case", _CONV_CASES)
def test_int8_conv_plain_version_matches_jax_bitwise(case):
    b, h, w, c, n, k, pads = case
    rng = np.random.default_rng(sum(case[:6]))
    x, wq = _int8((b, h, w, c), rng), _int8((k, k, c, n), rng)
    want = np.asarray(jq._conv_int8(jnp.asarray(x), jnp.asarray(wq),
                                    "SAME" if pads is None
                                    else (pads, pads)))
    w_ohwi = T(wq.transpose(3, 0, 1, 2).copy())
    got = int8_conv_reference(T(x), w_ohwi, pads)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int8_conv(T(x), w_ohwi, pads).numpy(),
                                  want)


@pytest.mark.parametrize("max_bytes", [1 << 30, 5000, 1])
@pytest.mark.parametrize("case", _CONV_CASES)
def test_int8_conv_im2col_route_equals_the_plain_version(case, max_bytes):
    """The card's GEMM route (``torch._int_mm``, which also runs on the
    CPU) bitwise: M <= 16 rows (zero-padded), K and N off a multiple of
    8, asymmetric pads, chunks of whole images, of rows, of one row."""
    b, h, w, c, n, k, pads = case
    rng = np.random.default_rng(7 + sum(case[:6]))
    x = T(_int8((b, h, w, c), rng))
    wq = T(_int8((n, k, k, c), rng))
    before = int8_conv_im2col.gemms
    got = int8_conv_im2col(x, wq, pads, max_bytes=max_bytes)
    assert torch.equal(got, int8_conv_reference(x, wq, pads))
    chunks = int8_conv_im2col.gemms - before
    if max_bytes == 1 << 30:
        assert chunks == 1
    elif max_bytes == 1:          # one output row per GEMM
        assert chunks == b * got.shape[1]


def test_int8_conv_raises_off_the_cpu_and_on_wrong_dtypes():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_conv(x.to("meta"), w.to("meta"))
    with pytest.raises(TypeError):
        int8_conv(x.float(), w)


def test_requant_matches_jax_from_the_same_accumulators():
    """conv1 -> conv2's int8 input from the same int32 accumulators and
    the same f32 vectors, against JAX's jitted expression: no value
    differs (0 of 200,000 at +-1)."""
    rng = np.random.default_rng(3)
    acc = rng.integers(-300_000, 300_000, (2, 50, 50, 40)).astype(np.int32)
    m1 = rng.uniform(1e-5, 1e-3, 40).astype(np.float32)
    qin2 = rng.uniform(1.0, 80.0, 40).astype(np.float32)
    b1 = rng.standard_normal(40).astype(np.float32)

    @jax.jit
    def jreq(acc, m1, qin2, b1):
        t = acc.astype(jnp.float32) * (m1 * qin2) + b1 * qin2
        return jnp.clip(jnp.round(jnp.maximum(t, 0.0)), -127,
                        127).astype(jnp.int8)

    want = np.asarray(jreq(acc, m1, qin2, b1))
    got = tq.requant(T(acc), T(m1) * T(qin2), T(b1) * T(qin2)).numpy()
    assert (np.abs(got.astype(int) - want) > 0).sum() == 0
    assert 0 < (want == 127).sum() and 0 < (want == 0).sum()


@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_int8_apply_matches_jax(scale):
    """From JAX's quantized weights, the port's apply equals JAX's
    evaluated op by op bitwise (uint8); from its own calibration and
    fold, it is within the stated LSB bound of JAX's jitted apply."""
    params, gen = _pair(scale)
    tiles = _tiles()
    x = jnp.asarray(tiles[0][:2])
    jcalib = jq.collect_calibration(params, tiles)
    qf = scale >= 8
    jqp = jq.quantize_generator_params(params, jcalib, scale, quant_fold=qf)
    japply = jq.make_int8_apply(scale, pads=jqp.pop("_pads"))
    jv = {"params": jqp}
    same = tq.Int8Apply(tq.quantize_generator_params(
        gen.state_dict(), _flat(jcalib), scale, qf,
        _jax_fold(params, scale)), scale, 0.1, "cpu")
    with jax.disable_jit():
        want_eager = np.asarray(japply.uint8_variant(jv, x))
    np.testing.assert_array_equal(same.uint8_variant(T(tiles[0][:2])).numpy(),
                                  want_eager)

    ours = tq.int8_inference(gen, tiles)
    got = ours.uint8_variant(T(tiles[0][:2])).numpy()
    y = ours(T(tiles[0][:2]))
    assert y.dtype == torch.bfloat16 and ours.forwards == 2
    want = np.asarray(jax.jit(japply.uint8_variant)(jv, x))
    r = fold_min_halo(scale) * scale
    d = np.abs(got.astype(int) - want.astype(int))[:, r:-r, r:-r]
    assert d.max() <= 8 and d.mean() < 1.0, (d.max(), d.mean())


@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_int8_apply_close_to_f32_on_the_interior(scale):
    """JAX's own limits for int8 vs the f32 generator (test_quant.py):
    interior |d| / max |ref| below 0.05 at most and 0.01 on average."""
    params, gen = _pair(scale)
    x = np.random.default_rng(1).uniform(-1, 1, (1, 24, 24, 3)).astype(
        np.float32)
    ours = tq.int8_inference(gen, [x])
    got = ours(T(x)).float().numpy()
    with torch.no_grad():
        ref = gen(T(x)).numpy()
    assert got.shape == ref.shape
    r = fold_min_halo(scale) * scale
    ref_i, got_i = ref[:, r:-r, r:-r], got[:, r:-r, r:-r]
    rel = np.abs(got_i - ref_i) / (np.abs(ref_i).max() + 1e-9)
    assert rel.max() < 0.05 and rel.mean() < 0.01, (rel.max(), rel.mean())


@pytest.mark.parametrize("scale", [4, 8])
def test_uint8_variant_equals_quantizing_after_the_shuffle(scale):
    _, gen = _pair(scale, blocks=2)
    x = T(_tiles()[0][:2])
    ours = tq.int8_inference(gen, [x.numpy()])
    assert ours.min_halo == fold_min_halo(scale)
    assert torch.equal(ours.uint8_variant(x), denormalize_to_uint8(ours(x)))
    pre_shuffle = ours._upfold(ours._trunk(x))
    assert torch.equal(pixel_shuffle(denormalize_to_uint8(pre_shuffle),
                                     scale),
                       denormalize_to_uint8(ours(x)))


def test_default_calib_tiles_match_jax_bitwise():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (40, 52, 3), dtype=np.uint8),
            rng.integers(0, 256, (130, 97, 3), dtype=np.uint8),
            rng.integers(0, 256, (20, 150, 3), dtype=np.uint8)]
    for kw in ({}, {"tile": 32, "max_tiles": 5, "seed": 4}):
        got, want = tq.default_calib_tiles(imgs, **kw), \
            jq.default_calib_tiles(imgs, **kw)
        assert len(got) == len(want) == 1
        assert got[0].dtype == want[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])


def test_quant_fold_is_auto_by_scale():
    """The upfold is int8 from x8 up, bf16 below (JAX's auto rule); an
    explicit ``quant_fold`` wins both ways."""
    for scale, want_int8 in ((2, False), (4, False), (8, True)):
        _, gen = _pair(scale, blocks=2, ch=8)
        tiles = _tiles(n=2, tile=16)
        assert isinstance(tq.int8_inference(gen, tiles).upfold,
                          dict) == want_int8
        assert isinstance(tq.int8_inference(gen, tiles,
                                            quant_fold=not want_int8).upfold,
                          dict) == (not want_int8)


def _demo(name, scale, tmp_path):
    """A demo checkpoint as the JAX params and the port's generator, the
    latter through the user's path: pesr_tpu.convert's .pth."""
    from pesr_tpu.convert import save_generator_torch
    from pesr_tpu.training.checkpoint import restore_generator_params
    params, _ = restore_generator_params(os.path.join(_REPO, "demo", name))
    pth = str(tmp_path / f"{name}.pth")
    save_generator_torch(params, scale, pth)
    gen = Generator(scale, 8, 64, device="cpu", seed=None)
    gen.load_state_dict(load_generator_pth(pth, 8, scale))
    return params, gen


@pytest.mark.parametrize("name,scale", [("checkpoint", 4),
                                        ("checkpoint_x8", 8)])
def test_demo_checkpoint_int8_psnr_matches_jax(name, scale, tmp_path):
    """Two synthetic eval images: the port's int8 PSNR within 0.02 dB of
    JAX's int8 and within 0.05 dB of the port's bf16 folded path, all
    through the batch engines at the CLI's auto tiling."""
    from pesr_tpu.data.datasets import SyntheticImages, \
        host_bicubic_downsample
    params, gen = _demo(name, scale, tmp_path)
    src = SyntheticImages(num_images=2, seed=1)
    hrs = [src.get(i) for i in range(2)]
    lrs = [host_bicubic_downsample(h, scale) for h in hrs]
    tiles = tq.default_calib_tiles(lrs)

    def psnr(srs):
        return float(np.mean([calc_psnr(sr, hr, crop_border=scale)
                              for sr, hr in zip(srs, hrs)]))

    def ours(apply_fn):
        eng = BatchTiledUpscaler(apply_fn, scale, "auto", 8, device="cpu")
        return psnr(eng.upscale_many(lrs, 2))

    japply, jv = jq.int8_inference(params, scale, jq.default_calib_tiles(
        lrs))
    jeng = jtiling.BatchTiledUpscaler(japply, jv, scale, "auto", 8)
    p_jax = psnr(jeng.upscale_many(lrs, 2))
    p_int8 = ours(tq.int8_inference(gen, tiles))
    p_bf16 = ours(KernelApply(gen, fold=True))
    assert abs(p_int8 - p_jax) <= 0.02, (p_int8, p_jax)
    assert abs(p_int8 - p_bf16) <= 0.05, (p_int8, p_bf16)


@pytest.mark.slow
@pytest.mark.parametrize("name,scale,want", [("checkpoint", 4, 44.09),
                                             ("checkpoint_x8", 8, 41.63)])
def test_demo_checkpoint_int8_on_the_synthetic_set(name, scale, want,
                                                   tmp_path):
    """demo/README.md's int8 W8A8 numbers (44.09 dB at x4, 41.63 at x8)
    through ``python -m pesr_torch.test --quant int8`` on the full
    synthetic set, within 0.05 dB."""
    from pesr_torch import test as cli
    from pesr_tpu.convert import save_generator_torch
    from pesr_tpu.training.checkpoint import restore_generator_params
    params, _ = restore_generator_params(os.path.join(_REPO, "demo", name))
    pth = str(tmp_path / "g.pth")
    save_generator_torch(params, scale, pth)
    res = cli.run(["--dataset", "synthetic", "--model_path", pth, "--scale",
                   str(scale), "--num_blocks", "8", "--num_channels", "64",
                   "--device", "cpu", "--quant", "int8", "--output_dir",
                   str(tmp_path)])
    assert res["precision"] == "int8-w8a8"
    assert abs(res["psnr"] - want) <= 0.05, res
