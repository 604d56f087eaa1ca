"""The port's folded upsampler (``pesr_torch/models/fold.py`` and the
folded ``KernelApply``) against the JAX package's, on the CPU.

Weights are the JAX init carried across with ``state_dict_from_jax``;
both sides compute in float32.  Tolerances:

* fold kernels and biases: atol 1e-5 (x |kernel| max, >= 1): each tap is
  a sum of a few hundred products of O(0.1) weights in another summation
  order;
* applies: atol 2e-5 on outputs of O(1), JAX's own fold tolerance;
* uint8 engine outputs: at most 1 LSB on fewer than 0.1% of the values,
  where a value sits within float32 summation noise of a rounding tie
  (x.5 LSB); a grid, halo or crop fault shows as tens of LSB.  Within the
  port (one set of float values) uint8 results are compared bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu.models import Generator as JaxGenerator
from pesr_tpu.models import fold as jfold
from pesr_tpu.ops import tiling as jtiling
from pesr_torch.convert import state_dict_from_jax
from pesr_torch.data.augment import denormalize_to_uint8, normalize_uint8
from pesr_torch.models.fold import (analytic_fold_upsampler, fold_upsampler,
                                    tail_params)
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.ops.tiling import BatchTiledUpscaler, WholeImageUpscaler
from pesr_torch.scales import fold_min_halo

T = torch.from_numpy


def _pair(scale, seed=0, blocks=2, ch=8):
    jgen = JaxGenerator(scale=scale, num_blocks=blocks, num_channels=ch,
                        dtype=jnp.float32)
    variables = jgen.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    gen = Generator(scale, blocks, ch, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(params, scale))
    return jgen, variables, gen


def _oihw(k_hwio):
    return np.asarray(k_hwio).transpose(3, 2, 0, 1)


def _assert_fold(got, want):
    (k, b, pads), (wk, wb, wpads) = got, want
    tol = 1e-5 * max(1.0, float(np.abs(wk).max()))
    assert pads == tuple(wpads)
    np.testing.assert_allclose(k.numpy(), _oihw(wk), atol=tol)
    np.testing.assert_allclose(b.numpy(), np.asarray(wb), atol=tol)


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 8])
def test_probe_fold_matches_jax(scale):
    _, variables, gen = _pair(scale)
    got = fold_upsampler(gen.state_dict(), scale)
    assert got[0].dtype == torch.float32
    _assert_fold(got, jfold.fold_upsampler(variables["params"], scale))


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 6])
def test_analytic_fold_matches_jax_and_the_probe(scale):
    _, variables, gen = _pair(scale, seed=1)
    p = variables["params"]
    up, out = tail_params(gen.state_dict(), scale)
    got = analytic_fold_upsampler(up, out, scale)
    _assert_fold(got, jfold.analytic_fold_upsampler(p.get("upsampler", {}),
                                                    p["out"], scale))
    _assert_fold(got, jfold.fold_upsampler(p, scale))


def test_probe_fold_in_float64_for_float64_weights():
    _, variables, gen = _pair(4)
    sd64 = {k: v.double() for k, v in gen.state_dict().items()}
    k, b, pads = fold_upsampler(sd64, 4)
    assert k.dtype == b.dtype == torch.float64
    _assert_fold((k.float(), b.float(), pads),
                 jfold.fold_upsampler(variables["params"], 4))


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_analytic_fold_gradients_match_jax_grad(scale):
    """Gradients of a random linear functional of (kernel, bias) w.r.t.
    the upsampler and out weights and biases, against ``jax.grad`` of the
    same functional of JAX's analytic fold: atol 1e-5 x max |grad|."""
    _, variables, gen = _pair(scale, seed=2)
    p = variables["params"]
    ck, cb, _ = jfold.analytic_fold_upsampler(p["upsampler"], p["out"],
                                              scale)
    rng = np.random.default_rng(scale)
    rk = rng.standard_normal(ck.shape).astype(np.float32)
    rb = rng.standard_normal(cb.shape).astype(np.float32)

    def jloss(up, out):
        k, b, _ = jfold.analytic_fold_upsampler(up, out, scale)
        return jnp.sum(k * rk) + jnp.sum(b * rb)

    jg_up, jg_out = jax.grad(jloss, argnums=(0, 1))(p["upsampler"], p["out"])
    sd = {k: v.clone().requires_grad_() for k, v in gen.state_dict().items()}
    up, out = tail_params(sd, scale)
    k, b, _ = analytic_fold_upsampler(up, out, scale)
    loss = (k * T(_oihw(rk))).sum() + (b * T(rb)).sum()
    loss.backward()
    want = {"tail.1.weight": _oihw(jg_out["kernel"]),
            "tail.1.bias": jg_out["bias"]}
    for i in range(len(up)):
        want[f"tail.0.{2 * i}.weight"] = _oihw(jg_up[f"conv{i}"]["kernel"])
        want[f"tail.0.{2 * i}.bias"] = jg_up[f"conv{i}"]["bias"]
    for name, w in want.items():
        w = np.asarray(w)
        g = sd[name].grad.numpy()
        assert np.any(g != 0), name
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_folded_apply_matches_jax_make_folded_apply(scale):
    """The whole output, borders included (both zero-pad the folded conv
    once); and the interior equals the plain chain."""
    jgen, variables, gen = _pair(scale, seed=3)
    fn, fvars = jfold.folded_inference(variables["params"], scale,
                                       dtype=jnp.float32)
    x = np.random.default_rng(scale).uniform(
        -1, 1, (2, 13, 11, 3)).astype(np.float32)
    want = np.asarray(fn(fvars, x))
    ours = KernelApply(gen, torch.float32, fold=True)
    assert ours.min_halo == fn.min_halo == fold_min_halo(scale)
    got = ours(T(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert ours.forwards == 1
    r = fold_min_halo(scale) * scale
    chain = gen(T(x)).detach().numpy()
    np.testing.assert_allclose(got[:, r:-r, r:-r], chain[:, r:-r, r:-r],
                               atol=2e-5)
    assert np.abs(got - chain).max() > 1e-3   # the border band differs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_uint8_variant_equals_the_denormalized_float_apply(dtype):
    _, _, gen = _pair(4, seed=4)
    apply_fn = KernelApply(gen, dtype, fold=True)
    img = np.random.default_rng(0).integers(0, 256, (2, 10, 12, 3),
                                            dtype=np.uint8)
    x = normalize_uint8(T(img))
    u8 = apply_fn.uint8_variant(x)
    assert u8.dtype == torch.uint8
    assert torch.equal(u8, denormalize_to_uint8(apply_fn(x)))
    assert apply_fn.forwards == 2
    assert KernelApply(gen, dtype).uint8_variant is None


def _u8_close(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d > 0) < 1e-3


# (scale, h, w, tile, batch): a multi-tile grid, a single tile per image
# (its borders padded only by the fold's min_halo), "auto", a tile smaller
# than min_halo's pad would need.
@pytest.mark.parametrize("scale,h,w,tile,batch", [
    (4, 30, 44, 16, 2), (4, 24, 30, (24, 30), 2), (2, 19, 33, "auto", 1),
    (3, 17, 20, 8, 1)])
def test_folded_batch_engine_matches_jax(scale, h, w, tile, batch):
    _, variables, gen = _pair(scale, seed=5)
    fn, fvars = jfold.folded_inference(variables["params"], scale,
                                       dtype=jnp.float32)
    imgs = np.random.default_rng(h).integers(0, 256, (batch, h, w, 3),
                                             dtype=np.uint8)
    want = jtiling.BatchTiledUpscaler(fn, fvars, scale, tile_size=tile,
                                      overlap=8).upscale_batch(imgs)
    eng = BatchTiledUpscaler(KernelApply(gen, torch.float32, fold=True),
                             scale, tile, 8, device="cpu")
    assert eng.min_halo == fold_min_halo(scale)
    got = eng.upscale_batch(imgs)
    assert got.shape == want.shape == (batch, h * scale, w * scale, 3)
    _u8_close(got, want)


def test_folded_whole_image_engine_pads_the_fold_band():
    """Whole-image mode pads and crops min_halo: equal to JAX's engine,
    and bit for bit to the port's single-tile engine."""
    _, variables, gen = _pair(4, seed=6)
    fn, fvars = jfold.folded_inference(variables["params"], 4,
                                       dtype=jnp.float32)
    img = np.random.default_rng(6).integers(0, 256, (20, 26, 3),
                                            dtype=np.uint8)
    apply_fn = KernelApply(gen, torch.float32, fold=True)
    whole = WholeImageUpscaler(apply_fn, 4, device="cpu")
    assert whole.min_halo == 3
    got = whole.upscale(img)
    _u8_close(got, jtiling.WholeImageUpscaler(fn, fvars, 4).upscale(img))
    single = BatchTiledUpscaler(apply_fn, 4, (20, 26), 8, device="cpu")
    np.testing.assert_array_equal(got, single.upscale_batch(img[None])[0])
    # the float path (self-ensemble branches) rounds to the same pixels
    np.testing.assert_array_equal(
        np.clip(np.floor(whole.upscale_float(img) + 0.5), 0, 255), got)
