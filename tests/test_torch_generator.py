"""The port's Generator and kernel apply against the JAX generator, on the
CPU: JAX ``Generator.init`` -> numpy -> ``state_dict_from_jax`` -> the
port, on identical inputs made with numpy.  Both sides compute in
float32 (atol 3e-5: a few blocks of f32 convs summed in a different
order, outputs O(1))."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pesr_tpu.convert import export_torch_generator, save_generator_torch
from pesr_tpu.models import Generator as JaxGenerator
from pesr_torch.convert import (generator_conv_names, load_generator_pth,
                                state_dict_from_jax)
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply

BLOCKS, CH = 2, 8


def _jax_params(scale, seed=0, blocks=BLOCKS, ch=CH):
    gen = JaxGenerator(scale=scale, num_blocks=blocks, num_channels=ch,
                       dtype=jnp.float32)
    params = gen.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))
    return gen, jax.tree_util.tree_map(np.asarray, params["params"])


def _port(params, scale, blocks=BLOCKS, ch=CH):
    gen = Generator(scale, blocks, ch, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(params, scale), strict=True)
    return gen


def _lr(seed, shape=(2, 9, 11, 3)):
    return np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_port_generator_matches_jax_generator(scale):
    jgen, params = _jax_params(scale, seed=scale)
    x = _lr(scale)
    ref = np.asarray(jgen.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = _port(params, scale)(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, 9 * scale, 11 * scale, 3)
    np.testing.assert_allclose(ours, ref, atol=3e-5)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_kernel_apply_on_cpu_equals_plain_generator(scale):
    gen = Generator(scale, BLOCKS, CH, device="cpu", seed=scale)
    x = torch.from_numpy(_lr(10 + scale))
    apply_fn = KernelApply(gen, torch.float32)
    with torch.no_grad():
        ref = gen(x)
    got = apply_fn(x)
    # same f32 convs; only the NHWC/NCHW layout of the calls differs
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    assert apply_fn.forwards == 1
    # the default bf16 path stays within bf16 rounding of the f32 chain
    got16 = KernelApply(gen)(x)
    assert got16.dtype == torch.float32
    assert float((got16 - ref).abs().max()) < 5e-2


def test_state_dict_keys_match_export_torch_generator():
    _, params = _jax_params(4)
    exported = export_torch_generator(params, 4)
    port_sd = Generator(4, BLOCKS, CH, device="cpu").state_dict()
    assert list(port_sd) == list(exported)
    assert list(port_sd) == [f"{n}.{k}" for n in
                             generator_conv_names(BLOCKS, 4)
                             for k in ("weight", "bias")]
    for k, v in exported.items():
        assert tuple(port_sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(
            state_dict_from_jax(params, 4)[k].numpy(), v)


def test_pth_from_save_generator_torch_loads_strict(tmp_path):
    _, params = _jax_params(4, seed=1)
    path = str(tmp_path / "g.pth")
    save_generator_torch(params, 4, path)
    gen = Generator(4, BLOCKS, CH, device="cpu", seed=None)
    gen.load_state_dict(load_generator_pth(path, BLOCKS, 4), strict=True)
    np.testing.assert_array_equal(
        gen.state_dict()["body.1.body.2.weight"].numpy(),
        np.asarray(params["body"]["block"]["conv2"]["kernel"][1]
                   ).transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="expected .* convs"):
        load_generator_pth(path, BLOCKS + 1, 4)


def test_random_init_is_seeded_and_lecun_scaled():
    a = Generator(2, 1, 16, device="cpu", seed=3).state_dict()
    b = Generator(2, 1, 16, device="cpu", seed=3).state_dict()
    c = Generator(2, 1, 16, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.0.weight"], c["head.0.weight"])
    w = a["body.0.body.0.weight"]
    assert abs(float(w.std()) * (16 * 9) ** 0.5 - 1.0) < 0.1
    assert float(w.abs().max()) <= 2 / 0.8796 / (16 * 9) ** 0.5 + 1e-6
    assert float(a["body.0.body.0.bias"].abs().max()) == 0.0
