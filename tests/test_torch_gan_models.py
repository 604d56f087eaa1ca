"""The GAN phase's networks and losses in the port against the JAX package,
on the CPU.

JAX initialises each network (f32); the weights go into the port through
``discriminator_state_dict_from_jax`` / ``vgg_state_dict_from_jax``, and
the same numpy inputs go through both.  Tolerances: D logits atol 5e-5
(as tests/test_convert.py holds converted discriminators: 8 convs and 2
dense layers of f32 in another summation order); VGG features rtol 1e-5
of the largest feature; losses and their gradients atol 1e-6, rtol 1e-5
(a few f32 reductions).  The gradient penalty is a function of D's input
gradient and differentiates D twice: its value and its gradients into
D's parameters are held to the kernels' gradient tolerance (atol 2e-5,
rtol 1e-4, tests/test_torch_train_ops.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from pesr_tpu import losses as jax_losses
from pesr_tpu.convert import load_discriminator_weights, load_vgg_weights
from pesr_tpu.models import Discriminator as JaxDiscriminator
from pesr_tpu.models import VGG19Features as JaxVGG
from pesr_tpu.models.discriminator import _spectral_normalize
from pesr_torch import losses
from pesr_torch.config import Opts
from pesr_torch.convert import (discriminator_state_dict_from_jax,
                                load_discriminator_pth, load_vgg19_pth,
                                vgg_state_dict_from_jax)
from pesr_torch.models.discriminator import Discriminator, spectral_normalize
from pesr_torch.models.vgg import VGG19Features
from pesr_torch.training import checkpoint as ckpt
from pesr_torch.training.state import add_discriminator, create_generator_state

T = torch.from_numpy
CPU = torch.device("cpu")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_D = dict(channel_schedule=(4, 8, 8, 8), dense_features=16)
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def jax_discriminator(hr, sn=False, seed=0, **kw):
    """A JAX D (f32) with its params as numpy; the norm scales and biases
    are randomised, so a mapping error cannot hide behind ones and
    zeros."""
    kw = kw or TINY_D
    disc = JaxDiscriminator(spectral_norm=sn, dtype=jnp.float32, **kw)
    params = jax.tree_util.tree_map(np.asarray, disc.init(
        jax.random.key(seed), jnp.zeros((2, hr, hr, 3)))["params"])
    rng = np.random.default_rng(seed + 100)
    for name, leaf in params.items():
        if name.startswith("bn"):
            leaf["scale"] = rng.uniform(0.5, 1.5, leaf["scale"].shape
                                        ).astype(np.float32)
            leaf["bias"] = rng.uniform(-0.3, 0.3, leaf["bias"].shape
                                       ).astype(np.float32)
    return disc, params


def port_discriminator(params, hr, sn=False, **kw):
    kw = kw or TINY_D
    d = Discriminator(hr, spectral_norm=sn, dtype=torch.float32,
                      device="cpu", seed=None, **kw)
    d.load_state_dict(discriminator_state_dict_from_jax(params, hr),
                      strict=True)
    return d


@pytest.mark.parametrize("sn", [False, True])
def test_discriminator_logits_match_jax(sn):
    hr = 32
    disc, params = jax_discriminator(hr, sn)
    d = port_discriminator(params, hr, sn)
    x = _images(1, (4, hr, hr, 3))
    want = np.asarray(disc.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = d(T(x))
    assert got.dtype == torch.float32 and got.shape == (4, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_discriminator_normalises_with_the_batch_it_is_given():
    """No running statistics: D on a batch is not D on its halves."""
    hr = 16
    _, params = jax_discriminator(hr)
    d = port_discriminator(params, hr)
    x = T(_images(2, (4, hr, hr, 3)))
    with torch.no_grad():
        whole = d(x)
        halves = torch.cat([d(x[:2]), d(x[2:])])
    assert not torch.allclose(whole, halves, atol=1e-3)
    assert not any(n.endswith(("running_mean", "running_var"))
                   for n in d.state_dict())


def test_spectral_normalize_matches_jax():
    w = np.random.default_rng(3).standard_normal((3, 3, 8, 16)).astype(
        np.float32)
    want = np.asarray(_spectral_normalize(jnp.asarray(w)))
    got = spectral_normalize(T(w).permute(3, 2, 0, 1))
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), want,
                               atol=1e-6, rtol=1e-5)


def _jax_vgg(layer, hr=32):
    vgg = JaxVGG(layer=layer, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, vgg.init(
        jax.random.key(4), jnp.zeros((1, hr, hr, 3)))["params"])
    return vgg, params


@pytest.mark.parametrize("layer", ["22", "54"])
def test_vgg_features_match_jax(layer):
    vgg, params = _jax_vgg(layer)
    ours = VGG19Features(layer, torch.float32, device="cpu", seed=None)
    ours.load_state_dict(vgg_state_dict_from_jax(params), strict=True)
    assert not any(p.requires_grad for p in ours.parameters())
    x = _images(5, (2, 32, 32, 3))
    want = np.asarray(vgg.apply({"params": params}, jnp.asarray(x)))
    got = ours(T(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_vgg_passes_gradients_to_its_input():
    ours = VGG19Features("22", torch.float32, device="cpu", seed=0)
    x = T(_images(6, (1, 16, 16, 3))).requires_grad_()
    ours(x).square().sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    assert all(p.grad is None for p in ours.parameters())


def test_vgg_rejects_an_unknown_layer():
    with pytest.raises(ValueError, match="not in the VGG-19 trunk"):
        VGG19Features("61", device="cpu")


@pytest.mark.parametrize("focal", [0.0, 2.0])
@pytest.mark.parametrize("gan_type",
                         ["GAN", "LSGAN", "RSGAN", "RaSGAN", "RaLSGAN"])
def test_gan_losses_and_their_gradients_match_jax(gan_type, focal):
    rng = np.random.default_rng(7)
    dr = rng.normal(0.5, 2.0, (6, 1)).astype(np.float32)
    df = rng.normal(-0.5, 2.0, (6, 1)).astype(np.float32)
    jfns = jax_losses.gan_losses(gan_type, focal)
    fns = losses.gan_losses(gan_type, focal)
    for side in ("d", "g"):
        want, (wr, wf) = jax.value_and_grad(jfns[side], argnums=(0, 1))(
            jnp.asarray(dr), jnp.asarray(df))
        a, b = T(dr).requires_grad_(), T(df).requires_grad_()
        got = fns[side](a, b)
        ga, gb = torch.autograd.grad(got, (a, b), allow_unused=True,
                                     materialize_grads=True)
        np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
        np.testing.assert_allclose(ga.numpy(), np.asarray(wr), **LOSS_TOL)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wf), **LOSS_TOL)


def test_unknown_gan_type_raises():
    with pytest.raises(ValueError, match="unknown gan_type"):
        losses.gan_losses("WGAN")


def test_tv_and_perceptual_losses_match_jax():
    x = _images(8, (2, 9, 7, 3))
    y = _images(9, (2, 9, 7, 3))
    want, wgrad = jax.value_and_grad(jax_losses.tv_loss)(jnp.asarray(x))
    t = T(x).requires_grad_()
    got = losses.tv_loss(t)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(wgrad), **LOSS_TOL)
    np.testing.assert_allclose(
        float(losses.perceptual_loss(T(x), T(y))),
        float(jax_losses.perceptual_loss(jnp.asarray(x), jnp.asarray(y))),
        **LOSS_TOL)


@pytest.mark.parametrize("sn", [False, True])
def test_gradient_penalty_and_its_parameter_gradients_match_jax(sn):
    # The last norm normalises over b x (hr / 16)^2 values per channel; at
    # 16^2 and batch 3 (3 values) the double backward is so ill-conditioned
    # that either f32 side strays from float64 by up to 50% per element.
    hr, b = 32, 4
    disc, params = jax_discriminator(hr, sn, seed=2)
    d = port_discriminator(params, hr, sn)
    real, fake = _images(10, (b, hr, hr, 3)), _images(11, (b, hr, hr, 3))
    key = jax.random.key(12)
    eps = np.array(jax.random.uniform(key, (b, 1, 1, 1), jnp.float32))

    def jgp(p):
        return jax_losses.gradient_penalty(
            lambda x: disc.apply({"params": p}, x), jnp.asarray(real),
            jnp.asarray(fake), key)

    want, wgrads = jax.value_and_grad(jgp)(params)
    got = losses.gradient_penalty(d, T(real), T(fake), T(eps))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **GRAD_TOL)
    want_sd = discriminator_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, wgrads), hr)
    for name, p in d.named_parameters():
        # fc1's bias does not move the input gradient: no gradient
        got_g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got_g.numpy(), want_sd[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_discriminator_pth_is_read_by_pesr_tpu_convert(tmp_path):
    """A snapshot's discriminator.pth (SRGAN widths, dense 16 at HR 32)
    through ``pesr_tpu.convert.load_discriminator_weights``: the JAX D on
    the converted params gives the port's logits; the port's own loader
    reads it back, from the file and from the snapshot directory."""
    hr = 32
    opts = Opts(scale=2, num_blocks=1, num_channels=4, patch_size=hr // 2,
                device="cpu")
    state = create_generator_state(opts, CPU)
    d = Discriminator(hr, dense_features=16, dtype=torch.float32,
                      device="cpu", seed=5)
    with torch.no_grad():
        for name, p in d.named_parameters():
            if name.startswith("bn"):
                p.uniform_(0.5, 1.5)
    add_discriminator(state, opts, CPU, d)
    path = ckpt.save_train_ckpt(str(tmp_path), state)
    disc = JaxDiscriminator(dense_features=16, dtype=jnp.float32)
    template = disc.init(jax.random.key(0),
                         jnp.zeros((1, hr, hr, 3)))["params"]
    params = load_discriminator_weights(
        os.path.join(path, ckpt.DISCRIMINATOR), template, hr)
    x = _images(13, (2, hr, hr, 3))
    want = np.asarray(disc.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(d(T(x)).numpy(), want, atol=5e-5)
    for sd in (load_discriminator_pth(
            os.path.join(path, ckpt.DISCRIMINATOR), hr),
               ckpt.restore_discriminator_params(path, hr),
               ckpt.restore_discriminator_params(str(tmp_path), hr)):
        assert list(sd) == list(d.state_dict())
        for k, v in d.state_dict().items():
            assert torch.equal(sd[k], v), k
    with pytest.raises(ValueError, match="hr_size=64"):
        load_discriminator_pth(os.path.join(path, ckpt.DISCRIMINATOR), 64)


def _torchvision_vgg19_state_dict(seed=6):
    """A torchvision ``vgg19()``-layout state_dict: ``features.{i}`` convs
    (with ReLUs and max-pools between, as indices) and a 2-D classifier
    that the loaders skip."""
    torch.manual_seed(seed)
    layers, cin = [], 3
    for _, n, ch in ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512),
                     (5, 4, 512)):
        for _ in range(n):
            layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
            cin = ch
        layers.append(nn.MaxPool2d(2))
    model = nn.Module()
    model.features = nn.Sequential(*layers)
    model.classifier = nn.Sequential(nn.Linear(8, 4), nn.ReLU(),
                                     nn.Linear(4, 2))
    return model.state_dict()


def test_a_torchvision_vgg_pth_gives_equal_features_in_both(tmp_path):
    path = str(tmp_path / "vgg19.pth")
    torch.save(_torchvision_vgg19_state_dict(), path)
    x = _images(14, (1, 32, 32, 3))
    for layer in ("22", "54"):
        vgg, template = _jax_vgg(layer)
        params = load_vgg_weights(path, template)
        want = np.asarray(vgg.apply({"params": params}, jnp.asarray(x)))
        ours = VGG19Features(layer, torch.float32, device="cpu", seed=None)
        sd = load_vgg19_pth(path, layer)
        assert len(sd) == 2 * len(template)
        ours.load_state_dict(sd, strict=True)
        np.testing.assert_allclose(ours(T(x)).numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_vgg_loader_needs_exactly_16_convs(tmp_path):
    sd = _torchvision_vgg19_state_dict()
    sd = {k: v for k, v in sd.items() if not k.startswith("features.34")}
    path = str(tmp_path / "short.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="exactly 16"):
        load_vgg19_pth(path, "22")


def test_loaders_refuse_an_orbax_directory_with_a_hint():
    with pytest.raises(ValueError, match="orbax.*torchvision-layout"):
        load_vgg19_pth(os.path.join(_REPO, "demo", "vgg_synthetic"))
    orbax_d = os.path.join(_REPO, "demo", "checkpoint_gan")
    with pytest.raises(ValueError, match="orbax.*SRGAN-order"):
        load_discriminator_pth(orbax_d, 192)
    with pytest.raises(ValueError, match="orbax.*SRGAN-order"):
        ckpt.restore_discriminator_params(orbax_d, 192)
