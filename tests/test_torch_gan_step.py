"""The port's GAN step (``make_gan_step``) against the JAX package's, on
the CPU.

A tiny generator (2 blocks x 8 channels, x2), a tiny discriminator
(channels 4, 8, 8, 8, dense 16) and the VGG-19 trunk are initialised by
the JAX package and carried into the port with the converters; both
sides then take the same GAN steps on the same numpy batches in f32, at
the training default LR (1e-4, halved after the first step), the
penalty's ``eps`` drawn by JAX and passed to the port.  After each of two
steps the metrics, the G and D gradients, both Adams' moments and the
parameters are compared with the L1 pretrain step's tolerances
(tests/test_torch_training.py): losses atol 1e-6, rtol 1e-5, PSNR atol
1e-4; gradients atol 1e-6, rtol 1e-4; parameters 2e-6, except where the
gradients differ by more than 0.1% (at most 1% of the elements), which
Adam may move by up to 2 lr per step.  The reference gradients are
JAX's: the D loss at the step's D on the step's detached SR, and the G
loss against the D that JAX's step returned (the updated one).

What the discriminator adds, and how the checks take it:

* ``alpha_vgg`` is 1, as in the JAX package's own GAN-step tests
  (tests/test_training.py).  The L1 distance of VGG54 features is
  piecewise linear in SR, so its gradient jumps where SR crosses a kink;
  the two sides' SR differ by f32 rounding (~7e-7), which moved G's
  gradient by up to 6.5e-5 at ``alpha_vgg`` 50 (0.3% of the VGG term's
  gradient).  At 1 the jump is ~1.3e-6 while the VGG term is still ~40x
  the rtol of the tensors it feeds.
* Some of D's gradients are 0 by symmetry (a conv bias that a norm
  follows; a bias that shifts every logit alike, which the relativistic
  losses cancel), so both sides hold rounding noise of either sign
  there.  Such elements (reference within the gradient atol of 0) may
  move by 2 lr like the uncertain ones, and are not counted in the 1%.
* With the gradient penalty, D's gradients are O(1) sums of a double
  backward: each f32 side strays from float64 by up to ~3e-6 there, so
  D's gradients take the penalty's atol of
  tests/test_torch_gan_models.py (2e-5).
* Adam's moments are held to the error the gradients' tolerance implies
  through its averages (b1 0.9, b2 0.999), plus rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu import config as jax_config
from pesr_tpu import losses as jax_losses
from pesr_tpu.models import Discriminator as JaxDiscriminator
from pesr_tpu.models import VGG19Features as JaxVGG
from pesr_tpu.training import loop as jax_loop
from pesr_tpu.training import state as jax_state
from pesr_tpu.training import steps as jax_steps
from pesr_torch.config import Opts
from pesr_torch.convert import (discriminator_state_dict_from_jax,
                                state_dict_from_jax, vgg_state_dict_from_jax)
from pesr_torch.models.discriminator import Discriminator
from pesr_torch.models.generator import Generator
from pesr_torch.models.vgg import VGG19Features
from pesr_torch.training import steps
from pesr_torch.training.state import (add_discriminator,
                                       create_generator_state, make_ema)

T = torch.from_numpy
CPU = torch.device("cpu")
ARCH = dict(scale=2, num_blocks=2, num_channels=8)
D_KW = dict(channel_schedule=(4, 8, 8, 8), dense_features=16)
BATCH, PATCH = 4, 16          # HR 32: the last D norm sees 2 x 2 x 4 values
LR0 = 1e-4


def _jax_init(model, seed, shape):
    """``model.init`` under jit at the JAX package's init shapes
    (``create_*_state``, ``init_vgg_params``): the same params, without
    the seconds of its eager trace."""
    return jax.jit(model.init)(jax.random.key(seed),
                               jnp.zeros(shape))["params"]


def _jax_state(jo, model, seed, shape):
    return jax_state.GanTrainState.create(
        apply_fn=model.apply, params=_jax_init(model, seed, shape),
        tx=jax_state._make_tx(jo))


class Pair:
    """The same GAN train state on both sides, in f32."""

    def __init__(self, **cfg):
        kw = dict(**ARCH, batch_size=BATCH, patch_size=PATCH,
                  learning_rate=LR0, lr_step=1, steps_per_epoch=1,
                  **{"alpha_vgg": 1.0, **cfg})
        self.jopts = jax_config.Opts(**kw, compute_dtype="float32")
        self.popts = Opts(**kw, compute_dtype="float32", device="cpu")
        jo, hr = self.jopts, self.jopts.hr_patch_size
        self.g = jax_loop.configure_generator_apply(
            jo, _jax_state(jo, jax_loop.build_generator(jo), 0,
                           (1, PATCH, PATCH, 3)))
        self.disc = JaxDiscriminator(spectral_norm=jo.spectral_norm,
                                     dtype=jnp.float32, **D_KW)
        self.d = _jax_state(jo, self.disc, 1, (2, hr, hr, 3))
        rng = np.random.default_rng(2)
        d_params = jax.tree_util.tree_map(np.asarray, self.d.params)
        for name, leaf in d_params.items():
            if name.startswith("bn"):
                leaf["scale"] = rng.uniform(0.5, 1.5, leaf["scale"].shape
                                            ).astype(np.float32)
                leaf["bias"] = rng.uniform(-0.3, 0.3, leaf["bias"].shape
                                           ).astype(np.float32)
        self.d = self.d.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                              d_params))
        self.vgg = JaxVGG(layer=jo.vgg_layer, dtype=jnp.float32)
        self.vgg_params = _jax_init(self.vgg, 3, (1, hr, hr, 3))
        self._ref_grads = None
        self.ema = (jax.tree_util.tree_map(jnp.copy, self.g.params)
                    if jo.ema_decay else None)
        self.jstep = jax_steps.make_gan_step(
            jo, d_apply=self.d_apply,
            vgg_apply=lambda p, x: self.vgg.apply({"params": p}, x))

        gen = Generator(**ARCH, device="cpu", seed=None)
        gen.load_state_dict(sd_g(self.g.params))
        self.state = create_generator_state(self.popts, CPU, gen)
        d = Discriminator(hr, spectral_norm=jo.spectral_norm,
                          dtype=torch.float32, device="cpu", seed=None,
                          **D_KW)
        d.load_state_dict(sd_d(self.d.params, hr))
        add_discriminator(self.state, self.popts, CPU, d)
        self.state.vgg = VGG19Features(jo.vgg_layer, torch.float32,
                                       device="cpu", seed=None)
        self.state.vgg.load_state_dict(vgg_state_dict_from_jax(
            jax.device_get(self.vgg_params)))
        if jo.ema_decay:
            self.state.ema = make_ema(gen)
        self.pstep = steps.make_gan_step(self.popts)

    def d_apply(self, p, x):
        return self.disc.apply({"params": p}, x)

    def eps(self, key):
        """The penalty's eps as JAX's step draws it, in the port's layout
        (microbatch i takes eps[i::A])."""
        a = max(1, self.jopts.grad_accum)
        if a == 1:
            return np.array(jax.random.uniform(key, (BATCH, 1, 1, 1)))
        full = np.zeros((BATCH, 1, 1, 1), np.float32)
        for i, k in enumerate(jax.random.split(key, a)):
            full[i::a] = np.asarray(jax.random.uniform(
                k, (BATCH // a, 1, 1, 1)))
        return full

    def reference_grads(self, g_params, d_params, d_new, lr, hr, key):
        """JAX's D gradients at ``d_params`` and G gradients against
        ``d_new``, microbatched as its step."""
        jo = self.jopts
        a = max(1, jo.grad_accum)
        if self._ref_grads is None:
            self._ref_grads = self._reference_fns()
        d_grad, g_grad = self._ref_grads
        keys = [key] if a == 1 else list(jax.random.split(key, a))
        lrs = jax_steps._microbatches(jnp.asarray(lr), a)
        hrs = jax_steps._microbatches(jnp.asarray(hr), a)
        dg = gg = None
        for i in range(a):
            d_i = d_grad(d_params, g_params, lrs[i], hrs[i], keys[i])
            g_i = g_grad(g_params, d_new, lrs[i], hrs[i])
            dg = d_i if dg is None else jax.tree_util.tree_map(jnp.add, dg,
                                                               d_i)
            gg = g_i if gg is None else jax.tree_util.tree_map(jnp.add, gg,
                                                               g_i)
        return (sd_d(jax.tree_util.tree_map(lambda t: t / a, dg),
                     jo.hr_patch_size),
                sd_g(jax.tree_util.tree_map(lambda t: t / a, gg)))

    def _reference_fns(self):
        """Jitted gradients of one microbatch: the D loss in D's params
        (on G's detached SR) and the G loss in G's params."""
        jo = self.jopts
        fns = jax_losses.gan_losses(jo.gan_type,
                                    jo.fl_gamma if jo.focal_loss else 0.0)
        g_apply = self.g.apply_fn

        def vgg_apply(x):
            return self.vgg.apply({"params": self.vgg_params}, x)

        def d_loss(dp, gp_, lr_mb, hr_mb, k):
            sr = jax.lax.stop_gradient(g_apply({"params": gp_}, lr_mb))
            loss = fns["d"](self.d_apply(dp, hr_mb), self.d_apply(dp, sr))
            if jo.use_gp:
                loss = loss + 10.0 * jax_losses.gradient_penalty(
                    lambda x: self.d_apply(dp, x), hr_mb, sr, k)
            return loss

        def g_loss(gp_, dp, lr_mb, hr_mb):
            sr = g_apply({"params": gp_}, lr_mb)
            total = (jo.alpha_gan * fns["g"](self.d_apply(dp, hr_mb),
                                             self.d_apply(dp, sr))
                     + jo.alpha_tv * jax_losses.tv_loss(sr))
            if jo.alpha_vgg > 0:
                total = total + jo.alpha_vgg * jax_losses.perceptual_loss(
                    vgg_apply(sr), jax.lax.stop_gradient(vgg_apply(hr_mb)))
            return total

        return jax.jit(jax.grad(d_loss)), jax.jit(jax.grad(g_loss))

    def jax_step(self, lr, hr, key):
        args = (jnp.asarray(lr), jnp.asarray(hr), key)
        if self.ema is not None:
            self.g, self.d, self.ema, m = self.jstep(
                self.g, self.d, self.vgg_params, self.ema, *args)
        else:
            self.g, self.d, m = self.jstep(self.g, self.d, self.vgg_params,
                                           *args)
        return {k: float(v) for k, v in m.items()}


def sd_g(tree):
    return state_dict_from_jax(jax.device_get(tree), ARCH["scale"])


def sd_d(tree, hr=PATCH * ARCH["scale"]):
    return discriminator_state_dict_from_jax(jax.device_get(tree), hr)


def batch(seed):
    rng = np.random.default_rng(seed)
    hr = PATCH * ARCH["scale"]
    return (rng.uniform(-1, 1, (BATCH, PATCH, PATCH, 3)).astype(np.float32),
            rng.uniform(-1, 1, (BATCH, hr, hr, 3)).astype(np.float32))


def _check_net(net, optimizer, want_grads, mu, nu, want_params, track,
               lr_sum, grad_atol=1e-6):
    """Gradients, Adam's moments and parameters of ``net`` after a step.
    ``track`` carries, per parameter, what earlier steps of the run
    allow: the moments' error bounds and the elements Adam may move by
    up to 2 lr per step."""
    for name, p in net.named_parameters():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        w = want_grads[name].numpy()
        np.testing.assert_allclose(g, w, atol=grad_atol, rtol=1e-4,
                                   err_msg=name)
        t = track.setdefault(name, {"uncertain": False, "noise": False,
                                    "mu": 0.0, "nu": 0.0})
        # Adam follows the sign of g at first: where two gradients differ
        # by more than 0.1%, or the reference is within the gradient
        # tolerance of 0 (a gradient that is 0 by symmetry, such as a
        # bias that a norm or a relativistic loss cancels, leaves only
        # rounding noise of either sign), the parameters may part by 2 lr.
        t["uncertain"] = t["uncertain"] | (np.abs(g - w) > 1e-3 * np.abs(w))
        t["noise"] = t["noise"] | (np.abs(w) <= grad_atol)
        # The moments' error: what the gradients' tolerance implies through
        # Adam's averages (b1 0.9, b2 0.999), plus rtol 1e-4 of their own.
        tol_g = grad_atol + 1e-4 * np.abs(w)
        t["mu"] = 0.9 * t["mu"] + 0.1 * tol_g
        t["nu"] = 0.999 * t["nu"] + 1e-3 * (2 * np.abs(w) + tol_g) * tol_g
        st = optimizer.state[p]
        for key, want, bound in (("exp_avg", mu, t["mu"]),
                                 ("exp_avg_sq", nu, t["nu"])):
            ref = want[name].numpy()
            d = np.abs(st[key].numpy() - ref)
            assert (d <= bound + 1e-4 * np.abs(ref)).all(), (name, key,
                                                             d.max())
    _check_params(net, want_params, track, lr_sum)


def _check_params(net, want, track, lr_sum):
    """Parameters agree to 2e-6, except the elements ``track`` marks
    (Adam may move them by up to 2 lr per step); of the elements whose
    gradient is not noise, at most 1% may be so marked."""
    counted = sum((track[n]["uncertain"] & ~track[n]["noise"]).sum()
                  for n, _ in net.named_parameters())
    share = counted / sum(p.numel() for p in net.parameters())
    assert share <= 0.01, share
    for name, p in net.named_parameters():
        free = track[name]["uncertain"] | track[name]["noise"]
        tol = 2e-6 + np.where(free, 2 * lr_sum, 0.0)
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert (d <= tol).all(), (name, d.max())


CASES = {
    "RSGAN": {},
    "RaSGAN": dict(gan_type="RaSGAN"),
    "GP+SN": dict(use_gp=True, spectral_norm=True),
    "EMA": dict(ema_decay=0.9),
    "accum2": dict(grad_accum=2),
    "fold_train": dict(fold_train=True),
}


def run_case(case):
    """Two steps of ``CASES[case]`` on both sides, every check after each
    (the cases are split between this file,
    tests/test_torch_gan_step_more.py and tests/test_torch_fold_train.py,
    so that each stays short)."""
    pair = Pair(**CASES[case])
    d_atol = 2e-5 if pair.jopts.use_gp else 1e-6
    st = pair.state
    ug, ud = {}, {}
    lr_sum = 0.0
    for k in range(2):
        lr, hr = batch(k)
        key = jax.random.key(10 + k)
        # the JAX step donates its states: keep copies of the params
        g_before, d_before = jax.tree_util.tree_map(
            jnp.copy, (pair.g.params, pair.d.params))
        want = pair.jax_step(lr, hr, key)
        dg, gg = pair.reference_grads(g_before, d_before, pair.d.params, lr,
                                      hr, key)
        got = pair.pstep(st, T(lr), T(hr), T(pair.eps(key)))
        assert st.step == k + 1
        assert sorted(got) == sorted(want)
        for name, v in want.items():
            tol = (dict(atol=1e-4) if name == "psnr"
                   else dict(atol=1e-6, rtol=1e-5))
            np.testing.assert_allclose(float(got[name]), v, err_msg=name,
                                       **tol)
        used = st.d_optimizer.param_groups[0]["lr"]
        assert used == st.optimizer.param_groups[0]["lr"]
        assert used == pytest.approx(LR0 * 0.5 ** k)
        lr_sum += used
        adam = pair.g.opt_state[0]
        _check_net(st.generator, st.optimizer, gg, sd_g(adam.mu),
                   sd_g(adam.nu), sd_g(pair.g.params), ug, lr_sum)
        adam = pair.d.opt_state[0]
        _check_net(st.discriminator, st.d_optimizer, dg, sd_d(adam.mu),
                   sd_d(adam.nu), sd_d(pair.d.params), ud, lr_sum, d_atol)
        if pair.ema is not None:
            _check_params(st.ema, sd_g(pair.ema), ug,
                          (1 - pair.jopts.ema_decay) * lr_sum)
    return pair


@pytest.mark.parametrize("case", ["RSGAN", "RaSGAN", "EMA"])
def test_two_gan_steps_match_jax(case):
    run_case(case)
