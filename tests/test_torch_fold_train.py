"""Training through the folded upsampler (``--fold_train``) against the
JAX package's ``make_fold_train_apply``, on the CPU.

Weights are the JAX init carried across; both sides compute in f32.  One
and two pretrain steps and one GAN step are held to the tolerances of
tests/test_torch_training.py and tests/test_torch_gan_step.py (losses
atol 1e-6, rtol 1e-5; gradients atol 1e-6, rtol 1e-4; Adam's moments and
the parameters as there).  The folded forward zero-pads each patch once
where the chain pads every stage, so it is held to JAX's folded forward
on the whole patch and to the plain chain only on the interior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu import config as jax_config
from pesr_tpu.models.fold import make_fold_train_apply
from pesr_tpu.training import loop as jax_loop
from pesr_tpu.training import state as jax_state
from pesr_tpu.training import steps as jax_steps
from pesr_torch import train as train_cli
from pesr_torch.config import Opts, opts_from_args
from pesr_torch.models import kernel_apply
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply, KernelTrainApply
from pesr_torch.scales import fold_min_halo
from pesr_torch.training import loop, steps
from pesr_torch.training.state import create_generator_state
from test_torch_gan_step import run_case
from test_torch_training import _assert_adam_params, _batch, _to_sd

T = torch.from_numpy
CPU = torch.device("cpu")
_ARCH = dict(scale=2, num_blocks=2, num_channels=8)


def _pair(**kw):
    """JAX and port pretrain states through the fold, from the same init,
    in f32; the LR halves after every step."""
    kw = dict(**_ARCH, batch_size=4, patch_size=8, learning_rate=1e-3,
              lr_step=1, steps_per_epoch=1, fold_train=True, **kw)
    jopts = jax_config.Opts(**kw, compute_dtype="float32")
    g_state = jax_loop.configure_generator_apply(
        jopts, jax_state.create_generator_state(
            jopts, jax_loop.build_generator(jopts), jax.random.key(0)))
    gen = Generator(**_ARCH, device="cpu", seed=None)
    gen.load_state_dict(_to_sd(g_state.params))
    popts = Opts(**kw, compute_dtype="float32", device="cpu")
    return jopts, g_state, popts, create_generator_state(popts, CPU, gen)


def test_fold_train_apply_matches_jax_and_the_chain_inside():
    _, g_state, _, state = _pair()
    assert isinstance(state.apply, KernelTrainApply) and state.apply.fold
    assert state.apply.min_halo == fold_min_halo(2)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 12, 10, 3)
                                         ).astype(np.float32)
    want = np.asarray(g_state.apply_fn({"params": g_state.params}, x))
    got = state.apply(T(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)
    r = fold_min_halo(2) * 2
    chain = state.generator(T(x)).detach().numpy()
    np.testing.assert_allclose(got.detach().numpy()[:, r:-r, r:-r],
                               chain[:, r:-r, r:-r], atol=2e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_fold_train_pretrain_steps_match_jax(accum):
    jopts, g_state, popts, state = _pair(grad_accum=accum)
    jstep = jax_steps.make_pretrain_step(jopts)
    pstep = steps.make_pretrain_step(popts)
    uncertain = {n: False for n, _ in state.generator.named_parameters()}
    lr_sum = 0.0
    for k in range(2):
        lr, hr = _batch(k)

        def loss(p):
            return jnp.mean(jnp.abs(g_state.apply_fn({"params": p}, lr)
                                    - hr))

        jgrads = _to_sd(jax.grad(loss)(g_state.params))
        g_state, jm = jstep(g_state, jnp.asarray(lr), jnp.asarray(hr))
        pm = pstep(state, T(lr), T(hr))
        np.testing.assert_allclose(float(pm["l1"]), float(jm["l1"]),
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(float(pm["psnr"]), float(jm["psnr"]),
                                   atol=1e-4)
        lr_sum += state.optimizer.param_groups[0]["lr"]
        adam = g_state.opt_state[0]
        mu, nu = _to_sd(adam.mu), _to_sd(adam.nu)
        for name, p in state.generator.named_parameters():
            g = p.grad.numpy()
            # the upsampler and out weights learn through the fold
            assert np.any(g != 0), name
            np.testing.assert_allclose(g, jgrads[name].numpy(), atol=1e-6,
                                       rtol=1e-4, err_msg=name)
            uncertain[name] = uncertain[name] | (
                np.abs(g - jgrads[name].numpy())
                > 1e-3 * np.abs(jgrads[name].numpy()))
            st = state.optimizer.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(),
                                       mu[name].numpy(), atol=1e-7,
                                       rtol=1e-4, err_msg=name)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       nu[name].numpy(), atol=1e-10,
                                       rtol=1e-4, err_msg=name)
        _assert_adam_params(state.generator, _to_sd(g_state.params),
                            uncertain, lr_sum)


def test_fold_train_gan_step_matches_jax():
    pair = run_case("fold_train")
    assert pair.state.apply.fold


def test_fold_train_evaluate_matches_jax():
    """Self-validation through the folded apply: JAX's ``evaluate`` on
    its train apply (fold_train) against the port's on ``KernelApply(...,
    fold=True)``, PSNR atol 1e-3 dB, SSIM 1e-4."""
    jopts = jax_config.Opts(**_ARCH, compute_dtype="float32",
                            valid_dataset="synthetic", num_valids=2)
    params = jax_loop.build_generator(jopts).init(
        jax.random.key(2), jnp.zeros((1, 8, 8, 3)))["params"]
    want = jax_loop.evaluate(jopts,
                             make_fold_train_apply(2, dtype=jnp.float32),
                             params, compute_pi=False)
    gen = Generator(**_ARCH, device="cpu", seed=None)
    gen.load_state_dict(_to_sd(params))
    popts = Opts(**_ARCH, valid_dataset="synthetic", num_valids=2,
                 device="cpu")
    apply_fn = KernelApply(gen, torch.float32, fold=True)
    got = loop.evaluate(popts, apply_fn, compute_pi=False)
    assert apply_fn.forwards == 3
    assert got["val_psnr"] == pytest.approx(want["val_psnr"], abs=1e-3)
    assert got["val_ssim"] == pytest.approx(want["val_ssim"], abs=1e-4)


@pytest.mark.parametrize("mode,argv", [
    ("train", []), ("train", ["--fold_train"]), ("train", ["--no_fold_train"]),
    ("train", ["--phase", "train"]), ("test", []), ("test", ["--no_fold"]),
    ("test", ["--fold"])])
def test_fold_flags_resolve_as_jax_does(mode, argv):
    """``fold_train`` (train mode: on unless --no_fold_train; test mode:
    off) and ``fold`` (test mode: on unless --no_fold) as
    ``pesr_tpu.config.opts_from_args`` resolves them."""
    want = jax_config.opts_from_args(argv, mode=mode)
    got = opts_from_args(argv, mode=mode)
    assert got.fold_train == want.fold_train
    if mode == "test":
        assert got.fold == want.fold
    assert Opts().fold_train is False


def test_train_cli_folds_by_default(tmp_path, capsys, monkeypatch):
    """``python -m pesr_torch.train`` with no fold flag trains and
    validates through the fold: no upsampler stage runs; with
    --no_fold_train every forward runs the chain."""
    stages = []

    def counted(fn):
        def wrapped(*a):
            stages.append(fn.__name__)
            return fn(*a)
        return wrapped

    for name in ("fused_upsampler_stage", "fused_upsampler_stage_train"):
        monkeypatch.setattr(kernel_apply, name,
                            counted(getattr(kernel_apply, name)))
    base = ["--device", "cpu", "--num_blocks", "2", "--num_channels", "8",
            "--scale", "2", "--batch_size", "2", "--patch_size", "12",
            "--train_dataset", "synthetic", "--valid_dataset", "synthetic",
            "--num_valids", "1", "--steps_per_epoch", "3", "--num_epochs",
            "1", "--log_every", "3"]
    assert train_cli.main(base + ["--check_point", str(tmp_path / "a")]) == 0
    out = capsys.readouterr().out
    assert "generator apply: folded upsampler (--fold_train)" in out
    assert stages == [] and "val_psnr" in out
    assert train_cli.main(base + ["--no_fold_train", "--check_point",
                                  str(tmp_path / "b")]) == 0
    assert "folded upsampler" not in capsys.readouterr().out
    # one x2 stage in each of the 3 steps, then in each eval forward
    assert stages.count("fused_upsampler_stage_train") == 3
    assert stages[3:] and set(stages[3:]) == {"fused_upsampler_stage"}
