"""The port's QAT phase (``pesr_torch/models/qat.py``, ``--phase qat``)
against the JAX package's ``models/qat.py``, on the CPU, in float32.

Tolerances:

* ``fake_quant_conv`` forward: both sides quantize with the same float32
  operations and convolve integers that float32 holds exactly, so the
  outputs agree to rtol 1e-5 (they are equal here); its STE gradients
  (conv backward sums in another order) to rtol 1e-5, atol 1e-6 x their
  largest magnitude;
* the QAT apply: a head-conv value within float32 summation noise of a
  rounding boundary can land on the other integer (one quantization
  step); such flips are counted and must be at most 1e-4 of the
  quantized values, elsewhere the outputs agree to rtol 1e-5;
* one and two QAT steps: the L1 and the parameters to the tolerances of
  ``tests/test_torch_training.py`` (L1 atol 1e-6, rtol 1e-5; Adam's
  moments rtol 1e-4; parameters 2e-6 except where the two gradients
  differ by more than 0.1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu import config as jax_config
from pesr_tpu.models import qat as jqat
from pesr_tpu.training import loop as jax_loop
from pesr_tpu.training import state as jax_state
from pesr_tpu.training import steps as jax_steps
from pesr_torch import train as train_cli
from pesr_torch.config import Opts, opts_from_args
from pesr_torch.models.generator import Generator
from pesr_torch.models.qat import QatApply, fake_quant_conv
from pesr_torch.ops import kernels
from pesr_torch.training import loop, steps
from pesr_torch.training.state import create_generator_state
from test_torch_training import _assert_adam_params, _batch, _to_sd

T = torch.from_numpy
CPU = torch.device("cpu")
_ARCH = dict(scale=2, num_blocks=2, num_channels=8)


def _conv_inputs(seed, c=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 12, 10, c)).astype(np.float32)
    k = (rng.normal(0, 1, (3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)
    b = rng.normal(0, 0.1, (c,)).astype(np.float32)
    cot = rng.normal(0, 1, (2, 12, 10, c)).astype(np.float32)
    return x, k, b, cot


@pytest.mark.parametrize("seed", [0, 1])
def test_fake_quant_conv_and_its_ste_gradients_match_jax(seed):
    x, k, b, cot = _conv_inputs(seed)

    def jloss(x, k, b):
        y = jqat.fake_quant_conv(x, k, b, jnp.float32)
        return jnp.sum(y * cot), y

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(x, k, b)
    ins = [T(x).requires_grad_(), T(k.transpose(3, 2, 0, 1).copy()
                                    ).requires_grad_(), T(b).requires_grad_()]
    got = fake_quant_conv(*ins, dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
    (got * T(cot)).sum().backward()
    for t, g, name, perm in zip(ins, jgrads, ("x", "kernel", "bias"),
                                (None, (3, 2, 0, 1), None)):
        g = np.asarray(g) if perm is None else np.asarray(g).transpose(perm)
        assert np.abs(g).max() > 0, name   # the STE passes a gradient
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-6 * np.abs(g).max(), err_msg=name)


def test_fake_quant_conv_rounds_to_the_int8_grid():
    """The forward equals an integer conv of int8-grid operands, scaled
    back per output channel: per-input-channel activation scales, the
    weight quantized per output channel after folding them in."""
    x, k, b, _ = _conv_inputs(2)
    w = T(k.transpose(3, 2, 0, 1).copy())
    got = fake_quant_conv(T(x), w, T(b), torch.float32)
    s_in = np.abs(x).max(axis=(0, 1, 2)) / 127.0
    xq = np.clip(np.round(x / s_in), -127, 127)
    w_fold = k * s_in[None, None, :, None]
    s_w = np.abs(w_fold).max(axis=(0, 1, 2)) / 127.0
    wq = np.clip(np.round(w_fold / s_w), -127, 127)
    assert np.abs(xq).max() == np.abs(wq).max() == 127
    y = torch.nn.functional.conv2d(T(xq).permute(0, 3, 1, 2).double(),
                                   T(wq.transpose(3, 2, 0, 1)).double(),
                                   padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got.numpy(), y * s_w + b, rtol=1e-5,
                               atol=1e-6)


def _qat_pair(lr=1e-3):
    """JAX and port QAT train states from the same init, in f32; the LR
    halves after every step."""
    kw = dict(**_ARCH, batch_size=4, patch_size=8, learning_rate=lr,
              lr_step=1, steps_per_epoch=1, phase="qat")
    jopts = jax_config.Opts(**kw, compute_dtype="float32")
    g_state = jax_state.create_generator_state(
        jopts, jax_loop.build_generator(jopts), jax.random.key(0))
    g_state = g_state.replace(apply_fn=jqat.make_qat_apply(
        2, 0.1, jnp.float32))
    popts = Opts(**kw, compute_dtype="float32", fold_train=True,
                 device="cpu")
    gen = Generator(**_ARCH, device="cpu", seed=None)
    gen.load_state_dict(_to_sd(g_state.params))
    return jopts, g_state, popts, create_generator_state(popts, CPU, gen)


def test_qat_apply_matches_jax_make_qat_apply():
    _, g_state, _, state = _qat_pair()
    assert isinstance(state.apply, QatApply)   # fold_train is ignored
    assert state.apply.min_halo == 0
    assert getattr(state.apply, "uint8_variant", None) is None
    x = np.random.default_rng(3).uniform(-1, 1, (2, 14, 11, 3)).astype(
        np.float32)
    want = np.asarray(g_state.apply_fn({"params": g_state.params}, x))
    kernels.reset_launch_counts()
    got = state.apply(T(x)).detach().numpy()
    assert kernels.launch_counts() == {"fused_resblock": 0,
                                       "fused_upsampler_stage": 0,
                                       "fused_rcab": 0, "rcab_excite": 0}
    assert got.shape == want.shape == (2, 28, 22, 3)
    # a flip moves its value by one step, ~1% of the layer's range, and
    # spreads through the later convs: count the outputs it moves
    off = np.abs(got - want) > 1e-5 * np.abs(want).max() + 1e-5 * np.abs(
        want)
    assert off.mean() <= 1e-4, off.mean()


@pytest.mark.parametrize("n_steps", [1, 2])
def test_qat_steps_match_jax(n_steps):
    jopts, g_state, popts, state = _qat_pair()
    jstep = jax_steps.make_pretrain_step(jopts)
    pstep = steps.make_pretrain_step(popts)
    uncertain = {n: False for n, _ in state.generator.named_parameters()}
    lr_sum = 0.0
    for k in range(n_steps):
        lr, hr = _batch(k)

        def loss(p):
            return jnp.mean(jnp.abs(g_state.apply_fn({"params": p}, lr)
                                    - hr))

        jgrads = _to_sd(jax.grad(loss)(g_state.params))
        g_state, jm = jstep(g_state, jnp.asarray(lr), jnp.asarray(hr))
        pm = pstep(state, T(lr), T(hr))
        np.testing.assert_allclose(float(pm["l1"]), float(jm["l1"]),
                                   atol=1e-6, rtol=1e-5)
        lr_sum += state.optimizer.param_groups[0]["lr"]
        adam = g_state.opt_state[0]
        mu, nu = _to_sd(adam.mu), _to_sd(adam.nu)
        for name, p in state.generator.named_parameters():
            g = p.grad.numpy()
            jg = jgrads[name].numpy()
            np.testing.assert_allclose(g, jg, atol=1e-6, rtol=1e-4,
                                       err_msg=name)
            uncertain[name] = uncertain[name] | (
                np.abs(g - jg) > 1e-3 * np.abs(jg))
            st = state.optimizer.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(),
                                       mu[name].numpy(), atol=1e-7,
                                       rtol=1e-4, err_msg=name)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       nu[name].numpy(), atol=1e-10,
                                       rtol=1e-4, err_msg=name)
        share = (sum(u.sum() for u in uncertain.values())
                 / sum(np.size(u) for u in uncertain.values()))
        assert share <= 0.01, share
        _assert_adam_params(state.generator, _to_sd(g_state.params),
                            uncertain, lr_sum)
    assert state.apply.forwards == n_steps


def test_qat_evaluate_runs_the_fake_quant_forward():
    """Self-validation in phase qat scores the fake-quant forward: JAX's
    ``evaluate`` on its QAT apply against the port's on ``QatApply``
    (PSNR atol 1e-3 dB, SSIM 1e-4), and not the float forward."""
    _, g_state, popts, state = _qat_pair()
    kw = dict(valid_dataset="synthetic", num_valids=1)
    jopts = jax_config.Opts(**_ARCH, **kw, compute_dtype="float32")
    want = jax_loop.evaluate(jopts, g_state.apply_fn, g_state.params,
                             compute_pi=False)
    opts = Opts(**_ARCH, **kw, device="cpu")
    got = loop.evaluate(opts, QatApply(state.generator, torch.float32),
                        compute_pi=False)
    assert got["val_psnr"] == pytest.approx(want["val_psnr"], abs=1e-3)
    assert got["val_ssim"] == pytest.approx(want["val_ssim"], abs=1e-4)
    from pesr_torch.models.kernel_apply import KernelApply
    float_psnr = loop.evaluate(opts, KernelApply(state.generator,
                                                 torch.float32),
                               compute_pi=False)["val_psnr"]
    assert abs(float_psnr - got["val_psnr"]) > 1e-3


def test_train_cli_runs_the_qat_phase(tmp_path, capsys):
    """``--phase qat`` parses as JAX's does, trains through the fake-quant
    forward (no kernel launches), ignores --fold_train and says so,
    validates, snapshots and resumes."""
    base = ["--device", "cpu", "--phase", "qat", "--num_blocks", "2",
            "--num_channels", "8", "--scale", "2", "--batch_size", "2",
            "--patch_size", "12", "--train_dataset", "synthetic",
            "--valid_dataset", "synthetic", "--num_valids", "1",
            "--steps_per_epoch", "3", "--log_every", "3", "--no_eval_pi",
            "--check_point", str(tmp_path)]
    opts = opts_from_args(base + ["--num_epochs", "1"], mode="train")
    assert opts.phase == jax_config.opts_from_args(
        ["--phase", "qat"], mode="train").phase == "qat"
    assert opts.fold_train
    kernels.reset_launch_counts()
    assert train_cli.main(base + ["--num_epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert "fake-quant" in out and "--fold_train is ignored" in out
    assert kernels.launch_counts() == {"fused_resblock": 0,
                                       "fused_upsampler_stage": 0,
                                       "fused_rcab": 0, "rcab_excite": 0}
    assert "val_psnr" in out and (tmp_path / "best").is_dir()
    summary = loop.run_training(opts_from_args(
        base + ["--num_epochs", "2", "--resume"], mode="train"))
    assert summary["steps"] == 6 and summary["train_forwards"] == 3
