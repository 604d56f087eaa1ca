"""The train CLI's host-side and precision flags on the CPU:
``--profile_dir`` (a torch.profiler trace of steps 5-9, closed on every
exit path), ``--trim_host_heap`` (once per epoch), ``--compute_dtype
float32`` (the plain f32 train apply the card runs, against JAX's f32
pretrain steps, chain and folded, and its GAN step) and ``--param_dtype
bfloat16`` (bf16 parameters and Adam moments, one step against JAX's).

Tolerances: the f32 steps as tests/test_torch_training.py holds them (L1
atol 1e-6 / rtol 1e-5, gradients atol 1e-6 / rtol 1e-4, GAN metrics and
both networks' gradients, moments and parameters by
tests/test_torch_gan_step.py's checks).  bf16 parameters: both sides
compute the forward in bf16 with their own rounding order (XLA's convs
against PyTorch's), so the first L1 agrees to 2e-3 relative (~1 bf16
ulp of the output).  Adam's first update is ~lr * sign(g); JAX rounds
each of its moment and update ops to bf16, PyTorch rounds once per fused
op, so updated parameters agree to 2 bf16 ulps, except where the two bf16
gradients differ in sign (gradients within bf16 noise of 0: 41 of 5,699
elements here, at most 1% allowed), which move apart by up to 2 lr.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gan_step as gs
from pesr_tpu import config as jax_config
from pesr_tpu.training import loop as jax_loop
from pesr_tpu.training import state as jax_state
from pesr_tpu.training import steps as jax_steps
from pesr_torch import train as train_cli
from pesr_torch.config import Opts
from pesr_torch.convert import state_dict_from_jax
from pesr_torch.models import kernel_apply
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import Float32TrainApply
from pesr_torch.scales import fold_min_halo
from pesr_torch.training import loop, steps
from pesr_torch.training.state import (add_discriminator,
                                       create_generator_state, plain_float32)
from pesr_torch.utils import memory
from test_torch_fold_train import _pair as _fold_pair
from test_torch_training import _TINY_CLI, _batch, _pair, _to_sd

T = torch.from_numpy
CPU = torch.device("cpu")


def _cli(tmp_path, *extra):
    return train_cli.main(_TINY_CLI + ["--check_point", str(tmp_path / "ck"),
                                       "--no_eval_pi", "--eval_every", "0",
                                       *extra])


def _traced_steps(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("name") == "train_step"
               and e.get("cat") == "user_annotation")


def test_profile_dir_traces_steps_5_to_9_and_trim_runs_per_epoch(
        tmp_path, capsys, monkeypatch):
    trims = []
    monkeypatch.setattr(loop, "trim_host_heap",
                        lambda: trims.append(1) or True)
    pdir = tmp_path / "prof"
    _cli(tmp_path, "--steps_per_epoch", "4", "--num_epochs", "3",
         "--profile_dir", str(pdir), "--trim_host_heap")
    out = capsys.readouterr().out
    assert os.listdir(pdir) == ["steps_5-9.pt.trace.json"]
    assert _traced_steps(pdir / "steps_5-9.pt.trace.json") == 5
    assert out.count("[profile] trace written to") == 1
    assert len(trims) == 3


def test_no_trace_and_no_trim_unless_asked(tmp_path, capsys, monkeypatch):
    trims = []
    monkeypatch.setattr(loop, "trim_host_heap",
                        lambda: trims.append(1) or True)
    _cli(tmp_path, "--steps_per_epoch", "3", "--num_epochs", "2")
    assert "[profile]" not in capsys.readouterr().out
    found = [f for _, _, fs in os.walk(tmp_path) for f in fs
             if f.endswith(".pt.trace.json")]
    assert found == [] and trims == []


def test_a_run_shorter_than_the_window_still_writes_its_trace(tmp_path,
                                                              capsys):
    pdir = tmp_path / "prof"
    _cli(tmp_path, "--steps_per_epoch", "7", "--num_epochs", "1",
         "--profile_dir", str(pdir))
    assert "(run ended before the full profile window)" in \
        capsys.readouterr().out
    assert _traced_steps(pdir / "steps_5-9.pt.trace.json") == 2


def test_an_interrupt_inside_the_window_closes_the_trace(tmp_path, capsys,
                                                         monkeypatch):
    real = loop.make_pretrain_step

    def interrupted(opts):
        step = real(opts)

        def wrapped(state, lr, hr):
            if state.step == 7:
                raise KeyboardInterrupt
            return step(state, lr, hr)
        return wrapped

    monkeypatch.setattr(loop, "make_pretrain_step", interrupted)
    pdir = tmp_path / "prof"
    with pytest.raises(KeyboardInterrupt):
        _cli(tmp_path, "--steps_per_epoch", "12", "--num_epochs", "1",
             "--profile_dir", str(pdir))
    out = capsys.readouterr().out
    assert "(run interrupted inside the profile window)" in out
    assert "[interrupt] checkpoint saved" in out
    # steps 5 and 6, and the range of the interrupted step 7
    assert _traced_steps(pdir / "steps_5-9.pt.trace.json") == 3


def test_trim_host_heap_trims_here():
    assert memory.trim_host_heap() is True


def test_float32_runs_plain_on_the_card_and_the_kernels_elsewhere():
    o32, o16 = Opts(compute_dtype="float32"), Opts()
    cuda = torch.device("cuda")
    assert plain_float32(o32, cuda)
    assert not plain_float32(o32, CPU) and not plain_float32(o16, cuda)


def _no_kernel(monkeypatch):
    """Make every kernel wrapper of the train apply raise: the float32
    apply must not reach one."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called")
    for name in ("fused_resblock_train", "fused_upsampler_stage_train"):
        monkeypatch.setattr(kernel_apply, name, boom)


@pytest.mark.parametrize("fold", [False, True])
def test_float32_pretrain_step_matches_jax(monkeypatch, fold):
    jopts, g_state, popts, state = (_fold_pair() if fold else _pair())
    state.apply = Float32TrainApply(state.generator, fold=fold)
    assert state.apply.min_halo == (fold_min_halo(2) if fold else 0)
    _no_kernel(monkeypatch)
    lr, hr = _batch(4)

    def loss(p):
        return jnp.mean(jnp.abs(g_state.apply_fn({"params": p}, lr) - hr))

    jgrads = _to_sd(jax.grad(loss)(g_state.params))
    _, jm = jax_steps.make_pretrain_step(jopts)(g_state, jnp.asarray(lr),
                                                jnp.asarray(hr))
    pm = steps.make_pretrain_step(popts)(state, T(lr), T(hr))
    assert state.apply.forwards == 1
    np.testing.assert_allclose(float(pm["l1"]), float(jm["l1"]), atol=1e-6,
                               rtol=1e-5)
    for name, p in state.generator.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)


def test_float32_gan_step_matches_jax(monkeypatch):
    pair = gs.Pair()
    st = pair.state
    st.apply = Float32TrainApply(st.generator)
    _no_kernel(monkeypatch)
    lr, hr = gs.batch(0)
    key = jax.random.key(10)
    g_before, d_before = jax.tree_util.tree_map(
        jnp.copy, (pair.g.params, pair.d.params))
    want = pair.jax_step(lr, hr, key)
    dg, gg = pair.reference_grads(g_before, d_before, pair.d.params, lr, hr,
                                  key)
    got = pair.pstep(st, T(lr), T(hr), T(pair.eps(key)))
    for name, v in want.items():
        tol = (dict(atol=1e-4) if name == "psnr"
               else dict(atol=1e-6, rtol=1e-5))
        np.testing.assert_allclose(float(got[name]), v, err_msg=name, **tol)
    adam = pair.g.opt_state[0]
    gs._check_net(st.generator, st.optimizer, gg, gs.sd_g(adam.mu),
                  gs.sd_g(adam.nu), gs.sd_g(pair.g.params), {}, gs.LR0)
    adam = pair.d.opt_state[0]
    gs._check_net(st.discriminator, st.d_optimizer, dg, gs.sd_d(adam.mu),
                  gs.sd_d(adam.nu), gs.sd_d(pair.d.params), {}, gs.LR0)


_ARCH = dict(scale=2, num_blocks=2, num_channels=8)


def _bf16_ulp(x):
    """One bf16 ulp at each value of ``x`` (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_bfloat16_parameters_match_jax_s_step():
    kw = dict(**_ARCH, batch_size=4, patch_size=8, learning_rate=1e-3,
              lr_step=1, steps_per_epoch=1)
    jopts = jax_config.Opts(**kw, param_dtype="bfloat16")
    g_state = jax_state.create_generator_state(
        jopts, jax_loop.build_generator(jopts), jax.random.key(0))
    assert all(a.dtype == jnp.bfloat16
               for a in jax.tree_util.tree_leaves(g_state.params))
    popts = Opts(**kw, param_dtype="bfloat16", device="cpu")
    gen = Generator(**_ARCH, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(
        jax.device_get(jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), g_state.params)), 2))
    state = create_generator_state(popts, CPU, gen)
    assert all(p.dtype == torch.bfloat16 for p in gen.parameters())
    lr, hr = _batch(6)

    def loss(p):
        return jnp.mean(jnp.abs(g_state.apply_fn({"params": p}, lr) - hr))

    jgrads = _to_sd(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), jax.grad(loss)(g_state.params)))
    g_state, jm = jax_steps.make_pretrain_step(jopts)(
        g_state, jnp.asarray(lr), jnp.asarray(hr))
    pm = steps.make_pretrain_step(popts)(state, T(lr), T(hr))
    np.testing.assert_allclose(float(pm["l1"]), float(jm["l1"]), rtol=2e-3)
    want = _to_sd(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                         g_state.params))
    flips = total = 0
    for name, p in gen.named_parameters():
        assert p.dtype == torch.bfloat16
        st = state.optimizer.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
        ours, ref = p.detach().float().numpy(), want[name].numpy()
        flip = (np.sign(p.grad.float().numpy())
                != np.sign(jgrads[name].numpy()))
        tol = 2 * _bf16_ulp(ref) + np.where(flip, 2 * 1e-3, 0.0)
        assert (np.abs(ours - ref) <= tol).all(), name
        flips += int(flip.sum())
        total += ref.size
    assert flips <= 0.01 * total, (flips, total)


def test_bfloat16_parameters_of_both_gan_networks(tmp_path):
    """G and D in bf16 with bf16 Adam moments after a GAN step; a
    snapshot records the dtype and an f32 run converts it on resume."""
    popts = Opts(**_ARCH, batch_size=2, patch_size=8, phase="train",
                 alpha_vgg=0.0, param_dtype="bfloat16", device="cpu",
                 check_point=str(tmp_path))
    state = create_generator_state(popts, CPU)
    add_discriminator(state, popts, CPU)
    lr, hr = _batch(7)
    m = steps.make_gan_step(popts)(state, T(lr[:2]), T(hr[:2]))
    assert all(np.isfinite(float(v)) for v in m.values())
    for net, opt in ((state.generator, state.optimizer),
                     (state.discriminator, state.d_optimizer)):
        for p in net.parameters():
            assert p.dtype == torch.bfloat16
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16
            assert st["exp_avg_sq"].dtype == torch.bfloat16
    from pesr_torch.training import checkpoint as ckpt
    path = ckpt.save_train_ckpt(str(tmp_path), state)
    assert torch.load(os.path.join(path, "train_state.pt"),
                      weights_only=True)["param_dtype"] == "bfloat16"
    o32 = dataclasses.replace(popts, param_dtype="float32")
    s32 = create_generator_state(o32, CPU)
    add_discriminator(s32, o32, CPU)
    ckpt.restore_train_state(str(tmp_path), s32)
    for p, q in zip(s32.generator.parameters(), state.generator.parameters()):
        assert p.dtype == torch.float32
        assert torch.equal(p.detach(), q.detach().float())
        assert s32.optimizer.state[p]["exp_avg"].dtype == torch.float32
