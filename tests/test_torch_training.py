"""The port's L1 pretrain phase against the JAX package, on the CPU.

A tiny generator (2 blocks x 8 channels, x2) is initialised by the JAX
package and carried into the port with ``state_dict_from_jax``; both
sides then take the same pretrain steps on the same numpy batch in f32.
Tolerances: the loss and the gradients agree to f32 summation order
(atol 1e-6, rtol 1e-4).  Adam's update is ~``lr * sign(g)`` where |g| is
near its own rounding, so the parameters agree to 2e-6 except where the
two gradients differ by more than 0.1% of the gradient (at most 1% of
the elements), which may move by up to 2 lr per step.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu import config as jax_config
from pesr_tpu.convert import convert_torch_generator
from pesr_tpu.data import datasets as jax_datasets
from pesr_tpu.training import loop as jax_loop
from pesr_tpu.training import state as jax_state
from pesr_tpu.training import steps as jax_steps
from pesr_torch import train as train_cli
from pesr_torch import test as test_cli
from pesr_torch.config import Opts, opts_from_args
from pesr_torch.convert import state_dict_from_jax
from pesr_torch.data import datasets
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.training import checkpoint as ckpt
from pesr_torch.training import loop, steps
from pesr_torch.training.state import (create_generator_state,
                                       make_ema, make_lr_schedule)
from pesr_torch.utils.image_io import imwrite_uint8

T = torch.from_numpy
CPU = torch.device("cpu")
_ARCH = dict(scale=2, num_blocks=2, num_channels=8)
_TINY_CLI = ["--device", "cpu", "--num_blocks", "2", "--num_channels", "16",
             "--batch_size", "2", "--patch_size", "24", "--train_dataset",
             "synthetic", "--valid_dataset", "synthetic", "--num_valids",
             "2"]


def _to_sd(tree):
    return state_dict_from_jax(jax.device_get(tree), _ARCH["scale"])


def _pair(accum=1, ema=0.0, lr=1e-3):
    """JAX and port train states from the same init, both in f32; the LR
    halves after every step (lr_step 1 x 1 step per epoch)."""
    kw = dict(**_ARCH, batch_size=4, patch_size=8, learning_rate=lr,
              lr_step=1, steps_per_epoch=1, grad_accum=accum,
              ema_decay=ema)
    jopts = jax_config.Opts(**kw, compute_dtype="float32")
    g_state = jax_state.create_generator_state(
        jopts, jax_loop.build_generator(jopts), jax.random.key(0))
    popts = Opts(**kw, compute_dtype="float32", device="cpu")
    gen = Generator(**_ARCH, device="cpu", seed=None)
    gen.load_state_dict(_to_sd(g_state.params))
    state = create_generator_state(popts, CPU, gen)
    if ema:
        state.ema = make_ema(gen)
    return jopts, g_state, popts, state


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32),
            rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32))


def _assert_adam_params(gen, ref_sd, uncertain, lr_sum):
    for name, p in gen.named_parameters():
        tol = 2e-6 + np.where(uncertain[name], 2 * lr_sum, 0.0)
        d = np.abs(p.detach().numpy() - ref_sd[name].numpy())
        assert (d <= tol).all(), (name, d.max())


@pytest.mark.parametrize("accum,ema", [(1, 0.0), (2, 0.0), (1, 0.9)])
def test_two_pretrain_steps_match_jax(accum, ema):
    jopts, g_state, popts, state = _pair(accum, ema)
    jstep = jax_steps.make_pretrain_step(jopts)
    pstep = steps.make_pretrain_step(popts)
    schedule = jax_state.make_lr_schedule(jopts)
    jema = jax.tree_util.tree_map(jnp.copy, g_state.params) if ema else None
    uncertain = {n: False for n, _ in state.generator.named_parameters()}
    lr_sum = 0.0
    for k in range(2):
        lr, hr = _batch(k)

        def loss(p):
            return jnp.mean(jnp.abs(g_state.apply_fn({"params": p}, lr)
                                    - hr))

        jgrads = _to_sd(jax.grad(loss)(g_state.params))
        if ema:
            g_state, jema, jm = jstep(g_state, jema, jnp.asarray(lr),
                                      jnp.asarray(hr))
        else:
            g_state, jm = jstep(g_state, jnp.asarray(lr), jnp.asarray(hr))
        pm = pstep(state, T(lr), T(hr))
        assert state.step == k + 1
        np.testing.assert_allclose(float(pm["l1"]), float(jm["l1"]),
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(float(pm["psnr"]), float(jm["psnr"]),
                                   atol=1e-4)
        # the LR of step k: 1e-3 at step 0, 5e-4 past the boundary
        used = state.optimizer.param_groups[0]["lr"]
        assert used == pytest.approx(float(schedule(k)), rel=1e-6)
        assert used == pytest.approx(1e-3 * 0.5 ** k)
        lr_sum += used
        adam = g_state.opt_state[0]
        mu, nu = _to_sd(adam.mu), _to_sd(adam.nu)
        for name, p in state.generator.named_parameters():
            g = p.grad.numpy()
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
        share = (sum(u.sum() for u in uncertain.values())
                 / sum(np.size(u) for u in uncertain.values()))
        assert share <= 0.01, share
        _assert_adam_params(state.generator, _to_sd(g_state.params),
                            uncertain, lr_sum)
        if ema:
            _assert_adam_params(state.ema, _to_sd(jema), uncertain,
                                (1 - ema) * lr_sum)


def test_grad_accum_equals_the_full_batch_step():
    """L1 is a per-sample mean: two strided microbatches give the full
    batch's loss and gradients."""
    _, _, popts, full = _pair(1)
    _, _, popts2, acc = _pair(2)
    lr, hr = _batch(3)
    m1 = steps.make_pretrain_step(popts)(full, T(lr), T(hr))
    m2 = steps.make_pretrain_step(popts2)(acc, T(lr), T(hr))
    assert float(m1["l1"]) == pytest.approx(float(m2["l1"]), abs=1e-6)
    for p, q in zip(full.generator.parameters(), acc.generator.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   atol=1e-6, rtol=1e-4)


def test_microbatches_psnr_and_schedule_match_jax():
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    got = steps._microbatches(T(x), 4)
    want = np.asarray(jax_steps._microbatches(jnp.asarray(x), 4))
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    with pytest.raises(ValueError):
        steps._microbatches(T(x), 3)
    mse = np.array([1e-14, 1e-4, 0.5, 4.0], np.float32)
    np.testing.assert_allclose(steps._psnr_from_mse(T(mse)).numpy(),
                               np.asarray(jax_steps._psnr_from_mse(mse)),
                               rtol=1e-6)
    # steps_per_epoch 0 -> 1000 steps per epoch in both
    for spe in (0, 7):
        kw = dict(learning_rate=2e-4, lr_step=2, steps_per_epoch=spe)
        ours = make_lr_schedule(Opts(**kw))
        theirs = jax_state.make_lr_schedule(jax_config.Opts(**kw))
        for k in (0, 13, 14, 1999, 2000, 4000, 6001):
            assert ours(k) == pytest.approx(float(theirs(k)), rel=1e-6)


def _write_folder(root, n=3, hr_hw=(40, 52), scale=4, lr_files=True):
    rng = np.random.default_rng(0)
    hr_dir, lr_dir = root / "HR", root / "LR"
    for i in range(n):
        hr = rng.integers(0, 256, hr_hw + (3,), dtype=np.uint8)
        imwrite_uint8(hr_dir / f"{i:04d}.png", hr)
        if lr_files:
            imwrite_uint8(lr_dir / f"{i:04d}x{scale}.png",
                          hr[::scale, ::scale])
    return str(hr_dir), (str(lr_dir) if lr_files else None)


@pytest.mark.parametrize("lr_files", [False, True])
def test_patch_iterator_crops_equal_jax(tmp_path, lr_files):
    hr_dir, lr_dir = _write_folder(tmp_path, lr_files=lr_files)
    ours = datasets.PatchIterator(
        datasets.PairedImageFolder(hr_dir, lr_dir, 4), 6, 4, 5, seed=9)
    theirs = jax_datasets.PatchIterator(
        jax_datasets.PairedImageFolder(hr_dir, lr_dir, 4), 6, 4, 5, seed=9)
    assert ours.use_lr_files == lr_files
    for _ in range(3):
        (a_lr, a_hr), (b_lr, b_hr) = next(ours), next(theirs)
        np.testing.assert_array_equal(a_hr, b_hr)
        if lr_files:
            np.testing.assert_array_equal(a_lr, b_lr)
        else:
            assert a_lr is None and b_lr is None


def test_patch_iterator_on_the_synthetic_corpus_equals_jax():
    ours = datasets.PatchIterator(datasets.SyntheticImages(4, 64, 64, 3),
                                  8, 4, 3, seed=1)
    theirs = jax_datasets.PatchIterator(
        jax_datasets.SyntheticImages(4, 64, 64, 3), 8, 4, 3, seed=1)
    for _ in range(2):
        np.testing.assert_array_equal(next(ours)[1], next(theirs)[1])


@pytest.mark.parametrize("start_step", [0, 7])
def test_train_iterator_folds_the_resume_step_into_the_seed(tmp_path,
                                                            start_step):
    """LR-file mode, where the JAX package also runs the Python
    iterator: the same (seed, start_step) gives the same crops."""
    _write_folder(tmp_path / "DIV2K" / "x")
    os.rename(tmp_path / "DIV2K" / "x" / "HR",
              tmp_path / "DIV2K" / "DIV2K_train_HR")
    os.makedirs(tmp_path / "DIV2K" / "DIV2K_train_LR_bicubic")
    os.rename(tmp_path / "DIV2K" / "x" / "LR",
              tmp_path / "DIV2K" / "DIV2K_train_LR_bicubic" / "X4")
    kw = dict(train_dataset="DIV2K", data_root=str(tmp_path), patch_size=6,
              batch_size=4, seed=5)
    ours, from_files = datasets.make_train_iterator(Opts(**kw), start_step)
    theirs, _ = jax_datasets.make_train_iterator(jax_config.Opts(**kw),
                                                 start_step)
    try:
        assert from_files
        assert datasets.train_num_images(Opts(**kw)) == 3
        for _ in range(2):
            a, b = next(ours), next(theirs)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    finally:
        ours.close()
        theirs.close()


def test_prefetcher_reraises_the_worker_error_and_closes():
    def gen():
        yield 1
        raise FileNotFoundError("no LR file")

    it = datasets.Prefetcher(gen())
    assert next(it) == 1
    with pytest.raises(FileNotFoundError):
        next(it)
    with pytest.raises(FileNotFoundError):
        next(it)
    it.close()
    with pytest.raises(RuntimeError):
        next(it)


def test_checkpoint_round_trip_restores_everything(tmp_path):
    _, _, popts, state = _pair(ema=0.5)
    step = steps.make_pretrain_step(dataclasses.replace(popts,
                                                        ema_decay=0.5))
    lr, hr = _batch(1)
    step(state, T(lr), T(hr))
    path = ckpt.save_train_ckpt(str(tmp_path), state, best_psnr=21.5,
                                extra={"data_seed": 3})
    assert sorted(os.listdir(path)) == ["ema.pth", "generator.pth",
                                        "train_state.pt"]
    assert ckpt.latest_step_dir(str(tmp_path)) == path
    _, _, _, fresh = _pair(ema=0.5)
    got_step, best, ts = ckpt.restore_train_state(str(tmp_path), fresh)
    assert (got_step, best, ts["data_seed"], ts["has_ema"]) == (1, 21.5, 3,
                                                                True)
    for a, b in zip(state.generator.state_dict().values(),
                    fresh.generator.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(state.ema.parameters(), fresh.ema.parameters()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for k in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][k][key], sb["state"][k][key])
    # restore_generator_params prefers the EMA copy
    sd, at = ckpt.restore_generator_params(path)
    assert at == 1
    for k, v in state.ema.state_dict().items():
        assert torch.equal(sd[k], v)
    raw, _ = ckpt.restore_generator_params(path, prefer_ema=False)
    assert not torch.equal(sd["head.0.weight"], raw["head.0.weight"])
    # the same next step from both
    lr, hr = _batch(2)
    m_a, m_b = step(state, T(lr), T(hr)), step(fresh, T(lr), T(hr))
    assert float(m_a["l1"]) == float(m_b["l1"])


def test_prune_snapshots_keeps_the_newest_and_best(tmp_path):
    for k in (1, 2, 10, 3):
        os.makedirs(tmp_path / f"step_{k}")
    os.makedirs(tmp_path / "best")
    assert ckpt.prune_snapshots(str(tmp_path), 0) == []
    pruned = ckpt.prune_snapshots(str(tmp_path), 2)
    assert sorted(os.path.basename(p) for p in pruned) == ["step_1",
                                                           "step_2"]
    assert sorted(os.listdir(tmp_path)) == ["best", "step_10", "step_3"]


def test_validate_params_compat_names_the_mismatch():
    want = Generator(**_ARCH, device="cpu").state_dict()
    got = Generator(scale=2, num_blocks=3, num_channels=8,
                    device="cpu").state_dict()
    with pytest.raises(ValueError, match="unexpected in checkpoint"):
        ckpt.validate_params_compat(want, got)
    ckpt.validate_params_compat(want, want)


def test_snapshot_is_read_by_pesr_tpu_convert(tmp_path):
    """A snapshot's generator.pth through pesr_tpu.convert: the JAX
    generator on the converted params gives the port's output."""
    gen = Generator(**_ARCH, device="cpu", seed=4)
    state = create_generator_state(Opts(**_ARCH, device="cpu"), CPU, gen)
    path = ckpt.save_train_ckpt(str(tmp_path), state)
    sd = torch.load(os.path.join(path, "generator.pth"), weights_only=True)
    params = convert_torch_generator(sd, _ARCH["num_blocks"], _ARCH["scale"])
    jopts = jax_config.Opts(**_ARCH, compute_dtype="float32")
    x = np.random.default_rng(1).uniform(-1, 1, (2, 9, 7, 3)).astype(
        np.float32)
    want = jax_loop.build_generator(jopts).apply({"params": params},
                                                 jnp.asarray(x))
    with torch.no_grad():
        got = gen(T(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-5)


def test_evaluate_psnr_equals_jax(tmp_path):
    """Self-validation on 2 synthetic images (x2: LR 240 x 240, tile 96:
    3 x 3 tiles each, 18 in batches of 8) from the same f32 weights:
    JAX's ``evaluate(..., compute_pi=False)`` against the port's."""
    jopts = jax_config.Opts(**_ARCH, compute_dtype="float32",
                            valid_dataset="synthetic", num_valids=2)
    gen_j = jax_loop.build_generator(jopts)
    params = gen_j.init(jax.random.key(2),
                        jnp.zeros((1, 8, 8, 3)))["params"]
    want = jax_loop.evaluate(jopts, gen_j.apply, params, compute_pi=False)
    gen = Generator(**_ARCH, device="cpu", seed=None)
    gen.load_state_dict(_to_sd(params))
    popts = Opts(**_ARCH, valid_dataset="synthetic", num_valids=2,
                 device="cpu")
    apply_fn = KernelApply(gen, torch.float32)
    got = loop.evaluate(popts, apply_fn, compute_pi=False)
    assert apply_fn.forwards == 3      # 2 x 9 tiles in batches of 8
    assert got["val_psnr"] == pytest.approx(want["val_psnr"], abs=1e-3)
    assert got["val_ssim"] == pytest.approx(want["val_ssim"], abs=1e-4)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_on_the_cpu_and_writes_snapshots(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert train_cli.main(_TINY_CLI + [
        "--steps_per_epoch", "10", "--num_epochs", "2", "--log_every", "5",
        "--learning_rate", "1e-3", "--check_point", ck,
        "--keep_snapshots", "1", "--snapshot_every", "1"]) == 0
    out = capsys.readouterr().out
    done = json.loads(out.strip().splitlines()[-1][len("[done] "):])
    assert done["steps"] == 20 and done["train_forwards"] == 20
    # x4: 2 LR images of 120 x 120, 2 x 2 tiles each: one batch of 8 per
    # eval
    assert done["eval_forwards"] == 2 and np.isfinite(done["val_psnr"])
    assert np.isfinite(done["val_pi"])
    recs = [r for r in _jsonl(os.path.join(ck, "pretrain.jsonl"))
            if "l1" in r]
    assert [r["step"] for r in recs] == [5, 10, 15, 20]
    assert recs[-1]["l1"] < recs[0]["l1"]
    assert sorted(os.listdir(ck)) == ["best", "pretrain.jsonl", "step_20"]
    # the best snapshot loads in the test CLI and in pesr_tpu.convert
    res = test_cli.run(["--device", "cpu", "--num_blocks", "2",
                        "--num_channels", "16", "--dataset", "synthetic",
                        "--model_path", os.path.join(ck, "best"),
                        "--output_dir", str(tmp_path / "out")])
    assert np.isfinite(res["psnr"])
    sd = torch.load(os.path.join(ck, "best", "generator.pth"),
                    weights_only=True)
    assert convert_torch_generator(sd, 2, 4)["body"]["block"]["conv1"][
        "kernel"].shape == (2, 3, 3, 16, 16)


def test_cli_resumes_and_saves_on_interrupt(tmp_path, monkeypatch, capsys):
    ck = str(tmp_path / "ck")
    base = _TINY_CLI + ["--steps_per_epoch", "3", "--log_every", "0",
                        "--eval_every", "0", "--check_point", ck]
    real = loop.make_pretrain_step

    def interrupted(opts):
        step = real(opts)

        def wrapped(state, lr, hr):
            if state.step == 4:
                raise KeyboardInterrupt
            return step(state, lr, hr)
        return wrapped

    monkeypatch.setattr(loop, "make_pretrain_step", interrupted)
    with pytest.raises(KeyboardInterrupt):
        train_cli.main(base + ["--num_epochs", "3"])
    assert "[interrupt] checkpoint saved" in capsys.readouterr().out
    assert sorted(os.listdir(ck)) == ["pretrain.jsonl", "step_4"]
    monkeypatch.setattr(loop, "make_pretrain_step", real)
    summary = loop.run_training(opts_from_args(
        base + ["--num_epochs", "3", "--resume"], mode="train"))
    assert summary["steps"] == 9 and summary["train_forwards"] == 5
    assert "resumed from" in capsys.readouterr().out
    assert ckpt.latest_step_dir(ck).endswith("step_9")


def test_test_cli_prefers_the_ema_copy_of_a_port_checkpoint(tmp_path):
    gen = Generator(**_ARCH, device="cpu", seed=1)
    state = create_generator_state(Opts(**_ARCH, device="cpu"), CPU, gen)
    state.ema = Generator(**_ARCH, device="cpu", seed=2)
    state.step = 3
    ckpt.save_train_ckpt(str(tmp_path), state)
    state.step = 5
    ckpt.save_train_ckpt(str(tmp_path), state)
    for path in (str(tmp_path), str(tmp_path / "step_3")):
        opts = opts_from_args(["--num_blocks", "2", "--num_channels", "8",
                               "--scale", "2", "--model_path", path,
                               "--device", "cpu"])
        loaded = test_cli.build_generator(opts, CPU)
        for a, b in zip(loaded.state_dict().values(),
                        state.ema.state_dict().values()):
            assert torch.equal(a, b)


def test_cli_without_device_raises_when_cuda_is_missing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(_TINY_CLI[2:] + ["--check_point", str(tmp_path)])


@pytest.mark.parametrize("flag", [
    ["--quant", "int8"], ["--use_pallas"], ["--remat"], ["--unroll_body"],
    ["--mesh_shape", "4"], ["--distributed"], ["--export_artifact", "a"]])
def test_train_cli_rejects_flags_the_port_lacks(flag):
    with pytest.raises(SystemExit):
        opts_from_args(_TINY_CLI + flag, mode="train")


@pytest.mark.parametrize("flag, field", [
    (["--phase", "train"], "phase"), (["--gan_type", "RaSGAN"], "gan_type"),
    (["--alpha_vgg", "1"], "alpha_vgg"), (["--GP"], "use_gp"),
    (["--vgg_weights", "v.pth"], "vgg_weights"),
    (["--pretrained_d", "d"], "pretrained_d"),
    (["--param_dtype", "bfloat16"], "param_dtype"),
    (["--profile_dir", "p"], "profile_dir"),
    (["--trim_host_heap"], "trim_host_heap"),
    (["--compute_dtype", "float32"], "compute_dtype")])
def test_train_cli_parses_the_gan_flags_as_jax_does(flag, field):
    """The GAN phase's flags and the host-side and precision flags, once
    rejected, now parse into the field the JAX package's parser sets,
    with its value."""
    ours = opts_from_args(_TINY_CLI + flag, mode="train")
    want = getattr(jax_config.opts_from_args(flag, mode="train"), field)
    assert getattr(ours, field) == want != getattr(Opts(), field)


def test_train_cli_checks_grad_accum():
    with pytest.raises(SystemExit, match="divisible"):
        opts_from_args(_TINY_CLI + ["--grad_accum", "3"], mode="train")
    with pytest.raises(SystemExit, match=">= 1"):
        opts_from_args(_TINY_CLI + ["--grad_accum", "0"], mode="train")
    assert opts_from_args(_TINY_CLI + ["--grad_accum", "2"],
                          mode="train").grad_accum == 2
