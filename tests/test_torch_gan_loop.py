"""The port's GAN phase end to end on the CPU: ``python -m pesr_torch.train
--phase train`` from a pretrain checkpoint, its snapshots, ``--resume``
and ``--pretrained_d``, and a checkpoint round trip that must restore
both networks, both optimizers and the penalty's random stream exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu.convert import load_discriminator_weights
from pesr_tpu.models import Discriminator as JaxDiscriminator
from pesr_torch import test as test_cli
from pesr_torch import train as train_cli
from pesr_torch.config import Opts
from pesr_torch.training import checkpoint as ckpt
from pesr_torch.training import loop
from pesr_torch.training.state import (add_discriminator,
                                       create_generator_state, init_vgg,
                                       make_ema)
from pesr_torch.training.steps import make_gan_step

CPU = torch.device("cpu")
# x4, 2 x 16 generator, batch 2 of 24^2 LR patches (HR 96): the SRGAN
# discriminator (64 ... 512, dense 1024) and VGG54 at their full widths.
_TINY_CLI = ["--device", "cpu", "--num_blocks", "2", "--num_channels", "16",
             "--batch_size", "2", "--patch_size", "24", "--train_dataset",
             "synthetic", "--valid_dataset", "synthetic", "--num_valids",
             "2"]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _done(out):
    return json.loads(out.strip().splitlines()[-1][len("[done] "):])


def test_gan_cli_runs_from_a_pretrain_checkpoint_and_resumes(tmp_path,
                                                              capsys):
    pre, gan = str(tmp_path / "pre"), str(tmp_path / "gan")
    assert train_cli.main(_TINY_CLI + [
        "--steps_per_epoch", "2", "--num_epochs", "1", "--log_every", "0",
        "--check_point", pre]) == 0
    capsys.readouterr()
    gan_cli = _TINY_CLI + ["--phase", "train", "--pretrained_model", pre,
                           "--steps_per_epoch", "3", "--log_every", "3",
                           "--snapshot_every", "1", "--keep_snapshots", "1",
                           "--ema_decay", "0.9", "--check_point", gan]
    assert train_cli.main(gan_cli + ["--num_epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert "loaded pretrained generator (step 2)" in out
    assert "RANDOM VGG features" in out and "GAN phase: RSGAN" in out
    done = _done(out)
    # one generator forward per GAN step
    assert done["steps"] == 6 and done["train_forwards"] == 6
    assert np.isfinite(done["val_psnr"])
    recs = [r for r in _jsonl(os.path.join(gan, "train.jsonl"))
            if "d_loss" in r]
    assert [r["step"] for r in recs] == [3, 6]
    for r in recs:
        assert {"d_loss", "g_loss", "g_gan", "tv", "vgg", "psnr"} <= set(r)
        assert "l1" not in r
        assert all(np.isfinite(r[k]) for k in ("d_loss", "g_loss", "vgg"))
    assert sorted(os.listdir(gan)) == ["best", "step_6", "train.jsonl"]
    for snap in ("best", "step_6"):
        assert sorted(os.listdir(os.path.join(gan, snap))) == [
            "discriminator.pth", "ema.pth", "generator.pth",
            "train_state.pt"]
    ts = torch.load(os.path.join(gan, "step_6", ckpt.TRAIN_STATE),
                    weights_only=True)
    assert {"optimizer", "d_optimizer", "gp_rng", "augment"} <= set(ts)
    res = test_cli.run(["--device", "cpu", "--num_blocks", "2",
                        "--num_channels", "16", "--dataset", "synthetic",
                        "--model_path", os.path.join(gan, "best"),
                        "--output_dir", str(tmp_path / "out")])
    assert np.isfinite(res["psnr"])

    # --resume continues G, D and both optimizers from step_6
    assert train_cli.main(gan_cli + ["--num_epochs", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 6" in out
    assert "checkpoint has no discriminator" not in out
    done = _done(out)
    assert done["steps"] == 9 and done["train_forwards"] == 3
    assert os.path.isfile(os.path.join(gan, "step_9", ckpt.DISCRIMINATOR))

    # --pretrained_d takes a port checkpoint directory
    assert train_cli.main(_TINY_CLI + [
        "--phase", "train", "--pretrained_model", gan, "--pretrained_d", gan,
        "--steps_per_epoch", "1", "--num_epochs", "1", "--eval_every", "0",
        "--alpha_vgg", "0", "--check_point", str(tmp_path / "d")]) == 0
    out = capsys.readouterr().out
    assert f"loaded pretrained discriminator from {gan}" in out
    assert "RANDOM VGG" not in out


def _gan_state(opts):
    state = create_generator_state(opts, CPU)
    add_discriminator(state, opts, CPU)
    state.vgg = init_vgg(opts, CPU)
    state.ema = make_ema(state.generator)
    return state


def test_gan_checkpoint_round_trip_restores_everything(tmp_path):
    """Save after a step, restore into a state built from another seed:
    G, D, EMA, both Adams, the step and the penalty's generator come back
    exactly, and the next step (eps drawn from that generator) is the
    same bit for bit."""
    kw = dict(scale=2, num_blocks=1, num_channels=8, batch_size=2,
              patch_size=8, compute_dtype="float32", use_gp=True,
              vgg_layer="22", ema_decay=0.9, device="cpu")
    opts = Opts(**kw)
    step = make_gan_step(opts)
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32))
    a = _gan_state(opts)
    step(a, lr, hr)
    path = ckpt.save_train_ckpt(str(tmp_path), a, 12.5)
    b = _gan_state(Opts(**dict(kw, seed=7)))
    # the frozen VGG is in no snapshot: a resumed run rebuilds it from the
    # same --seed (or --vgg_weights)
    b.vgg = init_vgg(opts, CPU)
    at, best, ts = ckpt.restore_train_state(str(tmp_path), b)
    assert (at, best, ts["has_d"], ts["has_ema"]) == (1, 12.5, True, True)
    assert path.endswith("step_1")
    for net in ("generator", "discriminator", "ema"):
        for (n, p), q in zip(getattr(a, net).state_dict().items(),
                             getattr(b, net).state_dict().values()):
            assert torch.equal(p, q), (net, n)
    ma, mb = step(a, lr, hr), step(b, lr, hr)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for net in ("generator", "discriminator"):
        for p, q in zip(getattr(a, net).parameters(),
                        getattr(b, net).parameters()):
            assert torch.equal(p, q), net
    for oa, ob in ((a.optimizer, b.optimizer),
                   (a.d_optimizer, b.d_optimizer)):
        for sa, sb in zip(oa.state.values(), ob.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_snapshot_discriminator_loads_in_pesr_tpu_at_the_cli_widths(
        tmp_path):
    """The CLI's discriminator.pth (SRGAN widths at HR 96) through
    ``pesr_tpu.convert.load_discriminator_weights``."""
    opts = Opts(num_blocks=1, num_channels=8, patch_size=24,
                compute_dtype="float32", device="cpu")
    state = create_generator_state(opts, CPU)
    add_discriminator(state, opts, CPU)
    path = ckpt.save_train_ckpt(str(tmp_path), state)
    disc = JaxDiscriminator(dtype=jnp.float32)
    template = disc.init(jax.random.key(0), jnp.zeros((1, 96, 96, 3)))[
        "params"]
    params = load_discriminator_weights(
        os.path.join(path, ckpt.DISCRIMINATOR), template, 96)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 96, 96, 3)).astype(
        np.float32)
    want = np.asarray(disc.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = state.discriminator(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_run_training_names_qat_as_the_missing_phase():
    """QAT, once the missing phase, is ported (tests/test_torch_qat.py);
    an unknown phase is refused with the three the port has."""
    with pytest.raises(ValueError, match="'pretrain', 'train' and 'qat'"):
        loop.run_training(Opts(phase="int8", device="cpu"))
