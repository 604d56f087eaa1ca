"""The port's GAN step on 2 gloo ranks against the JAX package's GAN step
on a 2-device mesh of the conftest's virtual devices (one jit over a
batch-sharded global batch), from the same weights, global batch and
penalty ``eps``: RaSGAN with the gradient penalty and VGG, whose
relativistic means, discriminator batch statistics and penalty couple
the samples of the two blocks.  Held at tests/test_torch_gan_step.py's
tolerances: metrics atol 1e-6, rtol 1e-5 (PSNR atol 1e-4); gradients
atol 1e-6 (D 2e-5, the penalty's), rtol 1e-4; Adam's moments; the
parameters to 2e-6 except where Adam may move them by 2 lr.  The workers
are this file run as a script under the ``PESR_*`` contract
(tests/test_torch_ddp.py's :func:`run_group`)."""

import os
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from pesr_torch import parallel  # noqa: E402
from pesr_torch.config import Opts  # noqa: E402
from pesr_torch.models.discriminator import Discriminator  # noqa: E402
from pesr_torch.training import steps  # noqa: E402
from pesr_torch.training.state import (add_discriminator,  # noqa: E402
                                       create_generator_state)
from tests.test_torch_ddp import run_workers, worker_mesh  # noqa: E402

CPU = torch.device("cpu")


# tests/test_torch_gan_step.py's Pair geometry (checked against it below),
# kept here so that the workers import no JAX
ARCH = dict(scale=2, num_blocks=2, num_channels=8)
D_KW = dict(channel_schedule=(4, 8, 8, 8), dense_features=16)
BATCH, PATCH, LR0 = 4, 16, 1e-4


def worker_gan_vs_jax(workdir):
    from pesr_torch.models.generator import Generator
    from pesr_torch.models.vgg import VGG19Features
    mesh = worker_mesh()
    sds = torch.load(os.path.join(workdir, "pair.pt"))
    inp = torch.load(os.path.join(workdir, "batch.pt"))
    opts = Opts(**ARCH, batch_size=BATCH, patch_size=PATCH,
                learning_rate=LR0, lr_step=1, steps_per_epoch=1,
                alpha_vgg=1.0, gan_type="RaSGAN", use_gp=True,
                compute_dtype="float32", device="cpu")
    gen = Generator(**ARCH, device="cpu", seed=None)
    gen.load_state_dict(sds["g"])
    state = create_generator_state(opts, CPU, gen)
    state.mesh = mesh
    d = Discriminator(opts.hr_patch_size, dtype=torch.float32, device="cpu",
                      seed=None, **D_KW)
    d.load_state_dict(sds["d"])
    add_discriminator(state, opts, CPU, d)
    state.vgg = VGG19Features(opts.vgg_layer, torch.float32, device="cpu",
                              seed=None)
    state.vgg.load_state_dict(sds["vgg"])
    block = parallel.batch_sharding(mesh, BATCH)
    m = steps.make_gan_step(opts)(state, inp["lr"][block], inp["hr"][block],
                                  inp["eps"][block])
    if mesh.rank == 0:
        out = {"metrics": {k: float(v) for k, v in m.items()}}
        for tag, net, opt in (("g", state.generator, state.optimizer),
                              ("d", d, state.d_optimizer)):
            out[tag] = {n: {"param": p.detach(), "grad": p.grad,
                            **{k: opt.state[p][k] for k in
                               ("exp_avg", "exp_avg_sq")}}
                        for n, p in net.named_parameters()}
        torch.save(out, os.path.join(workdir, "out.pt"))


class _Adam:
    """The ``state`` lookup of ``_check_net`` over saved moments."""

    def __init__(self, net, saved):
        self.state = {p: saved[n] for n, p in net.named_parameters()}


def test_two_rank_gan_step_matches_jax_on_a_two_device_mesh(tmp_path):
    import jax
    import jax.numpy as jnp
    from pesr_tpu.parallel import make_mesh, shard_batch
    from pesr_tpu.parallel import shard_pytree_replicated
    from tests import test_torch_gan_step as ref
    from pesr_torch.models.generator import Generator
    assert (ref.ARCH, ref.D_KW, ref.BATCH, ref.PATCH, ref.LR0) == (
        ARCH, D_KW, BATCH, PATCH, LR0)
    pair = ref.Pair(gan_type="RaSGAN", use_gp=True)
    st = pair.state
    torch.save({"g": st.generator.state_dict(),
                "d": st.discriminator.state_dict(),
                "vgg": st.vgg.state_dict()},
               os.path.join(tmp_path, "pair.pt"))
    lr, hr = ref.batch(0)
    key = jax.random.key(10)
    torch.save({"lr": torch.from_numpy(lr), "hr": torch.from_numpy(hr),
                "eps": torch.from_numpy(pair.eps(key))},
               os.path.join(tmp_path, "batch.pt"))
    run_workers(__file__, "gan_vs_jax", tmp_path)

    mesh = make_mesh(2)
    g0, d0 = jax.tree_util.tree_map(jnp.copy,
                                    (pair.g.params, pair.d.params))
    pair.g = shard_pytree_replicated(mesh, pair.g)
    pair.d = shard_pytree_replicated(mesh, pair.d)
    pair.vgg_params = shard_pytree_replicated(mesh, pair.vgg_params)
    sharded = shard_batch(mesh, {"lr": lr, "hr": hr})
    assert len(sharded["hr"].sharding.device_set) == 2
    want = pair.jax_step(sharded["lr"], sharded["hr"], key)
    dg, gg = pair.reference_grads(g0, d0, pair.d.params, lr, hr, key)

    got = torch.load(os.path.join(tmp_path, "out.pt"), weights_only=False)
    assert sorted(got["metrics"]) == sorted(want)
    for name, v in want.items():
        tol = (dict(atol=1e-4) if name == "psnr"
               else dict(atol=1e-6, rtol=1e-5))
        np.testing.assert_allclose(got["metrics"][name], v, err_msg=name,
                                   **tol)
    hr_size = pair.jopts.hr_patch_size
    for tag, want_grads, adam, params, atol in (
            ("g", gg, pair.g.opt_state[0], ref.sd_g(pair.g.params), 1e-6),
            ("d", dg, pair.d.opt_state[0], ref.sd_d(pair.d.params, hr_size),
             2e-5)):
        conv = ref.sd_g if tag == "g" else (lambda t: ref.sd_d(t, hr_size))
        net = (Generator(**ARCH, device="cpu", seed=None) if tag == "g"
               else Discriminator(hr_size, dtype=torch.float32, device="cpu",
                                  seed=None, **D_KW))
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(got[tag][n]["param"])
                p.grad = got[tag][n]["grad"]
        ref._check_net(net, _Adam(net, got[tag]), want_grads, conv(adam.mu),
                       conv(adam.nu), params, {}, LR0, atol)


if __name__ == "__main__":
    {"gan_vs_jax": worker_gan_vs_jax}[sys.argv[1]](sys.argv[2])
