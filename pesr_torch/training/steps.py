"""The train steps of both phases (counterpart of ``make_pretrain_step``,
``make_gan_step`` and their helpers in ``pesr_tpu/training/steps.py``).

Pretrain step: forward through the kernels, L1 loss (and the MSE for the
PSNR metric) in f32, backward (the recompute backward of the kernels),
one Adam update at the step's LR, then the EMA update.  With
``grad_accum`` A > 1 the batch is split into A strided microbatches
whose gradients are averaged before the single update: the full-batch
step for a per-sample mean loss, at ~1/A of the activation memory.

GAN step: the discriminator's update, then the generator's against the
updated discriminator, in JAX's order (see :func:`make_gan_step`).

On a mesh of P processes (``state.mesh``, data parallel) each rank
steps on its contiguous block of the global batch and the step computes
JAX's function of the global batch (one jit over a batch-sharded
array): after the backward every gradient is replaced by its mean over
the ranks (one all-reduce), every reduction that couples samples (the
relativistic means, the discriminator's batch statistics) is taken over
the global batch by a differentiable all-reduce (``parallel.sum_all``,
whose backward sums every rank's gradient), each rank backpropagates
its block's share of the loss, and the metrics are averaged over the
ranks.  Random draws (the penalty's ``eps``) are made for the global
batch on every rank from the same generator and sliced.

The metrics stay on the device; the loop reads them at its log points,
so a step does not wait for the device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch

from pesr_torch import losses, parallel
from pesr_torch.training.state import TrainState
from pesr_torch.utils.device import full_f32

Metrics = Dict[str, torch.Tensor]


def _psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    """PSNR over the model's [-1,1] range mapped to [0,1] (peak 1.0)."""
    return -10.0 * torch.log10(torch.clamp(mse / 4.0, min=1e-12))


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module,
               decay: float) -> None:
    """One EMA step on every parameter: ``e += (1 - decay) * (p - e)``."""
    e = list(ema.parameters())
    torch._foreach_add_(e, torch._foreach_sub(list(model.parameters()), e),
                        alpha=1.0 - float(decay))


def _microbatches(x: torch.Tensor, accum: int) -> List[torch.Tensor]:
    """[B, ...] -> ``accum`` microbatches of B / accum; microbatch i takes
    every ``accum``-th sample from i (the JAX package's strided split)."""
    b = x.shape[0]
    if b % accum:
        raise ValueError(f"batch size {b} not divisible by "
                         f"grad_accum={accum}")
    return [x[i::accum] for i in range(accum)]


def _accumulate(loss_fn: Callable, split_xs: Sequence[List[torch.Tensor]],
                accum: int) -> List[torch.Tensor]:
    """Run ``loss_fn(*microbatch) -> (loss, *aux)`` over the
    microbatches; each ``loss / accum`` is backpropagated at once, so the
    parameters' ``.grad`` accumulate the mean gradient and only one
    microbatch's activations live at a time.  Returns the mean of
    ``(loss, *aux)``, detached."""
    total = None
    for mb in zip(*split_xs):
        out = loss_fn(*mb)
        (out[0] / accum).backward()
        out = [t.detach() for t in out]
        total = out if total is None else [a + b for a, b in zip(total, out)]
    return [t / accum for t in total]


def _sync_grads(state: TrainState, module: torch.nn.Module) -> None:
    """Each gradient of ``module`` replaced by its mean over the mesh."""
    parallel.all_reduce_mean_(
        state.mesh, [p.grad for p in module.parameters()
                     if p.grad is not None])


def _mesh_mean(state: TrainState, values: List[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Per-rank scalar metrics -> their means over the mesh (the global
    batch's, every block being one size)."""
    if state.mesh is None or not state.mesh.collective:
        return values
    flat = torch.stack([v.float() for v in values])
    parallel.all_reduce_mean_(state.mesh, [flat])
    return list(flat.unbind())


def _precision(opts, x: torch.Tensor):
    """The step's numerics scope: float32 steps run forward and backward
    with TF32 off on the card (:func:`full_f32`), so cuDNN's backward
    convs keep the f32 they compute in."""
    return (full_f32(x.device) if opts.compute_dtype == "float32"
            else contextlib.nullcontext())


def make_pretrain_step(opts) -> Callable[[TrainState, torch.Tensor,
                                          torch.Tensor], Metrics]:
    """``step(state, lr_img, hr_img) -> {"l1", "psnr"}``: one L1 pretrain
    step on ``state`` (updated in place; ``state.step`` counts it).
    ``opts.grad_accum`` microbatches per update; with
    ``opts.ema_decay > 0`` the step also updates ``state.ema``."""
    accum = max(1, int(opts.grad_accum))
    ema_decay = float(opts.ema_decay)

    def loss_fn(state, lr_mb, hr_mb):
        sr = state.apply(lr_mb)
        return losses.l1_loss(sr, hr_mb), losses.l2_loss(sr, hr_mb)

    def step(state: TrainState, lr_img: torch.Tensor,
             hr_img: torch.Tensor) -> Metrics:
        state.optimizer.zero_grad(set_to_none=True)
        with _precision(opts, hr_img):
            l1, mse = _accumulate(
                lambda lr_mb, hr_mb: loss_fn(state, lr_mb, hr_mb),
                (_microbatches(lr_img, accum), _microbatches(hr_img, accum)),
                accum)
        _sync_grads(state, state.generator)
        l1, mse = _mesh_mean(state, [l1, mse])
        _set_lr(state.optimizer, state.lr_at(state.step))
        state.optimizer.step()
        state.step += 1
        if ema_decay > 0.0:
            ema_update(state.ema, state.generator, ema_decay)
        return {"l1": l1, "psnr": _psnr_from_mse(mse)}

    return step


def make_gan_step(opts) -> Callable[..., Metrics]:
    """``step(state, lr_img, hr_img, eps=None) -> metrics``: one GAN
    fine-tune step on ``state`` (which holds the discriminator, its
    optimizer, the VGG trunk when ``alpha_vgg > 0`` and the penalty's
    generator), updated in place.  In JAX's order:

    1. ONE generator forward through the kernels (``state.apply``);
    2. the discriminator's update on ``sr`` detached: D applied to HR and
       to SR separately (its batch statistics are per call), the D loss
       of ``gan_type``, plus 10 x the gradient penalty with ``--GP``, then
       D's Adam step at the step's LR;
    3. the generator's loss on the same ``sr`` against the UPDATED D:
       ``alpha_gan * gan + alpha_tv * tv``, plus ``alpha_vgg *`` the L1
       distance of VGG features (HR's without gradient) and ``alpha_l1 *
       l1`` when those weights are > 0; one backward into G (D frozen
       meanwhile, so neither step leaves gradients in the other network),
       G's Adam step, then the EMA update.

    With ``grad_accum`` A > 1 the D update accumulates over the strided
    microbatches, each recomputing its generator forward without
    gradient, and then the G update accumulates over them against the
    updated D: per-microbatch batch statistics and Ra means, as in JAX.

    ``eps`` [B, 1, 1, 1] are the penalty's interpolation weights of this
    rank's block (microbatch i takes ``eps[i::A]``); None draws them
    uniform from ``state.gp_rng`` for the global batch and takes the
    block.  Metrics (on the device): ``d_loss``, ``g_loss``,
    ``g_gan``, ``tv``, ``vgg`` and ``l1`` when on, ``psnr``."""
    gamma = opts.fl_gamma if opts.focal_loss else 0.0
    accum = max(1, int(opts.grad_accum))
    ema_decay = float(opts.ema_decay)
    use_vgg, use_l1 = opts.alpha_vgg > 0.0, opts.alpha_l1 > 0.0
    names = (["g_loss", "g_gan", "tv"] + ["vgg"] * use_vgg + ["l1"] * use_l1
             + ["mse"])

    def d_loss_fn(fns, d, sr, hr_mb, eps_mb):
        loss = fns["d"](d(hr_mb), d(sr))
        if opts.use_gp:
            loss = loss + 10.0 * losses.gradient_penalty(d, hr_mb, sr, eps_mb)
        return (loss,)

    def g_loss_fn(fns, state, sr, hr_mb):
        d = state.discriminator
        with torch.no_grad():
            dr = d(hr_mb)
        gan = fns["g"](dr, d(sr))
        tv = losses.tv_loss(sr)
        out = [opts.alpha_gan * gan + opts.alpha_tv * tv, gan, tv]
        if use_vgg:
            with torch.no_grad():
                f_hr = state.vgg(hr_mb)
            out.append(losses.perceptual_loss(state.vgg(sr), f_hr))
            out[0] = out[0] + opts.alpha_vgg * out[-1]
        if use_l1:
            out.append(losses.l1_loss(sr, hr_mb))
            out[0] = out[0] + opts.alpha_l1 * out[-1]
        out.append(losses.l2_loss(sr, hr_mb))
        return out

    def step(state: TrainState, lr_img: torch.Tensor, hr_img: torch.Tensor,
             eps: Optional[torch.Tensor] = None) -> Metrics:
        with _precision(opts, hr_img):
            return _step(state, lr_img, hr_img, eps)

    def _step(state, lr_img, hr_img, eps):
        d = state.discriminator
        mesh = state.mesh
        fns = losses.gan_losses(opts.gan_type, gamma,
                                lambda t: parallel.batch_mean(mesh, t))
        lr = state.lr_at(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        state.d_optimizer.zero_grad(set_to_none=True)
        lrs, hrs = _microbatches(lr_img, accum), _microbatches(hr_img, accum)
        if opts.use_gp and eps is None:
            p = mesh.size if mesh is not None else 1
            eps = torch.rand((hr_img.shape[0] * p, 1, 1, 1),
                             generator=state.gp_rng, device=hr_img.device)
            eps = eps[parallel.batch_sharding(mesh, eps.shape[0])]
        epss = (_microbatches(eps, accum) if opts.use_gp
                else [None] * accum)

        if accum == 1:
            sr = state.apply(lr_img)
            (d_loss,) = _accumulate(
                lambda hr_mb, eps_mb: d_loss_fn(fns, d, sr.detach(), hr_mb,
                                                eps_mb),
                (hrs, epss), 1)
        else:
            def d_mb(lr_mb, hr_mb, eps_mb):
                with torch.no_grad():
                    sr_mb = state.apply(lr_mb)
                return d_loss_fn(fns, d, sr_mb, hr_mb, eps_mb)

            (d_loss,) = _accumulate(d_mb, (lrs, hrs, epss), accum)
        _sync_grads(state, d)
        _set_lr(state.d_optimizer, lr)
        state.d_optimizer.step()

        d.requires_grad_(False)
        try:
            if accum == 1:
                aux = _accumulate(
                    lambda sr_mb, hr_mb: g_loss_fn(fns, state, sr_mb, hr_mb),
                    ([sr], hrs), 1)
            else:
                aux = _accumulate(
                    lambda lr_mb, hr_mb: g_loss_fn(fns, state,
                                                   state.apply(lr_mb), hr_mb),
                    (lrs, hrs), accum)
        finally:
            d.requires_grad_(True)
        _sync_grads(state, state.generator)
        d_loss, *aux = _mesh_mean(state, [d_loss, *aux])
        _set_lr(state.optimizer, lr)
        state.optimizer.step()
        state.step += 1
        if ema_decay > 0.0:
            ema_update(state.ema, state.generator, ema_decay)
        metrics = dict(zip(names, aux))
        metrics["psnr"] = _psnr_from_mse(metrics.pop("mse"))
        return {"d_loss": d_loss, **metrics}

    return step


def _set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
