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

The metrics stay on the device; the loop reads them at its log points,
so a step does not wait for the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from pesr_torch import losses
from pesr_torch.training.state import TrainState

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
        l1, mse = _accumulate(
            lambda lr_mb, hr_mb: loss_fn(state, lr_mb, hr_mb),
            (_microbatches(lr_img, accum), _microbatches(hr_img, accum)),
            accum)
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

    ``eps`` [B, 1, 1, 1] are the penalty's interpolation weights
    (microbatch i takes ``eps[i::A]``); None draws them uniform from
    ``state.gp_rng``.  Metrics (on the device): ``d_loss``, ``g_loss``,
    ``g_gan``, ``tv``, ``vgg`` and ``l1`` when on, ``psnr``."""
    fns = losses.gan_losses(opts.gan_type,
                            opts.fl_gamma if opts.focal_loss else 0.0)
    accum = max(1, int(opts.grad_accum))
    ema_decay = float(opts.ema_decay)
    use_vgg, use_l1 = opts.alpha_vgg > 0.0, opts.alpha_l1 > 0.0
    names = (["g_loss", "g_gan", "tv"] + ["vgg"] * use_vgg + ["l1"] * use_l1
             + ["mse"])

    def d_loss_fn(d, sr, hr_mb, eps_mb):
        loss = fns["d"](d(hr_mb), d(sr))
        if opts.use_gp:
            loss = loss + 10.0 * losses.gradient_penalty(d, hr_mb, sr, eps_mb)
        return (loss,)

    def g_loss_fn(state, sr, hr_mb):
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
        d = state.discriminator
        lr = state.lr_at(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        state.d_optimizer.zero_grad(set_to_none=True)
        lrs, hrs = _microbatches(lr_img, accum), _microbatches(hr_img, accum)
        if opts.use_gp and eps is None:
            eps = torch.rand((hr_img.shape[0], 1, 1, 1),
                             generator=state.gp_rng, device=hr_img.device)
        epss = (_microbatches(eps, accum) if opts.use_gp
                else [None] * accum)

        if accum == 1:
            sr = state.apply(lr_img)
            (d_loss,) = _accumulate(
                lambda hr_mb, eps_mb: d_loss_fn(d, sr.detach(), hr_mb,
                                                eps_mb),
                (hrs, epss), 1)
        else:
            def d_mb(lr_mb, hr_mb, eps_mb):
                with torch.no_grad():
                    sr_mb = state.apply(lr_mb)
                return d_loss_fn(d, sr_mb, hr_mb, eps_mb)

            (d_loss,) = _accumulate(d_mb, (lrs, hrs, epss), accum)
        _set_lr(state.d_optimizer, lr)
        state.d_optimizer.step()

        d.requires_grad_(False)
        try:
            if accum == 1:
                aux = _accumulate(
                    lambda sr_mb, hr_mb: g_loss_fn(state, sr_mb, hr_mb),
                    ([sr], hrs), 1)
            else:
                aux = _accumulate(
                    lambda lr_mb, hr_mb: g_loss_fn(state, state.apply(lr_mb),
                                                   hr_mb),
                    (lrs, hrs), accum)
        finally:
            d.requires_grad_(True)
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
