"""Losses of both training phases (counterpart of ``pesr_tpu/losses.py``).

* Pixel losses (L1, L2): the pretrain objective and the PSNR metric.
* Total variation of the SR output and the perceptual distance between
  (already extracted) VGG features.
* The GAN family on raw discriminator logits: GAN, LSGAN, RSGAN (pairwise
  relativistic), RaSGAN and RaLSGAN (relativistic against the batch mean
  of the other logits), with an optional focal weight on the BCE.
* The gradient penalty on interpolates of HR and SR.

Every loss is a scalar in float32, whatever the dtype of its inputs.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def l1_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(sr.float() - hr.float()))


def l2_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    d = sr.float() - hr.float()
    return torch.mean(d * d)


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total variation of NHWC ``x``: ``2 * (mean dh^2 + mean dw^2)``."""
    xf = x.float()
    dh = xf[:, 1:] - xf[:, :-1]
    dw = xf[:, :, 1:] - xf[:, :, :-1]
    return 2.0 * (torch.mean(dh * dh) + torch.mean(dw * dw))


def perceptual_loss(feat_sr: torch.Tensor,
                    feat_hr: torch.Tensor) -> torch.Tensor:
    """L1 distance between VGG features (JAX's default criterion, the
    only one its GAN step uses)."""
    return l1_loss(feat_sr, feat_hr)


def _bce_logits(logits: torch.Tensor, target: float,
                focal_gamma: float) -> torch.Tensor:
    """Mean BCE-with-logits against a constant target, in the stable form
    ``max(x, 0) - x t + log1p(exp(-|x|))``; with ``focal_gamma > 0`` each
    term is weighted by ``(1 - p_correct) ** focal_gamma``, detached."""
    x = logits.float()
    bce = torch.clamp(x, min=0.0) - x * target + torch.log1p(
        torch.exp(-torch.abs(x)))
    if focal_gamma > 0.0:
        p = torch.sigmoid(x)
        p_correct = p if target > 0.5 else 1.0 - p
        bce = ((1.0 - p_correct) ** focal_gamma).detach() * bce
    return torch.mean(bce)


def gan_losses(gan_type: str, focal_gamma: float = 0.0,
               batch_mean: Callable[[torch.Tensor], torch.Tensor] = torch.mean
               ) -> Dict[str, LossFn]:
    """``{"d": fn, "g": fn}``, each ``fn(d_real_logits, d_fake_logits)``.
    The discriminator has no sigmoid; the relativistic types compare real
    and fake logits pairwise (RSGAN) or against the other side's batch
    mean (Ra*), which ``batch_mean`` takes: over the global batch on a
    mesh (``parallel.batch_mean``)."""
    g = focal_gamma

    def bce(x, t):
        return _bce_logits(x, t, g)

    if gan_type == "GAN":
        def d_loss(dr, df):
            return bce(dr, 1.0) + bce(df, 0.0)

        def g_loss(dr, df):
            return bce(df, 1.0)
    elif gan_type == "LSGAN":
        def d_loss(dr, df):
            return (l2_loss(dr, torch.ones_like(dr))
                    + l2_loss(df, torch.zeros_like(df)))

        def g_loss(dr, df):
            return l2_loss(df, torch.ones_like(df))
    elif gan_type == "RSGAN":
        def d_loss(dr, df):
            return bce(dr - df, 1.0)

        def g_loss(dr, df):
            return bce(df - dr, 1.0)
    elif gan_type == "RaSGAN":
        def d_loss(dr, df):
            return 0.5 * (bce(dr - batch_mean(df), 1.0)
                          + bce(df - batch_mean(dr), 0.0))

        def g_loss(dr, df):
            return 0.5 * (bce(dr - batch_mean(df), 0.0)
                          + bce(df - batch_mean(dr), 1.0))
    elif gan_type == "RaLSGAN":
        def d_loss(dr, df):
            return 0.5 * (torch.mean((dr - batch_mean(df) - 1.0) ** 2)
                          + torch.mean((df - batch_mean(dr) + 1.0) ** 2))

        def g_loss(dr, df):
            return 0.5 * (torch.mean((dr - batch_mean(df) + 1.0) ** 2)
                          + torch.mean((df - batch_mean(dr) - 1.0) ** 2))
    else:
        raise ValueError(f"unknown gan_type {gan_type!r}")
    return {"d": d_loss, "g": g_loss}


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                     hr: torch.Tensor, sr: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """``E[(||grad_x D(x_hat)|| - 1)^2]`` on ``x_hat = eps hr + (1 - eps)
    sr``, ``eps`` [B, 1, 1, 1] from the caller.  The input gradient keeps
    its graph (``create_graph``), so the penalty differentiates into D's
    parameters; ``hr`` and ``sr`` get no gradient."""
    x_hat = (eps * hr.detach().float()
             + (1.0 - eps) * sr.detach().float()).requires_grad_()
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(d_apply(x_hat).sum(), x_hat,
                                       create_graph=True)
    norms = torch.sqrt(torch.sum(grads * grads, dim=(1, 2, 3)) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)
