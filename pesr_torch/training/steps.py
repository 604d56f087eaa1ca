"""The L1 pretrain step (counterpart of ``make_pretrain_step`` and its
helpers in ``pesr_tpu/training/steps.py``).

One step: forward through the kernels, L1 loss (and the MSE for the PSNR
metric) in f32, backward (the recompute backward of the kernels), one
Adam update at the step's LR, then the EMA update.  With ``grad_accum``
A > 1 the batch is split into A strided microbatches whose gradients are
averaged before the single update: the full-batch step for a per-sample
mean loss, at ~1/A of the activation memory.

The metrics stay on the device; the loop reads them at its log points,
so a step does not wait for the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

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
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_at(state.step)
        state.optimizer.step()
        state.step += 1
        if ema_decay > 0.0:
            ema_update(state.ema, state.generator, ema_decay)
        return {"l1": l1, "psnr": _psnr_from_mse(mse)}

    return step
