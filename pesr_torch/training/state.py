"""Train state of the L1 pretrain phase: generator, Adam, the staircase LR
and the EMA copy (counterpart of ``pesr_tpu/training/state.py``).

The JAX package trains with ``optax.adam(b1=0.9, b2=0.999)`` (eps 1e-8,
added outside the square root) on an ``exponential_decay`` staircase:
the LR halves every ``lr_step`` epochs of ``steps_per_epoch`` steps and
step 0 uses the base LR.  ``torch.optim.Adam`` with the same betas and
eps computes the same update; its LR is set from :func:`make_lr_schedule`
before every step (``pretrain_step``), so the schedule needs no state of
its own in a checkpoint.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch

from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelTrainApply

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_lr_schedule(opts) -> Callable[[int], float]:
    """Step -> LR: ``learning_rate * 0.5 ** (step // (lr_step * spe))``.
    ``steps_per_epoch == 0`` means "derive from the dataset"; the loop
    resolves it before building the state, so a 0 here is a caller
    without a dataset, which gets the reference's 1000 steps per
    epoch."""
    spe = opts.steps_per_epoch if opts.steps_per_epoch > 0 else 1000
    every = max(1, opts.lr_step * spe)
    return lambda step: opts.learning_rate * 0.5 ** (step // every)


@dataclasses.dataclass
class TrainState:
    """What a pretrain step updates in place.  ``apply`` is the forward
    the step differentiates (:class:`KernelTrainApply` on ``generator``);
    ``ema`` is a copy of the generator holding the parameter average
    when ``--ema_decay > 0``."""
    generator: Generator
    optimizer: torch.optim.Optimizer
    lr_at: Callable[[int], float]
    apply: Callable[[torch.Tensor], torch.Tensor]
    step: int = 0
    ema: Optional[Generator] = None


def make_ema(generator: Generator) -> Generator:
    """The EMA copy, seeded with the current parameters (no zero-init
    bias correction: the GAN-SR convention)."""
    ema = copy.deepcopy(generator)
    ema.requires_grad_(False)
    return ema


def create_generator_state(opts, device: torch.device,
                           generator: Optional[Generator] = None
                           ) -> TrainState:
    """A generator from ``opts`` (random init from ``opts.seed``, or the
    given one), Adam over its parameters and the kernel-backed train
    apply in ``opts.compute_dtype``."""
    if generator is None:
        generator = Generator(opts.scale, opts.num_blocks, opts.num_channels,
                              opts.res_scale, device=device, seed=opts.seed)
    opt = torch.optim.Adam(generator.parameters(), lr=opts.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(generator, opt, make_lr_schedule(opts),
                      KernelTrainApply(generator,
                                       COMPUTE_DTYPES[opts.compute_dtype]))
