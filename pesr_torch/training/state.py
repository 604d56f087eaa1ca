"""Train state of both phases: generator, Adam, the staircase LR and the
EMA copy; in the GAN phase also the discriminator with its own Adam, the
frozen VGG trunk and the gradient penalty's random generator
(counterpart of ``pesr_tpu/training/state.py``).

The JAX package trains with ``optax.adam(b1=0.9, b2=0.999)`` (eps 1e-8,
added outside the square root) on an ``exponential_decay`` staircase:
the LR halves every ``lr_step`` epochs of ``steps_per_epoch`` steps and
step 0 uses the base LR.  ``torch.optim.Adam`` with the same betas and
eps computes the same update; its LR is set from :func:`make_lr_schedule`
before every step (by the steps), so the schedule needs no state of its
own in a checkpoint.  The discriminator's Adam is the same optimizer on
the same schedule (JAX's ``_make_tx`` for both networks).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch

from pesr_torch.convert import load_vgg19_pth
from pesr_torch.models.discriminator import (Discriminator,
                                             set_batch_stats_mesh)
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import Float32TrainApply, KernelTrainApply
from pesr_torch.models.qat import QatApply
from pesr_torch.models.vgg import VGG19Features
from pesr_torch.parallel import Mesh

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
PARAM_DTYPES = COMPUTE_DTYPES


def plain_float32(opts, device: torch.device) -> bool:
    """True where ``--compute_dtype float32`` runs on plain PyTorch convs
    instead of the kernels: on a CUDA device (the kernels take bf16
    only).  On the CPU the kernel wrappers run those plain versions
    anyway."""
    return opts.compute_dtype == "float32" and device.type == "cuda"


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
    """What a train step updates in place.  ``apply`` is the forward the
    step differentiates (:class:`KernelTrainApply` on ``generator``,
    folded or not, or the QAT phase's :class:`QatApply`);
    ``ema`` is a copy of the generator holding the parameter average
    when ``--ema_decay > 0``.  The GAN phase also sets
    ``discriminator`` and ``d_optimizer`` (:func:`add_discriminator`),
    ``vgg`` when ``alpha_vgg > 0`` (:func:`init_vgg`), and ``gp_rng``, the
    generator the step draws the gradient penalty's ``eps`` from.
    ``mesh``: the data-parallel process group the step averages over
    (None: this process alone)."""
    generator: Generator
    optimizer: torch.optim.Optimizer
    lr_at: Callable[[int], float]
    apply: Callable[[torch.Tensor], torch.Tensor]
    step: int = 0
    ema: Optional[Generator] = None
    discriminator: Optional[Discriminator] = None
    d_optimizer: Optional[torch.optim.Optimizer] = None
    vgg: Optional[VGG19Features] = None
    gp_rng: Optional[torch.Generator] = None
    mesh: Optional[Mesh] = None


def make_ema(generator: Generator) -> Generator:
    """The EMA copy, seeded with the current parameters (no zero-init
    bias correction: the GAN-SR convention)."""
    ema = copy.deepcopy(generator)
    ema.requires_grad_(False)
    return ema


def create_generator_state(opts, device: torch.device,
                           generator: Optional[Generator] = None,
                           mesh: Optional[Mesh] = None) -> TrainState:
    """A generator from ``opts`` (random init from ``opts.seed``, or the
    given one) with its parameters in ``opts.param_dtype`` (JAX's
    ``param_dtype``: bf16 parameters give Adam bf16 moments, as optax's
    ``zeros_like``), Adam over them and the train apply in
    ``opts.compute_dtype``: the kernel-backed one, through the folded
    upsampler when ``opts.fold_train`` (JAX's
    ``configure_generator_apply``), or :class:`Float32TrainApply` for
    float32 on the card (:func:`plain_float32`), or in phase ``qat`` the
    fake-quant forward, which ignores ``fold_train`` as JAX's does.  The
    parameters and snapshots stay those of the plain generator.
    ``mesh``: the data-parallel process group of the steps (the QAT
    forward takes its activation scales over it)."""
    if generator is None:
        generator = Generator(opts.scale, opts.num_blocks, opts.num_channels,
                              opts.res_scale, device=device, seed=opts.seed)
    generator.to(PARAM_DTYPES[opts.param_dtype])
    dtype = COMPUTE_DTYPES[opts.compute_dtype]
    if opts.phase == "qat":
        apply = QatApply(generator, dtype, mesh)
    elif plain_float32(opts, device):
        apply = Float32TrainApply(generator, fold=opts.fold_train)
    else:
        apply = KernelTrainApply(generator, dtype, fold=opts.fold_train)
    return TrainState(generator, _adam(generator, opts),
                      make_lr_schedule(opts), apply, mesh=mesh)


def _adam(module: torch.nn.Module, opts) -> torch.optim.Optimizer:
    return torch.optim.Adam(module.parameters(), lr=opts.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def add_discriminator(state: TrainState, opts, device: torch.device,
                      discriminator: Optional[Discriminator] = None) -> None:
    """Give ``state`` the GAN phase's discriminator (random init from
    ``opts.seed + 1``, or the given one; SRGAN widths, dense 1024, sized
    for ``opts.hr_patch_size``, computing in ``opts.compute_dtype``, its
    parameters in ``opts.param_dtype``) with its Adam, and the penalty's
    generator on ``device`` (seeded with ``opts.seed + 3``).  On a mesh
    (``state.mesh``) D's batch statistics are the global batch's."""
    if discriminator is None:
        discriminator = Discriminator(
            opts.hr_patch_size, spectral_norm=opts.spectral_norm,
            dtype=COMPUTE_DTYPES[opts.compute_dtype], device=device,
            seed=opts.seed + 1)
    discriminator.to(PARAM_DTYPES[opts.param_dtype])
    set_batch_stats_mesh(discriminator, state.mesh)
    state.discriminator = discriminator
    state.d_optimizer = _adam(discriminator, opts)
    state.gp_rng = torch.Generator(device=device).manual_seed(opts.seed + 3)


def init_vgg(opts, device: torch.device) -> VGG19Features:
    """The frozen VGG-19 trunk up to ``opts.vgg_layer`` in
    ``opts.compute_dtype``: ``--vgg_weights`` (a torchvision-layout
    ``.pth``) when given, else random from ``opts.seed + 2``."""
    vgg = VGG19Features(opts.vgg_layer, COMPUTE_DTYPES[opts.compute_dtype],
                        device=device, seed=opts.seed + 2)
    if opts.vgg_weights:
        vgg.load_state_dict(load_vgg19_pth(opts.vgg_weights, opts.vgg_layer))
    return vgg
