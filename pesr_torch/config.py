"""Options of the port: the test-mode and train-mode subsets of
``pesr_tpu/config.py``.

Test mode has the single-device flow of the JAX ``test.py``: the folded
upsampler (``--fold``, on by default; tiled modes only), the x8
self-ensemble (``--self_ensemble``), network interpolation
(``--interp_model``, ``--interp_alpha``), int8 W8A8 inference
(``--quant int8``, with the quality guard ``--quant_guard_db``) and
``--compute_dtype float32`` (plain f32 convs, no kernel; also the
guard's fallback precision).  Train mode has the three phases of the JAX
package, ``--phase pretrain``, ``--phase train`` (the GAN fine-tune, with
JAX's loss flags, names and defaults) and ``--phase qat`` (L1 through the
W8A8 fake-quant forward); ``--eval_pi`` (on by default: the PIRM
perceptual index in every self-validation); ``--fold_train``, which
the CLI turns on unless ``--no_fold_train`` is given, as JAX's resolver
does (the dataclass default stays off; QAT ignores it);
``--compute_dtype`` (float32: plain convs with TF32 off on the card, no
kernel), ``--param_dtype`` (bfloat16 parameters and Adam moments),
``--profile_dir`` (a torch.profiler trace of steps 5-9) and
``--trim_host_heap``.  Both CLIs read the datasets ``synthetic``,
``synthetic_hard``, ``synthetic_hard_x4``, ``synthetic_device`` and
``natural`` besides folders.  On/off flags have their ``--no_`` twins.
Both CLIs take ``--mesh_shape N`` and ``--distributed`` (one process
per device: the process group from the ``PESR_*`` contract or torchrun,
``pesr_torch/parallel``): training data parallel over N processes, and
in test mode the engine's ``--mesh_axis batch|tiles`` (each rank
upscales its block of the batch, or its share of each image's tiles).
Test mode also has ``--export_artifact PATH`` (the serving artifact of
``pesr_torch/serving.py``), its own ``--profile_dir`` (a
torch.profiler trace of the timed pass over the eval set) and ``--arch
rcan`` (RCAN, ``--num_groups`` x ``--num_blocks`` x ``--num_channels``
with ``--reduction``; unset, the last two are RCAN x4's 20 and 64, and
EDSR's 32 and 256 without it).  Each parser
takes the flags its CLI reads; a flag it does not take is an argparse
error, not ignored.  So these
flags of JAX's shared parser are not in the port's: in test mode the
training flags JAX's ``test.py`` never reads (``--param_dtype``,
``--batch_size``, ``--patch_size``, ``--grad_accum``, ``--fold_train``,
``--train_dataset``, ``--valid_dataset``, ``--num_valids``,
``--num_repeats``, ``--vgg_weights``); in train mode the inference flags
JAX's loop never reads (``--fold``, ``--quant``, ``--quant_guard_db``,
``--mesh_axis``, ``--test_dataset``).  The port always runs its kernels
(no ``--use_pallas``) and its recompute backward keeps only each block's
input (no ``--remat``, no ``--unroll_body``), so JAX's resolver never
steps aside for those.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from pesr_torch.scales import upsample_stages


@dataclasses.dataclass(frozen=True)
class Opts:
    # model
    scale: int = 4
    num_channels: int = 256
    num_blocks: int = 32          # residual blocks (RCAN: per group)
    res_scale: float = 0.1
    arch: str = "edsr"            # edsr | rcan (test mode)
    num_groups: int = 10          # RCAN's residual groups
    reduction: int = 16           # RCAN's channel-attention reduction
    # data
    train_dataset: str = "DIV2K"
    valid_dataset: str = "PIRM"
    test_dataset: str = "Set5"
    data_root: str = "data"
    num_valids: int = 10
    patch_size: int = 48          # LR patch side; HR side = patch_size*scale
    batch_size: int = 16
    num_repeats: int = 20         # epoch = image list x num_repeats
    # training
    phase: str = "pretrain"       # "pretrain" (L1) | "train" (GAN) |
                                  # "qat" (L1, W8A8 fake-quant forward)
    pretrained_model: str = ""
    pretrained_d: str = ""        # discriminator init for the GAN phase
    learning_rate: float = 1e-4
    lr_step: int = 120            # epochs between x0.5 LR decays
    num_epochs: int = 300
    steps_per_epoch: int = 0      # 0 = ceil(num_images * num_repeats / batch)
    seed: int = 0
    ema_decay: float = 0.0        # 0 = off
    grad_accum: int = 1           # microbatches per optimizer step
    compute_dtype: str = "bfloat16"  # the kernels take bf16; float32:
                                     # plain convs, TF32 off, no kernel
    param_dtype: str = "float32"     # training parameters (and Adam's
                                     # moments): float32 | bfloat16
    # GAN losses (phase "train")
    gan_type: str = "RSGAN"       # RSGAN | RaSGAN | RaLSGAN | LSGAN | GAN
    use_gp: bool = False          # gradient penalty on D (weight 10)
    spectral_norm: bool = False   # stateless spectral norm on D's convs
    focal_loss: bool = False
    fl_gamma: float = 1.0
    alpha_vgg: float = 50.0
    alpha_gan: float = 1.0
    alpha_tv: float = 1e-6
    alpha_l1: float = 0.0
    vgg_layer: str = "54"         # conv5_4 pre-activation ("VGG54")
    vgg_weights: str = ""         # torchvision-layout VGG-19 .pth
    fold_train: bool = False      # train through the folded upsampler
                                  # (the train CLI turns it on)
    # checkpoints / logging
    check_point: str = "check_point/pesr"
    snapshot_every: int = 10      # epochs between snapshots (0 = last only)
    keep_snapshots: int = 0       # newest step_<K> dirs kept (0 = all)
    log_every: int = 50           # steps between scalar logs (0 = off)
    eval_every: int = 1           # epochs between self-validations (0 = off)
    eval_pi: bool = True          # PIRM PI (NIQE + Ma) in self-validation
    resume: bool = False
    trim_host_heap: bool = False  # malloc_trim(0) at epoch boundaries
    profile_dir: str = ""         # torch.profiler trace: steps 5-9 / test pass
    # inference (the training self-validation tiles as the JAX one: 96)
    model_path: str = ""
    output_dir: str = "results"
    tile_size: object = 96        # int, 0 = whole image, or "auto"
    tile_overlap: int = 8         # LR halo on each side
    infer_batch: int = 8          # images per device batch
    fold: bool = True             # folded upsampler in tiled inference
    self_ensemble: bool = False   # x8 geometric self-ensemble
    interp_model: str = ""        # network interpolation: second weights
    interp_alpha: float = 0.5     # (1 - a) * model_path + a * interp_model
    quant: str = "none"           # none | int8 (W8A8 inference, folded)
    quant_guard_db: float = 0.0   # > 0: int8-vs-bf16 agreement floor (dB)
                                  # below which the guard falls back
    export_artifact: str = ""     # serving artifact path (test mode)
    # multi-device: one process per device
    mesh_shape: str = ""          # N processes of the mesh; "" = the world
    mesh_axis: str = "batch"      # inference: batch (DP) | tiles (spatial)
    distributed: bool = False     # bring the process group up (PESR_* or
                                  # torchrun's environment)
    device: str = "cuda"

    @property
    def hr_patch_size(self) -> int:
        return self.patch_size * self.scale


_SETS = ("'synthetic', 'synthetic_hard', 'synthetic_hard_x4', "
         "'synthetic_device' (rendered on the device), 'natural' "
         "(photographs of installed packages)")


def _tile_size(value: str):
    """--tile_size parser: int or the literal "auto"."""
    if value == "auto":
        return value
    return int(value)


def _add_bool_flag(g, name: str, default: bool, help_: str) -> None:
    """An on/off flag ``--name`` with its ``--no_name`` twin."""
    g.add_argument(f"--{name}", dest=name, action="store_true",
                   default=default, help=help_)
    g.add_argument(f"--no_{name}", dest=name, action="store_false",
                   help=argparse.SUPPRESS)


# --num_blocks / --num_channels when not given, by --arch: EDSR's are the
# dataclass defaults; RCAN x4's are 20 RCAB a group at 64 channels
ARCH_DEFAULTS = {"edsr": {"num_blocks": Opts.num_blocks,
                          "num_channels": Opts.num_channels},
                 "rcan": {"num_blocks": 20, "num_channels": 64}}


def _add_model_flags(p: argparse.ArgumentParser, d: Opts, mode: str) -> None:
    g = p.add_argument_group("model")
    g.add_argument("--scale", type=int, default=d.scale,
                   help="super-resolution scale (any 2^a*3^b)")
    g.add_argument("--num_channels", type=int, default=None,
                   help=f"default: {d.num_channels} (EDSR), 64 (RCAN)")
    g.add_argument("--num_blocks", type=int, default=None,
                   help=f"residual blocks (RCAN: per group); default: "
                        f"{d.num_blocks} (EDSR), 20 (RCAN)")
    g.add_argument("--res_scale", type=float, default=d.res_scale)
    if mode == "test":
        g.add_argument("--arch", default=d.arch, choices=sorted(ARCH_DEFAULTS),
                       help="edsr: the EDSR-style generator; rcan: RCAN "
                            "(Zhang et al. 2018), residual groups of "
                            "channel-attention blocks")
        g.add_argument("--num_groups", type=int, default=d.num_groups,
                       help="RCAN's residual groups")
        g.add_argument("--reduction", type=int, default=d.reduction,
                       help="RCAN's channel-attention reduction")


def build_parser(mode: str = "test") -> argparse.ArgumentParser:
    """The flags of ``python -m pesr_torch.test`` (``mode="test"``) or
    ``python -m pesr_torch.train`` (``mode="train"``)."""
    d = Opts()
    desc = {"test": "pesr_torch inference: tiled x-scale SR of an eval set "
                    "on the H100 kernels, PNGs out, PSNR/SSIM printed",
            "train": "pesr_torch training on the H100 kernels: the L1 "
                     "pretrain phase, the GAN fine-tune (discriminator, "
                     "VGG perceptual, TV and relativistic losses) or QAT, "
                     "with PSNR/SSIM/PI self-validation and snapshots"}[mode]
    p = argparse.ArgumentParser(
        prog=f"python -m pesr_torch.{mode}", description=desc,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_model_flags(p, d, mode)
    g = p.add_argument_group("data")
    if mode == "test":
        g.add_argument("--dataset", "--test_dataset", dest="test_dataset",
                       default=d.test_dataset,
                       help=f"{_SETS} or a folder <data_root>/<name>/HR")
    else:
        g.add_argument("--train_dataset", default=d.train_dataset,
                       help=f"{_SETS}, 'DIV2K' (<data_root>/DIV2K/"
                            "DIV2K_train_HR) or a folder <data_root>/<name>")
        g.add_argument("--valid_dataset", default=d.valid_dataset,
                       help=f"{_SETS} or an eval folder, as --dataset of "
                            "pesr_torch.test")
        g.add_argument("--num_valids", type=int, default=d.num_valids)
        g.add_argument("--patch_size", type=int, default=d.patch_size,
                       help="LR patch side")
        g.add_argument("--batch_size", type=int, default=d.batch_size)
        g.add_argument("--num_repeats", type=int, default=d.num_repeats)
    g.add_argument("--data_root", default=d.data_root)
    if mode == "test":
        g.add_argument("--seed", type=int, default=d.seed,
                       help="random init (no --model_path) and synthetic "
                            "data")
        g = p.add_argument_group("inference")
        g.add_argument("--model_path", default=d.model_path,
                       help="EDSR-style generator .pth (see pesr_tpu.convert."
                            "save_generator_torch) or a pesr_torch training "
                            "checkpoint directory")
        g.add_argument("--output_dir", default=d.output_dir)
        g.add_argument("--tile_size", type=_tile_size, default="auto",
                       help='LR tile side, 0 = whole image, or "auto"')
        g.add_argument("--tile_overlap", type=int, default=d.tile_overlap)
        g.add_argument("--infer_batch", type=int, default=d.infer_batch)
        _add_bool_flag(g, "fold", d.fold,
                       "fold the linear upsampler + out chain into one conv "
                       "(tiled modes; exact on the interior, the engines "
                       "pad and crop its border band)")
        _add_bool_flag(g, "self_ensemble", d.self_ensemble,
                       "x8 geometric test-time augmentation")
        g.add_argument("--interp_model", default=d.interp_model,
                       help="network interpolation: blend this checkpoint's "
                            "weights into --model_path's as (1-a)*base + "
                            "a*this before inference")
        g.add_argument("--interp_alpha", type=float, default=d.interp_alpha,
                       help="blend factor a in [0, 1]: 0 = --model_path, "
                            "1 = --interp_model")
        g.add_argument("--quant", default=d.quant, choices=["none", "int8"],
                       help="post-training-quantized inference path (int8: "
                            "W8A8 calibrated on the eval set's LR tiles, "
                            "always on the folded upsampler)")
        g.add_argument("--quant_guard_db", type=float,
                       default=d.quant_guard_db,
                       help="int8 quality guard: minimum int8-vs-bf16 "
                            "output-agreement PSNR (dB) before falling back "
                            "to the folded --compute_dtype path with a "
                            "warning (0 = off; 55 = JAX's stress-calibrated "
                            "floor)")
        g.add_argument("--compute_dtype", default=d.compute_dtype,
                       choices=["bfloat16", "float32"],
                       help="bfloat16: the hand-written kernels; float32: "
                            "plain PyTorch convs with TF32 off (no kernel)")
        g.add_argument("--export_artifact", default=d.export_artifact,
                       help="write the tiled engine as a serving artifact "
                            "(pesr_torch/serving.py) for the first image's "
                            "shape at --infer_batch and exit")
        g.add_argument("--profile_dir", default=d.profile_dir,
                       help="write a torch.profiler Chrome trace of the "
                            "timed pass over the eval set here")
        g.add_argument("--mesh_axis", default=d.mesh_axis,
                       choices=["batch", "tiles"],
                       help="multi-device inference: shard the image batch "
                            "(throughput) or each image's tile grid "
                            "(spatial; single-image latency)")
    else:
        g = p.add_argument_group("training")
        g.add_argument("--phase", default=d.phase,
                       choices=["pretrain", "train", "qat"],
                       help="'pretrain' (L1), 'train' (the GAN fine-tune) "
                            "or 'qat' (L1 through the W8A8 fake-quant "
                            "forward)")
        g.add_argument("--pretrained_model", default=d.pretrained_model,
                       help="initial generator: a pesr_torch checkpoint "
                            "directory (EMA preferred)")
        g.add_argument("--pretrained_d", default=d.pretrained_d,
                       help="initial discriminator of the GAN phase: an "
                            "SRGAN-order .pth or a pesr_torch checkpoint "
                            "directory")
        g.add_argument("--learning_rate", type=float,
                       default=d.learning_rate)
        g.add_argument("--lr_step", type=int, default=d.lr_step,
                       help="epochs between x0.5 LR decays")
        g.add_argument("--num_epochs", type=int, default=d.num_epochs)
        g.add_argument("--steps_per_epoch", type=int,
                       default=d.steps_per_epoch,
                       help="0 = ceil(num_images * num_repeats / "
                            "batch_size)")
        g.add_argument("--seed", type=int, default=d.seed,
                       help="init, data crops and augmentation")
        g.add_argument("--ema_decay", type=float, default=d.ema_decay,
                       help="EMA of the generator parameters (0 = off); "
                            "eval, best checkpoint and inference use it")
        g.add_argument("--grad_accum", type=int, default=d.grad_accum,
                       help="microbatches per optimizer step (batch_size "
                            "must divide)")
        # None = not given: the CLI default is ON (opts_from_args), as in
        # the JAX package; the Opts default stays off for library callers.
        g.add_argument("--fold_train", dest="fold_train", action="store_true",
                       default=None,
                       help="train through the differentiable folded "
                            "upsampler (default on; patch borders see the "
                            "fold's one zero padding instead of one per "
                            "stage, the interior is the same)")
        g.add_argument("--no_fold_train", dest="fold_train",
                       action="store_false", help=argparse.SUPPRESS)
        g = p.add_argument_group("losses (phase train)")
        g.add_argument("--gan_type", default=d.gan_type,
                       choices=["RSGAN", "RaSGAN", "RaLSGAN", "LSGAN", "GAN"])
        _add_bool_flag(g, "GP", d.use_gp, "gradient penalty on D")
        _add_bool_flag(g, "spectral_norm", d.spectral_norm,
                       "spectral norm on D's convs")
        _add_bool_flag(g, "focal_loss", d.focal_loss,
                       "focal re-weighting of the GAN loss")
        g.add_argument("--fl_gamma", type=float, default=d.fl_gamma)
        g.add_argument("--alpha_vgg", type=float, default=d.alpha_vgg)
        g.add_argument("--alpha_gan", type=float, default=d.alpha_gan)
        g.add_argument("--alpha_tv", type=float, default=d.alpha_tv)
        g.add_argument("--alpha_l1", type=float, default=d.alpha_l1)
        g.add_argument("--vgg_layer", default=d.vgg_layer,
                       help="VGG-19 layer of the perceptual loss, e.g. 54 "
                            "= conv5_4 pre-activation")
        g.add_argument("--vgg_weights", default=d.vgg_weights,
                       help="torchvision-layout VGG-19 .pth (random "
                            "weights without it)")
        g = p.add_argument_group("checkpointing")
        g.add_argument("--check_point", default=d.check_point)
        g.add_argument("--snapshot_every", type=int, default=d.snapshot_every)
        g.add_argument("--keep_snapshots", type=int,
                       default=d.keep_snapshots,
                       help="retain the newest N step_<K> dirs (0 = all; "
                            "'best' is never pruned)")
        g.add_argument("--log_every", type=int, default=d.log_every)
        g.add_argument("--eval_every", type=int, default=d.eval_every)
        _add_bool_flag(g, "eval_pi", d.eval_pi,
                       "PIRM perceptual index (NIQE, Ma; on the host) in "
                       "self-validation")
        _add_bool_flag(g, "resume", d.resume,
                       "resume the networks' and optimizers' state from "
                       "the newest snapshot under --check_point")
        _add_bool_flag(g, "trim_host_heap", d.trim_host_heap,
                       "return freed host-heap arenas to the OS at epoch "
                       "boundaries (glibc malloc_trim)")
        g.add_argument("--profile_dir", default=d.profile_dir,
                       help="write a torch.profiler Chrome trace of steps "
                            "5-9 after the start here")
        g = p.add_argument_group("precision")
        g.add_argument("--compute_dtype", default=d.compute_dtype,
                       choices=["bfloat16", "float32"],
                       help="bfloat16: the hand-written kernels; float32: "
                            "plain PyTorch convs with TF32 off (no kernel)")
        g.add_argument("--param_dtype", default=d.param_dtype,
                       choices=["float32", "bfloat16"],
                       help="dtype of the generator's and discriminator's "
                            "parameters and of their Adam moments")
    g = p.add_argument_group("multi-device")
    g.add_argument("--mesh_shape", default=d.mesh_shape,
                   help="processes of the mesh, one device each (\"\" = "
                        "the whole process group; N > 1 needs one)")
    _add_bool_flag(g, "distributed", d.distributed,
                   "bring the process group up from PESR_COORDINATOR / "
                   "PESR_NUM_PROCESSES / PESR_PROCESS_ID or torchrun's "
                   "environment (raises without either)")
    p.add_argument("--device", default=d.device,
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def opts_from_args(argv: Optional[Sequence[str]] = None,
                   mode: str = "test") -> Opts:
    ns = vars(build_parser(mode).parse_args(argv))
    for key, value in ARCH_DEFAULTS[ns.get("arch", Opts.arch)].items():
        if ns[key] is None:
            ns[key] = value
    if "GP" in ns:
        ns["use_gp"] = ns.pop("GP")
    if ns.get("fold_train", False) is None:
        ns["fold_train"] = True
    opts = Opts(**ns)
    upsample_stages(opts.scale)  # fail fast on e.g. 5
    if opts.grad_accum < 1:
        raise SystemExit(f"--grad_accum must be >= 1, got {opts.grad_accum}")
    if mode == "train" and opts.batch_size % opts.grad_accum:
        raise SystemExit(f"--batch_size {opts.batch_size} must be divisible "
                         f"by --grad_accum {opts.grad_accum}")
    return opts
