"""Training loop of both phases (counterpart of
``pesr_tpu/training/loop.py``): ``pretrain`` (L1) and ``train`` (the GAN
fine-tune: discriminator, VGG perceptual, TV and relativistic losses,
usually from ``--pretrained_model``).

Per epoch: ``steps_per_epoch`` steps (uint8 batch to the device, LR
synthesis + dihedral augmentation there, one step of the phase through
the kernels), then PSNR/SSIM self-validation on ``num_valids`` images of the
validation set through the tiled engine (``BatchTiledUpscaler``, tile
and overlap as the JAX package's training tiler) on a ``KernelApply``
built from the current or EMA weights, JSONL/stdout scalars, and
snapshots.  With ``--fold_train`` both the steps and the validation run
through the folded upsampler (as the JAX loop evaluates its train
apply); the engine pads and crops the fold's border band.  Ctrl-C saves
a snapshot of the interrupted step before
exiting, so ``--resume`` continues from it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from pesr_torch.data import augment, datasets
from pesr_torch.metrics import calc_psnr, calc_ssim
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.ops.tiling import BatchTiledUpscaler
from pesr_torch.training import checkpoint as ckpt
from pesr_torch.training.state import (COMPUTE_DTYPES, add_discriminator,
                                       create_generator_state, init_vgg,
                                       make_ema)
from pesr_torch.training.steps import make_gan_step, make_pretrain_step
from pesr_torch.utils.device import host_to_device, resolve_device
from pesr_torch.utils.logging import AverageMeter, MetricLogger


class EvalSkip(ValueError):
    """The validation set has no ground truth, so there is nothing to
    evaluate (the perceptual index is not in the port yet)."""


def evaluate(opts, apply_fn, samples=None) -> Dict[str, float]:
    """Mean Y-PSNR / SSIM against HR (``val_psnr`` / ``val_ssim``) of the
    SR outputs of ``apply_fn`` (a :class:`KernelApply`) on the validation
    set, tiled as the JAX package's training self-validation tiles it.
    Raises :class:`EvalSkip` when no sample has an HR image."""
    if samples is None:
        samples = datasets.load_eval_set(opts, opts.valid_dataset,
                                         opts.num_valids)
    if not samples:
        raise FileNotFoundError(
            f"validation set {opts.valid_dataset!r} is empty")
    engine = BatchTiledUpscaler(apply_fn, opts.scale, opts.tile_size,
                                opts.tile_overlap, device=opts.device)
    srs = engine.upscale_many([s.lr for s in samples], opts.infer_batch)
    psnr_m, ssim_m = AverageMeter(), AverageMeter()
    for s, sr in zip(samples, srs):
        if s.hr is not None:
            psnr_m.update(calc_psnr(sr, s.hr, crop_border=opts.scale))
            ssim_m.update(calc_ssim(sr, s.hr, crop_border=opts.scale))
    if not psnr_m.count:
        raise EvalSkip(f"validation set {opts.valid_dataset!r} has no "
                       f"ground-truth HR images: nothing to evaluate")
    return {"val_psnr": psnr_m.avg, "val_ssim": ssim_m.avg}


def run_training(opts) -> Dict[str, float]:
    """Run the configured phase end to end; returns the summary (steps,
    wall time, last validation, forward counts of training and eval)."""
    if opts.phase not in ("pretrain", "train"):
        raise ValueError(f"phase {opts.phase!r} is not ported (the port has "
                         f"'pretrain' and 'train'; 'qat' is still missing)")
    device = resolve_device(opts.device)
    opts = dataclasses.replace(opts, device=str(device))
    if opts.steps_per_epoch <= 0:
        n_img = datasets.train_num_images(opts)
        spe = -(-n_img * opts.num_repeats // opts.batch_size)
        opts = dataclasses.replace(opts, steps_per_epoch=spe)
        print(f"epoch length: {n_img} images x {opts.num_repeats} repeats"
              f" / batch {opts.batch_size} = {spe} steps")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"device: {where}, phase={opts.phase}, compute "
          f"{opts.compute_dtype}")
    if opts.fold_train:
        print("generator apply: folded upsampler (--fold_train)")

    state = create_generator_state(opts, device)
    if opts.pretrained_model:
        sd, at_step = ckpt.restore_generator_params(opts.pretrained_model)
        ckpt.validate_params_compat(state.generator.state_dict(), sd)
        state.generator.load_state_dict(sd)
        print(f"loaded pretrained generator (step {at_step}) from "
              f"{opts.pretrained_model}")
    if opts.ema_decay > 0.0:
        state.ema = make_ema(state.generator)
    if opts.phase == "train":
        step_fn = _gan_setup(opts, state, device)
    else:
        step_fn = make_pretrain_step(opts)
    aug = torch.Generator().manual_seed(opts.seed)

    best_psnr = None
    if opts.resume:
        _, best_psnr, ts = ckpt.restore_train_state(opts.check_point, state)
        if "augment" in ts:
            aug.set_state(ts["augment"])
        if state.ema is not None and not ts["has_ema"]:
            state.ema = make_ema(state.generator)
            print("[ema] checkpoint has no EMA copy: re-seeding the "
                  "average from the restored parameters")
        if state.discriminator is not None and not ts["has_d"]:
            print("[gan] checkpoint has no discriminator: D keeps its "
                  "initialisation")
        print(f"resumed from {opts.check_point} at step {state.step}"
              + (f" (best_psnr {best_psnr:.2f})" if best_psnr else ""))
    if state.ema is not None:
        print(f"EMA of generator params enabled (decay {opts.ema_decay})")
    start_step = state.step
    train_iter, lr_from_files = datasets.make_train_iterator(
        opts, start_step=start_step)
    print("LR source: pre-generated files (DIV2K bicubic track)"
          if lr_from_files else
          "LR source: synthesized on the device (MATLAB-bicubic)")
    if opts.eval_every > 0:
        print("[val] PSNR/SSIM only: the perceptual index (NIQE, Ma) is "
              "not in the port yet")

    logger = MetricLogger(opts.check_point, name=opts.phase)
    box = {"best_psnr": best_psnr, "eval_forwards": 0,
           "extra": {"data_seed": opts.seed, "data_start_step": start_step}}
    summary: Dict[str, float] = {}
    t_start = time.time()
    try:
        _train_epochs(opts, state, step_fn, aug, train_iter, logger,
                      summary, box)
    except KeyboardInterrupt:
        path = ckpt.save_train_ckpt(
            opts.check_point, state, box["best_psnr"],
            dict(box["extra"], augment=aug.get_state()))
        print(f"\n[interrupt] checkpoint saved to {path}; resume with "
              f"--resume --check_point {opts.check_point}")
        raise
    finally:
        train_iter.close()
        logger.close()
    summary["steps"] = state.step
    summary["wall_s"] = time.time() - t_start
    summary["train_forwards"] = state.apply.forwards
    summary["eval_forwards"] = box["eval_forwards"]
    return summary


def _gan_setup(opts, state, device):
    """The GAN phase's additions to ``state`` (discriminator from
    ``--pretrained_d`` or the seed, the VGG trunk when ``alpha_vgg > 0``)
    and its step."""
    add_discriminator(state, opts, device)
    if opts.pretrained_d:
        sd = ckpt.restore_discriminator_params(opts.pretrained_d,
                                               opts.hr_patch_size)
        ckpt.validate_params_compat(state.discriminator.state_dict(), sd,
                                    "discriminator")
        state.discriminator.load_state_dict(sd)
        print(f"loaded pretrained discriminator from {opts.pretrained_d}")
    if opts.alpha_vgg > 0.0:
        state.vgg = init_vgg(opts, device)
        if not opts.vgg_weights:
            print("WARNING: --alpha_vgg > 0 but no --vgg_weights: the "
                  "perceptual anchor uses RANDOM VGG features, whose "
                  "magnitudes are ~100x smaller than trained VGG54's; the "
                  "adversarial term will dominate and PSNR can collapse. "
                  "Provide torchvision-layout VGG-19 weights, or add "
                  "--alpha_l1 1.0 as a pixel anchor for experiments.")
    print(f"GAN phase: {opts.gan_type}, alpha vgg {opts.alpha_vgg} (layer "
          f"{opts.vgg_layer}) gan {opts.alpha_gan} tv {opts.alpha_tv} l1 "
          f"{opts.alpha_l1}, GP {opts.use_gp}, spectral norm "
          f"{opts.spectral_norm}, focal {opts.focal_loss}")
    return make_gan_step(opts)


def _train_epochs(opts, state, step_fn, aug, train_iter, logger, summary,
                  box) -> None:
    device = torch.device(opts.device)
    pending: list = []
    t_window = time.time()

    def flush() -> None:
        """Average and log the pending step metrics (this reads them from
        the device, so it waits for the steps), and restart the
        throughput window."""
        nonlocal t_window
        if not pending:
            return
        avg = {k: float(torch.stack([m[k] for m in pending]).mean())
               for k in pending[0]}
        now = time.time()
        window = max(now - t_window, 1e-9)
        t_window = now
        avg["steps_per_s"] = len(pending) / window
        avg["mpx_per_s"] = (len(pending) * opts.batch_size
                            * opts.hr_patch_size ** 2 / window / 1e6)
        logger.log(state.step, avg, prefix=opts.phase)
        pending.clear()

    start_epoch = state.step // max(opts.steps_per_epoch, 1)
    for epoch in range(start_epoch, opts.num_epochs):
        while state.step < (epoch + 1) * opts.steps_per_epoch:
            lr_u8, hr_u8 = next(train_iter)
            hr_u8 = host_to_device(torch.from_numpy(hr_u8), device)
            if lr_u8 is not None:
                lr_u8 = host_to_device(torch.from_numpy(lr_u8), device)
            bits = augment.dihedral_bits(aug, hr_u8.shape[0], device)
            lr_img, hr_img = augment.prepare_train_batch(
                bits, hr_u8, opts.scale, lr_u8)
            metrics = step_fn(state, lr_img, hr_img)
            if opts.log_every > 0:
                pending.append(metrics)
                if state.step % opts.log_every == 0:
                    flush()
        flush()
        extra = dict(box["extra"], augment=aug.get_state())
        if opts.eval_every > 0 and (epoch + 1) % opts.eval_every == 0:
            _validate(opts, state, logger, summary, box, extra)
        if ((opts.snapshot_every > 0
             and (epoch + 1) % opts.snapshot_every == 0)
                or epoch + 1 == opts.num_epochs):
            path = ckpt.save_train_ckpt(opts.check_point, state,
                                        box["best_psnr"], extra)
            print(f"[ckpt] saved {path}")
            pruned = ckpt.prune_snapshots(opts.check_point,
                                          opts.keep_snapshots)
            if pruned:
                print(f"[ckpt] pruned {len(pruned)} old snapshot(s) "
                      f"(keep_snapshots={opts.keep_snapshots})")
        t_window = time.time()


def _validate(opts, state, logger, summary, box, extra) -> None:
    """Self-validation of the EMA weights when there are any (what the
    best checkpoint and inference use), else of the live ones, folded
    when the steps are; a new best PSNR writes ``best/``."""
    if "eval_samples" not in box:
        try:
            box["eval_samples"] = datasets.load_eval_set(
                opts, opts.valid_dataset, opts.num_valids)
        except FileNotFoundError as e:
            print(f"[val] skipped: {e}")
            return
    apply_fn = KernelApply(
        state.ema if state.ema is not None else state.generator,
        COMPUTE_DTYPES[opts.compute_dtype], fold=opts.fold_train)
    try:
        val = evaluate(opts, apply_fn, samples=box["eval_samples"])
    except EvalSkip as e:
        print(f"[val] skipped: {e}")
        return
    finally:
        box["eval_forwards"] += apply_fn.forwards
    logger.log(state.step, val, prefix="val")
    summary.update(val)
    if val["val_psnr"] > (box["best_psnr"] or -1.0):
        box["best_psnr"] = val["val_psnr"]
        path = ckpt.save_best_ckpt(opts.check_point, state,
                                   val["val_psnr"], extra)
        print(f"[ckpt] new best val_psnr={val['val_psnr']:.2f} -> {path}")
        summary["best_psnr"] = val["val_psnr"]
