"""Training loop of the three phases (counterpart of
``pesr_tpu/training/loop.py``): ``pretrain`` (L1), ``train`` (the GAN
fine-tune: discriminator, VGG perceptual, TV and relativistic losses,
usually from ``--pretrained_model``) and ``qat`` (the L1 step through the
W8A8 fake-quant forward of ``models/qat.py``).

Per epoch: ``steps_per_epoch`` steps (uint8 batch to the device, unless
``synthetic_device`` rendered it there; LR synthesis + dihedral
augmentation there, one step of the phase), then
self-validation on ``num_valids`` images of the validation set, tiled as
the JAX package tiles it: its host-stitch ``TiledUpscaler`` (fixed
96-px tiles, ``tile_overlap`` px of replicated context on every border,
tiles of all images in batches of ``infer_batch``), kept across evals
with the apply swapped.  The apply is a ``KernelApply`` of the current
or EMA weights, through the folded upsampler with ``--fold_train`` (as
the JAX loop evaluates its train apply), or in phase ``qat`` the same
fake-quant forward the steps take, so ``val_psnr`` is the quantized
quality.  Scores: Y-PSNR / SSIM against HR, and with ``--eval_pi`` the
PIRM perceptual index of each SR output (float64 numpy on the host).
Then JSONL/stdout scalars and snapshots; a new best PSNR writes
``best/``, and with ``--trim_host_heap`` freed host heap goes back to the
OS.  ``--profile_dir`` traces steps 5-9 after the start with
``torch.profiler`` (CPU and CUDA activities, each step a ``train_step``
range) into a Chrome trace ``*.pt.trace.json``; the trace is closed and
written on every exit path.  Ctrl-C saves a snapshot of the interrupted
step before exiting, so ``--resume`` continues from it.

``--mesh_shape N`` (``--distributed`` brings the process group up)
trains data parallel on N processes, one device each, as JAX's loop
runs one jit over a batch-sharded global batch: every rank draws its
``batch_size / N`` patches from its own stream, the augmentation bits
and the penalty's ``eps`` are drawn for the global batch on every rank
and sliced, and the steps average over the mesh (``training/steps.py``).
Every rank runs the same self-validation on its replicated weights and
takes the best-PSNR decision together (:func:`parallel.all_agree`);
rank 0 alone writes the log, the snapshots and the profile, and prunes;
an interrupt saves nothing on a mesh (the save waits for every rank at a
barrier, which the others would not reach).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import torch

from pesr_torch import parallel
from pesr_torch.data import augment, datasets
from pesr_torch.metrics import calc_psnr, calc_ssim, perceptual_index
from pesr_torch.models.kernel_apply import (Float32Apply, Float32TrainApply,
                                            KernelApply)
from pesr_torch.models.qat import QatApply
from pesr_torch.ops.tiling import TiledUpscaler
from pesr_torch.training import checkpoint as ckpt
from pesr_torch.training.state import (COMPUTE_DTYPES, add_discriminator,
                                       create_generator_state, init_vgg,
                                       make_ema, plain_float32)
from pesr_torch.training.steps import make_gan_step, make_pretrain_step
from pesr_torch.utils.device import host_to_device
from pesr_torch.utils.logging import AverageMeter, MetricLogger
from pesr_torch.utils.memory import trim_host_heap
from pesr_torch.utils.spans import span, start_profile, stop_profile

PROFILE_STEPS = range(5, 10)  # steps after the start that --profile_dir traces


class EvalSkip(ValueError):
    """Nothing to evaluate: the validation set has no ground truth and
    the perceptual index is off or could not be computed."""


def evaluate(opts, apply_fn, samples=None,
             tiler: Optional[TiledUpscaler] = None,
             compute_pi: bool = True) -> Dict[str, float]:
    """Self-validation of ``apply_fn`` (a :class:`KernelApply` or
    :class:`QatApply`) on the validation set through the host-stitch
    :class:`TiledUpscaler` (``tile_size``, ``tile_overlap`` and
    ``infer_batch`` of ``opts``), scored by :func:`score_outputs`.  Pass
    the ``tiler`` of an earlier eval to reuse it with ``apply_fn``
    swapped in."""
    if samples is None:
        samples = datasets.load_eval_set(opts, opts.valid_dataset,
                                         opts.num_valids)
    if not samples:
        raise FileNotFoundError(
            f"validation set {opts.valid_dataset!r} is empty")
    if tiler is None:
        tiler = make_eval_tiler(opts, apply_fn)
    else:
        tiler.update_apply(apply_fn)
    srs = tiler.upscale_many([s.lr for s in samples])
    return score_outputs(opts, samples, srs, compute_pi)


def make_eval_tiler(opts, apply_fn) -> TiledUpscaler:
    """The self-validation engine of ``opts`` around ``apply_fn``."""
    return TiledUpscaler(apply_fn, opts.scale, opts.tile_size,
                         opts.tile_overlap, opts.infer_batch,
                         device=opts.device)


def score_outputs(opts, samples, srs, compute_pi: bool = True
                  ) -> Dict[str, float]:
    """Mean Y-PSNR / SSIM against HR (``val_psnr`` / ``val_ssim``, when a
    sample has HR) and mean perceptual index (``val_pi``, with
    ``compute_pi``) of the SR outputs ``srs`` of ``samples``.  An image
    whose PI cannot be computed (smaller than the 96-px NIQE block) is
    left out of ``val_pi`` with one warning.  Raises :class:`EvalSkip`
    when neither is there."""
    psnr_m, ssim_m, pi_m = AverageMeter(), AverageMeter(), AverageMeter()
    pi_err = None
    for s, sr in zip(samples, srs):
        if s.hr is not None:
            psnr_m.update(calc_psnr(sr, s.hr, crop_border=opts.scale))
            ssim_m.update(calc_ssim(sr, s.hr, crop_border=opts.scale))
        if compute_pi:
            try:
                pi_m.update(perceptual_index(sr))
            except ValueError as e:
                if pi_err is None:
                    pi_err = str(e)
                    print(f"[val] PI skipped for small image(s): {e}")
    out: Dict[str, float] = {}
    if psnr_m.count:
        out["val_psnr"] = psnr_m.avg
        out["val_ssim"] = ssim_m.avg
    if pi_m.count:
        out["val_pi"] = pi_m.avg
    if not out:
        raise EvalSkip(
            f"validation set {opts.valid_dataset!r} has no ground-truth HR "
            f"images and PI was "
            + ("disabled" if not compute_pi else
               f"not computable ({pi_err})") + ": nothing to evaluate")
    return out


def run_training(opts) -> Dict[str, float]:
    """Run the configured phase end to end; returns the summary (steps,
    wall time, last validation, forward counts of training and eval)."""
    if opts.phase not in ("pretrain", "train", "qat"):
        raise ValueError(f"unknown phase {opts.phase!r} (the port has "
                         f"'pretrain', 'train' and 'qat')")
    mesh = parallel.make_mesh(int(opts.mesh_shape) if opts.mesh_shape
                              else None, opts.device)
    device = mesh.device
    opts = dataclasses.replace(opts, device=str(device))
    if mesh.collective:
        _check_mesh_batch(opts, mesh)
        print(f"mesh: {mesh.size} processes ({mesh.backend}), rank "
              f"{mesh.rank} on {device}, {opts.batch_size // mesh.size} of "
              f"the global batch {opts.batch_size} per rank")
    if opts.steps_per_epoch <= 0:
        n_img = datasets.train_num_images(opts)
        spe = -(-n_img * opts.num_repeats // opts.batch_size)
        opts = dataclasses.replace(opts, steps_per_epoch=spe)
        print(f"epoch length: {n_img} images x {opts.num_repeats} repeats"
              f" / batch {opts.batch_size} = {spe} steps")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"device: {where}, phase={opts.phase}, compute "
          f"{opts.compute_dtype}, parameters {opts.param_dtype}")
    if opts.phase == "qat":
        print("generator apply: W8A8 fake-quant forward (QAT); its convs are "
              "library convs (F.conv2d, cuDNN on the card), as JAX's QAT "
              "runs lax.conv: no kernel launches"
              + ("; --fold_train is ignored under QAT" if opts.fold_train
                 else ""))
    elif plain_float32(opts, device):
        print("generator apply: plain float32 forward on library convs with "
              "TF32 off (--compute_dtype float32): no kernel launches; D "
              "and VGG in float32"
              + (", folded upsampler (--fold_train)" if opts.fold_train
                 else ""))
    elif opts.fold_train:
        print("generator apply: folded upsampler (--fold_train)")

    state = create_generator_state(opts, device, mesh=mesh)
    if opts.pretrained_model:
        sd, at_step = ckpt.restore_generator_params(opts.pretrained_model)
        ckpt.validate_params_compat(state.generator.state_dict(), sd)
        state.generator.load_state_dict(sd)
        print(f"loaded pretrained generator (step {at_step}) from "
              f"{opts.pretrained_model}"
              + _converted(str(next(iter(sd.values())).dtype), opts))
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
              + (f" (best_psnr {best_psnr:.2f})" if best_psnr else "")
              + _converted(ts.get("param_dtype", "float32"), opts))
    if state.ema is not None:
        print(f"EMA of generator params enabled (decay {opts.ema_decay})")
    for net in (state.generator, state.ema, state.discriminator):
        if net is not None:
            parallel.shard_pytree_replicated(mesh, net)
    start_step = state.step
    train_iter, lr_from_files = datasets.make_train_iterator(
        opts, start_step=start_step, mesh=mesh)
    print("LR source: pre-generated files (DIV2K bicubic track)"
          if lr_from_files else
          "LR source: synthesized on the device (MATLAB-bicubic)")

    logger = MetricLogger(opts.check_point, name=opts.phase)
    box = {"best_psnr": best_psnr, "eval_forwards": 0, "profiler": None,
           "extra": {"data_seed": opts.seed, "data_start_step": start_step}}
    summary: Dict[str, float] = {}
    t_start = time.time()
    try:
        _train_epochs(opts, state, step_fn, aug, train_iter, logger,
                      summary, box)
    except KeyboardInterrupt:
        if mesh.collective:
            print(f"\n[interrupt] process group: skipping the interrupt save "
                  f"(it waits for every rank); last snapshot: "
                  f"{ckpt.latest_step_dir(opts.check_point)}")
            raise
        path = ckpt.save_train_ckpt(
            opts.check_point, state, box["best_psnr"],
            dict(box["extra"], augment=aug.get_state()))
        print(f"\n[interrupt] checkpoint saved to {path}; resume with "
              f"--resume --check_point {opts.check_point}")
        raise
    finally:
        _stop_profile(opts, box, device, "run interrupted inside the "
                      "profile window")
        train_iter.close()
        logger.close()
    summary["steps"] = state.step
    summary["wall_s"] = time.time() - t_start
    summary["train_forwards"] = state.apply.forwards
    summary["eval_forwards"] = box["eval_forwards"]
    return summary


def _check_mesh_batch(opts, mesh) -> None:
    """The global batch splits into equal blocks, and each block into the
    ``grad_accum`` strided microbatches, so that the ranks' microbatch i
    together are the global microbatch i of JAX's split."""
    if opts.batch_size % mesh.size:
        raise ValueError(f"--batch_size {opts.batch_size} must be divisible "
                         f"by the process count {mesh.size} (it is the "
                         f"GLOBAL batch)")
    if (opts.batch_size // mesh.size) % opts.grad_accum:
        raise ValueError(f"the per-process batch "
                         f"{opts.batch_size // mesh.size} must be divisible "
                         f"by --grad_accum {opts.grad_accum}")


def _converted(saved: str, opts) -> str:
    """The note a load prints when the checkpoint's parameter dtype is
    not ``--param_dtype`` (``load_state_dict`` converts them)."""
    saved = saved.replace("torch.", "")
    return ("" if saved == opts.param_dtype else
            f"; its {saved} parameters converted to {opts.param_dtype}")


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

    start_step = state.step
    start_epoch = state.step // max(opts.steps_per_epoch, 1)
    for epoch in range(start_epoch, opts.num_epochs):
        while state.step < (epoch + 1) * opts.steps_per_epoch:
            k = state.step - start_step
            if (opts.profile_dir and k == PROFILE_STEPS[0]
                    and parallel.is_primary(state.mesh)):
                box["profiler"] = start_profile(device)
            with span("train_step"):
                metrics = _one_step(opts, state, step_fn, aug, train_iter,
                                    device)
            if k == PROFILE_STEPS[-1]:
                _stop_profile(opts, box, device)
            if opts.log_every > 0:
                pending.append(metrics)
                if state.step % opts.log_every == 0:
                    flush()
        flush()
        if opts.trim_host_heap:
            trim_host_heap()
        extra = dict(box["extra"], augment=aug.get_state())
        if opts.eval_every > 0 and (epoch + 1) % opts.eval_every == 0:
            _validate(opts, state, logger, summary, box, extra)
        if ((opts.snapshot_every > 0
             and (epoch + 1) % opts.snapshot_every == 0)
                or epoch + 1 == opts.num_epochs):
            path = ckpt.save_train_ckpt(opts.check_point, state,
                                        box["best_psnr"], extra)
            print(f"[ckpt] saved {path}")
            pruned = (ckpt.prune_snapshots(opts.check_point,
                                           opts.keep_snapshots)
                      if parallel.is_primary(state.mesh) else [])
            if pruned:
                print(f"[ckpt] pruned {len(pruned)} old snapshot(s) "
                      f"(keep_snapshots={opts.keep_snapshots})")
        t_window = time.time()
    _stop_profile(opts, box, device, "run ended before the full profile "
                  "window")


def _one_step(opts, state, step_fn, aug, train_iter, device):
    """Next batch (a host batch goes to the device; a device batch, as
    ``synthetic_device`` renders it, is taken as it is), LR synthesis and
    augmentation on the device, one step."""
    lr_u8, hr_u8 = next(train_iter)
    if not torch.is_tensor(hr_u8):
        hr_u8 = host_to_device(torch.from_numpy(hr_u8), device)
    if lr_u8 is not None and not torch.is_tensor(lr_u8):
        lr_u8 = host_to_device(torch.from_numpy(lr_u8), device)
    p = state.mesh.size if state.mesh is not None else 1
    n = hr_u8.shape[0] * p
    bits = augment.dihedral_bits(aug, n, device,
                                 parallel.batch_sharding(state.mesh, n))
    lr_img, hr_img = augment.prepare_train_batch(bits, hr_u8, opts.scale,
                                                 lr_u8)
    return step_fn(state, lr_img, hr_img)


def _stop_profile(opts, box, device: torch.device, why: str = "") -> None:
    """Stop an open ``--profile_dir`` trace and write it as
    ``steps_<a>-<b>.pt.trace.json``."""
    prof = box.get("profiler")
    if prof is None:
        return
    box["profiler"] = None
    stop_profile(prof, device, os.path.join(
        opts.profile_dir,
        f"steps_{PROFILE_STEPS[0]}-{PROFILE_STEPS[-1]}.pt.trace.json"), why)


def _validate(opts, state, logger, summary, box, extra) -> None:
    """Self-validation of the EMA weights when there are any (what the
    best checkpoint and inference use), else of the live ones, through
    the steps' forward (folded when they fold; fake-quant in QAT); the
    engine is built once and kept in ``box``.  A new best PSNR writes
    ``best/``.  On a mesh every rank evaluates and the ranks agree on
    the eval set's load and on a new best before the collective save."""
    if "eval_samples" not in box:
        err = None
        try:
            box["eval_samples"] = datasets.load_eval_set(
                opts, opts.valid_dataset, opts.num_valids)
        except FileNotFoundError as e:
            err = e
        if not parallel.all_agree(state.mesh, err is None):
            box.pop("eval_samples", None)
            print(f"[val] skipped: "
                  f"{err or 'eval set missing on another rank'}")
            return
    gen = state.ema if state.ema is not None else state.generator
    dtype = COMPUTE_DTYPES[opts.compute_dtype]
    if opts.phase == "qat":
        apply_fn = QatApply(gen, dtype)
    elif isinstance(state.apply, Float32TrainApply):
        apply_fn = Float32Apply(gen, fold=opts.fold_train)
    else:
        apply_fn = KernelApply(gen, dtype, fold=opts.fold_train)
    if "eval_tiler" not in box:
        box["eval_tiler"] = make_eval_tiler(opts, apply_fn)
    try:
        val = evaluate(opts, apply_fn, samples=box["eval_samples"],
                       tiler=box["eval_tiler"], compute_pi=opts.eval_pi)
    except EvalSkip as e:
        print(f"[val] skipped: {e}")
        return
    finally:
        box["eval_forwards"] += apply_fn.forwards
    logger.log(state.step, val, prefix="val")
    summary.update(val)
    val_psnr = val.get("val_psnr", float("-inf"))
    if parallel.all_agree(state.mesh, val_psnr > (box["best_psnr"] or -1.0)):
        box["best_psnr"] = val_psnr
        path = ckpt.save_best_ckpt(opts.check_point, state, val_psnr, extra)
        print(f"[ckpt] new best val_psnr={val_psnr:.2f} -> {path}")
        summary["best_psnr"] = val_psnr
