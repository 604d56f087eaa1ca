"""Inference entry point of the port (counterpart of the repo's
``test.py``): loads a generator, upscales every image of an eval set
through the hand-written kernels, writes PNGs into
``<output_dir>/<dataset>/`` and prints PSNR/SSIM and throughput.

    python -m pesr_torch.test --dataset synthetic --model_path g.pth \\
        --num_blocks 8 --num_channels 64
    python -m pesr_torch.test --dataset synthetic --device cpu ...

Weights: an EDSR-style ``.pth`` (``pesr_tpu.convert.save_generator_torch``
writes one from a JAX checkpoint), a checkpoint directory of
``python -m pesr_torch.train`` (its newest ``step_<K>``, ``best/``, or
any directory holding ``generator.pth``; the EMA copy is preferred), or
random init from ``--seed``; ``--interp_model`` blends a second set into
them (network interpolation).

Tiled modes run the folded upsampler unless ``--no_fold`` is given;
whole-image mode (``--tile_size 0``) keeps the chain, as the JAX
``test.py`` does.  ``--self_ensemble`` averages the x8 dihedral
transforms in either engine.  ``--quant int8`` serves the W8A8 apply of
``models/quant_apply.py``, calibrated on the eval set's LR tiles and
always folded; ``--quant_guard_db N`` measures its agreement with the
bf16 folded engine first and falls back to the folded ``--compute_dtype``
path below N dB.  ``--compute_dtype float32`` runs plain f32 convs with
TF32 off (no hand-written kernel).  The summary names the precision path
that served, as JAX's label does (``int8-w8a8``, ``folded-bfloat16``,
...).

``--mesh_shape N --mesh_axis batch|tiles`` (one process per device, the
group brought up by ``--distributed``) splits each tiled batch, or each
image's tile positions, over N processes; every rank gets every output
and rank 0 writes the PNGs.  ``--export_artifact PATH`` writes the tiled
engine as a serving artifact (``pesr_torch/serving.py``) for the first
image's shape at ``--infer_batch`` and exits; it refuses whole-image
mode, the self-ensemble and a batch-DP mesh, as JAX's ``test.py`` does.

``--profile_dir D`` writes ``D/<dataset>.pt.trace.json``, a
torch.profiler Chrome trace of the timed pass over the eval set, with
the engine's and the apply's ranges (``pesr.request``, ``pesr.forward``,
..., ``utils/spans.py``) beside the device's kernels.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from pesr_torch import parallel
from pesr_torch.config import Opts, opts_from_args
from pesr_torch.convert import load_generator_pth, state_dict_from_torch
from pesr_torch.data.datasets import host_bicubic_resize, load_eval_set
from pesr_torch.metrics import calc_psnr, calc_ssim
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import Float32Apply, KernelApply
from pesr_torch.models.quant_apply import (default_calib_tiles,
                                           int8_inference,
                                           int8_inference_guarded)
from pesr_torch.ops.tiling import BatchTiledUpscaler, WholeImageUpscaler
from pesr_torch.training.checkpoint import (interpolate_params,
                                             restore_generator_params)
from pesr_torch.training.state import COMPUTE_DTYPES
from pesr_torch.utils.device import resolve_device
from pesr_torch.utils.image_io import imwrite_uint8
from pesr_torch.utils.logging import AverageMeter
from pesr_torch.utils.spans import start_profile, stop_profile


def _load_state_dict(path: str, opts: Opts) -> dict:
    """Generator weights from ``path``: a port checkpoint directory (its
    EMA copy when it has one) or an EDSR-style ``.pth``, as a state_dict
    in the port's names."""
    sd = None
    if os.path.isdir(path):
        try:
            sd, step = restore_generator_params(path)
        except FileNotFoundError:
            pass
    if sd is None and (os.path.isdir(path)
                       or not path.endswith((".pth", ".pt"))):
        raise SystemExit(
            f"--model_path {path}: pesr_torch loads torch .pth/.pt files "
            f"and its own training checkpoints only.  An orbax checkpoint "
            f"directory needs JAX; convert it once with "
            f"pesr_tpu.convert.save_generator_torch (CLI: python -m "
            f"pesr_tpu.convert {path} out.pth --to_torch --scale "
            f"{opts.scale})")
    if sd is None:
        print(f"loaded torch generator from {path}")
        return load_generator_pth(path, opts.num_blocks, opts.scale)
    print(f"loaded pesr_torch checkpoint (step {step}) from {path}")
    return state_dict_from_torch(sd, opts.num_blocks, opts.scale)


def build_generator(opts: Opts, device: torch.device) -> Generator:
    """The generator of ``opts``, with weights from ``--model_path`` (a
    ``.pth`` or a port checkpoint directory), blended with
    ``--interp_model``'s when given, or random init from ``--seed``."""
    arch = dict(scale=opts.scale, num_blocks=opts.num_blocks,
                num_channels=opts.num_channels, res_scale=opts.res_scale,
                device=device)
    if not opts.model_path:
        if opts.interp_model:
            raise SystemExit("--interp_model needs --model_path (the base "
                             "PSNR-oriented checkpoint) to blend into")
        gen = Generator(**arch, seed=opts.seed)
        print("WARNING: no --model_path; using randomly-initialized "
              "generator")
        return gen
    if opts.interp_model and not 0.0 <= opts.interp_alpha <= 1.0:
        raise SystemExit(f"--interp_alpha {opts.interp_alpha} outside "
                         f"[0, 1]")
    sd = _load_state_dict(opts.model_path, opts)
    if opts.interp_model:
        sd = interpolate_params(sd, _load_state_dict(opts.interp_model, opts),
                                opts.interp_alpha)
        print(f"network interpolation: (1-a)*base + a*interp, "
              f"a={opts.interp_alpha}")
    gen = Generator(**arch, seed=None)
    gen.load_state_dict(sd, strict=True)
    return gen


def build_apply(opts: Opts, gen: Generator, lrs) -> tuple:
    """The apply that serves ``opts`` and its precision label (JAX's
    ``test.py:102-160``, ``:218-221``): int8 (guarded or not), the plain
    f32 forward, or the kernel path; folded in tiled modes unless
    ``--no_fold``, always under int8 and its guard's fallback."""
    fold = opts.fold and opts.tile_size != 0
    if opts.quant == "int8":
        # W8A8 with static per-channel scales, calibrated on the eval
        # set's own LR tiles (no labels needed).
        tiles = default_calib_tiles(lrs)
        if opts.quant_guard_db <= 0:
            print("using int8 W8A8 inference path (calibrated)")
            return int8_inference(gen, tiles), "int8-w8a8", None
        # Calibration and probe tiles coincide here (both from the eval
        # set), so the guard catches pathological weights; a deployment
        # calibrated offline probes with serving tiles to also catch
        # calibration shift.
        apply_fn, report = int8_inference_guarded(
            gen, tiles, min_agreement_db=opts.quant_guard_db,
            fallback_dtype=COMPUTE_DTYPES[opts.compute_dtype])
        print(f"int8 quality guard: {report}")
        if report["fallback"]:
            print(f"using folded {opts.compute_dtype} path (quality-guard "
                  f"fallback)")
            return apply_fn, f"folded-{opts.compute_dtype}", report
        print("using int8 W8A8 inference path (calibrated)")
        return apply_fn, "int8-w8a8", report
    label = ("folded-" if fold else "") + opts.compute_dtype
    if opts.compute_dtype == "float32":
        print("compute float32: plain PyTorch convs with TF32 off"
              + (" and the folded upsampler" if fold else "")
              + " (the hand-written kernels take bf16 only)")
        return Float32Apply(gen, fold=fold), label, None
    if fold:
        print("using folded upsampler (--no_fold for the plain chain)")
    return KernelApply(gen, fold=fold), label, None


def run(argv=None) -> dict:
    """The whole flow of :func:`main`; returns its summary (mean PSNR /
    SSIM / bicubic PSNR, MP/s, image and generator-forward counts, the
    precision path and the int8 guard's report), or with
    ``--export_artifact`` the artifact's metadata and precision path."""
    opts = opts_from_args(argv)
    if opts.export_artifact and (opts.tile_size == 0 or opts.self_ensemble
                                 or (opts.mesh_shape
                                     and opts.mesh_axis != "tiles")):
        # The artifact is the device-resident tiled program; the
        # self-ensemble composes eight of them on the host side, and a
        # batch-DP engine is better served as hermetic single-device
        # replicas (load the artifact on every device).
        raise SystemExit("--export_artifact requires tiled mode "
                         "(--tile_size != 0) without --self_ensemble or "
                         "batch-DP --mesh_shape (spatial --mesh_axis tiles "
                         "exports)")
    if opts.distributed:
        parallel.initialize_distributed(required=True, device=opts.device)
    mesh = (parallel.make_mesh(int(opts.mesh_shape), opts.device)
            if opts.mesh_shape else None)
    device = mesh.device if mesh is not None else resolve_device(opts.device)
    gen = build_generator(opts, device)
    samples = load_eval_set(opts)
    lrs = [s.lr for s in samples]
    apply_fn, precision, report = build_apply(opts, gen, lrs)
    se = opts.self_ensemble
    if opts.tile_size == 0:
        engine = WholeImageUpscaler(apply_fn, opts.scale, device)
        engine.warmup_many(lrs, se=se)
        run_all = lambda: engine.upscale_many(lrs, se=se)  # noqa: E731
        print("whole-image mode (no tiling)"
              + (" + x8 self-ensemble" if se else ""))
    else:
        if mesh is not None:
            print(f"inference mesh: {mesh.size} process(es), "
                  f"{opts.mesh_axis}-sharded; rank {mesh.rank} on {device}")
        engine = BatchTiledUpscaler(
            apply_fn, opts.scale, opts.tile_size, opts.tile_overlap,
            device=device, mesh=mesh,
            mesh_axis=opts.mesh_axis if mesh is not None else "batch")
        if opts.export_artifact:
            from pesr_torch.serving import export_upscaler
            b = min(opts.infer_batch, len(lrs)) or 1
            h, w = lrs[0].shape[:2]
            meta = export_upscaler(engine, b, h, w, opts.export_artifact,
                                   precision_path=precision)
            print(f"exported serving artifact to {opts.export_artifact}: "
                  f"input {meta['input_shape']}, x{meta['scale']}, "
                  f"{meta['precision_path']}, platforms "
                  f"{meta['platforms']}")
            return {"artifact": meta, "precision": precision,
                    "forwards": apply_fn.forwards}
        engine.warmup_many(lrs, opts.infer_batch, se=se)
        run_all = lambda: engine.upscale_many(  # noqa: E731
            lrs, opts.infer_batch, se=se)
        print(f"device-resident tiled mode (tile={opts.tile_size}, "
              f"overlap={opts.tile_overlap})"
              + (" + x8 self-ensemble" if se else ""))

    prof = (start_profile(device)
            if opts.profile_dir and parallel.is_primary(mesh) else None)
    try:
        t0 = time.perf_counter()
        srs = run_all()  # numpy results: the device work has finished
        elapsed = time.perf_counter() - t0
    finally:
        if prof is not None:
            stop_profile(prof, device, os.path.join(
                opts.profile_dir, f"{opts.test_dataset}.pt.trace.json"))

    out_dir = os.path.join(opts.output_dir, opts.test_dataset)
    psnr_m, ssim_m, bicubic_m = AverageMeter(), AverageMeter(), AverageMeter()
    total_mp = 0.0
    for s, sr in zip(samples, srs):
        if parallel.is_primary(mesh):
            imwrite_uint8(os.path.join(out_dir, f"{s.name}.png"), sr)
        total_mp += sr.shape[0] * sr.shape[1] / 1e6
        if s.hr is not None:
            psnr = calc_psnr(sr, s.hr, crop_border=opts.scale)
            ssim = calc_ssim(sr, s.hr, crop_border=opts.scale)
            h, w = s.lr.shape[:2]
            bic = host_bicubic_resize(s.lr, h * opts.scale, w * opts.scale)
            bpsnr = calc_psnr(bic, s.hr, crop_border=opts.scale)
            psnr_m.update(psnr)
            ssim_m.update(ssim)
            bicubic_m.update(bpsnr)
            print(f"{s.name}: PSNR {psnr:.2f} dB  SSIM {ssim:.4f}  "
                  f"(bicubic {bpsnr:.2f} dB)")

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    quality = (f"mean PSNR {psnr_m.avg:.2f} dB  mean SSIM "
               f"{ssim_m.avg:.4f}  bicubic {bicubic_m.avg:.2f} dB"
               if psnr_m.count else "no ground truth")
    mp_s = total_mp / elapsed
    print(f"[{opts.test_dataset} x{opts.scale}] {quality}  ({mp_s:.2f} MP/s "
          f"on {where} over {len(samples)} images, post-warmup, incl. "
          f"host transfers; {precision})")
    print(f"SR images written to {out_dir}/")
    return {"psnr": psnr_m.avg if psnr_m.count else None,
            "ssim": ssim_m.avg if ssim_m.count else None,
            "bicubic_psnr": bicubic_m.avg if bicubic_m.count else None,
            "mp_per_s": mp_s, "images": len(samples),
            "forwards": apply_fn.forwards, "out_dir": out_dir,
            "precision": precision, "quant_guard": report}


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
