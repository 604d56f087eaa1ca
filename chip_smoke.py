#!/usr/bin/env python3
"""Smoke run of the pesr_torch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--int8-first-form DIR]

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build   -- compile every CUDA kernel of ``pesr_torch/csrc`` with nvcc
              (set-up), print ptxas' registers / spills and the SASS
              evidence (counts of HGMMA, TMA and SYNCS instructions from
              cuobjdump; a library without HGMMA or TMA loads fails, and
              so does one whose wgmma ptxas serialized, and the int8
              block's library if ptxas reports spill bytes), print the
              card's name and power limit.
2. kernels -- each kernel against its plain PyTorch version (f32, TF32
              off, same bf16-rounded inputs): ragged shapes at the edges
              of the kernels' decompositions and narrow widths 1-129 at
              batches 1, 3, 16 (the resblock's flat mode, the upsampler's
              paired tiles), C = 64, 128, 256, then the
              shapes the main path gives it (C = 256, the tile batch the
              engine's auto chooser picks for two 510 x 336 LR images).
              Times (CUDA events; median, min and max of repetitions) of
              kernel, plain version and a library yardstick, and the
              data-sheet bound.
3. main    -- x4 32 x 256 inference through ``pesr_torch.test`` on
              ``synthetic``, then two 510 x 336 LR images through
              ``BatchTiledUpscaler`` with PNG output: launch counts per
              generator forward, MP/s, and the uint8 output against the
              plain f32 ``Generator`` on the same tile batch.
4. train   -- the L1 pretrain path at the flagship recipe (32 x 256, x4,
              batch 16, LR patch 48): each kernel's differentiable form
              (kernel forward, library-conv backward) against the plain
              version's f32 autograd at the training shapes, two ragged
              ones and the narrow widths (C = 64, 128, 256); kernel times
              at the training shapes, each row with its schedule, computed
              / useful MACs, share of its bound and cuDNN's time; one pretrain
              step of the kernel path (bf16) against the plain f32
              ``Generator`` from the same weights and batch; a profile of
              one step, its device time and launches, and the convolutions
              and convolution gradients it dispatches (35 and 69: one
              recompute per block); then ``run_training`` on ``synthetic`` for 2
              epochs with self-validation (PSNR, SSIM and PI) and
              snapshots: the loss falls, launch counts per forward, steps/s
              and HR MP/s, a finite ``val_pi``, and the best snapshot
              reloads through ``pesr_torch.test``.  The kernels at the eval
              forwards' tile batch ([8, 112, 112] and the stages above it),
              timed; then self-validation as the loop runs it (the
              host-stitch ``TiledUpscaler``, the best snapshot on
              ``KernelApply``) on two synthetic eval images and one whose
              LR side is <= 96 px: launches, the SR and PI seconds,
              ``val_pi`` against the PI recomputed on the same SR arrays,
              and the uint8 output against the plain f32 ``Generator``
              through the same engine.
5. gan     -- the GAN fine-tune at the flagship recipe and the JAX
              package's defaults (RSGAN, alpha_vgg 50, alpha_gan 1,
              alpha_tv 1e-6; the SRGAN discriminator, 64-512 with dense
              1024; VGG54 with random weights from the seed): one GAN step
              of the kernel path (bf16) against the plain step (plain
              ``Generator``, D and VGG in f32) on the same weights and
              batch, and planted wiring faults that must fail the same
              limits; the same step at LR 0 and with the plain step's
              updated D on both sides (G's loss read without D's first
              Adam step); launch counts over 5 steps (one generator forward per
              step); host queue time against device time and a profile of
              one step by network; then ``run_training --phase train``
              from the train phase's ``best/`` for 2 epochs with
              self-validation and snapshots (finite losses, launch counts,
              steps/s, ``discriminator.pth``, ``best/`` reloaded by
              ``pesr_torch.test``).
   Phases 3-5 drive the upsampler chain (``--no_fold``,
   ``fold_train=False``).  Every ``run_training`` self-validates with
   PSNR, SSIM and the perceptual index (``--eval_pi``, the default).
6. fold    -- the folded upsampler, the default of both CLIs: the
              flagship fold derived on the card (impulse probe and
              analytic, with TF32 allowed: the fold's guard must scope
              it off) against the float64 probe on the CPU, with the
              time to derive and a profile of the analytic fold's
              forward + backward; folded inference through the test CLI
              and the engine (exactly 32 + 0 launches per forward, MP/s
              in turns with the unfolded engine, uint8 against the plain
              f32 chain on the same padded images, a profile; the
              resblock kernel against its plain version and timed at the
              folded tile batch, which the fold's halo makes another
              shape; the folded conv's time and bound); the x8
              self-ensemble; one fold-train pretrain step against the
              plain f32 fold-train step, with planted fold faults that
              must fail the train limits, and its host and device time
              in turns with the unfolded step; the kernel at the folded
              eval's tile batches, then ``run_training`` as the train
              CLI resolves it (folded); one fold-train GAN step against
              its plain f32 step, with the plain step's updated D on
              both sides and each with its own.
7. qat     -- the QAT phase (``--phase qat``), whose W8A8 fake-quant
              convs are library convs (cuDNN), as JAX's are ``lax.conv``:
              one flagship QAT step in bf16 against the same step in f32
              (TF32 off) on weights with an outlier output channel per
              body conv, with planted faults that must fail its limits;
              ``run_training --phase qat`` (launches no kernel; steps/s,
              ``val_psnr`` of the fake-quant forward, ``val_pi``).
8. quant    -- int8 W8A8 inference (``--quant int8``): each residual
              block is one launch of ``fused_resblock_int8``
              (``csrc/resblock_int8.cu``, s8 ``wgmma``), the tail conv
              and the x8 int8 upfold a library GEMM (``torch._int_mm``
              over an int8 im2col), as JAX's are single ``lax.conv``s:
              the int8 conv against its plain float64 version bitwise
              (ragged shapes, chunked im2col, the x4 tail conv at the
              folded tile batch, the x8 int8 upfold), timed with its
              bound and parts; the int8 block kernel against its plain
              version bitwise (ragged shapes, C = 64, 128, 256, the x4
              and x8 tile batches), timed beside its bound, the plain
              version and the block on the ``_int_mm`` route, and the
              bf16 ``fused_resblock`` at the same shape, and, given
              ``--int8-first-form DIR``, in turns with the kernel's
              first form built from that checkout; a calibrated
              block and a planted fault in the kernel's arguments that
              the bitwise check must see; the flagship int8 apply at x4
              and x8, the card's route against the plain route bitwise
              (32 kernel launches each); ``pesr_torch.test --quant int8``
              on the train phase's ``best/`` and the engine in turns with
              the bf16 folded path (MP/s, agreement dB, uint8 against
              bf16, launches: 32 int8 blocks and one tail GEMM per
              forward), a planted scale fault the agreement must see;
              the guard's fallback (``--quant_guard_db 200``: the bf16
              kernel path) and ``--compute_dtype float32`` (no kernel;
              within the kernel path's uint8 limits).

9. data     -- the train CLI's data sources and host-side options at
              the flagship recipe (folded training, the CLI's default):
              the ``synthetic_device`` renderer on the card at [16, 192,
              192, 3] (uint8 covering 0..255, deterministic, sample i
              fixed by its index, distinct samples, fresh content after
              a resume's start_step, the band below the LR Nyquist; the
              same parameters rendered on the CPU within 2 LSB), timed
              against a pinned upload of the same bytes;
              ``run_training`` on ``synthetic_device`` with
              ``--profile_dir`` and ``--trim_host_heap`` (a trace of 5
              steps with no host-to-device copy of 1 MB or more, 32 + 0
              launches per forward, one trim per epoch), then steps/s in
              turns with ``synthetic``; ``--compute_dtype float32`` (no
              kernel launch, within the pretrain step's limits of the
              bf16 kernel step, TF32 allowed outside the step) and
              ``--param_dtype bfloat16`` (first L1 bitwise the
              f32-parameter kernel step's on bf16-rounded weights, bf16
              parameters and Adam moments); the native data core on a
              DIV2K-layout PNG folder where libpng is installed (decode
              bitwise, sampler batches/s against ``PatchIterator``,
              ``run_training --train_dataset DIV2K`` on the native
              sampler), and a line saying it did not run where it is
              not.
10. parallel -- multi-process runs on the one card: two gloo ranks (NCCL
              refuses two ranks on one device) over CUDA tensors, so no
              number of it is a speed-up.  Flagship pretrain (folded)
              and GAN (chain, JAX's defaults) steps, global batch 16 as
              2 x 8 against 1 x 16 on the same batches, each step from
              one state, under the step limits, with a second
              one-process run beside and a planted fault (D's
              statistics over the block) that must fail them; launches
              per rank per step; NCCL at world size 1 through
              ``python -m pesr_torch.train --distributed`` (L1 bitwise
              the run without a process group); the folded engine with
              ``mesh_axis`` tiles and batch on the two 336 x 510 images
              against the single-process engine (bitwise), launches and
              MP/s per rank.
11. serve    -- the serving artifact of the folded flagship engine at
              [2, 336, 510]: exported, loaded in a fresh process that
              imports only ``pesr_torch.serving`` (bitwise the live
              engine; the resblock op's launches inside the program),
              MP/s in turns with the live engine, a ``batch="any"``
              artifact on a batch of 1 and an int8 artifact (32 int8
              block launches per forward inside it), each bitwise its
              live engine.
12. fit      -- the PI model fitters on the card's host (no kernel, no
              scikit-learn): whether scikit-learn is importable there;
              ``pesr_torch.metrics.fit_ma.main`` at its defaults, every
              array bitwise the packaged ``ma_model_synthetic.npz`` and
              rc 0, with the seconds of its features and its forests;
              ``fit_natural.main``, its refusal below 4 registry
              photographs or its holdout orderings.  A ``{"fit": ...}``
              line before the kernels line.
13. bench    -- the port's headline benchmark, ``python -m
              pesr_torch.bench`` (``bench.py``'s contract): at its
              defaults in a subprocess (x4, 8 images of 510 x 336, int8
              headline and bf16 folded, best of 5; its JSON line with
              ``bench.py``'s keys, beside the card); a scale sweep in
              this process through the same functions (x2, x3, x6, x8 on
              both paths and x4 on the bf16 chain at 2 images, best of 2,
              then each at 8 images, x4 folded too: MP/s, the tile grid,
              each path's launches against the expected counts, peak
              memory), each kernel held to its plain version at every
              shape the sweep handed it (the int8 block bitwise);
              ``BENCH_MESH=2`` as two gloo ranks on the card (one line,
              from rank 0, with the mesh keys).  The kernels line gains
              each kernel's sweep launches and errors.
14. rcan     -- RCAN x4's kernels (``fused_rcab``, ``rcab_excite``, C =
              64) at a ragged batch with odd B whose runs cross strips
              and images ([3, 139, 300]) and at the batch engine's tile
              batch [8, 144, 342] (four of them make a request of 8
              DIV2K-sized LR photos): the schedule and ``rcab_work``,
              one wave a launch, the block without and with a pending
              block before it, and the excite, each against its plain
              version (``x`` and the excite within one bf16 ulp of ``h +
              s r``, ``r`` within ATOL / RTOL of f32 math on the same
              operands, the pooled sums within 1e-4); at the tile batch
              their times beside the bound and the block in library
              calls; then ``RCANKernelApply`` at 10 x 20
              x 64 on one tile batch (branch ends scaled by
              ``RCAN_BRANCH_GAIN``): 200 ``fused_rcab`` and 10
              ``rcab_excite`` launches, its output against the plain f32
              ``RCAN`` inside the fold's border, and its time.  The
              kernels line gains both kernels.

Prints a ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or pesr_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
REPO = os.path.dirname(os.path.abspath(__file__))

LR_H, LR_W, N_IMAGES = 336, 510, 2   # DIV2K-validation-sized LR, x4
BLOCKS, CHANNELS, SCALE = 32, 256, 4
# Kernel vs plain f32: |d| <= ATOL + RTOL * |ref| elementwise.  The
# kernel's output is rounded to bf16 once (half an ulp = 2^-9..2^-8 of
# |ref|) and the resblock's hidden is rounded to bf16 before conv2
# (~2^-9 relative on a term scaled by res_scale); inputs are O(1).
# RTOL = 2^-7 covers both with 2x margin; a wrong tap, mask or channel
# order shows up as O(0.1..1) absolute.
ATOL, RTOL = 1e-2, 2.0 ** -7
# Kernel path (bf16) vs plain Generator (f32) on uint8 output, random
# 32 x 256 weights: ~36 bf16 roundings of O(1) activations on the way to
# [-1, 1] (127.5 LSB per unit).  Allowed: mean <= 0.5 LSB, max <= 8 LSB.
LSB_MEAN_TOL, LSB_MAX_TOL = 0.5, 8
# Ragged (batch, H, W) at the edges of the kernels' decompositions.
RAGGED = ((1, 5, 3), (1, 1, 1), (1, 9, 63), (2, 49, 510), (3, 5, 1426))
# Narrow widths at the edges of the narrow-image decompositions (the
# resblock's flat mode takes 2 <= W <= 48; the upsampler pairs CTA tiles
# across row pairs where a row has an odd number of 64-pixel segments),
# at batches 1, 3 and 16 in turn.
NARROW_W = (1, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64, 65, 95, 96, 97, 127,
            128, 129)
NARROW = tuple((b, h, w) for (b, h), w in zip(((1, 5), (3, 7), (16, 12)) * 6,
                                              NARROW_W))
# The same widths for the backward checks, the batch-1 shapes at the
# training patch's 48 rows: GRAD_REL_TOL's ReLU-mask flips need pixels to
# average over (at [1,5,1,256], 5 pixels, one flip moved dw1 by 4.3e-2 in
# norm on the H100, with the backward's convolutions the same as autograd
# of the plain version's).
TRAIN_NARROW = tuple((b, h, w) for (b, h), w in zip(
    ((1, 48), (3, 7), (16, 12)) * 6, NARROW_W))
# The flagship training recipe (pesr_tpu/config.py): batch 16 of 48 x 48
# LR patches; the kernels see [16, 48, 48] (body, stage 1) and
# [16, 96, 96] (stage 2).
TRAIN_BATCH, TRAIN_PATCH = 16, 48
TRAIN_RAGGED = ((2, 19, 23), (3, 5, 70)) + TRAIN_NARROW
# A kernel's backward (bf16 library convolution gradients, conv1
# recomputed: on the CPU bitwise autograd of the plain version in bf16)
# vs the plain version's f32 autograd on the same bf16-rounded inputs and
# cotangent, per gradient tensor: ||d|| / ||ref|| <= GRAD_REL_TOL.  Each
# gradient passes 3-4 bf16 roundings (2^-9 relative each, independent
# across elements: ~2e-3 in norm) after f32 accumulation in cuDNN.  The
# resblock's dw1 and db1 also go through the ReLU mask, which the bf16
# recompute flips wherever the hidden is within its rounding of 0: a
# share f of flipped elements adds ~sqrt(f) in norm (measured on the
# H100: up to 1.5e-2, f ~ 2e-4).  3e-2 is 2x that; a wrong tap,
# transpose or mask gives O(1).
GRAD_REL_TOL = 3e-2
# RCAN x4 (rcan phase): the batch engine's tile batch for 8 LR photos of
# 510 x 336 (4 positions of [8, 144, 342]), 10 groups x 20 RCAB x 64
# channels.  Its weights are the port's init with the last conv of every
# residual branch scaled by 0.3: unscaled, 200 blocks with no residual
# scaling saturate every output subpixel.  The apply (bf16) against the
# plain f32 RCAN inside the fold's border, in LSB of the 0..255 scale:
# rms and max within the benchmark cell's limits against its reference
# (1.1 and 11; the sound kernel reads ~0.4 and ~3, channel attention
# removed ~19 rms).
RCAN_TILE = (8, 144, 342)
# A ragged batch with odd B whose schedule's runs cross strips and images.
RCAN_RAGGED = (3, 139, 300)
RCAN_GROUPS, RCAN_BLOCKS, RCAN_CHANNELS = 10, 20, 64
RCAN_BRANCH_GAIN = 0.3
RCAN_RMS_LSB, RCAN_MAX_LSB = 1.1, 11.0
# One flagship pretrain step, kernel path (bf16) vs plain Generator (f32),
# same weights and batch.  The outputs differ by bf16 noise of ~0.3 LSB
# (0.0024 in [-1, 1] units, main phase), but the noise is nearly
# zero-mean and cancels in the L1 mean over 16 x 192^2 x 3 values
# (measured on the H100: |d l1| 1.6e-5).  Gradients of L1 are
# sign(sr - hr) pulled back; bf16 noise flips the sign only where
# |sr - hr| is below it (measured: 1 - cosine <= 2.5e-5 over every
# parameter tensor).  The limits are ~30x and ~40x those readings, and
# each fault of PLANTED_FAULTS must break them.
STEP_L1_TOL, GRAD_COS_FLOOR = 5e-4, 0.999
# Wiring faults planted in the kernel path's generator only (the plain
# one stays sound): the kind of error a wrong index in ``KernelTrainApply``
# makes.  The step check fails if any of them passes the limits above.
PLANTED_FAULTS = ("res_scale applied twice", "x2 stages' weights swapped",
                  "residual blocks 0 and 1 swapped")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def edsr_launch_counts() -> dict:
    """The launch counters of the EDSR generator's bf16 kernels
    (``kernels.launch_counts()`` without RCAN's, which only the rcan
    phase runs)."""
    from pesr_torch.ops import kernels
    counts = kernels.launch_counts()
    return {k: counts[k]
            for k in ("fused_resblock", "fused_upsampler_stage")}


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def timed_ms(fn, iters: int, reps: int = 7, warmup: int = 2) -> dict:
    """ms per call: ``reps`` timed repetitions of ``iters`` calls each
    (CUDA events); their median, min and max."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    return {"ms": times[len(times) // 2], "min": times[0], "max": times[-1]}


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare(name: str, got, ref) -> dict:
    err = (got.float() - ref).abs()
    worst = float((err / (ATOL + RTOL * ref.abs())).max())
    res = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "max_ref": float(ref.abs().max()), "worst_tol_ratio": worst}
    print(f"  {name}: max|d| {res['max_abs_err']:.4g}  mean|d| "
          f"{res['mean_abs_err']:.3g}  max|ref| {res['max_ref']:.3g}  "
          f"worst |d|/(atol+rtol|ref|) {worst:.3f} (pass <= 1; atol "
          f"{ATOL}, rtol {RTOL})", flush=True)
    if not worst <= 1.0:
        fail(f"{name} disagrees with its plain version")
    return res


def make_inputs(shape_x, shapes_w, seed: int):
    """bf16 x ~ N(0, 1), weights ~ N(0, 1/fan_in), biases ~ N(0, 0.1),
    drawn on the CPU from ``seed`` and moved to the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape_x, generator=g).to(torch.bfloat16).cuda()
    ws = []
    for shape in shapes_w:
        if len(shape) == 4:  # HWIO
            t = torch.randn(shape, generator=g) / (9 * shape[2]) ** 0.5
            ws.append(t.to(torch.bfloat16).cuda())
        else:
            ws.append((torch.randn(shape, generator=g) * 0.1)
                      .to(torch.bfloat16).float().cuda())
    return x, ws


def check_resblock(bsz, h, w, c, res_scale, seed, timing=False) -> dict:
    import torch
    import torch.nn.functional as F
    from pesr_torch.ops.kernels import (fused_resblock, pack_resblock,
                                        resblock_reference)
    from pesr_torch.ops.kernels.resblock import (CLUSTER, _max_clusters,
                                                 resblock_schedule,
                                                 resblock_work)
    x, (w1, b1, w2, b2) = make_inputs(
        (bsz, h, w, c), [(3, 3, c, c), (c,), (3, 3, c, c), (c,)], seed)
    packed = pack_resblock(w1.permute(3, 2, 0, 1), b1,
                           w2.permute(3, 2, 0, 1), b2)
    out = fused_resblock(x, *packed, res_scale=res_scale)
    torch.cuda.synchronize()
    ref = resblock_reference(x.float(), w1.float(), b1, w2.float(), b2,
                             res_scale)
    res = compare(f"fused_resblock [{bsz},{h},{w},{c}] res_scale "
                  f"{res_scale}", out, ref)
    if not timing:
        return res
    xf, w1f, w2f = x.float(), w1.float(), w2.float()
    # library yardstick: cuDNN bf16 conv x2 + ReLU + add, channels_last
    xl = x.permute(0, 3, 1, 2)
    w1l = w1.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    w2l = w2.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)

    def library():
        y = F.relu(F.conv2d(xl, w1l, b1h, padding=1))
        return xl + res_scale * F.conv2d(y, w2l, b2h, padding=1)

    res["time"] = timed_ms(lambda: fused_resblock(x, *packed,
                                                  res_scale=res_scale), 10)
    res["plain"] = timed_ms(lambda: resblock_reference(
        xf, w1f, b1, w2f, b2, res_scale), 1, 5, 1)
    res["library"] = timed_ms(library, 10, 5)
    res["ms"], res["plain_ms"], res["library_ms"] = (
        res[k]["ms"] for k in ("time", "plain", "library"))
    res["shape"] = [bsz, h, w, c]
    px = bsz * h * w
    res["bound_ms"], res["bound_by"] = bound(
        4 * 9 * c * c * px, 2 * px * c * 2 + 2 * 9 * c * c * 2 + 2 * c * 4)
    # Weight bytes L2 serves per launch: every cluster streams both convs'
    # weights once per conv pass (line mode: rows / 2 + 1 conv1 + rows / 2
    # conv2; flat mode: steps + 1 conv1 + steps conv2, steps = span / 128
    # rounded up).
    clusters = _max_clusters(c, x.device)
    sched = resblock_schedule(bsz, h, w, clusters)
    res["schedule"] = sched
    res["work"] = resblock_work(bsz, h, w, c, clusters)
    passes = (2 * -(-sched.span // 128) + 1 if sched.span
              else sched.rows + 1)
    res["weight_l2_bytes"] = (sched.ctas // CLUSTER * passes
                              * 9 * c * c * 2)
    return res


def check_upsampler(bsz, h, w, c, seed, timing=False) -> dict:
    import torch
    import torch.nn.functional as F
    from pesr_torch.ops.kernels import (fused_upsampler_stage,
                                        pack_upsampler_stage,
                                        upsampler_stage_reference)
    from pesr_torch.ops.kernels.upsampler import (_max_clusters,
                                                  upsampler_schedule,
                                                  upsampler_work)
    x, (wt, b) = make_inputs((bsz, h, w, c), [(3, 3, c, 4 * c), (4 * c,)],
                             seed)
    wp, bp = pack_upsampler_stage(wt, b)
    out = fused_upsampler_stage(x, wp, bp)
    torch.cuda.synchronize()
    ref = upsampler_stage_reference(x.float(), wt.float(), b)
    res = compare(f"fused_upsampler_stage [{bsz},{h},{w},{c}]", out, ref)
    del ref
    if not timing:
        return res
    xf, wf = x.float(), wt.float()
    xl = x.permute(0, 3, 1, 2)
    wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bh = b.to(torch.bfloat16)
    res["time"] = timed_ms(lambda: fused_upsampler_stage(x, wp, bp), 10)
    res["plain"] = timed_ms(lambda: upsampler_stage_reference(xf, wf, b),
                            1, 5, 1)
    res["library"] = timed_ms(
        lambda: F.pixel_shuffle(F.conv2d(xl, wl, bh, padding=1), 2), 10, 5)
    res["ms"], res["plain_ms"], res["library_ms"] = (
        res[k]["ms"] for k in ("time", "plain", "library"))
    res["shape"] = [bsz, h, w, c]
    px = bsz * h * w
    res["bound_ms"], res["bound_by"] = bound(
        2 * 9 * c * 4 * c * px,
        px * c * 2 + 4 * px * c * 2 + 9 * c * 4 * c * 2 + 4 * c * 4)
    # Weight bytes L2 serves per launch: one 256-column slice (9 x C x 256
    # bf16) per cluster tile.
    clusters = _max_clusters(x.device)
    sched = upsampler_schedule(bsz, h, w, c, clusters)
    res["schedule"] = sched
    res["work"] = upsampler_work(bsz, h, w, c, clusters)
    res["weight_l2_bytes"] = sched.tiles * 9 * c * 256 * 2
    return res


SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "UBLKCP", "SYNCS")
# The tensor-core MMA each library must hold: bf16 wgmma (HGMMA), s8
# wgmma (IGMMA) in the int8 block.
SASS_MMA = {"resblock_int8": "IGMMA"}


def sass_counts(lib) -> dict:
    """Instruction counts of a kernel library's SASS (cuobjdump, from the
    toolkit of the nvcc that built it): each opcode of SASS_OPS counted
    at the start of an instruction's text."""
    import re
    from pesr_torch.ops.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True,
                          timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}(\.|\s)", sass))
            for op in SASS_OPS}


# The int8 block kernel's first form, from another checkout given as
# ``--int8-first-form DIR`` (its ``pesr_torch/csrc``, weights in natural
# output-channel order): built beside the port's libraries and timed in
# turns with the port's kernel (int8_block_turns).  Without the option
# that comparison is not run.
_int8_first_form = {}


def nvcc_first_form(checkout: str, out_dir: str) -> str:
    """``checkout``'s ``pesr_torch/csrc/resblock_int8.cu``, compiled with
    the port's nvcc flags against that checkout's headers only, into
    ``out_dir``.  Returns the library's path; a failed build fails the
    run."""
    from pesr_torch.ops.kernels import build
    csrc = os.path.join(checkout, "pesr_torch", "csrc")
    lib = os.path.join(out_dir, "libint8_block_first_form.so")
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib,
         os.path.join(csrc, "resblock_int8.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        fail(f"nvcc failed on the int8 block's first form in {csrc}:\n"
             f"{proc.stdout}")
    return lib


def ptxas_spills(log: str) -> list:
    """(spill store bytes, spill load bytes) of every kernel in a ptxas
    ``-v`` log."""
    import re
    return [(int(a), int(b)) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]


def phase_build(first_form: str = None) -> str:
    """Build the port's kernels (and, given a checkout, the int8 block's
    first form from it, in parallel) and check what ptxas and the SASS
    show.  Returns the card's name and power limit."""
    import atexit
    import concurrent.futures
    import shutil
    from pesr_torch.ops.kernels import build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        if first_form:
            ff_dir = tempfile.mkdtemp(prefix="pesr_int8_first_form_")
            atexit.register(shutil.rmtree, ff_dir, True)
            ff = ex.submit(nvcc_first_form, first_form, ff_dir)
        libs = build.build_all(verbose=True)
        if first_form:
            _int8_first_form["path"] = ff.result()
    print(f"[build] {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{', '.join(str(p) for p in libs.values())}"
          + (f"; the int8 block's first form from {first_form}: "
             f"{_int8_first_form['path']}" if first_form else ""),
          flush=True)
    if "resblock_int8" not in build.LOGS:
        fail("no ptxas log of libresblock_int8.so (a library built before "
             "its log was kept: delete pesr_torch/_build/ to rebuild it)")
    spills = ptxas_spills(build.LOGS["resblock_int8"])
    print(f"[build] ptxas spill bytes (stores, loads) of the int8 block's "
          f"kernels: {spills} (pass: all 0)", flush=True)
    if len(spills) != 3 or any(a or b for a, b in spills):
        fail(f"ptxas spilled registers in libresblock_int8.so: {spills}")
    for name, lib in libs.items():
        counts = sass_counts(lib)
        log = build.LOGS.get(name, "")
        serial = log.count("C7512") + log.count("C7513")
        print(f"[build] SASS of lib{name}.so: {counts}; kernels whose wgmma "
              f"ptxas serialized (C7512, C7513): {serial}", flush=True)
        mma = SASS_MMA.get(name, "HGMMA")
        if counts[mma] == 0 or counts["UTMALDG"] == 0:
            fail(f"lib{name}.so has no wgmma ({mma}) or no TMA load "
                 f"(UTMALDG) in its SASS")
        # ptxas serializes wgmma when the consumers run out of registers
        # (C7512) or when it cannot prove that no other instruction writes
        # a wgmma's registers while it runs (C7513): the kernels still
        # agree, but lose their asynchronous mainloop.
        if serial:
            fail(f"ptxas serialized the wgmma of {serial} kernel(s) of "
                 f"lib{name}.so (C7512, C7513)")
    return gpu_name_power()


def tile_batch(n: int, h: int, w: int, tile_size="auto", overlap: int = 8,
               min_halo: int = 0):
    """The tile batch (images, tile rows, tile cols; halo included) and
    the grid (nh, nw, th, tw) the tiled engine gives ``n`` images of
    h x w for an apply whose ``min_halo`` is as given (the folded
    upsampler's: ``fold_min_halo``): the shapes it hands the kernels."""
    from pesr_torch.ops.tiling import BatchTiledUpscaler

    def apply(x):
        return x

    apply.min_halo = min_halo
    eng = BatchTiledUpscaler(apply, SCALE, tile_size, overlap)
    nh, nw, th, tw = eng.grid(n, h, w)
    return (n, th + 2 * eng._ov_for(nh), tw + 2 * eng._ov_for(nw)), \
        (nh, nw, th, tw)


def main_path_tile_batch(min_halo: int = 0):
    """The tile batch and grid of the main path: N_IMAGES images of
    LR_H x LR_W under the engine's auto chooser."""
    return tile_batch(N_IMAGES, LR_H, LR_W, min_halo=min_halo)


def eval_tile_batches(opts) -> list:
    """The tile batches ``training.loop.evaluate`` hands the kernels: its
    ``TiledUpscaler`` cuts every image into square tiles of ``tile_size``
    + 2 x ``tile_overlap`` (raised to the fold's ``min_halo`` when
    ``opts.fold_train``) and runs them in full batches of
    ``infer_batch``, so there is one shape whatever the images."""
    from pesr_torch.scales import fold_min_halo
    halo = fold_min_halo(opts.scale) if opts.fold_train else 0
    t = opts.tile_size + 2 * max(opts.tile_overlap, halo)
    return [(opts.infer_batch, t, t)]


def phase_kernels(card: str) -> dict:
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pesr_torch.ops.kernels.resblock import resblock_schedule
    from pesr_torch.ops.kernels.upsampler import upsampler_schedule
    print("[kernels] small ragged shapes (edges, partial tiles, all widths)")
    for c in (64, 128, 256):
        check_resblock(2, 19, 23, c, 1.0, seed=c)
        check_resblock(1, 7, 5, c, 0.1, seed=c + 1)
        check_upsampler(2, 11, 29, c, seed=c + 2)
        check_upsampler(1, 3, 5, c, seed=c + 3)
    # Edges of the decompositions: narrower than a strip / tile, a width
    # one past a multiple of the resblock's 62-column strip and of the
    # upsampler's 64-pixel segment, a height one row past a resblock
    # segment (49 = 6 x 8 + 1), a height shorter than one segment with a
    # batch of 3.
    print("[kernels] ragged shapes at the edges of the decompositions")
    for bsz, h, w in RAGGED:
        print(f"  resblock schedule of [{bsz},{h},{w}]: "
              f"{resblock_schedule(bsz, h, w)}", flush=True)
    for c in (64, 128, 256):
        for i, (bsz, h, w) in enumerate(RAGGED):
            for rs in (0.1, 1.0):
                check_resblock(bsz, h, w, c, rs, seed=100 * c + i)
            check_upsampler(bsz, h, w, c, seed=100 * c + 50 + i)
        check_upsampler(1, 9, 65, c, seed=100 * c + 99)
    print("[kernels] narrow widths (the resblock's flat mode, the "
          "upsampler's paired tiles)")
    for bsz, h, w in NARROW:
        print(f"  schedules of [{bsz},{h},{w}]: resblock "
              f"{resblock_schedule(bsz, h, w)}, upsampler (C = 256) "
              f"{upsampler_schedule(bsz, h, w, 256)}", flush=True)
    for c in (64, 128, 256):
        for i, (bsz, h, w) in enumerate(NARROW):
            for rs in (0.1, 1.0):
                check_resblock(bsz, h, w, c, rs, seed=1000 * c + i)
            check_upsampler(bsz, h, w, c, seed=1000 * c + 50 + i)
    (b, th, tw), grid = main_path_tile_batch()
    print(f"[kernels] main-path shapes: tile batch [{b},{th},{tw}] "
          f"(grid nh,nw,th,tw = {grid}), C = {CHANNELS}, on {card}",
          flush=True)
    rb = check_resblock(b, th, tw, CHANNELS, 0.1, seed=1, timing=True)
    check_resblock(b, th, tw, CHANNELS, 1.0, seed=2)
    up1 = check_upsampler(b, th, tw, CHANNELS, seed=3, timing=True)
    up2 = check_upsampler(b, 2 * th, 2 * tw, CHANNELS, seed=4, timing=True)
    print_times(rb, up1, up2, card)
    torch.cuda.empty_cache()
    return {"fused_resblock": rb, "fused_upsampler_stage": up2,
            "upsampler_stage1": up1}


def print_time(name: str, r: dict, card: str,
               legend: str = "'plain' the f32 plain version, 'library' "
                             "cuDNN") -> None:
    """One timed check: kernel, plain version, library yardstick, bound."""
    spread = "  ".join(
        f"{k} {r[k]['ms']:.3f} ms [min {r[k]['min']:.3f}, max "
        f"{r[k]['max']:.3f}]" for k in ("time", "plain", "library"))
    print(f"  {name}: kernel {spread}  bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']}); 'time' is the kernel, {legend}  [{card}]",
          flush=True)


def print_times(rb: dict, up1: dict, up2: dict, card: str) -> None:
    """The timed checks of the three kernel calls of one path."""
    for name, r in (("fused_resblock", rb),
                    ("fused_upsampler_stage (stage 1)", up1),
                    ("fused_upsampler_stage (stage 2)", up2)):
        print_time(name, r, card)
        gb = r["weight_l2_bytes"] / 1e9
        print(f"    {r['schedule']}: weights from L2 {gb:.2f} GB per launch "
              f"= {gb / r['ms']:.2f} TB/s at the median time", flush=True)


def train_rows(rb: dict, up1: dict, up2: dict, card: str) -> list:
    """The training-shape rows of the kernel table: per kernel call its
    schedule, computed / useful conv MACs, times (median, min, max),
    bound and share of it, and cuDNN's time."""
    rows = []
    for name, r in (("fused_resblock", rb),
                    ("fused_upsampler_stage stage 1", up1),
                    ("fused_upsampler_stage stage 2", up2)):
        row = {"kernel": name, "shape": r["shape"],
               "schedule": list(r["schedule"]),
               "computed_over_useful": r["work"][0] / r["work"][1],
               "ms": r["time"]["ms"], "min_ms": r["time"]["min"],
               "max_ms": r["time"]["max"], "bound_ms": r["bound_ms"],
               "share_of_bound": r["bound_ms"] / r["time"]["ms"],
               "library_ms": r["library_ms"]}
        print(f"  row {name} {r['shape']}: {r['schedule']}, computed / "
              f"useful {row['computed_over_useful']:.4f}; kernel "
              f"{row['ms']:.4f} ms [{row['min_ms']:.4f}, "
              f"{row['max_ms']:.4f}], bound {row['bound_ms']:.4f} ms "
              f"({100 * row['share_of_bound']:.1f}% of it), cuDNN "
              f"{row['library_ms']:.4f} ms [{card}]", flush=True)
        rows.append(row)
    return rows


def conv_op_counts(fn) -> dict:
    """How many ``aten.convolution`` and ``aten.convolution_backward``
    calls ``fn()`` dispatches (a TorchDispatchMode around it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"convolution": 0, "convolution_backward": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    with Count() as mode:
        fn()
    return mode.n


def step_summary(what: str, fn, prof: dict, want, card: str) -> dict:
    """One line per training step: its device time and launches (from
    ``prof``, the profile of one step), host time, and the convolutions
    and convolution gradients one more step dispatches.  ``want``: the
    (convolutions, convolution gradients) a step must dispatch (None:
    not checked)."""
    n = conv_op_counts(fn)
    print(f"  {what} step: device busy {prof['busy_ms']:.3f} ms, "
          f"{prof['launches']} device launches, host queue "
          f"{prof['host_ms']:.2f} ms, wall {prof['step_ms']:.2f} ms; "
          f"aten.convolution {n['convolution']}, convolution_backward "
          f"{n['convolution_backward']} per step [{card}]", flush=True)
    if want is not None and (n["convolution"],
                             n["convolution_backward"]) != want:
        fail(f"{what} step dispatched {n} convolutions and gradients, not "
             f"{want} (library convs + one recompute per block; their "
             f"gradients + two per block + one per x2 stage)")
    return n


def kernel_shares(events, group_of) -> dict:
    """``{group: device us}`` over every kernel that the profile's
    ``events`` launched, each under ``group_of(event, kernel name)``."""
    shares = {}
    for e in events:
        for k in getattr(e, "kernels", []):
            g = group_of(e, k.name)
            shares[g] = shares.get(g, 0) + k.duration
    return shares


def profile_breakdown(fn, card: str, top: int = 8, group=None,
                      host_top: int = 0) -> dict:
    """Where the time of one ``fn()`` goes on the device: torch.profiler
    self device time by kernel, and the device's busy share of the wall
    time (the rest is host work, transfers and launch gaps).  ``group``
    maps the profile's events to ``{group: device us}`` (as
    :func:`kernel_shares` does); the shares of the groups are printed and
    returned.  ``host_top``: also print the device launches
    and the host ops with the most self CPU time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    # Device-side entries only (kernels, memcpy): a host op's self device
    # time (an aten:: op, an autograd Function, a record_function range
    # such as Adam.step) repeats the kernels it launched, and a CUDA
    # runtime call's (cudaLaunchKernel, cudaMemcpyAsync) the work it
    # enqueued; a range's device-side annotation spans kernels too.
    from torch.autograd import DeviceType

    def on_device(e):
        if getattr(e, "is_user_annotation", False):
            return False
        if getattr(e, "device_type", None) is not None:
            return e.device_type == DeviceType.CUDA
        return not e.key.startswith(("aten::", "cuda"))

    events = sorted((e for e in prof.key_averages()
                     if dev_us(e) > 0 and on_device(e)),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events)
    print(f"  profile of one batch on {card}: wall {wall_us / 1e3:.2f} ms "
          f"(profiler on), device busy {busy / 1e3:.2f} ms = "
          f"{100 * busy / wall_us:.1f}% of wall", flush=True)
    for e in events[:top]:
        print(f"    {100 * dev_us(e) / max(busy, 1):5.1f}%  "
              f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}",
              flush=True)
    shares = group(prof.events()) if group is not None else {}
    if shares:
        for g, us in sorted(shares.items(), key=lambda kv: -kv[1]):
            print(f"    group {g}: {us / 1e3:.3f} ms = "
                  f"{100 * us / max(busy, 1):.1f}% of device time",
                  flush=True)
    if host_top:
        host = sorted((e for e in prof.key_averages() if not on_device(e)
                       and not getattr(e, "is_user_annotation", False)),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        print(f"    {sum(e.count for e in events)} device launches; host "
              f"ops by self CPU time (profiler on):", flush=True)
        for e in host[:host_top]:
            print(f"      {e.self_cpu_time_total / 1e3:8.3f} ms  "
                  f"x{e.count:<5d} {e.key[:80]}", flush=True)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "launches": sum(e.count for e in events),
            "groups_ms": {g: us / 1e3 for g, us in shares.items()}}


def phase_main(card: str) -> dict:
    import numpy as np
    import torch
    from pesr_torch import test as cli
    from pesr_torch.data.augment import denormalize_to_uint8, normalize_uint8
    from pesr_torch.data.datasets import (SyntheticImages,
                                          host_bicubic_downsample)
    from pesr_torch.models.generator import Generator
    from pesr_torch.models.kernel_apply import KernelApply
    from pesr_torch.ops import kernels
    from pesr_torch.ops.tiling import BatchTiledUpscaler
    from pesr_torch.utils.image_io import imwrite_uint8

    def check_counts(what: str, forwards: int) -> dict:
        counts = edsr_launch_counts()
        want = {"fused_resblock": BLOCKS * forwards,
                "fused_upsampler_stage": 2 * forwards}
        print(f"  {what}: {forwards} generator forwards, launches {counts} "
              f"(expected {want})", flush=True)
        if forwards < 1 or counts != want:
            fail(f"{what}: kernel launch counts {counts} != {want}")
        return counts

    with tempfile.TemporaryDirectory() as tmp:
        print("[main] python -m pesr_torch.test x4 32x256 --tile_size auto "
              "--no_fold --dataset synthetic (random init, seed 0)",
              flush=True)
        kernels.reset_launch_counts()
        summary = cli.run(["--dataset", "synthetic", "--scale", str(SCALE),
                           "--num_blocks", str(BLOCKS), "--num_channels",
                           str(CHANNELS), "--tile_size", "auto", "--seed",
                           "0", "--no_fold", "--output_dir", tmp])
        check_counts("pesr_torch.test", summary["forwards"])
        pngs = os.listdir(summary["out_dir"])
        if len(pngs) != summary["images"] or not np.isfinite(
                summary["psnr"]):
            fail(f"pesr_torch.test wrote {len(pngs)} PNGs for "
                 f"{summary['images']} images, PSNR {summary['psnr']}")

        print(f"[main] BatchTiledUpscaler on {N_IMAGES} LR images "
              f"{LR_H}x{LR_W} -> {LR_H * SCALE}x{LR_W * SCALE}", flush=True)
        src = SyntheticImages(N_IMAGES, LR_H * SCALE, LR_W * SCALE, seed=7)
        hrs = [src.get(i) for i in range(N_IMAGES)]
        lrs = [host_bicubic_downsample(hr, SCALE) for hr in hrs]
        gen = Generator(SCALE, BLOCKS, CHANNELS, seed=0)
        apply_fn = KernelApply(gen)
        engine = BatchTiledUpscaler(apply_fn, SCALE, "auto", 8)
        kernels.reset_launch_counts()
        engine.warmup_many(lrs, N_IMAGES)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            srs = engine.upscale_many(lrs, N_IMAGES)
            times.append(time.perf_counter() - t0)
        counts = check_counts("BatchTiledUpscaler", apply_fn.forwards)
        for i, sr in enumerate(srs):
            if sr.shape != (LR_H * SCALE, LR_W * SCALE, 3):
                fail(f"output {i} has shape {sr.shape}")
            imwrite_uint8(os.path.join(tmp, f"div2k_sized_{i}.png"), sr)
        mp = sum(sr.shape[0] * sr.shape[1] for sr in srs) / 1e6
        best = min(times)
        print(f"  {mp:.3f} MP per batch; wall {[round(t, 4) for t in times]}"
              f" s -> {mp / best:.2f} MP/s (best of 3, host transfers "
              f"included) on {card}", flush=True)

        profile_breakdown(lambda: engine.upscale_many(lrs, N_IMAGES), card)

        # uint8 output of the kernel path vs the plain f32 Generator, on
        # the tile batch the engine ran (single tile per image here).
        (b, th, tw), grid = main_path_tile_batch()
        if grid[:2] != (1, 1):
            fail(f"expected one tile per image at {LR_H}x{LR_W}, got {grid}")
        x = normalize_uint8(torch.from_numpy(np.stack(lrs)).cuda())
        with torch.no_grad():
            ours = denormalize_to_uint8(apply_fn(x))
            ref = denormalize_to_uint8(gen(x))
        d = (ours.int() - ref.int()).abs().float()
        lsb_max, lsb_mean = float(d.max()), float(d.mean())
        print(f"  kernel path (bf16) vs plain Generator (f32), uint8: max "
              f"{lsb_max:.0f} LSB, mean {lsb_mean:.4f} LSB, "
              f"{float((d > 0).float().mean()) * 100:.2f}% of values differ"
              f" (tolerance: max <= {LSB_MAX_TOL}, mean <= {LSB_MEAN_TOL})",
              flush=True)
        if lsb_max > LSB_MAX_TOL or lsb_mean > LSB_MEAN_TOL:
            fail("kernel path output disagrees with the plain Generator")
    return {"launches": counts, "mp_per_s": mp / best,
            "synthetic_mp_per_s": summary["mp_per_s"]}


def check_backward(kind: str, bsz: int, h: int, w: int, c: int,
                   seed: int) -> dict:
    """Forward and backward of a kernel's differentiable form
    (``fused_resblock_train`` / ``fused_upsampler_stage_train``, OIHW bf16
    weights) against the plain version's f32 autograd on the same
    bf16-rounded inputs and bf16 cotangent."""
    import torch
    from pesr_torch.ops.kernels import (fused_resblock_train,
                                        fused_upsampler_stage_train,
                                        resblock_reference,
                                        upsampler_stage_reference)
    if kind == "resblock":
        x, (w1, b1, w2, b2) = make_inputs(
            (bsz, h, w, c), [(3, 3, c, c), (c,), (3, 3, c, c), (c,)], seed)
        ins = [x, w1.permute(3, 2, 0, 1).contiguous(), b1.bfloat16(),
               w2.permute(3, 2, 0, 1).contiguous(), b2.bfloat16()]
        names = ("x", "w1", "b1", "w2", "b2")

        def ours(x, w1, b1, w2, b2):
            return fused_resblock_train(x, w1, b1, w2, b2, 0.1)

        def plain(x, w1, b1, w2, b2):
            return resblock_reference(x, w1.permute(2, 3, 1, 0), b1,
                                      w2.permute(2, 3, 1, 0), b2, 0.1)
    else:
        x, (wt, b) = make_inputs((bsz, h, w, c), [(3, 3, c, 4 * c),
                                                  (4 * c,)], seed)
        ins = [x, wt.permute(3, 2, 0, 1).contiguous(), b.bfloat16()]
        names = ("x", "w", "b")
        ours = fused_upsampler_stage_train

        def plain(x, w, b):
            return upsampler_stage_reference(x, w.permute(2, 3, 1, 0), b)
    a = [t.detach().requires_grad_() for t in ins]
    out = ours(*a)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cot = torch.randn(out.shape, generator=gen, device="cuda").bfloat16()
    got = torch.autograd.grad(out, a, cot)
    r = [t.detach().float().requires_grad_() for t in ins]
    ref_out = plain(*r)
    ref = torch.autograd.grad(ref_out, r, cot.float())
    label = f"{kind} [{bsz},{h},{w},{c}]"
    res = compare(f"{label} forward", out.detach(), ref_out.detach())
    worst = 0.0
    parts = []
    for n, g, rg in zip(names, got, ref):
        rel = float((g.float() - rg).norm() / rg.norm().clamp_min(1e-30))
        cos = float(torch.nn.functional.cosine_similarity(
            g.float().flatten(), rg.flatten(), dim=0))
        worst = max(worst, rel)
        parts.append(f"d{n} rel {rel:.2e} cos {cos:.6f}")
        if not rel <= GRAD_REL_TOL:
            fail(f"{label}: gradient of {n} disagrees with the plain f32 "
                 f"autograd (||d||/||ref|| {rel:.3g} > {GRAD_REL_TOL})")
    print(f"  {label} backward: {'; '.join(parts)} (pass: rel <= "
          f"{GRAD_REL_TOL})", flush=True)
    res["grad_rel_worst"] = worst
    return res


def _train_batch(seed: int):
    """One training batch of the flagship recipe on the card: crops of
    the synthetic corpus, LR synthesized, dihedral bits from ``seed``."""
    import torch
    from pesr_torch.data.augment import dihedral_bits, prepare_train_batch
    from pesr_torch.data.datasets import PatchIterator, SyntheticImages
    it = PatchIterator(SyntheticImages(32, seed=seed), TRAIN_PATCH, SCALE,
                       TRAIN_BATCH, seed=seed)
    _, hr_u8 = next(it)
    bits = dihedral_bits(torch.Generator().manual_seed(seed), TRAIN_BATCH,
                         "cuda")
    return prepare_train_batch(bits, torch.from_numpy(hr_u8).cuda(), SCALE)


def _plant_fault(g, fault: str) -> None:
    """Plant one of PLANTED_FAULTS in generator ``g``, in place."""
    import torch
    from pesr_torch.models.kernel_apply import generator_convs
    if fault == "res_scale applied twice":
        g.res_scale = g.res_scale ** 2
        return
    _, blocks, _, stages, _ = generator_convs(g)
    a, b = ((blocks[0], blocks[1]) if fault.startswith("residual blocks")
            else ((stages[0][1],), (stages[1][1],)))
    with torch.no_grad():
        for ma, mb in zip(a, b):
            for p, q in zip(ma.parameters(), mb.parameters()):
                t = p.clone()
                p.copy_(q)
                q.copy_(t)


def step_agreement(opts, step, batch, ref, fault=None):
    """One pretrain step of the kernel path on a fresh seed-0 flagship
    generator (``fault`` planted) against the plain step's ``ref`` = (L1,
    {parameter name: gradient}).  Returns |d L1|, the least gradient
    cosine over the parameter tensors, its tensor, and the train state."""
    import torch
    from pesr_torch.models.generator import Generator
    from pesr_torch.training.state import create_generator_state
    gen = Generator(SCALE, BLOCKS, CHANNELS, seed=0)
    if fault is not None:
        _plant_fault(gen, fault)
    state = create_generator_state(opts, torch.device("cuda"), gen)
    m = step(state, *batch)
    cos, name = min((float(torch.nn.functional.cosine_similarity(
        p.grad.flatten(), ref[1][n].flatten(), dim=0)), n)
        for n, p in gen.named_parameters())
    return abs(float(m["l1"]) - ref[0]), cos, name, state


def _ours(key: str) -> bool:
    return "resblock_kernel<" in key or "upsampler_kernel<" in key


def _profile_group(key: str) -> str:
    if _ours(key):
        return "forward kernels (ours)"
    k = key.lower()
    if any(t in k for t in ("conv", "xmma", "cudnn", "wgrad", "dgrad",
                            "fprop", "gemm", "cutlass", "nhwc")):
        return ("cuDNN convs (backward, its recomputed forward, "
                "head/tail/out)")
    return "everything else (Adam, casts, losses, LR synthesis, copies)"


def steady_rate(recs, after_step: int, card: str) -> float:
    """Steps/s of the logged windows that end after ``after_step`` (the
    first epoch): their steps over the sum of their seconds, each
    window's seconds its steps over its ``steps_per_s``.  Prints each
    window's rate too."""
    steady = [r for r in recs if r["step"] > after_step]
    steps, secs, prev = 0, 0.0, after_step
    for r in steady:
        steps += r["step"] - prev
        secs += (r["step"] - prev) / r["steps_per_s"]
        prev = r["step"]
    print(f"  steps/s of the {len(steady)} windows after step {after_step}: "
          f"{[round(r['steps_per_s'], 3) for r in steady]}; together "
          f"{steps} steps in {secs:.3f} s = {steps / secs:.3f} steps/s "
          f"[{card}]", flush=True)
    return steps / secs


def phase_train(card: str, workdir: str) -> dict:
    """The pretrain path; its ``run_training`` writes its snapshots under
    ``workdir`` (the GAN phase starts from its ``best/``)."""
    import torch
    from pesr_torch import test as cli
    from pesr_torch.config import Opts
    from pesr_torch.models.generator import Generator
    from pesr_torch.ops import kernels
    from pesr_torch.training.loop import run_training
    from pesr_torch.training.state import TrainState, create_generator_state
    from pesr_torch.training.steps import make_pretrain_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    c = CHANNELS
    print(f"[train] backward of each kernel's differentiable form at C = "
          f"{c} (training shapes, then ragged; the narrow widths at C = "
          f"64, 128, 256) on {card}", flush=True)
    bt, p = TRAIN_BATCH, TRAIN_PATCH
    for kind, shape in (("resblock", (bt, p, p)), ("upsampler", (bt, p, p)),
                        ("upsampler", (bt, 2 * p, 2 * p))):
        check_backward(kind, *shape, c, seed=7)
    for i, shape in enumerate(TRAIN_RAGGED):
        for cc in ((64, 128, c) if shape in TRAIN_NARROW else (c,)):
            check_backward("resblock", *shape, cc, seed=20 + i)
            check_backward("upsampler", *shape, cc, seed=30 + i)
    torch.cuda.empty_cache()

    print(f"[train] kernel times at the training shapes, C = {c}",
          flush=True)
    rb = check_resblock(bt, p, p, c, 0.1, seed=11, timing=True)
    up1 = check_upsampler(bt, p, p, c, seed=12, timing=True)
    up2 = check_upsampler(bt, 2 * p, 2 * p, c, seed=13, timing=True)
    print_times(rb, up1, up2, card)
    rows = train_rows(rb, up1, up2, card)
    torch.cuda.empty_cache()

    print(f"[train] one pretrain step at {BLOCKS}x{c} x{SCALE}, batch {bt}, "
          f"patch {p}: kernel path (bf16) vs plain Generator (f32)",
          flush=True)
    opts = Opts(scale=SCALE, num_blocks=BLOCKS, num_channels=c,
                batch_size=bt, patch_size=p, fold_train=False, device="cuda")
    step = make_pretrain_step(opts)
    batch = _train_batch(seed=0)
    gen_p = Generator(SCALE, BLOCKS, c, seed=0)
    plain = create_generator_state(opts, torch.device("cuda"), gen_p)
    m_p = step(TrainState(gen_p, plain.optimizer, plain.lr_at, gen_p), *batch)
    ref = (float(m_p["l1"]),
           {n: q.grad for n, q in gen_p.named_parameters()})
    del plain, gen_p
    dl1, worst_cos, worst_name, state_k = step_agreement(opts, step, batch,
                                                         ref)
    print(f"  L1 {ref[0]:.6f} (plain): kernel path |d L1| {dl1:.2e} "
          f"(limit {STEP_L1_TOL}); least gradient cosine over the "
          f"parameter tensors {worst_cos:.6f} ({worst_name}; floor "
          f"{GRAD_COS_FLOOR})", flush=True)
    if not (dl1 <= STEP_L1_TOL and worst_cos >= GRAD_COS_FLOOR):
        fail("the kernel path's pretrain step disagrees with the plain "
             "Generator's")
    for fault in PLANTED_FAULTS:
        f_dl1, f_cos, f_name, _ = step_agreement(opts, step, batch, ref,
                                                 fault)
        print(f"  planted fault '{fault}': |d L1| {f_dl1:.2e}, least "
              f"cosine {f_cos:.6f} ({f_name})", flush=True)
        if f_dl1 <= STEP_L1_TOL and f_cos >= GRAD_COS_FLOOR:
            fail(f"the step limits pass the planted fault '{fault}'")
    del ref
    torch.cuda.empty_cache()
    lr_img, hr_img = batch
    host_ms, wall_ms = [], []
    kernels.reset_launch_counts()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state_k, lr_img, hr_img)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
    counts = edsr_launch_counts()
    if counts != {"fused_resblock": 5 * BLOCKS, "fused_upsampler_stage": 10}:
        fail(f"launches in 5 pretrain steps: {counts}")
    per_step = {k: v // 5 for k, v in counts.items()}
    print(f"  one step from an idle device: the host queues it in "
          f"{sorted(host_ms)[2]:.2f} ms, it ends {sorted(wall_ms)[2]:.2f} ms "
          f"after it starts (medians of 5) [{card}]", flush=True)
    prof = profile_breakdown(lambda: step(state_k, lr_img, hr_img), card,
                             top=10, host_top=8,
                             group=lambda ev: kernel_shares(
                                 ev, lambda e, k: _profile_group(k)))
    prof["host_ms"], prof["step_ms"] = sorted(host_ms)[2], sorted(wall_ms)[2]
    prof["conv_ops"] = step_summary(
        "pretrain", lambda: step(state_k, lr_img, hr_img), prof,
        (3 + BLOCKS, 3 + 2 * BLOCKS + 2), card)
    del state_k
    torch.cuda.empty_cache()

    spe, epochs, log_every = 20, 2, 10
    print(f"[train] run_training: {BLOCKS}x{c} x{SCALE}, batch {bt}, "
          f"patch {p}, synthetic, {epochs} epochs x {spe} steps, eval "
          f"on 2 synthetic images each epoch", flush=True)
    topts = Opts(scale=SCALE, num_blocks=BLOCKS, num_channels=c,
                 batch_size=bt, patch_size=p, train_dataset="synthetic",
                 valid_dataset="synthetic", num_valids=2,
                 steps_per_epoch=spe, num_epochs=epochs,
                 log_every=log_every, snapshot_every=1, keep_snapshots=1,
                 check_point=os.path.join(workdir, "pretrain"),
                 fold_train=False, device="cuda")
    ((b, th, tw),) = eval_tile_batches(topts)
    print(f"[train] the eval forwards' tile batch [{b},{th},{tw}] "
          f"(TiledUpscaler: tile {topts.tile_size} + 2 x "
          f"{topts.tile_overlap}, batch {topts.infer_batch}) and its x2 "
          f"stages, C = {c}", flush=True)
    ev_rb = check_resblock(b, th, tw, c, 0.1, seed=14, timing=True)
    ev_up1 = check_upsampler(b, th, tw, c, seed=15, timing=True)
    ev_up2 = check_upsampler(b, 2 * th, 2 * tw, c, seed=16, timing=True)
    print_times(ev_rb, ev_up1, ev_up2, card)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = run_training(topts)
    run_s = time.perf_counter() - t0
    counts = edsr_launch_counts()
    fwd = summary["train_forwards"] + summary["eval_forwards"]
    want = {"fused_resblock": BLOCKS * fwd,
            "fused_upsampler_stage": 2 * fwd}
    print(f"  run_training: {summary['train_forwards']} training + "
          f"{summary['eval_forwards']} eval forwards, launches {counts}"
          f" (expected {want})", flush=True)
    if summary["train_forwards"] != spe * epochs or counts != want:
        fail(f"run_training: launch counts {counts} != {want}")
    with open(os.path.join(topts.check_point, "pretrain.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "l1" in r]
    l1s = [r["l1"] for r in recs]
    print(f"  L1 per {log_every}-step window: "
          f"{[round(v, 5) for v in l1s]}", flush=True)
    if not all(map(math.isfinite, l1s)) or not l1s[-1] < l1s[0]:
        fail(f"run_training: the L1 loss did not fall ({l1s})")
    print(f"  last self-validation: val_psnr {summary['val_psnr']:.4f} dB, "
          f"val_ssim {summary['val_ssim']:.4f}, val_pi "
          f"{summary.get('val_pi')}", flush=True)
    if not math.isfinite(summary.get("val_pi", math.nan)):
        fail(f"run_training: val_pi {summary.get('val_pi')} is not finite")
    sps = steady_rate(recs, spe, card)
    mps = sps * bt * (p * SCALE) ** 2 / 1e6
    run_sps = summary["steps"] / run_s
    run_mps = run_sps * bt * (p * SCALE) ** 2 / 1e6
    print(f"  training throughput after the first epoch: {sps:.3f} "
          f"steps/s, {mps:.3f} HR MP/s at batch {bt} x {p * SCALE}^2 on "
          f"{card}", flush=True)
    print(f"  over the whole run_training call ({summary['steps']} "
          f"steps in {run_s:.2f} s: set-up, warm-up, {epochs} evals "
          f"and snapshots included): {run_sps:.3f} steps/s, "
          f"{run_mps:.3f} HR MP/s on {card}", flush=True)
    best = os.path.join(topts.check_point, "best")
    if not os.path.isfile(os.path.join(best, "generator.pth")):
        fail("run_training wrote no best/generator.pth")
    res = cli.run(["--dataset", "synthetic", "--scale", str(SCALE),
                   "--num_blocks", str(BLOCKS), "--num_channels",
                   str(c), "--model_path", best, "--no_fold", "--output_dir",
                   os.path.join(workdir, "out")])
    if not math.isfinite(res["psnr"]):
        fail(f"best/generator.pth through pesr_torch.test: PSNR "
             f"{res['psnr']}")
    print(f"  best/ (val_psnr {summary.get('best_psnr')}) reloads "
          f"through pesr_torch.test: PSNR {res['psnr']:.3f} dB",
          flush=True)
    ev = _tiled_eval(card, topts, best)
    ev.update({"fused_resblock": ev_rb, "fused_upsampler_stage": ev_up2,
               "upsampler_stage1": ev_up1})
    return {"fused_resblock": rb, "fused_upsampler_stage": up2,
            "upsampler_stage1": up1, "rows": rows, "launches": counts,
            "launches_per_step": per_step, "steps_per_s": sps,
            "mpx_per_s": mps, "run_steps_per_s": run_sps, "profile": prof,
            "l1": l1s, "best": best, "eval": ev}


# The LR size of the self-validation check's third image: one side <= 96
# px, so the whole image is one tile whose outer border the engine
# replicate-pads.
C1_LR_HW = (60, 88)


def _tiled_eval(card: str, opts, best: str) -> dict:
    """Self-validation as ``training.loop`` runs it: the host-stitch
    ``TiledUpscaler`` of ``opts`` on ``KernelApply`` (bf16, chain) of the
    ``best`` snapshot, on the two synthetic eval images at x4 and one
    image of ``C1_LR_HW``.  Launch counts of that eval (counters set to 0
    just before it), the SR and PI seconds, ``val_pi`` against the PI
    recomputed on the same SR arrays, and each uint8 output against the
    plain f32 ``Generator`` (TF32 off) through the same engine."""
    import numpy as np
    from pesr_torch.data.datasets import (EvalSample, SyntheticImages,
                                          host_bicubic_downsample,
                                          load_eval_set)
    from pesr_torch.metrics import perceptual_index
    from pesr_torch.models.generator import Generator
    from pesr_torch.models.kernel_apply import KernelApply
    from pesr_torch.ops import kernels
    from pesr_torch.training import checkpoint as ckpt
    from pesr_torch.training.loop import make_eval_tiler, score_outputs
    sd, _ = ckpt.restore_generator_params(best)
    gen = Generator(SCALE, BLOCKS, CHANNELS, seed=None)
    gen.load_state_dict(sd)
    samples = load_eval_set(opts, opts.valid_dataset, opts.num_valids)
    hr = SyntheticImages(1, C1_LR_HW[0] * SCALE, C1_LR_HW[1] * SCALE,
                         seed=9).get(0)
    samples.append(EvalSample("lr_side_le_96", host_bicubic_downsample(
        hr, SCALE), hr))
    lrs = [s.lr for s in samples]
    print(f"[train] self-validation through TiledUpscaler on "
          f"{[s.lr.shape[:2] for s in samples]} LR images, the best "
          f"snapshot on KernelApply (bf16)", flush=True)
    apply_fn = KernelApply(gen)
    tiler = make_eval_tiler(opts, apply_fn)
    tiler.upscale_many(lrs)      # warm-up: cuDNN's algorithm searches
    apply_fn.forwards = 0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    srs = tiler.upscale_many(lrs)          # ends with the cores' D2H copy
    sr_s = time.perf_counter() - t0
    counts = edsr_launch_counts()
    fwd = apply_fn.forwards
    tiles = sum(-(-h // opts.tile_size) * -(-w // opts.tile_size)
                for h, w in (lr.shape[:2] for lr in lrs))
    want = {"fused_resblock": BLOCKS * fwd, "fused_upsampler_stage": 2 * fwd}
    print(f"  {tiles} tiles in {fwd} forwards of batch {opts.infer_batch}: "
          f"launches {counts} (expected {want})", flush=True)
    if fwd != -(-tiles // opts.infer_batch) or counts != want:
        fail(f"self-validation: launch counts {counts} != {want}")
    t0 = time.perf_counter()
    val = score_outputs(opts, samples, srs, compute_pi=True)
    pi_s = time.perf_counter() - t0
    pis = [perceptual_index(sr) for sr in srs]
    d_pi = abs(val["val_pi"] - float(np.mean(pis)))
    print(f"  {json.dumps(val)}; per-image PI {[round(v, 4) for v in pis]}; "
          f"|val_pi - mean PI recomputed| {d_pi:.3g} (limit 1e-9)",
          flush=True)
    if not (math.isfinite(val["val_pi"]) and d_pi <= 1e-9):
        fail("self-validation: val_pi is not finite or not the mean PI of "
             "its SR outputs")
    print(f"  eval wall: SR {sr_s:.3f} s (device forwards, D2H of the "
          f"cores, host stitch), PI {pi_s:.3f} s (NIQE + Ma on the host, "
          f"{len(srs)} images of {[sr.shape[:2] for sr in srs]}) [{card}]",
          flush=True)
    plain = make_eval_tiler(opts, gen).upscale_many(lrs)
    for s, ours, ref in zip(samples, srs, plain):
        d = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
        print(f"  {s.name} {s.lr.shape[:2]}: KernelApply (bf16) vs plain "
              f"Generator (f32) through the same engine, uint8: max "
              f"{int(d.max())} LSB, mean {float(d.mean()):.4f} LSB "
              f"(tolerance: max <= {LSB_MAX_TOL}, mean <= {LSB_MEAN_TOL})",
              flush=True)
        if d.max() > LSB_MAX_TOL or d.mean() > LSB_MEAN_TOL:
            fail(f"self-validation output of {s.name} disagrees with the "
                 f"plain Generator's")
    return {"launches": counts, "forwards": fwd, "sr_s": sr_s,
            "pi_s": pi_s, "val": val}


# GAN phase: one flagship GAN step at the JAX defaults (RSGAN, alpha_vgg
# 50, alpha_gan 1, alpha_tv 1e-6, no GP), the SRGAN discriminator (64-512,
# dense 1024) and VGG54 with random weights from the seed; kernel path (G,
# D and VGG in bf16) vs the plain step (G, D and VGG in f32, TF32 off).
# First sound reading on the H100: |d d_loss| 8.2e-4, least cosine 0.952
# over G's tensors (a conv bias: a sum over every pixel of a gradient
# that passed D's 8 bf16 convs and norms) and 0.973 over D's; the limits
# are ~3-4x those (in 1 - cosine for the cosines).  g_loss is read
# against D after its Adam step, whose first step moves each of D's
# ~2e7 weights by ~lr along its gradient's sign: the logits of HR and SR
# part by ~20, g_loss grows from ~1 (LR 0) to ~20, and the bf16 D's
# error grows with it.  Readings over G's forward (chain, fold) and D
# (each side's own, or the plain step's on both): |d g_loss| 6.5e-3 to
# 3.2e-2 of g_loss 19.9 (3e-4 to 1.6e-3 of it); at LR 0 1.4e-3 to
# 1.9e-3.  So g_loss is held to |d| <= atol + rtol |g_loss|: rtol 2.5e-3
# (~1.3 bf16 roundings, 2^-9, of the result; errors that do not share a
# sign average below one), atol 5e-3 (~3x the LR 0 readings).  The
# planted faults read |d d_loss| >= 5.2e-2, |d g_loss| >= 0.27 and
# cosines <= 0.72.
GAN_LIMITS = {"d_loss": 3e-3, "g_loss_atol": 5e-3, "g_loss_rtol": 2.5e-3,
              "cos_g": 0.85, "cos_d": 0.9}
# Wiring faults planted in the kernel path's step only (the plain one
# stays sound); the step check fails if any of them passes GAN_LIMITS.
GAN_FAULTS = ("HR and SR through D as one concatenated batch",
              "D fed H and W swapped", "res_scale applied twice")
GAN_SPE, GAN_EPOCHS, GAN_LOG_EVERY = 20, 2, 10


def _gan_opts(**kw):
    from pesr_torch.config import Opts
    return Opts(scale=SCALE, num_blocks=BLOCKS, num_channels=CHANNELS,
                batch_size=TRAIN_BATCH, patch_size=TRAIN_PATCH,
                phase="train", device="cuda", **{"fold_train": False, **kw})


def _gan_state(opts, g0, d0, vgg, plain=False):
    """A GAN train state on the card from the initial weights ``g0`` /
    ``d0`` (state_dicts), D computing in ``opts.compute_dtype``;
    ``plain``: the plain f32 forward instead of the kernels (the
    ``Generator``, or with ``opts.fold_train`` :func:`_plain_fold_apply`)."""
    import torch
    from pesr_torch.models.discriminator import Discriminator
    from pesr_torch.models.generator import Generator
    from pesr_torch.training.state import (COMPUTE_DTYPES, add_discriminator,
                                           create_generator_state)
    dev = torch.device("cuda")
    gen = Generator(SCALE, BLOCKS, CHANNELS, device=dev, seed=None)
    gen.load_state_dict(g0)
    state = create_generator_state(opts, dev, gen)
    if plain:
        state.apply = _plain_fold_apply(gen) if opts.fold_train else gen
    d = Discriminator(opts.hr_patch_size,
                      dtype=COMPUTE_DTYPES[opts.compute_dtype], device=dev,
                      seed=None)
    d.load_state_dict(d0)
    add_discriminator(state, opts, dev, d)
    state.vgg = vgg
    return state


def _plant_gan_fault(state, fault: str, hr) -> None:
    """Plant one of GAN_FAULTS in ``state``, in place."""
    import torch
    if fault == "res_scale applied twice":
        _plant_fault(state.generator, fault)
        return
    inner_apply, box = state.apply, {}

    def apply(x):
        box["sr"] = inner_apply(x)
        return box["sr"]

    class Faulty(torch.nn.Module):
        def __init__(self, d):
            super().__init__()
            self.d = d

        def forward(self, x):
            if fault.startswith("D fed"):
                return self.d(x.transpose(1, 2))
            # each call runs D on [HR; SR] and keeps its own half
            other = (box["sr"].detach() if x.data_ptr() == hr.data_ptr()
                     else hr)
            return self.d(torch.cat([x, other]))[:x.shape[0]]

    state.apply = apply
    state.discriminator = Faulty(state.discriminator)


def gan_step_agreement(step, batch, ref, state) -> dict:
    """One GAN step on ``state`` against the plain step's ``ref`` (its
    metrics and {network: {parameter: gradient}}): |d d_loss|, |d g_loss|
    and the least gradient cosine over G's and over D's tensors (D's
    tensors whose f32 gradient is rounding noise, 0 by construction, are
    left out and named)."""
    import torch
    m = step(state, *batch)
    out = {k: abs(float(m[k]) - ref["metrics"][k])
           for k in ("d_loss", "g_loss")}
    out["g_loss_ref"] = ref["metrics"]["g_loss"]
    d = state.discriminator
    d = getattr(d, "d", d)
    for net, mod in (("g", state.generator), ("d", d)):
        grads = ref["grads"][net]
        norms = {n: float(g.norm()) for n, g in grads.items()}
        keep = [n for n in grads if norms[n] > 1e-4 * max(norms.values())]
        out[f"cos_{net}"], out[f"worst_{net}"] = min(
            (float(torch.nn.functional.cosine_similarity(
                p.grad.flatten(), grads[n].flatten(), dim=0)), n)
            for n, p in mod.named_parameters() if n in keep)
        out[f"skipped_{net}"] = sorted(set(grads) - set(keep))
    return out


def _gan_ref(opts32, g0, d0, batch) -> dict:
    """The plain f32 GAN step of ``opts32`` from ``g0`` / ``d0`` on
    ``batch``: its metrics, {network: {parameter: gradient}}, and D's
    parameters after its Adam step (``d_after``)."""
    import torch
    from pesr_torch.training.state import init_vgg
    from pesr_torch.training.steps import make_gan_step
    plain = _gan_state(opts32, g0, d0,
                       init_vgg(opts32, torch.device("cuda")), plain=True)
    m = make_gan_step(opts32)(plain, *batch)
    ref = {"metrics": {k: float(v) for k, v in m.items()},
           "grads": {"g": {n: q.grad for n, q in
                           plain.generator.named_parameters()},
                     "d": {n: q.grad for n, q in
                           plain.discriminator.named_parameters()}},
           "d_after": {n: q.detach().clone() for n, q in
                       plain.discriminator.named_parameters()}}
    del plain
    torch.cuda.empty_cache()
    return ref


def _share_updated_d(state, d_after: dict) -> None:
    """After each of its own Adam steps, ``state``'s D takes the
    parameters ``d_after`` (the plain step's D after its step): G's loss
    is then read against the same D on both sides.  D's gradients and
    d_loss come before the update and are left as they were."""
    import torch
    d = state.discriminator

    def take(*_):
        with torch.no_grad():
            for n, q in d.named_parameters():
                q.copy_(d_after[n])

    state.d_optimizer.register_step_post_hook(take)


def _gan_reading(name: str, step, batch, ref, state, share_d=False) -> dict:
    """:func:`gan_step_agreement` on ``state`` (with ``share_d``, D set
    to the plain step's updated D after its own step), printed."""
    if share_d:
        _share_updated_d(state, ref["d_after"])
    r = gan_step_agreement(step, batch, ref, state)
    print(f"  {name}: plain g_loss {r['g_loss_ref']:.4f} (g_gan "
          f"{ref['metrics']['g_gan']:.4f}); |d d_loss| {r['d_loss']:.3e}, "
          f"|d g_loss| {r['g_loss']:.3e}; least gradient cosine over G's "
          f"tensors {r['cos_g']:.6f} ({r['worst_g']}), over D's "
          f"{r['cos_d']:.6f} ({r['worst_d']}; left out as rounding noise: "
          f"{r['skipped_d']})", flush=True)
    return r


def _gan_within(r: dict) -> bool:
    g_tol = (GAN_LIMITS["g_loss_atol"]
             + GAN_LIMITS["g_loss_rtol"] * abs(r["g_loss_ref"]))
    return (r["d_loss"] <= GAN_LIMITS["d_loss"]
            and r["g_loss"] <= g_tol
            and r["cos_g"] >= GAN_LIMITS["cos_g"]
            and r["cos_d"] >= GAN_LIMITS["cos_d"])


def _gan_profile_groups(events) -> dict:
    """Device time of one GAN step by network, from the profile's event
    tree: a kernel belongs to the ``gan::`` range its op ran in, or, in
    the backward, to the range of the forward op whose autograd node
    launched it (matched by sequence number); Adam by its range; our
    forward kernels by name."""
    ranges = {"gan::G": "G: cuDNN backward, recompute, head/tail/out",
              "gan::D": "D: both applications, backward, penalty",
              "gan::VGG": "VGG: SR and HR forwards, backward to SR"}
    seq = {}

    def forward_range(e):
        while e is not None:
            if e.name in ranges:
                return ranges[e.name]
            e = e.cpu_parent
        return None

    for e in events:
        g = forward_range(e)
        if g is not None and e.sequence_nr >= 0:
            seq[e.sequence_nr] = g

    def group(e):
        while e is not None:
            if e.name in ranges:
                return ranges[e.name]
            if e.name.startswith("Optimizer.step"):
                return "Adam (G and D)"
            if (e.name.startswith("autograd::engine::evaluate_function")
                    and e.sequence_nr in seq):
                return seq[e.sequence_nr]
            e = e.cpu_parent
        return "the rest: losses, casts, EMA, zeroing"

    return kernel_shares(events, lambda e, k: ("forward kernels (ours)"
                                               if _ours(k) else group(e)))


def _named(state):
    """``state`` with G's apply, D and VGG each running inside a
    ``gan::`` profiler range (for :func:`_gan_profile_groups`)."""
    import torch
    from torch.profiler import record_function

    class Named(torch.nn.Module):
        def __init__(self, name, mod):
            super().__init__()
            self.name, self.mod = name, mod

        def forward(self, x):
            with record_function(self.name):
                return self.mod(x)

    inner = state.apply

    def apply(x):
        with record_function("gan::G"):
            return inner(x)

    return dataclasses.replace(
        state, apply=apply,
        discriminator=Named("gan::D", state.discriminator),
        vgg=Named("gan::VGG", state.vgg))


def phase_gan(card: str, pretrained: str, workdir: str) -> dict:
    import torch
    from pesr_torch import test as cli
    from pesr_torch.models.discriminator import Discriminator
    from pesr_torch.models.generator import Generator
    from pesr_torch.ops import kernels
    from pesr_torch.training.loop import run_training
    from pesr_torch.training.state import init_vgg
    from pesr_torch.training.steps import make_gan_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = _gan_opts()
    opts32 = _gan_opts(compute_dtype="float32")
    bt, p = TRAIN_BATCH, TRAIN_PATCH
    print(f"[gan] one GAN step at {BLOCKS}x{CHANNELS} x{SCALE}, batch {bt}, "
          f"patch {p}: {opts.gan_type}, alpha vgg {opts.alpha_vgg} (VGG"
          f"{opts.vgg_layer}, random weights) gan {opts.alpha_gan} tv "
          f"{opts.alpha_tv}, D 64-512 dense 1024; kernel path (bf16) vs "
          f"plain Generator with D and VGG in f32", flush=True)
    dev = torch.device("cuda")
    g0 = Generator(SCALE, BLOCKS, CHANNELS, device=dev, seed=0).state_dict()
    d0 = Discriminator(opts.hr_patch_size, device=dev,
                       seed=opts.seed + 1).state_dict()
    vgg16 = init_vgg(opts, dev)
    step = make_gan_step(opts)
    batch = _train_batch(seed=1)
    ref = _gan_ref(opts32, g0, d0, batch)
    print(f"  plain step: {json.dumps(ref['metrics'])}", flush=True)
    state = _gan_state(opts, g0, d0, vgg16)
    print(f"  limits {GAN_LIMITS}", flush=True)
    r = _gan_reading("kernel path", step, batch, ref, state)
    if not _gan_within(r):
        fail("the kernel path's GAN step disagrees with the plain step")
    readings = {"sound": r}
    # g_loss is read against D after its Adam step (GAN_LIMITS): two
    # witnesses, at LR 0 (D stays put, g_loss ~1) and with the plain
    # step's updated D on both sides (one D, whatever the two updates).
    ref0 = _gan_ref(_gan_opts(compute_dtype="float32", learning_rate=0.0),
                    g0, d0, batch)
    for name, wref, w_opts, share in (
            ("LR 0", ref0, _gan_opts(learning_rate=0.0), False),
            ("LR 1e-4, D shared", ref, opts, True)):
        w = readings[name] = _gan_reading(
            name, step, batch, wref, _gan_state(w_opts, g0, d0, vgg16), share)
        if not _gan_within(w):
            fail(f"the kernel path's GAN step ({name}) disagrees with the "
                 f"plain step")
    del ref0
    for fault in GAN_FAULTS:
        f_state = _gan_state(opts, g0, d0, vgg16)
        _plant_gan_fault(f_state, fault, batch[1])
        f = gan_step_agreement(step, batch, ref, f_state)
        readings[fault] = f
        print(f"  planted fault '{fault}': |d d_loss| {f['d_loss']:.3e}, "
              f"|d g_loss| {f['g_loss']:.3e}, cosine G {f['cos_g']:.6f} "
              f"({f['worst_g']}), D {f['cos_d']:.6f} ({f['worst_d']})",
              flush=True)
        if _gan_within(f):
            fail(f"the GAN step limits pass the planted fault '{fault}'")
        del f_state
    torch.cuda.empty_cache()

    lr_img, hr_img = batch
    host_ms, wall_ms = [], []
    kernels.reset_launch_counts()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, lr_img, hr_img)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
    counts = edsr_launch_counts()
    if counts != {"fused_resblock": 5 * BLOCKS, "fused_upsampler_stage": 10}:
        fail(f"launches in 5 GAN steps: {counts} (one generator forward "
             f"per step gives {5 * BLOCKS} and 10)")
    per_step = {k: v // 5 for k, v in counts.items()}
    print(f"  launches in 5 GAN steps: {counts}: one generator forward per "
          f"step", flush=True)
    print(f"  one GAN step from an idle device: the host queues it in "
          f"{sorted(host_ms)[2]:.2f} ms, it ends {sorted(wall_ms)[2]:.2f} ms "
          f"after it starts (medians of 5) [{card}]", flush=True)
    named = _named(state)
    prof = profile_breakdown(lambda: step(named, lr_img, hr_img), card,
                             top=10, host_top=8, group=_gan_profile_groups)
    prof["host_ms"], prof["step_ms"] = sorted(host_ms)[2], sorted(wall_ms)[2]
    prof["conv_ops"] = step_summary(
        "GAN", lambda: step(state, lr_img, hr_img), prof, None, card)
    del state, named
    torch.cuda.empty_cache()

    print(f"[gan] run_training --phase train from {pretrained}: "
          f"{GAN_EPOCHS} epochs x {GAN_SPE} steps, eval on 2 synthetic "
          f"images each epoch", flush=True)
    topts = _gan_opts(pretrained_model=pretrained, train_dataset="synthetic",
                      valid_dataset="synthetic", num_valids=2,
                      steps_per_epoch=GAN_SPE, num_epochs=GAN_EPOCHS,
                      log_every=GAN_LOG_EVERY, snapshot_every=1,
                      keep_snapshots=1,
                      check_point=os.path.join(workdir, "gan"))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = run_training(topts)
    run_s = time.perf_counter() - t0
    counts = edsr_launch_counts()
    fwd = summary["train_forwards"] + summary["eval_forwards"]
    want = {"fused_resblock": BLOCKS * fwd, "fused_upsampler_stage": 2 * fwd}
    print(f"  run_training: {summary['train_forwards']} training + "
          f"{summary['eval_forwards']} eval forwards, launches {counts} "
          f"(expected {want})", flush=True)
    if summary["train_forwards"] != GAN_SPE * GAN_EPOCHS or counts != want:
        fail(f"GAN run_training: launch counts {counts} != {want}")
    with open(os.path.join(topts.check_point, "train.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "d_loss" in r]
    for k in ("d_loss", "g_loss", "g_gan", "vgg", "psnr"):
        vals = [r[k] for r in recs]
        print(f"  {k} per {GAN_LOG_EVERY}-step window: "
              f"{[round(v, 5) for v in vals]}", flush=True)
        if not vals or not all(map(math.isfinite, vals)):
            fail(f"GAN run_training: {k} is not finite ({vals})")
    sps = steady_rate(recs, GAN_SPE, card)
    mps = sps * bt * (p * SCALE) ** 2 / 1e6
    run_sps = summary["steps"] / run_s
    print(f"  GAN training throughput after the first epoch: {sps:.3f} "
          f"steps/s, {mps:.3f} HR MP/s at batch {bt} x {p * SCALE}^2 on "
          f"{card}", flush=True)
    print(f"  over the whole run_training call ({summary['steps']} steps in "
          f"{run_s:.2f} s: set-up, warm-up, {GAN_EPOCHS} evals and "
          f"snapshots included): {run_sps:.3f} steps/s, "
          f"{run_sps * bt * (p * SCALE) ** 2 / 1e6:.3f} HR MP/s on {card}",
          flush=True)
    best = os.path.join(topts.check_point, "best")
    last = os.path.join(topts.check_point, f"step_{summary['steps']}")
    for snap in (best, last):
        if not os.path.isfile(os.path.join(snap, "discriminator.pth")):
            fail(f"GAN run_training wrote no {snap}/discriminator.pth")
    # With random VGG the losses cannot tell a working G update from a
    # missing one; G's weights moving away from the pretrained ones can.
    g_from, g_to = (torch.load(os.path.join(d, "generator.pth"),
                               weights_only=True)
                    for d in (pretrained, last))
    moved = max(float((g_to[k] - v).abs().max()) for k, v in g_from.items())
    print(f"  G's largest weight change over the GAN run: {moved:.3e}",
          flush=True)
    if not moved > 0.0:
        fail("GAN run_training left the generator's weights unchanged")
    res = cli.run(["--dataset", "synthetic", "--scale", str(SCALE),
                   "--num_blocks", str(BLOCKS), "--num_channels",
                   str(CHANNELS), "--model_path", best, "--no_fold",
                   "--output_dir", os.path.join(workdir, "gan_out")])
    if not math.isfinite(res["psnr"]):
        fail(f"GAN best/ through pesr_torch.test: PSNR {res['psnr']}")
    print(f"  GAN best/ (val_psnr {summary.get('best_psnr')}) reloads "
          f"through pesr_torch.test: PSNR {res['psnr']:.3f} dB", flush=True)
    return {"launches_per_step": per_step, "readings": readings,
            "profile": prof, "steps_per_s": sps, "mpx_per_s": mps,
            "run_steps_per_s": run_sps}


# Fold phase.  The folded composite in f32 (probe on the card, TF32 off)
# vs float64 on the CPU: each tap sums ~10^3 products in another order,
# ~1e-6 of the largest tap; a wrong phase or tap is O(1) of it.
FOLD_REL_TOL = 1e-4
# Planted faults in the fold-train path's fold only (the plain step
# stays sound); the step check fails if either passes the train limits.
FOLD_FAULTS = ("phases i and j swapped in the folded kernel",
               "folded conv's pads shifted by one")
FOLD_SPE, FOLD_EPOCHS, FOLD_LOG_EVERY = 20, 2, 10


def _plain_fold_apply(gen):
    """The plain f32 fold-train forward of ``gen``: its own trunk modules
    (head, blocks, tail + skip), then the analytic fold of its upsampler
    and out weights in f32 (TF32 off) as one conv and a pixel shuffle."""
    from pesr_torch.models.fold import analytic_fold_upsampler, folded_conv
    from pesr_torch.models.kernel_apply import generator_convs
    from pesr_torch.ops.pixel_shuffle import pixel_shuffle

    def apply(x):
        h = gen.head(x.permute(0, 3, 1, 2).float())
        y = (gen.body(h) + h).permute(0, 2, 3, 1)
        _, _, _, stages, out = generator_convs(gen)
        k, b, pads = analytic_fold_upsampler(
            [(m.weight, m.bias) for _, m in stages], (out.weight, out.bias),
            gen.scale)
        return pixel_shuffle(folded_conv(y, k, b, pads), gen.scale).float()

    return apply


class _FoldFault:
    """Plant one of FOLD_FAULTS in ``KernelTrainApply``'s analytic fold
    for the ``with`` block."""

    def __init__(self, fault: str):
        self.fault = fault

    def __enter__(self):
        from pesr_torch.models import kernel_apply
        self.mod, real = kernel_apply, kernel_apply.analytic_fold_upsampler
        s = SCALE

        def faulty(up, out, scale):
            k, b, (lo, hi) = real(up, out, scale)
            if self.fault.startswith("phases"):
                o, c, kh, kw = k.shape
                k = k.reshape(o // (s * s), s, s, c, kh, kw).transpose(1, 2)
                b = b.reshape(o // (s * s), s, s).transpose(1, 2)
                return k.reshape(o, c, kh, kw), b.reshape(-1), (lo, hi)
            return k, b, (lo - 1, hi + 1)

        kernel_apply.analytic_fold_upsampler = faulty
        self.real = real
        return self

    def __exit__(self, *exc):
        self.mod.analytic_fold_upsampler = self.real


def _fold_profile_group(events) -> dict:
    """Device time of a folded inference batch: our resblock kernel, the
    folded conv (its ``fold::conv`` range), the D2H copy, the other cuDNN
    convs (head, tail), the rest."""
    def group(e, k):
        if _ours(k):
            return "resblock kernel (ours)"
        if "dtoh" in k.lower():
            return "D2H copy of the uint8 canvas"
        while e is not None:
            if e.name == "fold::conv":
                return "folded conv (cuDNN)"
            e = e.cpu_parent
        if _profile_group(k).startswith("cuDNN"):
            return "head and tail convs (cuDNN)"
        return "the rest: normalize, pads, quantize, shuffle, crops"

    return kernel_shares(events, group)


def _fold_derivation(card: str, gen) -> dict:
    """The flagship fold on the card (probe and analytic, f32) against
    the same probe in float64 on the CPU.  The folds on the card run with
    TF32 allowed for cuDNN (PyTorch's default) and for matmuls (what
    ``set_float32_matmul_precision("high")`` sets): ``utils.device
    .full_f32`` must scope them back to full f32.  The probe without that
    guard is read beside them, not held: whether cuDNN picks a TF32
    algorithm there is its own choice."""
    import contextlib
    import torch
    from pesr_torch.models import fold
    from pesr_torch.models.fold import (analytic_fold_upsampler,
                                        fold_upsampler, tail_params)
    sd = gen.state_dict()
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    guard = fold.full_f32
    try:
        timed("probe (warm-up)", lambda: fold_upsampler(sd, SCALE))
        k, b, pads = timed("probe", lambda: fold_upsampler(sd, SCALE))
        timed("analytic (warm-up)", lambda: analytic_fold_upsampler(
            *tail_params(sd, SCALE), SCALE))
        ka, ba, pads_a = timed("analytic", lambda: analytic_fold_upsampler(
            *tail_params(sd, SCALE), SCALE))
        fold.full_f32 = lambda device: contextlib.nullcontext()
        unguarded = fold_upsampler(sd, SCALE)
    finally:
        fold.full_f32 = guard
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    sd64 = {n: t.double().cpu() for n, t in sd.items()}
    k64, b64, pads64 = timed("probe f64 on the CPU",
                             lambda: fold_upsampler(sd64, SCALE))
    scale_k = float(k64.abs().max())
    res = {"pads": pads, "kernel_shape": tuple(k.shape), "seconds": times}
    for name, (kk, bb, pp), held in (
            ("probe f32 on the card", (k, b, pads), True),
            ("analytic f32 on the card", (ka, ba, pads_a), True),
            ("probe on the card without full_f32", unguarded, False)):
        # (a fold whose trim kept rounding noise has a wider kernel)
        dk = (float((kk.double().cpu() - k64).abs().max())
              if kk.shape == k64.shape else math.inf)
        db = float((bb.double().cpu() - b64).abs().max())
        res[name] = {"max_abs_kernel": dk, "max_abs_bias": db}
        print(f"  {name} (TF32 allowed) vs probe f64 on the CPU: kernel "
              f"{tuple(kk.shape)} pads {pp}; max|d| kernel {dk:.3e}, bias "
              f"{db:.3e} (max|kernel| {scale_k:.3e}; "
              + (f"pass: <= {FOLD_REL_TOL} x it)" if held
                 else "not held: the trap the guard removes)"), flush=True)
        if held and (pp != pads64
                     or not max(dk, db) <= FOLD_REL_TOL * scale_k):
            fail(f"the {name} fold disagrees with the float64 probe")
    print(f"  time to derive: " + ", ".join(
        f"{n} {t * 1e3:.1f} ms" for n, t in times.items()) + f" [{card}]",
        flush=True)

    up, out = tail_params(sd, SCALE)
    up = [(w.requires_grad_(), b.requires_grad_()) for w, b in up]
    out = tuple(t.requires_grad_() for t in out)

    def analytic_fwd_bwd():
        k, b, _ = analytic_fold_upsampler(up, out, SCALE)
        (k.sum() + b.sum()).backward()

    print("  the analytic fold forward + backward, as a fold-train step runs "
          "it (plus one sum per output):", flush=True)
    analytic_fwd_bwd()
    res["analytic_profile"] = profile_breakdown(analytic_fwd_bwd, card,
                                                top=6, host_top=4)
    return res


def _folded_inference(card: str, gen, lrs, main_mps: float) -> dict:
    """Folded inference through the test CLI and its engine: launches,
    MP/s, the uint8 output against the plain f32 chain on the interior,
    a profile; the x8 self-ensemble the same way."""
    import numpy as np
    import torch
    from pesr_torch import test as cli
    from pesr_torch.models import kernel_apply
    from pesr_torch.models.fold import folded_conv
    from pesr_torch.models.kernel_apply import KernelApply
    from pesr_torch.ops import kernels
    from pesr_torch.ops.tiling import (BatchTiledUpscaler, WholeImageUpscaler,
                                       self_ensemble_upscale)
    from pesr_torch.scales import fold_min_halo

    def check_counts(what, forwards):
        counts = edsr_launch_counts()
        want = {"fused_resblock": BLOCKS * forwards,
                "fused_upsampler_stage": 0}
        print(f"  {what}: {forwards} generator forwards, launches {counts} "
              f"(expected {want})", flush=True)
        if forwards < 1 or counts != want:
            fail(f"{what}: kernel launch counts {counts} != {want}")
        return counts

    with tempfile.TemporaryDirectory() as tmp:
        print("[fold] python -m pesr_torch.test x4 32x256 (the CLI default: "
              "folded) --dataset synthetic", flush=True)
        kernels.reset_launch_counts()
        summary = cli.run(["--dataset", "synthetic", "--scale", str(SCALE),
                           "--num_blocks", str(BLOCKS), "--num_channels",
                           str(CHANNELS), "--seed", "0", "--output_dir", tmp])
        check_counts("pesr_torch.test (folded)", summary["forwards"])
        if not np.isfinite(summary["psnr"]):
            fail(f"folded pesr_torch.test: PSNR {summary['psnr']}")

    apply_fn = KernelApply(gen, fold=True)
    engine = BatchTiledUpscaler(apply_fn, SCALE, "auto", 8)
    print(f"[fold] BatchTiledUpscaler on the folded apply: {N_IMAGES} LR "
          f"images {LR_H}x{LR_W}, min_halo {engine.min_halo}", flush=True)
    kernels.reset_launch_counts()
    engine.warmup_many(lrs, N_IMAGES)
    srs = engine.upscale_many(lrs, N_IMAGES)
    counts = check_counts("folded BatchTiledUpscaler", apply_fn.forwards)
    mp = sum(sr.shape[0] * sr.shape[1] for sr in srs) / 1e6
    # the unfolded engine on the same weights and images, in turns
    engines = {"folded": engine,
               "unfolded": BatchTiledUpscaler(KernelApply(gen), SCALE,
                                              "auto", 8)}
    engines["unfolded"].warmup_many(lrs, N_IMAGES)
    times = {"folded": [], "unfolded": []}
    for rep in range(4):
        for name in (("folded", "unfolded") if rep % 2
                     else ("unfolded", "folded")):
            t0 = time.perf_counter()
            engines[name].upscale_many(lrs, N_IMAGES)
            times[name].append(time.perf_counter() - t0)
    mps = mp / min(times["folded"])
    unfolded_mps = mp / min(times["unfolded"])
    walls = {n: [round(t, 4) for t in ts] for n, ts in times.items()}
    print(f"  {mp:.3f} MP per batch; best of 4 in turns: folded {mps:.2f} "
          f"MP/s ({walls['folded']} s), unfolded {unfolded_mps:.2f} MP/s "
          f"({walls['unfolded']} s; the main phase read {main_mps:.2f}) on "
          f"{card}", flush=True)
    del engines

    real_conv = kernel_apply.folded_conv

    def named_conv(*a):
        with torch.profiler.record_function("fold::conv"):
            return real_conv(*a)

    kernel_apply.folded_conv = named_conv
    try:
        prof = profile_breakdown(lambda: engine.upscale_many(lrs, N_IMAGES),
                                 card, group=_fold_profile_group)
    finally:
        kernel_apply.folded_conv = real_conv

    # uint8 output vs the plain f32 chain on the same context: the engine
    # replicate-pads min_halo around each single-tile image, so the plain
    # Generator runs on the same padded image (as JAX's single-tile fold
    # test holds it); the fold's own border band is inside the crop.
    m = fold_min_halo(SCALE) * SCALE

    def plain(x):
        return gen(x)

    plain.min_halo = fold_min_halo(SCALE)
    whole = WholeImageUpscaler(plain, SCALE)
    d = np.abs(np.stack(srs).astype(np.int16)
               - np.stack([whole.upscale(lr) for lr in lrs]).astype(np.int16))
    inner, band = d[:, m:-m, m:-m], d.copy()
    band[:, m:-m, m:-m] = 0
    res = {"mp_per_s": mps, "unfolded_mp_per_s": unfolded_mps,
           "launches": counts, "profile": prof,
           "lsb_max": float(inner.max()), "lsb_mean": float(inner.mean()),
           "band_max": float(band.max())}
    print(f"  folded path (bf16) vs plain Generator (f32) on the same "
          f"{fold_min_halo(SCALE)}-px replicate-padded images, uint8, beyond "
          f"{m} HR px of the edge: max {res['lsb_max']:.0f} LSB, mean "
          f"{res['lsb_mean']:.4f} LSB (tolerance: max <= {LSB_MAX_TOL}, mean "
          f"<= {LSB_MEAN_TOL}); in the {m}-px border band: max "
          f"{res['band_max']:.0f} LSB", flush=True)
    if res["lsb_max"] > LSB_MAX_TOL or res["lsb_mean"] > LSB_MEAN_TOL:
        fail("folded inference disagrees with the plain Generator")

    # The resblock kernel and the folded conv alone at the tile batch the
    # folded engine gives them: the fold's halo makes it another shape
    # than the chain's, cut differently by the kernel's strips and
    # segments.
    (b, th, tw), grid = main_path_tile_batch(fold_min_halo(SCALE))
    nh, nw, gh, gw = engine.grid(N_IMAGES, LR_H, LR_W)
    if (th, tw) != (gh + 2 * engine._ov_for(nh), gw + 2 * engine._ov_for(nw)):
        fail(f"the folded engine's tile batch is not [{b},{th},{tw}]")
    print(f"[fold] fused_resblock at the folded main path's tile batch "
          f"[{b},{th},{tw}] (grid nh,nw,th,tw = {grid}), C = {CHANNELS}",
          flush=True)
    res["resblock"] = check_resblock(b, th, tw, CHANNELS, 0.1, seed=21,
                                     timing=True)
    check_resblock(b, th, tw, CHANNELS, 1.0, seed=22)
    print_time(f"fused_resblock [{b},{th},{tw},{CHANNELS}]", res["resblock"],
               card)
    y = torch.randn((b, th, tw, CHANNELS), device="cuda").bfloat16()
    kb, bb = apply_fn.fold
    res["conv"] = timed_ms(lambda: folded_conv(y, kb, bb, apply_fn.pads), 10)
    res["conv_plain"] = timed_ms(lambda: folded_conv(
        y.float(), kb.float(), bb.float(), apply_fn.pads), 3, 5, 1)
    o, c, kh, kw = kb.shape
    px = b * th * tw
    res["conv_bound_ms"], res["conv_bound_by"] = bound(
        2 * kh * kw * c * o * px,
        px * c * 2 + px * o * 2 + o * c * kh * kw * 2)
    print(f"  folded conv [{b},{th},{tw},{c}] -> {o} ch, {kh}x{kw}: cuDNN "
          f"bf16 {res['conv']['ms']:.3f} ms [min {res['conv']['min']:.3f}, "
          f"max {res['conv']['max']:.3f}], f32 {res['conv_plain']['ms']:.3f} "
          f"ms, bound {res['conv_bound_ms']:.3f} ms "
          f"({res['conv_bound_by']}) [{card}]", flush=True)
    del y

    print("[fold] x8 self-ensemble, folded, same images", flush=True)
    engine.warmup_many(lrs, N_IMAGES, se=True)
    se_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        se = engine.upscale_many(lrs, N_IMAGES, se=True)
        se_times.append(time.perf_counter() - t0)
    res["se_mp_per_s"] = mp / min(se_times)
    ref_se = self_ensemble_upscale(whole, lrs[0])
    d = np.abs(se[0].astype(np.int16) - ref_se.astype(np.int16))[m:-m, m:-m]
    res["se_lsb_max"], res["se_lsb_mean"] = float(d.max()), float(d.mean())
    print(f"  wall {[round(t, 4) for t in se_times]} s -> "
          f"{res['se_mp_per_s']:.2f} MP/s (best of 2) on {card}; image 0 vs "
          f"the plain f32 self-ensemble beyond {m} HR px of the edge: max "
          f"{res['se_lsb_max']:.0f} LSB, mean {res['se_lsb_mean']:.4f} LSB",
          flush=True)
    if res["se_lsb_max"] > LSB_MAX_TOL or res["se_lsb_mean"] > LSB_MEAN_TOL:
        fail("the folded self-ensemble disagrees with the plain one")
    torch.cuda.empty_cache()
    return res


def _fold_train_step(card: str) -> dict:
    """One flagship fold-train pretrain step against the plain f32
    fold-train step; planted fold faults; launches and host time."""
    import torch
    from pesr_torch.config import Opts
    from pesr_torch.models.generator import Generator
    from pesr_torch.ops import kernels
    from pesr_torch.training.state import TrainState, create_generator_state
    from pesr_torch.training.steps import make_pretrain_step
    bt, p = TRAIN_BATCH, TRAIN_PATCH
    print(f"[fold] one fold-train pretrain step at {BLOCKS}x{CHANNELS} "
          f"x{SCALE}, batch {bt}, patch {p}: kernel path (bf16) vs plain "
          f"trunk + analytic fold (f32)", flush=True)
    opts = Opts(scale=SCALE, num_blocks=BLOCKS, num_channels=CHANNELS,
                batch_size=bt, patch_size=p, fold_train=True, device="cuda")
    step = make_pretrain_step(opts)
    batch = _train_batch(seed=0)
    gen_p = Generator(SCALE, BLOCKS, CHANNELS, seed=0)
    plain = create_generator_state(opts, torch.device("cuda"), gen_p)
    m_p = step(TrainState(gen_p, plain.optimizer, plain.lr_at,
                          _plain_fold_apply(gen_p)), *batch)
    ref = (float(m_p["l1"]), {n: q.grad for n, q in gen_p.named_parameters()})
    del plain, gen_p
    dl1, cos, name, state = step_agreement(opts, step, batch, ref)
    print(f"  L1 {ref[0]:.6f} (plain): kernel path |d L1| {dl1:.2e} (limit "
          f"{STEP_L1_TOL}); least gradient cosine {cos:.6f} ({name}; floor "
          f"{GRAD_COS_FLOOR})", flush=True)
    if not (dl1 <= STEP_L1_TOL and cos >= GRAD_COS_FLOOR):
        fail("the fold-train step disagrees with the plain fold-train step")
    res = {"dl1": dl1, "cos": cos, "faults": {}}
    for fault in FOLD_FAULTS:
        with _FoldFault(fault):
            f_dl1, f_cos, f_name, _ = step_agreement(opts, step, batch, ref)
        res["faults"][fault] = (f_dl1, f_cos)
        print(f"  planted fault '{fault}': |d L1| {f_dl1:.2e}, least cosine "
              f"{f_cos:.6f} ({f_name})", flush=True)
        if f_dl1 <= STEP_L1_TOL and f_cos >= GRAD_COS_FLOOR:
            fail(f"the step limits pass the planted fault '{fault}'")
    del ref
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    for _ in range(5):
        step(state, *batch)
    counts = edsr_launch_counts()
    if counts != {"fused_resblock": 5 * BLOCKS, "fused_upsampler_stage": 0}:
        fail(f"launches in 5 fold-train steps: {counts}")
    print(f"  launches in 5 fold-train steps: {counts}", flush=True)
    # The unfolded step from the same weights beside it, in turns (the
    # host's speed drifts across a call).
    opts_u = dataclasses.replace(opts, fold_train=False)
    state_u = create_generator_state(
        opts_u, torch.device("cuda"), Generator(SCALE, BLOCKS, CHANNELS,
                                                seed=0))
    times = {"folded": ([], []), "unfolded": ([], [])}
    for rep in range(10):
        for name in (("folded", "unfolded") if rep % 2
                     else ("unfolded", "folded")):
            st = state if name == "folded" else state_u
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st, *batch)
            times[name][0].append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            times[name][1].append(1e3 * (time.perf_counter() - t0))
    for name, (host, wall) in times.items():
        res[name] = {"host_ms": sorted(host)[5], "step_ms": sorted(wall)[5]}
        print(f"  {name} step from an idle device (10 in turns): the host "
              f"queues it in {res[name]['host_ms']:.2f} ms, it ends "
              f"{res[name]['step_ms']:.2f} ms after it starts (medians; "
              f"host {[round(t, 1) for t in host]}) [{card}]", flush=True)
    group = lambda ev: kernel_shares(  # noqa: E731
        ev, lambda e, k: _profile_group(k))
    for name, st in (("folded", state), ("unfolded", state_u)):
        print(f"  {name} step:", flush=True)
        res[name]["profile"] = profile_breakdown(
            lambda: step(st, *batch), card, top=6, host_top=6, group=group)
    del state, state_u
    torch.cuda.empty_cache()
    return res


def _fold_run_training(card: str, workdir: str, train_sps: float) -> dict:
    """``run_training --phase pretrain`` as the train CLI resolves its
    flags (fold_train on by default): the kernel at the folded eval's
    tile batches, launches, the falling loss, steps/s beside the train
    phase's unfolded run (``train_sps``)."""
    from pesr_torch.config import opts_from_args
    from pesr_torch.ops import kernels
    from pesr_torch.training.loop import run_training
    ck = os.path.join(workdir, "fold_pretrain")
    opts = opts_from_args(
        ["--num_blocks", str(BLOCKS), "--num_channels", str(CHANNELS),
         "--scale", str(SCALE), "--batch_size", str(TRAIN_BATCH),
         "--patch_size", str(TRAIN_PATCH), "--train_dataset", "synthetic",
         "--valid_dataset", "synthetic", "--num_valids", "2",
         "--steps_per_epoch", str(FOLD_SPE), "--num_epochs",
         str(FOLD_EPOCHS), "--log_every", str(FOLD_LOG_EVERY),
         "--snapshot_every", "1", "--keep_snapshots", "1",
         "--check_point", ck], mode="train")
    if not opts.fold_train:
        fail("the train CLI did not resolve --fold_train as JAX's does")
    print(f"[fold] the folded eval forwards' tile batches, C = {CHANNELS}",
          flush=True)
    for b, th, tw in eval_tile_batches(opts):
        check_resblock(b, th, tw, CHANNELS, 0.1, seed=17)
    print(f"[fold] run_training --phase pretrain, the train CLI's default "
          f"(folded): {FOLD_EPOCHS} epochs x {FOLD_SPE} steps, eval on 2 "
          f"synthetic images each epoch", flush=True)
    kernels.reset_launch_counts()
    summary = run_training(opts)
    counts = edsr_launch_counts()
    fwd = summary["train_forwards"] + summary["eval_forwards"]
    want = {"fused_resblock": BLOCKS * fwd, "fused_upsampler_stage": 0}
    print(f"  run_training: {summary['train_forwards']} training + "
          f"{summary['eval_forwards']} eval forwards, launches {counts} "
          f"(expected {want})", flush=True)
    if summary["train_forwards"] != FOLD_SPE * FOLD_EPOCHS or counts != want:
        fail(f"folded run_training: launch counts {counts} != {want}")
    with open(os.path.join(ck, "pretrain.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "l1" in r]
    l1s = [r["l1"] for r in recs]
    print(f"  L1 per {FOLD_LOG_EVERY}-step window: "
          f"{[round(v, 5) for v in l1s]}", flush=True)
    if not all(map(math.isfinite, l1s)) or not l1s[-1] < l1s[0]:
        fail(f"folded run_training: the L1 loss did not fall ({l1s})")
    sps = steady_rate(recs, FOLD_SPE, card)
    print(f"  folded {sps:.3f} steps/s; the train phase's unfolded run read "
          f"{train_sps:.3f} (host-bound steps: one run each, no difference "
          f"resolved) [{card}]", flush=True)
    return {"steps_per_s": sps, "launches": counts}


def _fold_gan_step(card: str) -> dict:
    """One fold-train GAN step against the plain f32 fold-train GAN step
    at the training LR, each side with its own D update (the step as it
    trains), and with the plain step's updated D on both sides (the
    witness the gan phase also reads), both held to GAN_LIMITS;
    launches."""
    import torch
    from pesr_torch.models.discriminator import Discriminator
    from pesr_torch.models.generator import Generator
    from pesr_torch.ops import kernels
    from pesr_torch.training.state import init_vgg
    from pesr_torch.training.steps import make_gan_step
    print(f"[fold] one fold-train GAN step at {BLOCKS}x{CHANNELS} x{SCALE} "
          f"(JAX defaults, random VGG54): kernel path (bf16) vs plain step "
          f"(f32), limits {GAN_LIMITS}", flush=True)
    dev = torch.device("cuda")
    g0 = Generator(SCALE, BLOCKS, CHANNELS, device=dev, seed=0).state_dict()
    d0 = Discriminator(TRAIN_PATCH * SCALE, device=dev,
                       seed=1).state_dict()
    batch = _train_batch(seed=1)
    opts = _gan_opts(fold_train=True)
    ref = _gan_ref(_gan_opts(fold_train=True, compute_dtype="float32"),
                   g0, d0, batch)
    step = make_gan_step(opts)
    vgg = init_vgg(opts, dev)
    readings = {}
    for name, share in (("D shared", True), ("own D", False)):
        state = _gan_state(opts, g0, d0, vgg)
        readings[name] = _gan_reading(name, step, batch, ref, state, share)
        if not _gan_within(readings[name]):
            fail(f"the fold-train GAN step ({name}) disagrees with the "
                 f"plain step")
    kernels.reset_launch_counts()
    for _ in range(2):
        step(state, *batch)
    counts = edsr_launch_counts()
    if counts != {"fused_resblock": 2 * BLOCKS, "fused_upsampler_stage": 0}:
        fail(f"launches in 2 fold-train GAN steps: {counts}")
    print(f"  launches in 2 fold-train GAN steps: {counts}", flush=True)
    del state, ref
    torch.cuda.empty_cache()
    return readings


def phase_fold(card: str, main_mps: float, train_sps: float,
               workdir: str) -> dict:
    """The folded upsampler at full width: the fold itself, folded
    inference and self-ensemble, the fold-train pretrain step,
    ``run_training`` with the train CLI's default, a fold-train GAN step.
    ``main_mps`` / ``train_sps``: the unfolded main and train phases'
    rates, printed beside the folded ones (0.0 when not run)."""
    import torch
    from pesr_torch.data.datasets import (SyntheticImages,
                                          host_bicubic_downsample)
    from pesr_torch.models.generator import Generator
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[fold] the folded upsampler of the x{SCALE} {BLOCKS}x{CHANNELS} "
          f"generator (seed 0) on {card}", flush=True)
    gen = Generator(SCALE, BLOCKS, CHANNELS, seed=0)
    res = {"derivation": _fold_derivation(card, gen)}
    src = SyntheticImages(N_IMAGES, LR_H * SCALE, LR_W * SCALE, seed=7)
    lrs = [host_bicubic_downsample(src.get(i), SCALE) for i in range(N_IMAGES)]
    res["inference"] = _folded_inference(card, gen, lrs, main_mps)
    del gen
    torch.cuda.empty_cache()
    res["train_step"] = _fold_train_step(card)
    res["run_training"] = _fold_run_training(card, workdir, train_sps)
    res["gan_step"] = _fold_gan_step(card)
    return res


# QAT phase.  One flagship QAT step in bf16 vs the same step in f32 (TF32
# off), same weights and batch.  bf16 rounds each fake-quant conv's
# output, and the next layer's quantizer turns that rounding into
# one-step flips of ~1/4 of its integers (a step is 1/127 of a channel's
# amax, bf16's rounding ~2^-9 of a value): noise of the size of bf16's
# own, through 65 quantized convs.  Emulated on the CPU (12 blocks x 128,
# batch 8 of 24^2): |d L1| 2.6e-5, least cosine 0.997.  The weights get
# one outlier output channel (x16) in every body conv, as trained convs
# have, so that per-tensor weight scales (every other channel quantized
# on 1/16 of the grid) show: the emulation read cosine 0.59 for them, 0
# with the STE's gradient to the activations cut.  First flagship
# reading on the H100: |d L1| 6.9e-4 (1.4e-3 of L1: the bf16 rounding
# of each conv's integer sums is not averaged out by 65 requantizations
# as the plain path's noise is), least cosine 0.9955; per-tensor scales
# 1.6e-2 / 0.50, the STE cut 6.9e-4 / 0.  The limits are ~4x the sound
# reading (in 1 - cosine for the cosine).
QAT_L1_TOL, QAT_COS_FLOOR = 3e-3, 0.98
QAT_FAULTS = ("the STE detached from the activations (no gradient to x)",
              "per-tensor weight scales in place of per-output-channel")
QAT_SPE, QAT_EPOCHS, QAT_LOG_EVERY = 20, 2, 10


def _per_tensor_fake_quant_conv(x, weight, bias, dtype, mesh=None):
    """``qat.fake_quant_conv`` with one weight scale for the whole
    kernel: the planted fault of QAT_FAULTS[1] (one process: ``mesh``
    is None)."""
    import torch
    import torch.nn.functional as F
    from pesr_torch.models import qat
    xf = x.float()
    s_in = xf.detach().abs().amax(dim=(0, 1, 2)).clamp_min(1e-6) / 127.0
    xq = qat._clip127(qat._ste_round(xf / s_in))
    w_fold = weight.float() * s_in[None, :, None, None]
    s_w = (w_fold.detach().abs().amax().clamp_min(1e-12) / 127.0).expand(
        weight.shape[0])
    wq = qat._clip127(qat._ste_round(w_fold / s_w[:, None, None, None]))
    y = F.conv2d(xq.to(dtype).permute(0, 3, 1, 2), wq.to(dtype), padding=1)
    return (y.permute(0, 2, 3, 1).float() * s_w + bias.float()).to(dtype)


class _QatFault:
    """Plants one of QAT_FAULTS in ``pesr_torch.models.qat`` while
    active."""

    def __init__(self, fault: str) -> None:
        self.fault = fault

    def __enter__(self):
        from pesr_torch.models import qat
        self.orig = orig = qat.fake_quant_conv
        if self.fault == QAT_FAULTS[0]:
            qat.fake_quant_conv = (lambda x, w, b, dtype, mesh=None: orig(
                x.detach(), w, b, dtype, mesh))
        else:
            qat.fake_quant_conv = _per_tensor_fake_quant_conv
        return self

    def __exit__(self, *exc) -> None:
        from pesr_torch.models import qat
        qat.fake_quant_conv = self.orig


def _qat_weights():
    """The seed-0 flagship generator's state_dict with output channel 0
    of every body conv scaled by 16."""
    import torch
    from pesr_torch.models.generator import Generator
    gen = Generator(SCALE, BLOCKS, CHANNELS, seed=0)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.startswith("body.") and p.dim() == 4:
                p[0].mul_(16.0)
    return gen.state_dict()


def _qat_step(opts, sd, batch):
    """One QAT step of a fresh generator on ``sd``: (L1, {name:
    gradient}, its train state); a gradient that never formed is 0."""
    import torch
    from pesr_torch.models.generator import Generator
    from pesr_torch.training.state import create_generator_state
    from pesr_torch.training.steps import make_pretrain_step
    gen = Generator(SCALE, BLOCKS, CHANNELS, seed=None)
    gen.load_state_dict(sd)
    state = create_generator_state(opts, torch.device("cuda"), gen)
    m = make_pretrain_step(opts)(state, *batch)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in gen.named_parameters()}
    return float(m["l1"]), grads, state


def _qat_agreement(ours, ref):
    import torch
    cos, name = min((float(torch.nn.functional.cosine_similarity(
        g.float().flatten(), ref[1][n].flatten(), dim=0)), n)
        for n, g in ours[1].items())
    return abs(ours[0] - ref[0]), cos, name


def phase_qat(card: str, workdir: str) -> dict:
    """The QAT phase: one flagship QAT step (bf16) against the same step
    in f32, planted faults, the step's launches and time; then
    ``run_training --phase qat`` as the train CLI resolves it."""
    import torch
    from pesr_torch.config import Opts, opts_from_args
    from pesr_torch.ops import kernels
    from pesr_torch.training.loop import run_training
    from pesr_torch.training.steps import make_pretrain_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bt, p = TRAIN_BATCH, TRAIN_PATCH
    print(f"[qat] one QAT step at {BLOCKS}x{CHANNELS} x{SCALE}, batch {bt}, "
          f"patch {p} (seed-0 weights, output channel 0 of every body conv "
          f"x16): bf16 vs f32 (TF32 off); limits |d L1| <= {QAT_L1_TOL}, "
          f"least gradient cosine >= {QAT_COS_FLOOR}", flush=True)
    opts = Opts(scale=SCALE, num_blocks=BLOCKS, num_channels=CHANNELS,
                batch_size=bt, patch_size=p, phase="qat", device="cuda")
    opts32 = dataclasses.replace(opts, compute_dtype="float32")
    sd = _qat_weights()
    batch = _train_batch(seed=2)
    ref = _qat_step(opts32, sd, batch)[:2]
    kernels.reset_launch_counts()
    ours = _qat_step(opts, sd, batch)
    step_counts = edsr_launch_counts()
    dl1, cos, name = _qat_agreement(ours, ref)
    print(f"  L1 {ref[0]:.6f} (f32): bf16 |d L1| {dl1:.3e}; least gradient "
          f"cosine {cos:.6f} ({name}); kernel launches {step_counts}",
          flush=True)
    if not (dl1 <= QAT_L1_TOL and cos >= QAT_COS_FLOOR):
        fail("the bf16 QAT step disagrees with the f32 QAT step")
    if any(step_counts.values()):
        fail(f"the QAT step launched kernels: {step_counts}")
    res = {"dl1": dl1, "cos": cos, "faults": {}}
    for fault in QAT_FAULTS:
        with _QatFault(fault):
            f_dl1, f_cos, f_name = _qat_agreement(_qat_step(opts, sd, batch),
                                                  ref)
        res["faults"][fault] = (f_dl1, f_cos)
        print(f"  planted fault '{fault}': |d L1| {f_dl1:.3e}, least cosine "
              f"{f_cos:.6f} ({f_name})", flush=True)
        if f_dl1 <= QAT_L1_TOL and f_cos >= QAT_COS_FLOOR:
            fail(f"the QAT step limits pass the planted fault '{fault}'")
    state = ours[2]
    del ref, ours
    torch.cuda.empty_cache()
    step = make_pretrain_step(opts)
    host_ms, wall_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *batch)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
    res["host_ms"], res["step_ms"] = sorted(host_ms)[2], sorted(wall_ms)[2]
    print(f"  one QAT step from an idle device: the host queues it in "
          f"{res['host_ms']:.2f} ms, it ends {res['step_ms']:.2f} ms after "
          f"it starts (medians of 5) [{card}]", flush=True)
    res["profile"] = profile_breakdown(lambda: step(state, *batch), card,
                                       top=8, host_top=6)
    del state
    torch.cuda.empty_cache()

    ck = os.path.join(workdir, "qat")
    topts = opts_from_args(
        ["--phase", "qat", "--num_blocks", str(BLOCKS), "--num_channels",
         str(CHANNELS), "--scale", str(SCALE), "--batch_size", str(bt),
         "--patch_size", str(p), "--train_dataset", "synthetic",
         "--valid_dataset", "synthetic", "--num_valids", "2",
         "--steps_per_epoch", str(QAT_SPE), "--num_epochs", str(QAT_EPOCHS),
         "--log_every", str(QAT_LOG_EVERY), "--snapshot_every", "1",
         "--keep_snapshots", "1", "--check_point", ck], mode="train")
    print(f"[qat] run_training --phase qat: {QAT_EPOCHS} epochs x {QAT_SPE} "
          f"steps, eval (fake-quant forward) on 2 synthetic images each "
          f"epoch", flush=True)
    kernels.reset_launch_counts()
    summary = run_training(topts)
    counts = edsr_launch_counts()
    print(f"  run_training: {summary['train_forwards']} training + "
          f"{summary['eval_forwards']} eval forwards, kernel launches "
          f"{counts} (the QAT path runs none)", flush=True)
    if summary["train_forwards"] != QAT_SPE * QAT_EPOCHS or any(
            counts.values()) or not summary["eval_forwards"]:
        fail(f"QAT run_training: forwards {summary} / launches {counts}")
    with open(os.path.join(ck, "qat.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "l1" in r]
    l1s = [r["l1"] for r in recs]
    print(f"  L1 per {QAT_LOG_EVERY}-step window: "
          f"{[round(v, 5) for v in l1s]}; val_psnr {summary.get('val_psnr')}"
          f" dB, val_pi {summary.get('val_pi')}", flush=True)
    if not (all(map(math.isfinite, l1s)) and l1s[-1] < l1s[0]
            and math.isfinite(summary.get("val_psnr", math.nan))
            and math.isfinite(summary.get("val_pi", math.nan))):
        fail(f"QAT run_training: L1 {l1s}, val {summary}")
    sps = steady_rate(recs, QAT_SPE, card)
    print(f"  QAT training throughput after the first epoch: {sps:.3f} "
          f"steps/s, {sps * bt * (p * SCALE) ** 2 / 1e6:.3f} HR MP/s at "
          f"batch {bt} x {p * SCALE}^2 on {card}", flush=True)
    res.update(steps_per_s=sps, val_psnr=summary["val_psnr"],
               val_pi=summary["val_pi"])
    return res


# int8 phase.  The int8 conv's route (torch._int_mm over an int8 im2col)
# must equal its plain float64 version bitwise; its bound counts int8
# operations at the data sheet's dense int8 rate.
PEAK_INT8_OPS = 1979e12
# The int8 convs checked on the card, (b, h, w, c, n, k, pads): rows
# <= 16 (zero-padded for _int_mm), K and N off a multiple of 8, odd
# sizes, asymmetric pads; each also through im2col chunks of a few rows.
INT8_RAGGED = ((1, 2, 3, 64, 64, 3, None), (1, 4, 4, 128, 128, 3, None),
               (2, 19, 23, 256, 256, 3, None), (3, 5, 70, 64, 48, 5, (2, 2)),
               (1, 9, 11, 256, 192, 9, (4, 4)), (2, 7, 13, 128, 27, 5, (1, 3)))
# x8 flagship: two 255 x 170 LR images (DIV2K validation, x8) with the
# fold's 4-px halo, through the int8 upfold (9 x 9 x 256 -> 192, pads 4):
# its im2col (3.9 GB) runs in chunks, so a chunk boundary is on the card.
X8_TILE_BATCH = (2, 178, 263)
# A planted fault the agreement probe must see: block 0's and block 1's
# conv2 dequant scales swapped.  On the H100 the train phase's best/
# read 57.93 dB healthy and 54.23 with the swap.  Caught when the faulty
# reading is at least QUANT_FAULT_MARGIN_DB below the healthy one.
QUANT_FAULT_MARGIN_DB = 1.0


def int8_conv_bound(m: int, kk: int, n: int, nbytes: float):
    """The int8 conv's least time: ``2 m kk n`` int8 operations at
    PEAK_INT8_OPS, or its bytes at PEAK_BYTES."""
    t_ops, t_bytes = 2 * m * kk * n / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_int8_conv(card, b, h, w, c, n, k, pads, seed, timing=False,
                    max_bytes=None) -> dict:
    """``int8_conv`` (the ``_int_mm`` route on the card) against
    ``int8_conv_reference`` on the same random integers: equal int32
    values or the phase fails; with ``max_bytes``, the im2col route in
    chunks of at most that many bytes too.  ``timing``: times of the
    route, the plain version and cuDNN bf16 on the same integers (a
    yardstick: above 2^24 its f32 sums are not exact), and the bound."""
    import torch
    import torch.nn.functional as F
    from pesr_torch.ops.int8_conv import (int8_conv, int8_conv_im2col,
                                          int8_conv_reference)
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, (b, h, w, c), generator=g,
                      dtype=torch.int8).cuda()
    wq = torch.randint(-127, 128, (n, k, k, c), generator=g,
                       dtype=torch.int8).cuda()
    ref = int8_conv_reference(x, wq, pads)
    gemms = int8_conv_im2col.gemms
    got = int8_conv(x, wq, pads)
    gemms = int8_conv_im2col.gemms - gemms
    name = f"int8_conv [{b},{h},{w},{c}] -> {n}, {k}x{k}, pads {pads}"
    res = {"max_abs_err": float((got.long() - ref.long()).abs().max()),
           "gemms": gemms}
    if not torch.equal(got, ref):
        fail(f"{name}: the _int_mm route differs from the plain version "
             f"(max |d| {res['max_abs_err']})")
    if max_bytes is not None:
        before = int8_conv_im2col.gemms
        if not torch.equal(int8_conv_im2col(x, wq, pads, max_bytes), ref):
            fail(f"{name}: the im2col route in chunks of {max_bytes} bytes "
                 f"differs from the plain version")
        res["chunks"] = int8_conv_im2col.gemms - before
    print(f"  {name}: _int_mm route ({gemms} GEMMs) == plain (int32, "
          f"bitwise)"
          + (f"; also in {res['chunks']} chunks of <= {max_bytes} B"
             if max_bytes is not None else ""), flush=True)
    if not timing:
        return res
    lo, hi = ((k - 1) // 2, k // 2) if pads is None else pads
    ho, wo = h + lo + hi - k + 1, w + lo + hi - k + 1
    m = b * ho * wo
    res["time"] = timed_ms(lambda: int8_conv(x, wq, pads), 5)
    res["plain"] = timed_ms(lambda: int8_conv_reference(x, wq, pads), 1, 3, 1)
    xb = F.pad(x.permute(0, 3, 1, 2).bfloat16(), (lo, hi, lo, hi))
    wb = wq.permute(0, 3, 1, 2).bfloat16()
    res["library"] = timed_ms(lambda: F.conv2d(xb, wb), 5)
    res["ms"], res["plain_ms"], res["library_ms"] = (
        res[key]["ms"] for key in ("time", "plain", "library"))
    res["bound_ms"], res["bound_by"] = int8_conv_bound(
        m, k * k * c, n, x.numel() + wq.numel() + 4 * m * n)
    print_time(name, res, card, "here the _int_mm route; 'plain' the "
               "float64 plain version, 'library' cuDNN bf16 on the same "
               "integers")
    return res


def _int8_conv_parts(card: str, b: int, h: int, w: int) -> dict:
    """Where the x4 body conv's time goes: its im2col alone (the stack of
    nine shifted slices, as the route copies them: 8 channels per int64
    word; and byte by byte, the int8 stack it replaced), and
    ``torch._int_mm`` alone with the weights column-major (the route's
    layout) and row-major [K, N]."""
    import torch
    import torch.nn.functional as F
    c = CHANNELS
    x = torch.randint(-127, 128, (b, h, w, c), dtype=torch.int8,
                      device="cuda")
    wmat = torch.randint(-127, 128, (c, 9 * c), dtype=torch.int8,
                         device="cuda")
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))

    def im2col(t):
        return torch.stack([t[:, dy:dy + h, dx:dx + w] for dy in range(3)
                            for dx in range(3)], dim=3).view(
                                torch.int8).reshape(-1, 9 * c)

    col = im2col(xp.view(torch.int64))
    if not torch.equal(col, im2col(xp)):
        fail("the int64 im2col differs from the int8 one")
    wt = wmat.t().contiguous()
    res = {"im2col_int64": timed_ms(lambda: im2col(xp.view(torch.int64)), 5),
           "im2col_int8": timed_ms(lambda: im2col(xp), 5),
           "gemm_colmajor": timed_ms(lambda: torch._int_mm(col, wmat.t()), 5),
           "gemm_rowmajor": timed_ms(lambda: torch._int_mm(col, wt), 5)}
    print("  its parts: " + "  ".join(
        f"{k} {v['ms']:.3f} ms [min {v['min']:.3f}, max {v['max']:.3f}]"
        for k, v in res.items()) + f"  [{card}]", flush=True)
    return res


def int8_block_args(bsz, h, w, c, seed):
    """A bf16 carry ~ N(0, 1) and one int8 block's arguments on the card,
    drawn on the CPU from ``seed``: int8 weights uniform in [-127, 127]
    (OHWI), scales that put the quantized input at ~N(0, 40) (every
    other channel's ``qin1`` = 64, so that products of bf16 values fall
    on rint's ties), the requant's pre-round value at ~N(0, 60) (clipped
    at 0 and 127; a quarter of its channels at ``mq`` = 2^-10, ``bq`` =
    0.5, ties again) and y2 at ~N(0, 1).  Returns ``(y, ohwi, packed)``:
    ``ohwi`` the plain version's arguments after ``y``, ``packed`` the
    kernel's."""
    import torch
    from pesr_torch.ops.kernels.resblock_int8 import pack_int8_block_weights
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(c, generator=g)

    y = torch.randn((bsz, h, w, c), generator=g).to(torch.bfloat16)
    w1, w2 = (torch.randint(-127, 128, (c, 3, 3, c), generator=g,
                            dtype=torch.int8) for _ in range(2))
    ch = torch.arange(c)
    spread = (9 * c) ** 0.5 * 127 / 3 ** 0.5 * 40
    qin1 = torch.where(ch % 2 == 0, torch.tensor(64.0), u(20.0, 60.0))
    tie = ch % 4 == 1
    mq = torch.where(tie, torch.tensor(2.0 ** -10), u(0.5, 1.5) * 60 / spread)
    bq = torch.where(tie, torch.tensor(0.5), u(-20.0, 20.0))
    m2 = u(0.5, 1.5) / spread
    b2 = torch.randn(c, generator=g) * 0.1
    vec = [t.float().cuda() for t in (qin1, mq, bq, m2, b2)]
    w1, w2 = w1.cuda(), w2.cuda()
    p1, p2 = pack_int8_block_weights(w1, w2)
    return (y.cuda(), (w1, *vec[:3], w2, *vec[3:]),
            (p1, *vec[:3], p2, *vec[3:]))


def int8_block_bound(bsz, h, w, c):
    """The int8 block's least time: two convs' int8 operations at
    PEAK_INT8_OPS, or its bytes (the carry read and the output written
    once, both weights, five f32 vectors) at PEAK_BYTES."""
    m = bsz * h * w
    return int8_conv_bound(2 * m, 9 * c, c, 4 * m * c + 2 * 9 * c * c
                           + 5 * 4 * c)


def check_int8_block(card, bsz, h, w, c, seed, res_scale=0.1,
                     timing=False) -> dict:
    """``fused_resblock_int8`` (the kernel) against
    ``int8_resblock_reference`` (the plain version, float64 convs) on the
    same inputs: equal bf16 outputs or the phase fails.  ``timing``: the
    kernel, the plain version and, as the library yardstick, the same
    block on the ``_int_mm`` route (``int8_conv_im2col``), with the
    bound and the schedule."""
    import torch
    from pesr_torch.ops.int8_conv import int8_conv_im2col
    from pesr_torch.ops.kernels.resblock_int8 import (
        _max_clusters, fused_resblock_int8, int8_resblock_reference,
        resblock_int8_schedule, resblock_int8_work)
    y, plain, packed = int8_block_args(bsz, h, w, c, seed)
    out = fused_resblock_int8(y, *packed, res_scale)
    torch.cuda.synchronize()
    ref = int8_resblock_reference(y, *plain, res_scale)
    d = (out.float() - ref.float()).abs()
    res = {"max_abs_err": float(d.max()), "differ": int((d > 0).sum()),
           "shape": [bsz, h, w, c]}
    name = f"fused_resblock_int8 [{bsz},{h},{w},{c}] res_scale {res_scale}"
    print(f"  {name}: {res['differ']} of {d.numel()} values differ from "
          f"the plain version, max |d| {res['max_abs_err']:.4g} (pass: 0, "
          f"bitwise)", flush=True)
    if not torch.equal(out, ref):
        fail(f"{name} differs from its plain version")
    if not timing:
        return res
    res["time"] = timed_ms(lambda: fused_resblock_int8(y, *packed,
                                                       res_scale), 10)
    res["plain"] = timed_ms(lambda: int8_resblock_reference(
        y, *plain, res_scale), 1, 3, 1)
    gemms = int8_conv_im2col.gemms
    lib = int8_resblock_reference(y, *plain, res_scale,
                                  conv=int8_conv_im2col)
    res["library_gemms"] = int8_conv_im2col.gemms - gemms
    if not torch.equal(lib, ref):
        fail(f"{name}: the _int_mm route differs from the plain version")
    res["library"] = timed_ms(lambda: int8_resblock_reference(
        y, *plain, res_scale, conv=int8_conv_im2col), 5)
    res["ms"], res["plain_ms"], res["library_ms"] = (
        res[k]["ms"] for k in ("time", "plain", "library"))
    res["bound_ms"], res["bound_by"] = int8_block_bound(bsz, h, w, c)
    clusters = _max_clusters(c, y.device)
    res["schedule"] = resblock_int8_schedule(bsz, h, w, clusters)
    res["work"] = resblock_int8_work(bsz, h, w, c, clusters)
    print_time(name, res, card, "'plain' the plain version (float64 "
               "convs), 'library' the same block on the _int_mm route")
    print(f"    library route: {res['library_gemms']} GEMMs, two im2cols and "
          f"the f32 passes; schedule {res['schedule']}, {res['work']}; "
          f"{100 * res['bound_ms'] / res['ms']:.1f}% of the bound",
          flush=True)
    return res


def _int8_block_fault(int8, shape) -> dict:
    """A calibrated flagship block on a carry ~ N(0, 1) at ``shape``:
    block 0 through the kernel bitwise its plain version, then the planted
    fault -- block 1's ``mq`` and ``bq`` in the kernel's arguments, block
    0's in the plain version's -- which the bitwise check must fail."""
    import torch
    from pesr_torch.ops.kernels.resblock_int8 import (
        fused_resblock_int8, int8_resblock_reference,
        unpack_int8_block_weights)
    y = torch.randn(shape, generator=torch.Generator().manual_seed(55)).to(
        torch.bfloat16).cuda()
    blk, other = int8.blocks[0], int8.blocks[1]
    w1, w2 = unpack_int8_block_weights(blk.w1, blk.w2)
    ref = int8_resblock_reference(y, w1, blk.qin1, blk.mq, blk.bq, w2,
                                  blk.m2, blk.b2, int8.res_scale)
    ok = torch.equal(fused_resblock_int8(y, *blk, int8.res_scale), ref)
    bad = fused_resblock_int8(y, *blk._replace(mq=other.mq, bq=other.bq),
                              int8.res_scale)
    differ = int((bad != ref).sum())
    print(f"  calibrated flagship block 0 at {list(shape)}: kernel bitwise "
          f"the plain version: {ok}; planted fault (block 1's mq and bq in "
          f"the kernel's arguments only): {differ} of {ref.numel()} values "
          f"differ (caught when > 0)", flush=True)
    if not ok:
        fail("the calibrated int8 block differs from its plain version")
    if differ == 0:
        fail("the bitwise check does not see block 1's requant vectors in "
             "block 0's kernel call")
    return {"bitwise": ok, "fault_differ": differ}


# The int8 block's ragged shapes (batch, H, W): widths at the edges of
# its 62-column strips and 64-pixel rows, odd heights, batches 1-3.
INT8_BLOCK_W = (1, 2, 5, 40, 61, 62, 63, 64, 65, 130)
INT8_BLOCK_RAGGED = tuple((1 + i % 3, (5, 7, 9, 13, 3)[i % 5], w)
                          for i, w in enumerate(INT8_BLOCK_W))


def int8_block_checks(card) -> dict:
    """The int8 block kernel against its plain version, bitwise, at the
    ragged shapes for C = 64, 128, 256 (res_scale 0.1 and 1.0), then at
    the x4 folded tile batch (timed) and the x8 tile batch."""
    from pesr_torch.scales import fold_min_halo
    print(f"[quant] fused_resblock_int8 (csrc/resblock_int8.cu) vs its "
          f"plain version, bitwise, ragged shapes {INT8_BLOCK_RAGGED}",
          flush=True)
    for c in (64, 128, 256):
        for i, (bsz, h, w) in enumerate(INT8_BLOCK_RAGGED):
            check_int8_block(card, bsz, h, w, c, seed=7000 + 100 * c + i,
                             res_scale=(0.1, 1.0)[i % 2])
    (b, th, tw), _ = main_path_tile_batch(fold_min_halo(SCALE))
    x8 = check_int8_block(card, *X8_TILE_BATCH, CHANNELS, seed=7001)
    x4 = check_int8_block(card, b, th, tw, CHANNELS, seed=7002, timing=True)
    if _int8_first_form:
        x4["turns"] = int8_block_turns(card, b, th, tw, CHANNELS, seed=7002)
    else:
        x4["turns"] = None
        print("  fused_resblock_int8 in turns with its first form: not run "
              "(give --int8-first-form DIR, a checkout holding it)",
              flush=True)
    return {"x4": x4, "x8": x8}


def int8_block_turns(card, bsz, h, w, c, seed, rounds=12,
                     iters=10) -> dict:
    """The first form of the kernel (``--int8-first-form``, built by
    phase_build) and the port's, in turns on the same inputs, each first
    held bitwise to the plain version: ms per launch, median [min, max]
    of ``rounds`` timed runs of ``iters`` launches each (CUDA events)."""
    import ctypes
    import torch
    from pesr_torch.ops.kernels.resblock_int8 import (
        _ARGTYPES, _bf16_value, fused_resblock_int8, int8_resblock_reference,
        resblock_int8_schedule)
    y, plain, packed = int8_block_args(bsz, h, w, c, seed)
    ref = int8_resblock_reference(y, *plain, 0.1)
    dll = ctypes.CDLL(_int8_first_form["path"])
    fn = dll.pesr_fused_resblock_int8
    fn.argtypes, fn.restype = list(_ARGTYPES), ctypes.c_int
    sched = resblock_int8_schedule(bsz, h, w,
                                   dll.pesr_resblock_int8_max_clusters(c))
    # the first form takes both weights in natural output order
    v1_args = (plain[0].permute(1, 2, 0, 3).contiguous(), *plain[1:4],
               plain[4].permute(1, 2, 0, 3).contiguous(), *plain[5:])
    out = torch.empty_like(y)
    stream = torch.cuda.current_stream().cuda_stream

    def first_form():
        rc = fn(y.data_ptr(), *(t.data_ptr() for t in v1_args[:4]),
                *(t.data_ptr() for t in v1_args[4:]), out.data_ptr(), bsz, h,
                w, c, _bf16_value(0.1), sched.rows, sched.strips, sched.segs,
                sched.ctas, stream)
        if rc:
            fail(f"the int8 block's first form failed to launch: CUDA "
                 f"error {rc}")
        return out

    runs = {"first_form": first_form,
            "port": lambda: fused_resblock_int8(y, *packed, 0.1)}
    for name, run in runs.items():
        if not torch.equal(run(), ref):
            fail(f"the int8 block kernel ({name}) differs from its plain "
                 f"version before the timing in turns")
    times = {name: [] for name in runs}
    for r in range(rounds):
        for name in (tuple(runs) if r % 2 == 0 else tuple(runs)[::-1]):
            times[name].append(timed_ms(runs[name], iters, reps=1)["ms"])
    res = {}
    for name, ts in times.items():
        ts.sort()
        res[name] = {"ms": ts[len(ts) // 2], "min": ts[0], "max": ts[-1]}
    print(f"  fused_resblock_int8 [{bsz},{h},{w},{c}] in turns, {rounds} x "
          f"{iters} launches each, both bitwise the plain version: first "
          f"form {res['first_form']['ms']:.3f} ms "
          f"[{res['first_form']['min']:.3f}, {res['first_form']['max']:.3f}]"
          f", port (csrc/resblock_int8.cu) {res['port']['ms']:.3f} ms "
          f"[{res['port']['min']:.3f}, {res['port']['max']:.3f}], "
          f"{res['first_form']['ms'] / res['port']['ms']:.3f}x  [{card}]",
          flush=True)
    if not res["port"]["ms"] < res["first_form"]["ms"]:
        fail("the int8 block kernel is not faster than its first form in "
             "turns")
    return res


@contextlib.contextmanager
def _plain_int8_route():
    """``quant_apply``'s int8 conv set to its plain float64 version and
    its int8 block to the block's plain version (float64 convs) while
    active (the ``_int_mm`` route and the kernel otherwise)."""
    from pesr_torch.models import quant_apply
    from pesr_torch.ops.int8_conv import int8_conv_reference
    from pesr_torch.ops.kernels.resblock_int8 import (
        int8_resblock_reference, unpack_int8_block_weights)

    def plain_block(y, w1, qin1, mq, bq, w2, m2, b2, res_scale):
        a, b = unpack_int8_block_weights(w1, w2)
        return int8_resblock_reference(y, a, qin1, mq, bq, b, m2, b2,
                                       res_scale)

    real = quant_apply.int8_conv, quant_apply.fused_resblock_int8
    quant_apply.int8_conv = int8_conv_reference
    quant_apply.fused_resblock_int8 = plain_block
    try:
        yield
    finally:
        quant_apply.int8_conv, quant_apply.fused_resblock_int8 = real


def _quant_apply_bitwise(scale: int, seed: int) -> dict:
    """The flagship int8 apply at ``scale`` (random seed weights,
    calibrated on 4 synthetic 32-px crops) on a 40 x 40 LR tile: uint8
    output of the card's route (the int8 block kernel, ``_int_mm`` for
    the tail and the x8 upfold) == the plain route, bitwise, with one
    kernel launch per block."""
    import numpy as np
    import torch
    from pesr_torch.data.datasets import SyntheticImages
    from pesr_torch.data.augment import normalize_uint8
    from pesr_torch.models.generator import Generator
    from pesr_torch.models.quant_apply import default_calib_tiles, \
        int8_inference
    from pesr_torch.ops.kernels import fused_resblock_int8
    gen = Generator(scale, BLOCKS, CHANNELS, seed=seed)
    img = SyntheticImages(1, 160, 160, seed=seed).get(0)
    apply_fn = int8_inference(gen, default_calib_tiles([img], 32, 4))
    x = normalize_uint8(torch.from_numpy(img[None, :40, :40].copy()).cuda())
    launches = fused_resblock_int8.launches
    ours = apply_fn.uint8_variant(x)
    launches = fused_resblock_int8.launches - launches
    with _plain_int8_route():
        ref = apply_fn.uint8_variant(x)
    d = (ours.int() - ref.int()).abs()
    res = {"upfold": "int8" if isinstance(apply_fn.upfold, dict) else "bf16",
           "max_lsb": int(d.max()), "shape": tuple(ours.shape),
           "launches": launches}
    print(f"  x{scale} {BLOCKS}x{CHANNELS} int8 apply (upfold {res['upfold']}"
          f") on [1,40,40,3] -> {res['shape']}: card route ({launches} "
          f"fused_resblock_int8 launches) vs plain route, uint8 max |d| "
          f"{res['max_lsb']} (pass: 0)", flush=True)
    if res["max_lsb"] != 0 or not torch.equal(ours, ref):
        fail(f"the x{scale} int8 apply's card route differs from its "
             f"plain route")
    if launches != BLOCKS:
        fail(f"the x{scale} int8 apply launched the int8 block kernel "
             f"{launches} times, not {BLOCKS}")
    del gen, apply_fn
    torch.cuda.empty_cache()
    return res


def phase_quant(card: str, best: str, workdir: str) -> dict:
    """int8 W8A8 inference (``--quant int8``): the int8 conv against its
    plain version and timed, the int8 block kernel against its plain
    version (bitwise) and timed, a planted fault in its arguments, the
    whole apply bitwise, the test CLI and the engine on ``best/`` (MP/s
    in turns with the bf16 folded path, agreement, launches), the guard's
    fallback, a planted scale fault, and ``--compute_dtype float32``."""
    import numpy as np
    import torch
    from pesr_torch import test as cli
    from pesr_torch.config import opts_from_args
    from pesr_torch.data.datasets import (EvalSample, SyntheticImages,
                                          host_bicubic_downsample)
    from pesr_torch.models.kernel_apply import Float32Apply, KernelApply
    from pesr_torch.models.quant_apply import (default_calib_tiles,
                                               int8_agreement_db,
                                               int8_inference)
    from pesr_torch.ops import kernels
    from pesr_torch.ops.int8_conv import int8_conv_im2col
    from pesr_torch.ops.tiling import BatchTiledUpscaler
    from pesr_torch.scales import fold_min_halo
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    print(f"[quant] int8 conv (_int_mm over an int8 im2col) vs its plain "
          f"float64 version on {card}: ragged shapes", flush=True)
    for i, case in enumerate(INT8_RAGGED):
        check_int8_conv(card, *case, seed=40 + i, max_bytes=3000)
    (b, th, tw), grid = main_path_tile_batch(fold_min_halo(SCALE))
    print(f"[quant] the x{SCALE} tail conv at the folded tile batch "
          f"[{b},{th},{tw},{CHANNELS}] (grid {grid}) and the x8 int8 upfold "
          f"at {list(X8_TILE_BATCH)}", flush=True)
    res["conv"] = check_int8_conv(card, b, th, tw, CHANNELS, CHANNELS, 3,
                                  None, seed=50, timing=True)
    res["conv_parts"] = _int8_conv_parts(card, b, th, tw)
    res["upfold_conv"] = check_int8_conv(card, *X8_TILE_BATCH, CHANNELS,
                                         3 * 8 * 8, 9, (4, 4), seed=51,
                                         timing=True)
    torch.cuda.empty_cache()

    res["int8_block"] = int8_block_checks(card)
    print(f"[quant] the bf16 fused_resblock at the same tile batch "
          f"[{b},{th},{tw},{CHANNELS}], for comparison", flush=True)
    res["resblock"] = check_resblock(b, th, tw, CHANNELS, 0.1, seed=52,
                                     timing=True)
    print_time(f"fused_resblock [{b},{th},{tw},{CHANNELS}]", res["resblock"],
               card)
    from pesr_torch.models.generator import Generator
    gen = Generator(SCALE, BLOCKS, CHANNELS, seed=0)
    img = SyntheticImages(1, LR_H * SCALE, LR_W * SCALE, seed=7).get(0)
    int8 = int8_inference(gen, default_calib_tiles(
        [host_bicubic_downsample(img, SCALE)]))
    res["block_fault"] = _int8_block_fault(int8, (b, th, tw, CHANNELS))
    del int8, gen
    torch.cuda.empty_cache()

    print(f"[quant] whole {BLOCKS}x{CHANNELS} int8 apply, the card's route "
          f"vs the plain route", flush=True)
    res["apply_x4"] = _quant_apply_bitwise(4, seed=0)
    res["apply_x8"] = _quant_apply_bitwise(8, seed=1)
    if res["apply_x8"]["upfold"] != "int8":
        fail("the x8 int8 apply did not quantize its upfold")

    src = SyntheticImages(N_IMAGES, LR_H * SCALE, LR_W * SCALE, seed=7)
    hrs = [src.get(i) for i in range(N_IMAGES)]
    lrs = [host_bicubic_downsample(hr, SCALE) for hr in hrs]
    samples = [EvalSample(f"div2k_sized_{i}", lr, hr)
               for i, (lr, hr) in enumerate(zip(lrs, hrs))]
    base = ["--model_path", best, "--scale", str(SCALE), "--num_blocks",
            str(BLOCKS), "--num_channels", str(CHANNELS), "--dataset",
            "div2k_sized"]

    def run_cli(extra, what):
        real = cli.load_eval_set
        cli.load_eval_set = lambda opts: samples
        kernels.reset_launch_counts()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                summary = cli.run(base + extra + ["--output_dir", tmp])
                pngs = len(os.listdir(summary["out_dir"]))
        finally:
            cli.load_eval_set = real
        counts = {**edsr_launch_counts(),
                  "fused_resblock_int8": kernels.fused_resblock_int8.launches}
        print(f"  pesr_torch.test {' '.join(extra)}: {summary['precision']}, "
              f"{summary['forwards']} forwards, launches {counts}, "
              f"{summary['mp_per_s']:.2f} MP/s, PSNR {summary['psnr']:.2f} dB,"
              f" {pngs} PNGs", flush=True)
        if pngs != N_IMAGES or not np.isfinite(summary["psnr"]):
            fail(f"pesr_torch.test {what}: {pngs} PNGs, {summary}")
        return summary, counts

    print(f"[quant] python -m pesr_torch.test --quant int8 on the train "
          f"phase's best/ ({N_IMAGES} LR images {LR_H}x{LR_W})", flush=True)
    summary, counts = run_cli(["--quant", "int8"], "--quant int8")
    want = {"fused_resblock": 0, "fused_upsampler_stage": 0,
            "fused_resblock_int8": BLOCKS * summary["forwards"]}
    if summary["precision"] != "int8-w8a8" or counts != want:
        fail(f"--quant int8 served {summary['precision']} with launches "
             f"{counts}, expected {want}")
    res["cli_mp_per_s"] = summary["mp_per_s"]

    opts = opts_from_args(base + ["--quant", "int8"])
    gen = cli.build_generator(opts, torch.device("cuda"))
    calib = default_calib_tiles(lrs)
    int8 = int8_inference(gen, calib)
    bf16 = KernelApply(gen, fold=True)
    engines = {"int8": BatchTiledUpscaler(int8, SCALE, "auto", 8),
               "bf16": BatchTiledUpscaler(bf16, SCALE, "auto", 8)}
    for eng in engines.values():
        eng.warmup_many(lrs, N_IMAGES)
    kernels.reset_launch_counts()
    fwd, gemms = int8.forwards, int8_conv_im2col.gemms
    srs = {"int8": engines["int8"].upscale_many(lrs, N_IMAGES)}
    fwd, gemms = int8.forwards - fwd, int8_conv_im2col.gemms - gemms
    res["int8_launches"] = {k: v // max(fwd, 1) for k, v in
                            edsr_launch_counts().items()}
    res["int8_block_launches"] = kernels.fused_resblock_int8.launches
    res["int8_forwards"] = fwd
    print(f"  int8 engine: {fwd} forwards, bf16 kernel launches per forward "
          f"{res['int8_launches']} (expected 0), fused_resblock_int8 "
          f"launches {res['int8_block_launches']} (expected {BLOCKS} per "
          f"forward), _int_mm GEMMs per forward {gemms / max(fwd, 1):.0f} "
          f"(expected 1: the tail)", flush=True)
    if (any(edsr_launch_counts().values()) or fwd < 1
            or res["int8_block_launches"] != BLOCKS * fwd or gemms != fwd):
        fail(f"the int8 engine launched {edsr_launch_counts()}, "
             f"{res['int8_block_launches']} int8 blocks and {gemms} GEMMs "
             f"in {fwd} forwards")
    srs["bf16"] = engines["bf16"].upscale_many(lrs, N_IMAGES)
    mp = sum(sr.shape[0] * sr.shape[1] for sr in srs["int8"]) / 1e6
    times = {"int8": [], "bf16": []}
    for rep in range(4):
        for name in (("int8", "bf16") if rep % 2 else ("bf16", "int8")):
            t0 = time.perf_counter()
            engines[name].upscale_many(lrs, N_IMAGES)
            times[name].append(time.perf_counter() - t0)
    res["mp_per_s"] = mp / min(times["int8"])
    res["bf16_mp_per_s"] = mp / min(times["bf16"])
    walls = {n: [round(t, 4) for t in ts] for n, ts in times.items()}
    print(f"  {mp:.3f} MP per batch; best of 4 in turns: int8 "
          f"{res['mp_per_s']:.2f} MP/s ({walls['int8']} s), bf16 folded "
          f"{res['bf16_mp_per_s']:.2f} MP/s ({walls['bf16']} s) on {card}",
          flush=True)
    d = np.abs(np.stack(srs["int8"]).astype(np.int16)
               - np.stack(srs["bf16"]).astype(np.int16))
    res["lsb_max"], res["lsb_mean"] = float(d.max()), float(d.mean())
    res["agreement_db"] = int8_agreement_db(int8, gen, calib, bf16)
    print(f"  int8 vs bf16 folded, uint8 over both images: max "
          f"{res['lsb_max']:.0f} LSB, mean {res['lsb_mean']:.4f} LSB; "
          f"int8_agreement_db on the calibration tiles "
          f"{res['agreement_db']:.2f} dB (JAX's guard floor: 55)", flush=True)
    if not res["agreement_db"] > 30.0:
        fail(f"int8 agreement {res['agreement_db']:.2f} dB: the int8 path "
             f"is not the model")
    res["profile"] = profile_breakdown(
        lambda: engines["int8"].upscale_many(lrs, N_IMAGES), card, top=10)

    faulty = int8_inference(gen, calib)
    b0, b1 = faulty.blocks[0], faulty.blocks[1]
    faulty.blocks[0], faulty.blocks[1] = (b0._replace(m2=b1.m2),
                                          b1._replace(m2=b0.m2))
    res["fault_db"] = int8_agreement_db(faulty, gen, calib, bf16)
    print(f"  planted fault (conv2 dequant scales of blocks 0 and 1 swapped):"
          f" agreement {res['fault_db']:.2f} dB vs healthy "
          f"{res['agreement_db']:.2f} (caught when >= "
          f"{QUANT_FAULT_MARGIN_DB} dB lower)", flush=True)
    if res["fault_db"] > res["agreement_db"] - QUANT_FAULT_MARGIN_DB:
        fail("the agreement probe does not see a swapped scale vector")

    f32 = Float32Apply(gen, fold=True)
    srs32 = BatchTiledUpscaler(f32, SCALE, "auto", 8).upscale_many(
        lrs, N_IMAGES)
    d = np.abs(np.stack(srs32).astype(np.int16)
               - np.stack(srs["bf16"]).astype(np.int16))
    m8 = fold_min_halo(SCALE) * SCALE
    res["f32_lsb_max"], res["f32_lsb_mean"] = float(d.max()), float(d.mean())
    print(f"  float32 folded apply vs the bf16 kernel path (uint8): max "
          f"{res['f32_lsb_max']:.0f} LSB, mean {res['f32_lsb_mean']:.4f} "
          f"(tolerance: max <= {LSB_MAX_TOL}, mean <= {LSB_MEAN_TOL}; "
          f"engine halo {m8} HR px)", flush=True)
    if res["f32_lsb_max"] > LSB_MAX_TOL or res["f32_lsb_mean"] > LSB_MEAN_TOL:
        fail("the float32 apply disagrees with the bf16 kernel path")
    del engines, int8, bf16, faulty, f32, gen
    torch.cuda.empty_cache()

    print("[quant] the guard's fallback and --compute_dtype float32 through "
          "the CLI", flush=True)
    summary, counts = run_cli(["--quant", "int8", "--quant_guard_db", "200"],
                              "--quant_guard_db 200")
    rep = summary["quant_guard"]
    if (summary["precision"] != "folded-bfloat16" or not rep["fallback"]
            or counts["fused_resblock"] != BLOCKS * summary["forwards"]
            or counts["fused_upsampler_stage"]):
        fail(f"the guard's fallback served {summary['precision']} ({rep}) "
             f"with launches {counts}")
    res["guard_report"] = rep
    summary, counts = run_cli(["--compute_dtype", "float32"],
                              "--compute_dtype float32")
    if summary["precision"] != "folded-float32" or any(counts.values()):
        fail(f"--compute_dtype float32 served {summary['precision']} with "
             f"launches {counts}")
    res["f32_mp_per_s"] = summary["mp_per_s"]
    return res


# --------------------------------------------------------------------------
# data: the train CLI's data sources and host-side options
# --------------------------------------------------------------------------

DATA_SPE, DATA_EPOCHS, DATA_LOG_EVERY = 20, 2, 10
# The traced steps of a synthetic_device run may hold no host-to-device
# copy this large (a batch is 16 x 192^2 x 3 = 1,769,472 bytes; the
# renderer's per-sample parameters are ~8 KB).
H2D_LIMIT_BYTES = 1 << 20
# The device renderer's properties (the JAX renderer's tests): on a 192^2
# x4 render, the share of energy at or above the LR Nyquist (0.125
# cycles/px) stays below ABOVE_MAX and the share in [f_lo, 0.125) above
# BAND_MIN.
ABOVE_MAX, BAND_MIN = 0.12, 0.15
NATIVE_IMAGES, NATIVE_SPE, NATIVE_EPOCHS = 8, 10, 2


class _Tee:
    """stdout that is also kept, so a run's log lines can be checked."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _run_logged(fn):
    """``fn()`` with stdout teed; returns (result, printed text)."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        res = fn()
    return res, tee.text()


def _spectrum_shares(img, f_lo: float):
    """(share at or above 0.125 cycles/px, share in [f_lo, 0.125)) of the
    luma's power spectrum, mean removed."""
    import numpy as np
    g = img.mean(-1).astype(np.float64)
    g -= g.mean()
    power = np.abs(np.fft.rfft2(g)) ** 2
    r = np.hypot(np.fft.fftfreq(g.shape[0])[:, None],
                 np.fft.rfftfreq(g.shape[1])[None, :])
    tot = power.sum()
    return (float(power[r >= 0.125].sum() / tot),
            float(power[(r >= f_lo) & (r < 0.125)].sum() / tot))


def _device_renderer(card: str) -> dict:
    """``synthetic_device``'s renderer at the flagship batch: its
    properties, the card against the same render on the CPU (same
    parameters), and its time against a pinned upload of the batch."""
    import numpy as np
    import torch
    from pesr_torch.data import device_synth as ds
    hp = TRAIN_PATCH * SCALE
    shape = (TRAIN_BATCH, hp, hp, 3)
    nbytes = math.prod(shape)
    print(f"[data] synthetic_device renderer: [{TRAIN_BATCH},{hp},{hp},3] "
          f"uint8 on {card}", flush=True)
    hr = ds.render_hr_batch(0, TRAIN_BATCH, hp, SCALE, "cuda")
    torch.cuda.synchronize()
    h = hr.cpu().numpy()
    res = {}
    if hr.dtype != torch.uint8 or tuple(hr.shape) != shape \
            or hr.device.type != "cuda":
        fail(f"render: {hr.dtype} {tuple(hr.shape)} on {hr.device}")
    lo = h.reshape(TRAIN_BATCH, -1).min(1)
    hi = h.reshape(TRAIN_BATCH, -1).max(1)
    if (lo != 0).any() or (hi != 255).any():
        fail(f"render does not cover 0..255 per sample: {lo}, {hi}")
    same = ds.render_hr_batch(0, TRAIN_BATCH, hp, SCALE, "cuda")
    b2 = ds.render_hr_batch(0, 2, hp, SCALE, "cuda")
    other = ds.render_hr_batch(1, TRAIN_BATCH, hp, SCALE, "cuda")
    checks = {
        "deterministic in the key": bool(torch.equal(same, hr)),
        "sample i the same in a batch of 2 and of 16":
            bool(torch.equal(b2, hr[:2])),
        "samples within a batch differ":
            len({h[i].tobytes() for i in range(TRAIN_BATCH)}) == TRAIN_BATCH,
        "another key gives other content": not bool(torch.equal(other, hr)),
    }
    opts = _data_opts()
    s0 = [next(ds.DeviceSyntheticStream(opts, "cuda"))[1] for _ in range(2)]
    s100 = next(ds.DeviceSyntheticStream(opts, "cuda", start_step=100))[1]
    checks["a stream is deterministic in (seed, step)"] = bool(
        torch.equal(*s0))
    checks["start_step folded in gives fresh content"] = not bool(
        torch.equal(s0[0], s100))
    f_lo, _ = ds.band_for_scale(SCALE)
    shares = [_spectrum_shares(h[i], f_lo) for i in range(TRAIN_BATCH)]
    res["above_max"] = max(a for a, _ in shares)
    res["band_min"] = min(b for _, b in shares)
    checks[f"energy >= 0.125 cyc/px < {ABOVE_MAX} on every sample"] = (
        res["above_max"] < ABOVE_MAX)
    checks[f"energy in [{f_lo:.4f}, 0.125) > {BAND_MIN} on every sample"] = (
        res["band_min"] > BAND_MIN)
    for what, ok in checks.items():
        print(f"  {what}: {'yes' if ok else 'NO'}", flush=True)
    print(f"  energy shares over the {TRAIN_BATCH} samples: above Nyquist "
          f"max {res['above_max']:.4f}, in band min {res['band_min']:.4f}",
          flush=True)
    if not all(checks.values()):
        fail("the device renderer lacks a stated property")
    params = ds.draw_params(0, TRAIN_BATCH, hp, SCALE)
    cpu = ds._render(params, hp, SCALE).numpy().astype(np.int16)
    d = np.abs(cpu - h.astype(np.int16))
    res["cpu_lsb_max"], res["cpu_lsb_mean"] = int(d.max()), float(d.mean())
    print(f"  the same parameters rendered on the CPU: max "
          f"{res['cpu_lsb_max']} LSB, mean {res['cpu_lsb_mean']:.5f} LSB "
          f"(float32 exp/cos of two libraries)", flush=True)
    if res["cpu_lsb_max"] > 2:
        fail("the card's render differs from the CPU's by more than 2 LSB")
    p_dev = params.cuda()
    pinned = torch.empty(shape, dtype=torch.uint8).pin_memory()
    res["render"] = timed_ms(
        lambda: ds.render_hr_batch(0, TRAIN_BATCH, hp, SCALE, "cuda"), 10)
    res["pixels"] = timed_ms(lambda: ds._render(p_dev, hp, SCALE), 10)
    res["h2d"] = timed_ms(lambda: pinned.to("cuda", non_blocking=True), 10)
    for name, what in (("render", "render_hr_batch (host parameters + "
                        "device pixels)"),
                       ("pixels", "the device pixels alone"),
                       ("h2d", f"pinned H2D copy of the {nbytes:,} bytes")):
        r = res[name]
        print(f"  {what}: {r['ms']:.4f} ms [min {r['min']:.4f}, max "
              f"{r['max']:.4f}] [{card}]", flush=True)
    return res


def _data_opts(extra=(), ck: str = "", dataset: str = "synthetic_device"):
    """The train CLI's options at the flagship recipe (folded training,
    its default) on ``dataset``, 2 epochs x 20 steps."""
    from pesr_torch.config import opts_from_args
    return opts_from_args(
        ["--num_blocks", str(BLOCKS), "--num_channels", str(CHANNELS),
         "--scale", str(SCALE), "--batch_size", str(TRAIN_BATCH),
         "--patch_size", str(TRAIN_PATCH), "--train_dataset", dataset,
         "--valid_dataset", dataset, "--num_valids", "1",
         "--steps_per_epoch", str(DATA_SPE), "--num_epochs",
         str(DATA_EPOCHS), "--log_every", str(DATA_LOG_EVERY),
         "--check_point", ck, *extra], mode="train")


def _traced_steps(trace: str):
    """(``train_step`` ranges, bytes of every H2D copy) in a Chrome trace
    of ``torch.profiler``."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    steps = sum(1 for e in events if e.get("name") == "train_step"
                and e.get("cat") == "user_annotation")
    h2d = [int(e.get("args", {}).get("bytes", 0)) for e in events
           if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    return steps, h2d


def _synthetic_device_run(card: str, workdir: str) -> dict:
    """``run_training --train_dataset synthetic_device --valid_dataset
    synthetic_device`` with ``--profile_dir`` and ``--trim_host_heap``:
    the trace, no batch upload in it, launches, trims; then steps/s in
    turns with ``synthetic`` on the same recipe."""
    from pesr_torch.ops import kernels
    from pesr_torch.training import loop
    ck = os.path.join(workdir, "data_device")
    pdir = os.path.join(workdir, "data_profile")
    opts = _data_opts(["--profile_dir", pdir, "--trim_host_heap"], ck)
    print(f"[data] run_training --train_dataset synthetic_device "
          f"--valid_dataset synthetic_device --profile_dir --trim_host_heap: "
          f"{BLOCKS}x{CHANNELS} x{SCALE}, batch {TRAIN_BATCH}, patch "
          f"{TRAIN_PATCH}, {DATA_EPOCHS} x {DATA_SPE} steps, folded "
          f"{opts.fold_train}", flush=True)
    trims = []
    real_trim = loop.trim_host_heap
    loop.trim_host_heap = lambda: trims.append(real_trim()) or trims[-1]
    kernels.reset_launch_counts()
    try:
        summary, out = _run_logged(lambda: loop.run_training(opts))
    finally:
        loop.trim_host_heap = real_trim
    counts = edsr_launch_counts()
    fwd = summary["train_forwards"] + summary["eval_forwards"]
    want = {"fused_resblock": BLOCKS * fwd, "fused_upsampler_stage": 0}
    res = {"launches": counts,
           "launches_per_step": {k: v // fwd for k, v in counts.items()}}
    traces = [f for f in os.listdir(pdir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        fail(f"--profile_dir holds {traces}")
    steps, h2d = _traced_steps(os.path.join(pdir, traces[0]))
    big = [n for n in h2d if n >= H2D_LIMIT_BYTES]
    res.update(traced_steps=steps, h2d_copies=len(h2d),
               h2d_max_bytes=max(h2d, default=0), trims=trims)
    print(f"  launches {counts} over {summary['train_forwards']} training + "
          f"{summary['eval_forwards']} eval forwards (expected {want}); "
          f"trace {traces[0]}: {steps} train_step ranges, {len(h2d)} H2D "
          f"copies, the largest {res['h2d_max_bytes']} bytes (limit "
          f"< {H2D_LIMIT_BYTES}); trim_host_heap ran {len(trims)} times "
          f"({trims}); val_psnr {summary.get('val_psnr')}, val_pi "
          f"{summary.get('val_pi')}", flush=True)
    if counts != want or summary["train_forwards"] != DATA_SPE * DATA_EPOCHS:
        fail(f"synthetic_device run_training: launches {counts} != {want}")
    if "HR source: rendered on the device" not in out \
            or "[profile] trace written to" not in out:
        fail("synthetic_device run_training: the log does not name the "
             "device source or the written trace")
    if steps != len(loop.PROFILE_STEPS) or big:
        fail(f"the trace covers {steps} steps, H2D copies >= 1 MB: {big}")
    if trims != [True] * DATA_EPOCHS:
        fail(f"--trim_host_heap: {trims}")
    if not math.isfinite(summary.get("val_pi", math.nan)):
        fail(f"synthetic_device eval: val_pi {summary.get('val_pi')}")

    print("[data] steps/s in turns, same recipe, no eval: synthetic, "
          "synthetic_device, synthetic_device, synthetic", flush=True)
    rates = {"synthetic": [], "synthetic_device": []}
    for i, name in enumerate(("synthetic", "synthetic_device",
                              "synthetic_device", "synthetic")):
        ck_i = os.path.join(workdir, f"data_turn_{i}")
        o = _data_opts(["--eval_every", "0"], ck_i, name)
        loop.run_training(o)
        with open(os.path.join(ck_i, "pretrain.jsonl")) as f:
            recs = [r for r in map(json.loads, f) if "l1" in r]
        rates[name].append(steady_rate(recs, DATA_SPE, card))
    res["steps_per_s"] = rates
    print(f"  steps/s of the second epoch: synthetic {rates['synthetic']}, "
          f"synthetic_device {rates['synthetic_device']} [{card}]",
          flush=True)
    return res


def _precision_steps(card: str) -> dict:
    """``--compute_dtype float32``: one flagship folded pretrain step on
    plain convs (TF32 allowed globally: the step's scope must turn it off)
    against the bf16 kernel step on the same weights and batch; no kernel
    launch; its steps/s.  Then ``--param_dtype bfloat16`` from weights
    rounded to bf16: its first L1 against the f32-parameter kernel step's,
    and two steps' parameters and Adam moments."""
    import torch
    from pesr_torch.models.generator import Generator
    from pesr_torch.models.kernel_apply import Float32TrainApply
    from pesr_torch.ops import kernels
    from pesr_torch.training.state import create_generator_state
    from pesr_torch.training.steps import make_pretrain_step
    cuda = torch.device("cuda")
    opts = _data_opts()
    torch.backends.cudnn.allow_tf32 = True   # PyTorch's default
    batch = _train_batch(seed=5)
    res = {}

    def state_of(o, gen=None):
        if gen is None:
            gen = Generator(SCALE, BLOCKS, CHANNELS, seed=0)
        return create_generator_state(o, cuda, gen)

    o32 = dataclasses.replace(opts, compute_dtype="float32")
    s32 = state_of(o32)
    if not isinstance(s32.apply, Float32TrainApply):
        fail(f"--compute_dtype float32 trains through {type(s32.apply)}")
    step32 = make_pretrain_step(o32)
    kernels.reset_launch_counts()
    m32 = step32(s32, *batch)
    torch.cuda.synchronize()
    res["f32_launches"] = edsr_launch_counts()
    sk = state_of(opts)
    mk = make_pretrain_step(opts)(sk, *batch)
    dl1 = abs(float(m32["l1"]) - float(mk["l1"]))
    cos, name = min((float(torch.nn.functional.cosine_similarity(
        p.grad.float().flatten(), q.grad.float().flatten(), dim=0)), n)
        for (n, p), q in zip(s32.generator.named_parameters(),
                             sk.generator.parameters()))
    res.update(f32_dl1=dl1, f32_cos=cos)
    print(f"[data] --compute_dtype float32, one folded flagship pretrain "
          f"step: launches {res['f32_launches']} (expected none); L1 "
          f"{float(m32['l1']):.6f} vs the bf16 kernel step's "
          f"{float(mk['l1']):.6f}: |d L1| {dl1:.2e} (limit {STEP_L1_TOL}); "
          f"least gradient cosine {cos:.6f} ({name}; floor "
          f"{GRAD_COS_FLOOR})", flush=True)
    if any(res["f32_launches"].values()):
        fail(f"the float32 step launched {res['f32_launches']}")
    if not (dl1 <= STEP_L1_TOL and cos >= GRAD_COS_FLOOR):
        fail("the float32 step disagrees with the bf16 kernel step")
    del sk
    for _ in range(2):
        step32(s32, *batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step32(s32, *batch)
    torch.cuda.synchronize()
    res["f32_steps_per_s"] = 5 / (time.perf_counter() - t0)
    print(f"  float32 steps/s (5 steps after 3, host clock around "
          f"synchronize): {res['f32_steps_per_s']:.3f} [{card}]", flush=True)
    del s32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    gen = Generator(SCALE, BLOCKS, CHANNELS, seed=0)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(p.bfloat16().float())
    gen16 = Generator(SCALE, BLOCKS, CHANNELS, seed=None)
    gen16.load_state_dict(gen.state_dict())
    o16 = dataclasses.replace(opts, param_dtype="bfloat16")
    s_f = state_of(opts, gen)
    s_b = state_of(o16, gen16)
    step = make_pretrain_step(opts)
    l1_f = float(step(s_f, *batch)["l1"])
    kernels.reset_launch_counts()
    l1_b = [float(step(s_b, *batch)["l1"]) for _ in range(2)]
    res["bf16_param_launches_per_step"] = {
        k: v // 2 for k, v in edsr_launch_counts().items()}
    tensors = [("param " + n, p) for n, p in s_b.generator.named_parameters()]
    for p in s_b.generator.parameters():
        st = s_b.optimizer.state[p]
        tensors += [("exp_avg", st["exp_avg"]),
                    ("exp_avg_sq", st["exp_avg_sq"])]
    bad = [n for n, t in tensors if t.dtype != torch.bfloat16
           or not bool(torch.isfinite(t).all())]
    res.update(bf16_l1_first=l1_b[0], f32_param_l1_first=l1_f,
               bf16_bad=len(bad))
    print(f"[data] --param_dtype bfloat16 from weights rounded to bf16: "
          f"first L1 {l1_b[0]!r} vs the float32-parameter kernel step's "
          f"{l1_f!r} ({'bitwise equal' if l1_b[0] == l1_f else 'DIFFER'});"
          f" second L1 {l1_b[1]!r}; launches per step "
          f"{res['bf16_param_launches_per_step']}; {len(tensors)} "
          f"parameters and Adam moments, {len(bad)} not bf16 or not "
          f"finite {bad[:4]}", flush=True)
    if l1_b[0] != l1_f or bad:
        fail("--param_dtype bfloat16: first-step L1 or dtypes")
    if res["bf16_param_launches_per_step"] != {"fused_resblock": BLOCKS,
                                               "fused_upsampler_stage": 0}:
        fail(f"bf16 parameters: launches {edsr_launch_counts()}")
    return res


def _libpng_present():
    """(png.h found, libpng's shared library found)."""
    import ctypes.util
    hdr = any(os.path.isfile(os.path.join(d, "png.h"))
              for d in ("/usr/include", "/usr/local/include",
                        "/usr/include/libpng", "/usr/include/libpng16"))
    return hdr, ctypes.util.find_library("png") is not None


def _native_path(card: str, workdir: str) -> dict:
    """The native data core on a DIV2K-layout PNG folder: the library
    built, 8 synthetic 480^2 images written with the port's PNG encoder
    and read back bitwise by ``decode_png``, the sampler's batches/s
    against ``PatchIterator``'s on the same images, and ``run_training
    --train_dataset DIV2K`` (whose log must name the native sampler).
    Runs only where libpng is installed; without it, says so and returns
    ``{"run": False}``."""
    import numpy as np
    from pesr_torch.data import native
    from pesr_torch.data.datasets import (PairedImageFolder, PatchIterator,
                                          SyntheticImages)
    from pesr_torch.training.loop import run_training
    from pesr_torch.utils.image_io import imwrite_uint8
    hdr, lib = _libpng_present()
    print(f"[data] native data core: png.h {'found' if hdr else 'absent'}, "
          f"libpng {'found' if lib else 'absent'}", flush=True)
    if not (hdr and lib):
        reason = native.unavailable_reason()
        print(f"  NOT RUN: libpng is not installed on this machine, so "
              f"pesr_torch/data/native cannot be built ({reason}); a PNG "
              f"folder trains through PatchIterator and Pillow here, and "
              f"the loop says so", flush=True)
        return {"run": False, "reason": reason}
    if not native.available():
        fail(f"libpng is installed but the native library did not build: "
             f"{native.unavailable_reason()}")
    root = os.path.join(workdir, "native")
    hr_dir = os.path.join(root, "DIV2K", "DIV2K_train_HR")
    src = SyntheticImages(NATIVE_IMAGES, 480, 480, seed=21)
    imgs = []
    for i in range(NATIVE_IMAGES):
        path = os.path.join(hr_dir, f"{i:04d}.png")
        imwrite_uint8(path, src.get(i))
        imgs.append(native.decode_png(path))
        if not np.array_equal(imgs[-1], src.get(i)):
            fail(f"decode_png does not read {path} back bitwise")
    print(f"  {NATIVE_IMAGES} PNGs of 480^2 written by the port's encoder "
          f"read back bitwise by decode_png ({native.lib_path()})",
          flush=True)
    hp, res = TRAIN_PATCH * SCALE, {"run": True}
    sampler = native.NativePatchSampler(imgs, hp, TRAIN_BATCH, seed=0)
    it = PatchIterator(PairedImageFolder(hr_dir, None, SCALE), TRAIN_PATCH,
                       SCALE, TRAIN_BATCH, seed=0)
    next(it)  # decodes and caches the folder
    for name, fn in (("native", sampler.sample), ("patch_iterator",
                                                   lambda: next(it))):
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        res[f"{name}_batches_per_s"] = 50 / (time.perf_counter() - t0)
    print(f"  batches/s of [{TRAIN_BATCH},{hp},{hp},3] from {NATIVE_IMAGES} "
          f"decoded images: native sampler ({sampler.threads} threads) "
          f"{res['native_batches_per_s']:.1f}, PatchIterator "
          f"{res['patch_iterator_batches_per_s']:.1f} [host of {card}]",
          flush=True)
    from pesr_torch.config import opts_from_args
    opts = opts_from_args(
        ["--num_blocks", str(BLOCKS), "--num_channels", str(CHANNELS),
         "--scale", str(SCALE), "--batch_size", str(TRAIN_BATCH),
         "--patch_size", str(TRAIN_PATCH), "--train_dataset", "DIV2K",
         "--data_root", root, "--eval_every", "0", "--steps_per_epoch",
         str(NATIVE_SPE), "--num_epochs", str(NATIVE_EPOCHS),
         "--log_every", "5", "--check_point", os.path.join(root, "ck")],
        mode="train")
    summary, out = _run_logged(lambda: run_training(opts))
    with open(os.path.join(root, "ck", "pretrain.jsonl")) as f:
        l1s = [r["l1"] for r in map(json.loads, f) if "l1" in r]
    print(f"  run_training --train_dataset DIV2K: {summary['steps']} steps, "
          f"L1 {[round(v, 5) for v in l1s]}", flush=True)
    if "HR source: native sampler" not in out:
        fail("run_training on a PNG folder did not use the native sampler")
    if summary["steps"] != NATIVE_SPE * NATIVE_EPOCHS \
            or not all(map(math.isfinite, l1s)):
        fail(f"run_training --train_dataset DIV2K: {summary}, {l1s}")
    return res


def phase_data(card: str, workdir: str) -> dict:
    """The train CLI's data sources and host-side options at the flagship
    recipe: the device renderer, a synthetic_device run with its trace,
    ``--compute_dtype float32`` and ``--param_dtype bfloat16`` steps, and
    the native data core."""
    t0 = time.perf_counter()
    res = {"render": _device_renderer(card)}
    res["device_run"] = _synthetic_device_run(card, workdir)
    res.update(_precision_steps(card))
    res["native"] = _native_path(card, workdir)
    print(f"[data] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return res


# --------------------------------------------------------------------------
# parallel: two gloo ranks on one card; serve: the serving artifact
# --------------------------------------------------------------------------

# Global batch 16 on 2 ranks x 8 against 1 process x 16: the same kernels,
# so both sides hold bf16 noise only; the limits are the pretrain and GAN
# step limits above (PERF.md section 2).  Each step is compared from the
# same state: before step k > 1 the one-process run takes the 2-rank run's
# parameters and optimizer states after step k - 1.  Run on, the GAN's
# two trajectories part after one step: D's and VGG's bf16 convs round
# differently at batch 8 and 16 (cuDNN picks by shape), and Adam turns
# small gradient differences into parameter steps of ~lr (measured on
# the H100: |d d_loss| 1.4e-4 at step 1, 1.6e-2 at step 2 run on; a
# second one-process run is bitwise the first).  D's cosine leaves out
# PAR_ZERO_GRAD_D, the tensors whose exact gradient is 0 (the gan phase
# leaves out the same ones as rounding noise against its f32 step; here
# both sides are bf16, their noise passes that norm filter and its cosine
# between the two runs is meaningless: 0.92 on conv0s.bias).
PAR_RANKS, PAR_STEPS = 2, 2
PAR_FAULT = "D's batch statistics over the rank's block (no all-reduce)"


def par_zero_grad_d(d) -> list:
    """D's parameters whose exact gradient is 0: the bias of every conv
    a batch-statistics norm follows (the norm subtracts the channel's
    mean, so a constant shift cancels), and ``fc1.bias``, which shifts
    every logit alike (the relativistic losses see logits only as
    differences)."""
    from pesr_torch.models.discriminator import BatchStatNorm
    mods = dict(d.named_children())
    names = list(mods)
    return [f"{a}.bias" for a, b in zip(names, names[1:])
            if isinstance(mods[b], BatchStatNorm)] + ["fc1.bias"]


def _rank_argv(call: str) -> list:
    """The command of a rank process running ``chip_smoke.<call>``."""
    return [sys.executable, "-c", f"import chip_smoke as c; c.{call}"]


def _run_ranks(argv: list, n: int = PAR_RANKS,
               timeout: float = 400.0, env=None) -> list:
    """``argv`` as ``n`` processes under the ``PESR_*`` contract (a free
    localhost port), from this script's directory, with ``env`` added to
    the environment; their output is printed with a rank prefix.  Kills
    every one still running after ``timeout`` s; fails unless all exit
    0."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(n):
        e = dict(os.environ, **(env or {}),
                 PESR_COORDINATOR=f"127.0.0.1:{port}",
                 PESR_NUM_PROCESSES=str(n), PESR_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            argv, cwd=root, env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        fail(f"{argv[-1]}: the {n} ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.rstrip().splitlines():
            print(f"  [rank {r}] {line}", flush=True)
        if p.returncode != 0:
            fail(f"{argv[-1]}: rank {r} exited {p.returncode}")
    return outs


def _rank_mesh():
    """In a rank process: the gloo group (NCCL refuses two ranks on one
    device) over CUDA tensors on this card."""
    from pesr_torch import parallel
    parallel.initialize_distributed(required=True, device="cuda",
                                    backend="gloo", timeout_s=120)
    return parallel.make_mesh(device="cuda")


def _par_case(case: str, mesh, fault=False, starts=None, seed=0,
              steps=PAR_STEPS) -> dict:
    """``steps`` flagship steps of ``case`` ("pretrain": folded L1;
    "gan": the chain, JAX's GAN defaults) from weights of ``seed`` (G;
    D ``seed + 1``) on the global batches of :func:`_train_batch` (seed
    ``100 * seed + k`` at step k), this rank's block of each (``mesh``
    None: one process, the whole batch; ``fault``: D's batch statistics
    over the block).  ``starts``: a 2-rank run's states, of which
    ``starts[k]`` is loaded before step k > 0.  Returns the metrics,
    launches and gradients of each step and, on rank 0 of a mesh, the
    state before each step (``starts``)."""
    import copy
    import torch
    from pesr_torch import parallel
    from pesr_torch.models.discriminator import (Discriminator,
                                                 set_batch_stats_mesh)
    from pesr_torch.models.generator import Generator
    from pesr_torch.ops import kernels
    from pesr_torch.training.state import (add_discriminator,
                                           create_generator_state, init_vgg)
    from pesr_torch.training.steps import make_gan_step, make_pretrain_step
    dev = torch.device("cuda")
    opts = _gan_opts()
    if case == "pretrain":
        opts = dataclasses.replace(opts, phase="pretrain", fold_train=True)
    state = create_generator_state(opts, dev, Generator(
        SCALE, BLOCKS, CHANNELS, device=dev, seed=seed), mesh=mesh)
    if case == "gan":
        add_discriminator(state, opts, dev, Discriminator(
            opts.hr_patch_size, device=dev, seed=seed + 1))
        state.vgg = init_vgg(opts, dev)
        if fault:
            set_batch_stats_mesh(state.discriminator, None)
        step = make_gan_step(opts)
    else:
        step = make_pretrain_step(opts)
    nets = [n for n in (state.generator, state.discriminator) if n is not None]
    optims = [o for o in (state.optimizer, state.d_optimizer) if o is not None]
    block = parallel.batch_sharding(mesh, TRAIN_BATCH)
    out = {"metrics": [], "launches": [], "grads": [], "starts": [None]}
    for k in range(steps):
        if k and starts is not None:
            with torch.no_grad():
                for net, params in zip(nets, starts[k]["params"]):
                    for p, q in zip(net.parameters(), params):
                        p.copy_(q)
            for o, sd in zip(optims, starts[k]["optimizers"]):
                # a copy: the optimizer would update the loaded moments in
                # place, and the next run loads the same start
                o.load_state_dict(copy.deepcopy(sd))
            state.step = starts[k]["step"]
        elif k and mesh is not None and mesh.rank == 0 and not fault:
            out["starts"].append({
                "params": [[p.detach().clone() for p in n.parameters()]
                           for n in nets],
                "optimizers": [copy.deepcopy(o.state_dict()) for o in optims],
                "step": state.step})
        lr_img, hr_img = _train_batch(seed=100 * seed + k)
        kernels.reset_launch_counts()
        m = step(state, lr_img[block], hr_img[block])
        out["launches"].append(edsr_launch_counts())
        out["metrics"].append({n: float(v) for n, v in m.items()})
        out["grads"].append({
            t: {n: p.grad.detach().float().clone()
                for n, p in net.named_parameters()}
            for t, net in (("g", state.generator), ("d", state.discriminator))
            if net is not None})
    return out


def _par_agreement(got: dict, ref: dict, zero_d=()) -> list:
    """Per step, the step limits' readings between two runs: |d| of the
    losses, and the least cosine of the step's gradients over the tensors
    (those whose gradient norm is under 1e-4 of the largest left out, as
    :func:`gan_step_agreement`, and D's ``zero_d``; ``cos_d_all`` and
    ``worst_d_all`` read D with ``zero_d`` kept, for the record)."""
    import torch

    def least(a, b, names):
        return min((float(torch.nn.functional.cosine_similarity(
            a[n].flatten(), b[n].flatten(), dim=0)), n) for n in names)

    out = []
    for k, (m, mr) in enumerate(zip(got["metrics"], ref["metrics"])):
        r = {}
        for key in ("l1", "d_loss", "g_loss"):
            if key in mr:
                r[key] = abs(m[key] - mr[key])
                r[key + "_ref"] = abs(mr[key])
        for net, grads in ref["grads"][k].items():
            norms = {n: float(g.norm()) for n, g in grads.items()}
            keep = [n for n in grads if norms[n] > 1e-4 * max(norms.values())]
            mine = got["grads"][k][net]
            if net == "d":
                r["cos_d_all"], r["worst_d_all"] = least(mine, grads, keep)
                keep = [n for n in keep if n not in zero_d]
            r[f"cos_{net}"], r[f"worst_{net}"] = least(mine, grads, keep)
        out.append(r)
    return out


def _par_within(case: str, r: dict) -> bool:
    """One step's readings (:func:`_par_agreement`) within the limits."""
    if case == "pretrain":
        return r["l1"] <= STEP_L1_TOL and r["cos_g"] >= GRAD_COS_FLOOR
    return (r["d_loss"] <= GAN_LIMITS["d_loss"]
            and r["g_loss"] <= (GAN_LIMITS["g_loss_atol"]
                                + GAN_LIMITS["g_loss_rtol"] * r["g_loss_ref"])
            and r["cos_g"] >= GAN_LIMITS["cos_g"]
            and r["cos_d"] >= GAN_LIMITS["cos_d"])


def rank_train(workdir: str, seed: int = 0,
               cases=("pretrain", "gan")) -> None:
    """A rank of the parallel phase's training check: the 2-rank steps of
    ``cases`` (and with "gan" one step with PAR_FAULT), then on rank 0
    the one-process steps and the agreement, written to
    ``workdir/par_train.json``; ``seed`` as :func:`_par_case`."""
    import torch
    from pesr_torch import parallel
    from pesr_torch.models.discriminator import Discriminator
    mesh = _rank_mesh()
    print(f"rank {mesh.rank} of {mesh.size} on {mesh.device} "
          f"({mesh.backend})", flush=True)
    runs = {}
    for case in cases:
        runs[(case, False)] = _par_case(case, mesh, seed=seed)
        if case == "gan":
            runs[(case, True)] = _par_case(case, mesh, True, seed=seed,
                                           steps=1)
    for (case, fault), run in runs.items():
        print(f"{case}{' (fault)' if fault else ''}: launches per step on "
              f"this rank {run['launches']}", flush=True)
    torch.cuda.empty_cache()
    parallel.barrier(mesh)
    if mesh.rank != 0:
        return
    # the names depend on the number of stages only
    zero_d = par_zero_grad_d(Discriminator(16, base_channels=1,
                                           dense_features=1, device="cpu",
                                           seed=None))
    res = {"launches": {c: runs[(c, False)]["launches"] for c in cases},
           "zero_grad_d": zero_d}
    t0 = time.perf_counter()
    for case in cases:
        two = runs.pop((case, False))
        ref = _par_case(case, None, starts=two["starts"], seed=seed)
        res[case] = _par_agreement(two, ref, zero_d)
        res[case + " metrics"] = {"2 ranks": two["metrics"],
                                  "1 process": ref["metrics"]}
        if case == "gan":
            res["fault"] = _par_agreement(runs.pop((case, True)), ref,
                                          zero_d)
        del ref, two
        torch.cuda.empty_cache()
    print(f"the one-process steps took {time.perf_counter() - t0:.1f} s",
          flush=True)
    with open(os.path.join(workdir, "par_train.json"), "w") as fh:
        json.dump(res, fh)


def _div2k_sized_lrs():
    """The main phase's two 336 x 510 LR images."""
    from pesr_torch.data.datasets import (SyntheticImages,
                                          host_bicubic_downsample)
    src = SyntheticImages(N_IMAGES, LR_H * SCALE, LR_W * SCALE, seed=7)
    return [host_bicubic_downsample(src.get(i), SCALE)
            for i in range(N_IMAGES)]


@contextlib.contextmanager
def kernel_shapes():
    """Within: per kernel, the set of input shapes [B, H, W, C] that the
    inference applies hand it (``pesr_torch.models.kernel_apply``'s
    ``fused_resblock`` and ``fused_upsampler_stage``,
    ``pesr_torch.models.quant_apply``'s ``fused_resblock_int8``)."""
    import pesr_torch.models.kernel_apply as ka
    import pesr_torch.models.quant_apply as qa
    sites = ((ka, "fused_resblock"), (ka, "fused_upsampler_stage"),
             (qa, "fused_resblock_int8"))
    seen = {name: set() for _, name in sites}
    inner = {name: getattr(mod, name) for mod, name in sites}

    def spy_of(name):
        def spy(x, *args, **kw):
            seen[name].add(tuple(x.shape))
            return inner[name](x, *args, **kw)
        return spy

    for mod, name in sites:
        setattr(mod, name, spy_of(name))
    try:
        yield seen
    finally:
        for mod, name in sites:
            setattr(mod, name, inner[name])


@contextlib.contextmanager
def resblock_shapes():
    """Within: the set of input shapes that the inference apply hands
    ``fused_resblock`` (:func:`kernel_shapes`)."""
    with kernel_shapes() as seen:
        yield seen["fused_resblock"]


def hold_resblock_at(shapes, seed: int) -> list:
    """``fused_resblock`` against its plain version at each of ``shapes``
    (the kernels phase's inputs and tolerance, flagship res_scale)."""
    return [check_resblock(*shape, 0.1, seed=seed + i)["max_abs_err"]
            for i, shape in enumerate(sorted(shapes))]


def rank_infer(workdir: str) -> None:
    """A rank of the parallel phase's inference check: the folded flagship
    engine with ``mesh_axis`` tiles and batch on the two 336 x 510 images
    against the single-process engine at the same geometry (and, batch
    mode, on each rank's block), its launches and MP/s, and the resblock
    kernel against its plain version at the shapes this rank gave it."""
    import numpy as np
    import torch
    from pesr_torch import parallel
    from pesr_torch.models.generator import Generator
    from pesr_torch.models.kernel_apply import KernelApply
    from pesr_torch.ops import kernels
    from pesr_torch.ops.tiling import BatchTiledUpscaler
    mesh = _rank_mesh()
    lrs = _div2k_sized_lrs()
    batch = np.stack(lrs)
    ap = KernelApply(Generator(SCALE, BLOCKS, CHANNELS, device=mesh.device,
                               seed=0), fold=True)
    res = {}
    for axis in ("tiles", "batch"):
        eng = BatchTiledUpscaler(ap, SCALE, "auto", 8, mesh=mesh,
                                 mesh_axis=axis)
        grid = eng.grid(N_IMAGES, LR_H, LR_W)
        single = BatchTiledUpscaler(ap, SCALE, tuple(grid[2:]), 8,
                                    device=mesh.device)
        if single.grid(N_IMAGES, LR_H, LR_W) != grid:
            fail(f"{axis}: the single-process engine cannot take the grid "
                 f"{grid}")
        eng.upscale_many(lrs, N_IMAGES)          # warm up
        kernels.reset_launch_counts()
        ap.forwards = 0
        with resblock_shapes() as shapes:
            got = eng.upscale_batch(batch)
        launches, forwards = edsr_launch_counts(), ap.forwards
        held = hold_resblock_at(shapes, seed=60 + 10 * mesh.rank)
        ref = single.upscale_batch(batch)
        own = None
        if axis == "batch":  # this rank's block through the single engine
            block = parallel.batch_sharding(mesh, N_IMAGES)
            own = np.array_equal(got[block], single.upscale_batch(
                batch[block]))
        times = []
        for _ in range(3):
            parallel.barrier(mesh)
            t0 = time.perf_counter()
            eng.upscale_many(lrs, N_IMAGES)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        mp = N_IMAGES * LR_H * LR_W * SCALE * SCALE / 1e6
        res[axis] = {
            "grid": list(grid), "launches": launches, "forwards": forwards,
            "bitwise_whole_batch": bool(np.array_equal(got, ref)),
            "max_lsb_whole_batch": int(np.abs(got.astype(int)
                                              - ref.astype(int)).max()),
            "bitwise_own_block": own,
            "resblock_shapes": sorted(shapes), "resblock_max_abs_err": held,
            "mp_per_s": mp / min(times), "times": times}
        print(f"mesh_axis {axis}: grid {grid}, {forwards} forwards on this "
              f"rank, launches {launches}, resblock inputs "
              f"{sorted(shapes)} held to the plain version (max |d| "
              f"{held}), canvas bitwise the single-process"
              f" engine's: {res[axis]['bitwise_whole_batch']} (max "
              f"{res[axis]['max_lsb_whole_batch']} LSB)"
              + ("" if own is None else
                 f", this rank's block bitwise the single-process engine on "
                 f"it: {res[axis]['bitwise_own_block']}")
              + f"; {res[axis]['mp_per_s']:.2f} MP/s", flush=True)
    with open(os.path.join(workdir, f"par_infer_{mesh.rank}.json"),
              "w") as fh:
        json.dump(res, fh)


def _nccl_world_of_one(card: str, workdir: str) -> dict:
    """``python -m pesr_torch.train --distributed --mesh_shape 1`` on NCCL
    at world size 1 (the ``PESR_*`` contract), against the same run
    without a process group: the logged L1 of every step bitwise."""
    args = ["-m", "pesr_torch.train", "--num_blocks", str(BLOCKS),
            "--num_channels", str(CHANNELS), "--scale", str(SCALE),
            "--batch_size", str(TRAIN_BATCH), "--patch_size",
            str(TRAIN_PATCH), "--steps_per_epoch", "3", "--num_epochs", "1",
            "--log_every", "1", "--eval_every", "0", "--train_dataset",
            "synthetic"]
    l1 = {}
    for name in ("nccl", "plain"):
        ck = os.path.join(workdir, f"nccl_{name}")
        argv = [sys.executable, *args, "--check_point", ck]
        if name == "nccl":
            out = _run_ranks(argv + ["--distributed", "--mesh_shape", "1"],
                             n=1, timeout=300)[0]
            if "distributed: process 0 of 1 (nccl)" not in out:
                fail("--distributed did not bring NCCL up at world size 1")
        else:
            subprocess.run(argv, check=True, timeout=300,
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           stdout=subprocess.DEVNULL)
        with open(os.path.join(ck, "pretrain.jsonl")) as fh:
            l1[name] = [json.loads(line)["l1"] for line in fh]
    same = l1["nccl"] == l1["plain"] and len(l1["plain"]) == 3
    print(f"[parallel] NCCL world size 1 vs no process group, L1 per step: "
          f"{l1['nccl']} vs {l1['plain']}: bitwise {same} [{card}]",
          flush=True)
    if not same:
        fail("the NCCL world-size-1 run's L1 differs from the plain run's")
    return l1


def phase_parallel(card: str, workdir: str) -> dict:
    """Multi-process runs on the one card: two gloo ranks (NCCL refuses two
    ranks on one device) over CUDA tensors on it, so no number here is a
    speed-up.  Flagship pretrain (folded) and GAN steps, 2 x 8 vs 1 x 16
    on the same global batches, under the step limits, with a planted
    fault that must break them; launches per step on each rank; NCCL at
    world size 1 through the train CLI; the tiles and batch engines on
    the two 336 x 510 images bitwise the single-process engine."""
    t0 = time.perf_counter()
    print(f"[parallel] {PAR_RANKS} gloo ranks on one card ({card}): "
          f"{PAR_STEPS} flagship steps each of pretrain (folded) and GAN "
          f"(chain, JAX defaults), global batch {TRAIN_BATCH} as "
          f"{PAR_RANKS} x {TRAIN_BATCH // PAR_RANKS}, against one process "
          f"x {TRAIN_BATCH}", flush=True)
    _run_ranks(_rank_argv(f"rank_train({workdir!r})"))
    t_train = time.perf_counter() - t0
    with open(os.path.join(workdir, "par_train.json")) as fh:
        res = json.load(fh)
    print(f"  D's tensors left out of cos_d (exact gradient 0): "
          f"{res['zero_grad_d']}", flush=True)
    for case in ("pretrain", "gan", "fault"):
        name = {"fault": f"gan with the planted fault ({PAR_FAULT})"
                }.get(case, case)
        for k, r in enumerate(res[case]):
            print(f"  {name}, step {k + 1}: " + ", ".join(
                f"{n} {v:.3e}" if isinstance(v, float) else f"{n} {v}"
                for n, v in r.items()), flush=True)
    for case in ("pretrain", "gan"):
        print(f"  {case} metrics: {res[case + ' metrics']}", flush=True)
    for case, want in (("pretrain", {"fused_resblock": BLOCKS,
                                     "fused_upsampler_stage": 0}),
                       ("gan", {"fused_resblock": BLOCKS,
                                "fused_upsampler_stage": 2})):
        if any(c != want for c in res["launches"][case]):
            fail(f"parallel {case}: launches per step on rank 0 "
                 f"{res['launches'][case]} != {want}")
    held = [(case, r) for case in ("pretrain", "gan") for r in res[case]]
    if not all(_par_within(case, r) for case, r in held):
        fail("the 2-rank steps disagree with the one-process steps")
    if _par_within("gan", res["fault"][0]):
        fail(f"the GAN limits pass the planted fault '{PAR_FAULT}'")
    t1 = time.perf_counter()
    nccl = _nccl_world_of_one(card, workdir)
    t_nccl = time.perf_counter() - t1
    t1 = time.perf_counter()
    print(f"[parallel] mesh_axis tiles and batch, folded flagship engine, "
          f"{N_IMAGES} LR images {LR_H}x{LR_W}, {PAR_RANKS} gloo ranks on "
          f"one card", flush=True)
    _run_ranks(_rank_argv(f"rank_infer({workdir!r})"))
    infer = []
    for r in range(PAR_RANKS):
        with open(os.path.join(workdir, f"par_infer_{r}.json")) as fh:
            infer.append(json.load(fh))
    for axis in ("tiles", "batch"):
        for r, res_r in enumerate(infer):
            a = res_r[axis]
            own = a["bitwise_own_block"]
            if not (a["bitwise_whole_batch"] or own):
                fail(f"mesh_axis {axis}: rank {r}'s canvas differs from the "
                     f"single-process engine's")
            per_fwd = {k: v / max(a["forwards"], 1)
                       for k, v in a["launches"].items()}
            if a["forwards"] < 1 or per_fwd != {"fused_resblock": BLOCKS,
                                                "fused_upsampler_stage": 0}:
                fail(f"mesh_axis {axis}: rank {r} launches {a['launches']} "
                     f"over {a['forwards']} forwards")
        print(f"  mesh_axis {axis}: {[x[axis]['mp_per_s'] for x in infer]} "
              f"MP/s per rank (two ranks share one card: not a speed-up) "
              f"[{card}]", flush=True)
    print(f"[parallel] phase took {time.perf_counter() - t0:.1f} s: "
          f"training check {t_train:.1f} s, NCCL world of one {t_nccl:.1f} "
          f"s, inference {time.perf_counter() - t1:.1f} s", flush=True)
    return {"train": res, "nccl": nccl, "infer": infer}


def serve_check(path: str, imgs_path: str, out_path: str) -> None:
    """In a fresh process that imports only ``pesr_torch.serving``: load
    the artifact, serve the saved images, write the output and the
    launches of the resblock op inside the program."""
    import numpy as np
    import pesr_torch.serving as serving
    up = serving.load_upscaler(path)
    from pesr_torch.ops import kernels   # imported by serving already
    imgs = np.load(imgs_path)
    up(imgs)                                   # first call: warm up
    kernels.reset_launch_counts()
    out = up(imgs)
    mods = sorted(m for m in sys.modules if m.startswith("pesr_torch."))
    np.save(out_path, out)
    with open(out_path + ".json", "w") as fh:
        json.dump({"launches": edsr_launch_counts(), "modules": mods}, fh)


def phase_serve(card: str, workdir: str) -> dict:
    """The serving artifact of the folded flagship engine at [2, 336, 510]:
    exported, loaded in a fresh process that imports only
    ``pesr_torch.serving`` (bitwise the live engine, 32 resblock launches
    per tile-batch forward inside the program), MP/s in turns with the
    live engine, a ``batch="any"`` artifact on a batch of 1, and an int8
    artifact bitwise its live engine (32 int8 block launches per
    forward inside it)."""
    import numpy as np
    import torch
    from pesr_torch.models.generator import Generator
    from pesr_torch.models.kernel_apply import KernelApply
    from pesr_torch.models.quant_apply import (default_calib_tiles,
                                               int8_inference)
    from pesr_torch.ops import kernels
    from pesr_torch.ops.tiling import BatchTiledUpscaler
    from pesr_torch.serving import export_upscaler, load_upscaler
    t0 = time.perf_counter()
    lrs = _div2k_sized_lrs()
    batch = np.stack(lrs)
    gen = Generator(SCALE, BLOCKS, CHANNELS, seed=0)
    ap = KernelApply(gen, fold=True)
    eng = BatchTiledUpscaler(ap, SCALE, "auto", 8)
    path = os.path.join(workdir, "flagship.pesr")
    t1 = time.perf_counter()
    meta = export_upscaler(eng, N_IMAGES, LR_H, LR_W, path,
                           precision_path="folded-bfloat16")
    t_export = time.perf_counter() - t1
    print(f"[serve] exported the folded flagship engine at [{N_IMAGES},"
          f"{LR_H},{LR_W}] in {t_export:.2f} s: {os.path.getsize(path)} "
          f"bytes, grid {meta['grid']}, platforms {meta['platforms']}",
          flush=True)
    live = eng.upscale_batch(batch)
    imgs_path = os.path.join(workdir, "serve_imgs.npy")
    out_path = os.path.join(workdir, "serve_out.npy")
    np.save(imgs_path, batch)
    subprocess.run(_rank_argv(f"serve_check({path!r}, {imgs_path!r}, "
                              f"{out_path!r})"), check=True, timeout=300,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    got = np.load(out_path)
    with open(out_path + ".json") as fh:
        info = json.load(fh)
    forwards = meta["grid"]["nh"] * meta["grid"]["nw"]
    want = {"fused_resblock": BLOCKS * forwards, "fused_upsampler_stage": 0}
    model_code = [m for m in info["modules"] if m.startswith(
        ("pesr_torch.models", "pesr_torch.training", "pesr_torch.config"))]
    print(f"  fresh process (imports only pesr_torch.serving): output "
          f"bitwise the live engine's: {np.array_equal(got, live)}; "
          f"launches inside the artifact {info['launches']} over {forwards} "
          f"tile-batch forward(s) (expected {want}); model modules loaded: "
          f"{model_code}", flush=True)
    if not np.array_equal(got, live):
        fail("the loaded artifact's output differs from the live engine's")
    if info["launches"] != want or model_code:
        fail("the artifact did not run the resblock kernel as the engine "
             "does, or needed model code")
    served = load_upscaler(path)
    mp = N_IMAGES * LR_H * LR_W * SCALE * SCALE / 1e6
    times = {"artifact": [], "engine": []}
    for _ in range(2):
        served(batch)
        eng.upscale_batch(batch)
    for _ in range(4):
        for name, fn in (("artifact", served), ("engine", eng.upscale_batch)):
            t1 = time.perf_counter()
            fn(batch)
            times[name].append(time.perf_counter() - t1)
    rates = {k: mp / min(v) for k, v in times.items()}
    print(f"  MP/s in turns (best of 4, host transfers included): artifact "
          f"{rates['artifact']:.2f}, live engine {rates['engine']:.2f} "
          f"[{card}]", flush=True)
    dyn = os.path.join(workdir, "any.pesr")
    export_upscaler(eng, "any", LR_H, LR_W, dyn, trace_batch=N_IMAGES)
    one = load_upscaler(dyn)(batch[:1])
    with resblock_shapes() as shapes:
        ok_dyn = np.array_equal(one, eng.upscale_batch(batch[:1]))
    print(f"  batch=\"any\" artifact (grid for trace_batch {N_IMAGES}) on a "
          f"batch of 1: bitwise the live engine's: {ok_dyn}; the engine's "
          f"resblock inputs {sorted(shapes)}, held to the plain version:",
          flush=True)
    hold_resblock_at(shapes, seed=80)
    if not ok_dyn:
        fail('the batch="any" artifact differs from the live engine')
    del served
    torch.cuda.empty_cache()
    eng8 = BatchTiledUpscaler(int8_inference(gen, default_calib_tiles(lrs)),
                              SCALE, "auto", 8)
    p8 = os.path.join(workdir, "int8.pesr")
    meta8 = export_upscaler(eng8, N_IMAGES, LR_H, LR_W, p8,
                            precision_path="int8-w8a8")
    served8 = load_upscaler(p8)
    served8(batch)                             # first call: warm up
    kernels.reset_launch_counts()
    got8 = served8(batch)
    launches8 = {**edsr_launch_counts(),
                 "fused_resblock_int8": kernels.fused_resblock_int8.launches}
    fwd8 = meta8["grid"]["nh"] * meta8["grid"]["nw"]
    want8 = {"fused_resblock": 0, "fused_upsampler_stage": 0,
             "fused_resblock_int8": BLOCKS * fwd8}
    ok8 = np.array_equal(got8, eng8.upscale_batch(batch))
    print(f"  int8 artifact bitwise its live engine: {ok8}; launches inside "
          f"the program {launches8} over {fwd8} tile-batch forward(s) "
          f"(expected {want8})", flush=True)
    if not ok8:
        fail("the int8 artifact differs from its live engine")
    if launches8 != want8:
        fail("the int8 artifact did not run the int8 block kernel once per "
             "block")
    print(f"[serve] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"rates": rates, "launches": info["launches"],
            "forwards": forwards, "export_s": t_export,
            "int8_launches": launches8, "int8_forwards": fwd8}


def phase_fit(workdir: str) -> dict:
    """The PI model fitters on the card's host (numpy and scipy, no
    scikit-learn; no kernel): ``fit_ma.main`` at its defaults must write
    every array of the packaged ``ma_model_synthetic.npz`` bitwise and
    exit 0 (4/4 held-out orderings), with the seconds of its feature
    extraction and of its forests; then ``fit_natural.main``, which
    refuses below 4 registry photographs (as the JAX package does) and
    otherwise validates on the holdouts."""
    import importlib.util

    from pesr_torch.data import natural
    from pesr_torch.metrics import fit_ma, fit_natural
    from pesr_torch.metrics.ma_features import MaModel
    t0 = time.perf_counter()
    has_sklearn = importlib.util.find_spec("sklearn") is not None
    print(f"[fit] scikit-learn importable on this machine: {has_sklearn} "
          "(the port's forest does not use it)", flush=True)
    seconds = {}
    originals = {"features_s": fit_ma.build_training_set,
                 "forests_s": fit_ma.fit_forests}

    def timed(key, fn):
        def run(*args, **kw):
            t1 = time.perf_counter()
            out = fn(*args, **kw)
            seconds[key] = time.perf_counter() - t1
            return out
        return run

    out = os.path.join(workdir, "ma_model_synthetic.npz")
    fit_ma.build_training_set = timed("features_s",
                                      originals["features_s"])
    fit_ma.fit_forests = timed("forests_s", originals["forests_s"])
    try:
        rc = fit_ma.main(["--out", out])
    finally:
        fit_ma.build_training_set = originals["features_s"]
        fit_ma.fit_forests = originals["forests_s"]
    ma_s = time.perf_counter() - t0
    got = MaModel.load(out).arrays
    want = MaModel.load(os.path.join(REPO, "pesr_torch", "metrics",
                                     "ma_model_synthetic.npz")).arrays
    keys = sorted(set(want) - {"provenance"})
    differ = [k for k in keys if k not in got
              or got[k].dtype != want[k].dtype
              or got[k].tobytes() != want[k].tobytes()]
    print(f"  fit_ma.main(['--out', ...]) at its defaults: rc {rc}; "
          f"{len(keys) - len(differ)}/{len(keys)} arrays bitwise the "
          f"packaged ma_model_synthetic.npz; features "
          f"{seconds['features_s']:.2f} s, forests {seconds['forests_s']:.2f}"
          f" s, whole call {ma_s:.2f} s", flush=True)
    if rc != 0:
        fail("fit_ma.main exited non-zero (held-out ordering)")
    if differ or set(got) - {"provenance"} != set(keys):
        fail(f"the refit Ma model differs from the packaged one: {differ}")
    n_images = len(natural.load_natural_images())
    t1 = time.perf_counter()
    argv = ["--niqe_out", os.path.join(workdir, "niqe_model_natural.npz"),
            "--ma_out", os.path.join(workdir, "ma_model_natural.npz")]
    try:
        nat_rc = fit_natural.main(argv)
        refusal = None
    except SystemExit as e:
        refusal = str(e)
        if n_images >= 4 or not refusal.startswith(
                f"only {n_images} curated natural images found"):
            raise
        nat_rc = None
    nat_s = time.perf_counter() - t1
    if refusal is not None:
        print(f"  fit_natural.main: {n_images} registry photograph(s) "
              f"here; refused as expected: {refusal!r}", flush=True)
    else:
        print(f"  fit_natural.main on {n_images} registry photographs: rc "
              f"{nat_rc} ({nat_s:.1f} s; holdout orderings above)",
              flush=True)
        if nat_rc != 0:
            fail("fit_natural's holdout orderings failed")
    res = {"sklearn_importable": has_sklearn, "features_s": seconds[
        "features_s"], "forests_s": seconds["forests_s"], "fit_ma_s": ma_s,
        "arrays_bitwise": len(keys), "natural_images": n_images,
        "natural_refused": refusal is not None, "natural_rc": nat_rc,
        "natural_s": nat_s}
    print(f"[fit] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return res


# The bench phase's scale sweep (BENCH_SCALE, BENCH_FOLD, BENCH_IMAGES):
# x2, x3, x6 and x8 on both paths, then x4 on the bf16 chain, the one
# bench path that runs fused_upsampler_stage.  Two images, best of two
# passes; then each at bench.py's batch of eight, one pass, for the grid
# the auto chooser takes and the peak memory there (x4 folded too, whose
# speed the defaults' subprocess measures).
BENCH_SWEEP = tuple((s, "1", ("2", "8")) for s in (2, 3, 6, 8)) + (
    (4, "0", ("2", "8")), (4, "1", ("8",)))
BENCH_SWEEP_REPEATS = {"2": "2", "8": "1"}
BENCH_KEYS = {"metric", "value", "unit", "precision", "vs_baseline", "paths"}


def _bench_line(out: str, what: str) -> dict:
    """The one JSON line of a ``pesr_torch.bench`` run's stdout."""
    lines = [x for x in out.splitlines() if x.startswith("{")]
    if len(lines) != 1:
        fail(f"{what}: {len(lines)} JSON lines, not one")
    return json.loads(lines[0])


def _bench_expected(scale: int, path: str, fold: bool, forwards: int
                    ) -> dict:
    """The launches a bench path makes over ``forwards`` generator
    forwards: 32 int8 blocks (int8), 32 resblocks and on the chain one
    upsampler stage per x2 factor (bf16)."""
    from pesr_torch.scales import upsample_stages
    if path == "int8-w8a8":
        return {"fused_resblock": 0, "fused_upsampler_stage": 0,
                "fused_resblock_int8": BLOCKS * forwards}
    stages = 0 if fold else sum(f == 2 for f in upsample_stages(scale))
    return {"fused_resblock": BLOCKS * forwards,
            "fused_upsampler_stage": stages * forwards,
            "fused_resblock_int8": 0}


def _bench_sweep(card: str) -> dict:
    """The sweep of BENCH_SWEEP in this process through
    ``pesr_torch.bench.run``: MP/s, grid, launches (each path's own,
    checked against :func:`_bench_expected`) and peak memory per path,
    then each kernel held to its plain version at every input shape the
    sweep handed it (the int8 block bitwise)."""
    import torch
    from pesr_torch import bench
    runs = {}
    with kernel_shapes() as shapes:
        for scale, fold, counts in BENCH_SWEEP:
            for images in counts:
                env = {"BENCH_SCALE": str(scale), "BENCH_FOLD": fold,
                       "BENCH_IMAGES": images,
                       "BENCH_REPEATS": BENCH_SWEEP_REPEATS[images]}
                if fold == "0":
                    env.update(BENCH_QUANT="none", BENCH_PATHS="bf16")
                record, details = bench.run("cuda", env)
                for path, d in details.items():
                    key = (f"x{scale} {path}{' chain' if fold == '0' else ''}"
                           f" {images} images")
                    want = _bench_expected(scale, path, fold == "1",
                                           d["forwards"])
                    r = runs[key] = {
                        "mp_per_s": record["paths"][path]["value"],
                        "seconds": d["seconds"], "grid": list(d["grid"]),
                        "forwards": d["forwards"], "launches": d["launches"],
                        "peak_gb": d["peak_bytes"] / 1e9}
                    print(f"  {key}: {r['mp_per_s']:.3f} MP/s, grid (nh, nw,"
                          f" th, tw) {r['grid']}, {r['forwards']} forwards, "
                          f"launches {r['launches']}, peak "
                          f"{r['peak_gb']:.2f} GB [{card}]", flush=True)
                    if d["launches"] != want:
                        fail(f"bench {key}: launches {d['launches']} != "
                             f"{want}")
    held = {
        "fused_resblock": hold_resblock_at(shapes["fused_resblock"], 90),
        "fused_upsampler_stage": [
            check_upsampler(*shape, seed=95 + i)["max_abs_err"]
            for i, shape in enumerate(sorted(
                shapes["fused_upsampler_stage"]))],
        "fused_resblock_int8": [
            check_int8_block(card, *shape, seed=97 + i)["max_abs_err"]
            for i, shape in enumerate(sorted(
                shapes["fused_resblock_int8"]))]}
    torch.cuda.empty_cache()
    return {"runs": runs, "held": held,
            "shapes": {k: sorted(v) for k, v in shapes.items()}}


def bench_keys(bench_res: dict, name: str) -> dict:
    """A kernel's keys of the bench phase for the kernels line: its
    launches on each sweep path that ran it, and its largest error
    against its plain version at the shapes the sweep handed it."""
    launches = {k: r["launches"][name] for k, r in bench_res["runs"].items()
                if r["launches"][name]}
    if not launches:
        fail(f"no bench path of the sweep launched {name}")
    return {"bench_launches": launches,
            "bench_shapes": bench_res["shapes"][name],
            "bench_max_abs_err": max(bench_res["held"][name])}


def check_rcab_at(shape, dev, g) -> tuple:
    """``fused_rcab`` (first block of a group, and with the block before
    pending) and ``rcab_excite`` at ``shape`` [B, H, W], C = 64, against
    their plain versions; the schedule and its steps (``rcab_work``), and
    one wave a launch.  -> (results, the operands for timing)."""
    import torch
    import torch.nn.functional as F
    from pesr_torch.ops.kernels import rcab as K
    from pesr_torch.ops.kernels.resblock import pack_resblock
    b, h, w = shape
    c = RCAN_CHANNELS

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    # conv kernels at variance 1 / fan_in; a squeeze whose s spreads over
    # (0, 1) (not ~0.5 everywhere), on partial sums of an O(1) branch
    c1w, c2w = rnd(c, c, 3, 3, scale=1 / 24), rnd(c, c, 3, 3, scale=1 / 24)
    c1b, c2b = rnd(c, scale=0.1), rnd(c, scale=0.1)
    convs = pack_resblock(c1w, c1b, c2w, c2b)
    sq = K.pack_squeeze(rnd(c // 16, c, 1, 1, scale=0.3),
                        rnd(c // 16, scale=0.1),
                        rnd(c, c // 16, 1, 1, scale=0.5), rnd(c, scale=0.1))
    hh, rr = rnd(b, h, w, c).bfloat16(), rnd(b, h, w, c).bfloat16()
    clusters = K._max_clusters(dev)
    sched = K.rcab_schedule(b, h, w, clusters)
    work = K.rcab_work(b, h, w, clusters)
    parts = sched.pool_rows
    pool = rnd(b, parts, c, scale=h * w / parts)
    s = K.squeeze_excite(pool, h * w, *sq)[:, None, None]
    # one bf16 ulp of h + s r (s is summed in another order)
    ulp = (hh.float().abs() + (s * rr.float()).abs()) * 2.0 ** -7
    res = {"shape": [b, h, w, c], "clusters": clusters,
           "schedule": {"ctas": sched.ctas, "strips": sched.strips,
                        "steps": sched.steps, "pool_rows": parts,
                        "critical": sched.critical},
           "work": dict(zip(("ctas", "waves", "critical_steps",
                             "computed_steps", "useful_steps"), work))}
    print(f"[rcan] fused_rcab at [{b},{h},{w},{c}] on {clusters} clusters: "
          f"schedule {res['schedule']}, rcab_work {res['work']}, segments "
          f"per CTA {min(map(len, sched.segments))}.."
          f"{max(map(len, sched.segments))}", flush=True)
    for pending in (False, True):
        what = "pending block" if pending else "first block"
        launches, waves = K.fused_rcab.launches, K.fused_rcab.waves
        x, rn, pn = K.fused_rcab(hh, rr if pending else None,
                                 pool if pending else None, *sq, *convs)
        torch.cuda.synchronize()
        if (K.fused_rcab.launches - launches, K.fused_rcab.waves - waves) \
                != (1, 1):
            fail(f"fused_rcab ({what}): not one wave a launch")
        want_x = K.excite_reference(hh, rr, pool, *sq) if pending else hh
        dx = (x.float() - want_x.float()).abs()
        print(f"  fused_rcab ({what}) x: max|d| {float(dx.max()):.4g}, "
              f"within one bf16 ulp of h + s r: "
              f"{bool((dx <= ulp).all())}", flush=True)
        if not (dx <= ulp).all():
            fail(f"fused_rcab ({what}): x is not h + s r")
        t = torch.relu(F.conv2d(x.float().permute(0, 3, 1, 2),
                                c1w.bfloat16().float(), convs[1],
                                padding=1))
        want = F.conv2d(t.bfloat16().float(), c2w.bfloat16().float(),
                        convs[3], padding=1).permute(0, 2, 3, 1)
        res[f"r_{'pending' if pending else 'first'}"] = compare(
            f"fused_rcab ({what}) r", rn, want)
        total = want.sum((1, 2))
        dp = float((pn.sum(1) - total).abs().max() / total.abs().max())
        print(f"  fused_rcab ({what}) pooled sums: max|d| / max|sum| "
              f"{dp:.3g} (pass <= 1e-4)", flush=True)
        if not dp <= 1e-4:
            fail(f"fused_rcab ({what}): pooled sums disagree")
    e = K.rcab_excite(hh, rr, pool, *sq)
    de = (e.float() - K.excite_reference(hh, rr, pool, *sq).float()).abs()
    print(f"  rcab_excite: max|d| {float(de.max()):.4g}, within one bf16 "
          f"ulp: {bool((de <= ulp).all())}", flush=True)
    if not (de <= ulp).all():
        fail("rcab_excite is not h + s r")
    res["max_abs_err"] = res["r_pending"]["max_abs_err"]
    res["excite_max_abs_err"] = float(de.max())
    return res, (hh, rr, pool, s, sq, convs, c1w, c2w, c1b, c2b)


def check_rcab(card: str) -> dict:
    """:func:`check_rcab_at` at ``RCAN_RAGGED`` and the tile batch
    ``RCAN_TILE``, then the times at ``RCAN_TILE``."""
    import torch
    import torch.nn.functional as F
    from pesr_torch.ops.kernels import rcab as K
    from pesr_torch.ops.kernels.resblock import unpack_resblock
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(64)
    ragged, _ = check_rcab_at(RCAN_RAGGED, dev, g)
    res, ops = check_rcab_at(RCAN_TILE, dev, g)
    res["ragged"] = ragged
    hh, rr, pool, s, sq, convs, c1w, c2w, c1b, c2b = ops
    b, h, w, c = res["shape"]

    # library yardstick: the same block in cuDNN bf16 convs (channels
    # last) and torch's excite and pool
    w1l, w2l = (t.bfloat16().contiguous(memory_format=torch.channels_last)
                for t in (c1w, c2w))
    b1h, b2h = c1b.bfloat16(), c2b.bfloat16()

    def library():
        xl = (hh.float() + s * rr.float()).bfloat16().permute(0, 3, 1, 2)
        y = F.conv2d(F.relu(F.conv2d(xl, w1l, b1h, padding=1)), w2l, b2h,
                     padding=1)
        return y, y.float().sum((2, 3))

    hf, rf = hh.float(), rr.float()
    plain_convs = [t.float() for t in unpack_resblock(*convs)]
    res["time"] = timed_ms(lambda: K.fused_rcab(hh, rr, pool, *sq, *convs),
                           10)
    res["first"] = timed_ms(lambda: K.fused_rcab(hh, None, None, *sq,
                                                 *convs), 10)
    res["excite"] = timed_ms(lambda: K.rcab_excite(hh, rr, pool, *sq), 10)
    res["plain"] = timed_ms(lambda: K.rcab_reference(
        hf, rf, pool, *sq, *plain_convs), 1, 5, 1)
    res["library"] = timed_ms(library, 10, 5)
    for k in ("time", "first", "excite", "plain", "library"):
        res[f"{k}_ms" if k != "time" else "ms"] = res[k]["ms"]
    px = b * h * w
    # fused_resblock's yardstick at C = 64: two convs at the bf16 peak, or
    # the carry read and written once and the weights once
    res["bound_ms"], res["bound_by"] = bound(
        4 * 9 * c * c * px, 2 * px * c * 2 + 2 * 9 * c * c * 2 + 2 * c * 4)
    print_time("fused_rcab (pending block)", res, card,
               "'plain' the f32 plain version, 'library' cuDNN bf16 convs "
               "and torch's pool and excite")
    print(f"  fused_rcab (first block) {res['first_ms']:.4f} ms, "
          f"rcab_excite {res['excite_ms']:.4f} ms  [{card}]", flush=True)
    return res


def rcan_model(seed: int):
    """RCAN x4 at ``RCAN_GROUPS`` x ``RCAN_BLOCKS`` x ``RCAN_CHANNELS`` on
    the card, the port's init from ``seed``, the last conv of every
    residual branch scaled by ``RCAN_BRANCH_GAIN``."""
    import torch
    from pesr_torch.models.rcan import RCAN
    net = RCAN(4, RCAN_GROUPS, RCAN_BLOCKS, RCAN_CHANNELS, device="cuda",
               seed=seed)
    ends = [blk.body[2] for grp in net.body[:-1] for blk in grp.body[:-1]]
    ends += [grp.body[-1] for grp in net.body[:-1]] + [net.body[-1]]
    with torch.no_grad():
        for m in ends:
            m.weight.mul_(RCAN_BRANCH_GAIN)
            m.bias.mul_(RCAN_BRANCH_GAIN)
    return net


def phase_rcan(card: str) -> dict:
    """RCAN's kernels at the engine's tile batch, then one tile batch
    through ``RCANKernelApply``: launches, output, time."""
    import torch
    from pesr_torch.models.rcan_apply import RCANKernelApply
    from pesr_torch.ops import kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"fused_rcab": check_rcab(card)}
    b, h, w = RCAN_TILE
    print(f"[rcan] RCANKernelApply, {RCAN_GROUPS} x {RCAN_BLOCKS} x "
          f"{RCAN_CHANNELS}, x4, on one tile batch [{b},{h},{w}]",
          flush=True)
    net = rcan_model(seed=5)
    apply_fn = RCANKernelApply(net)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand(b, h, w, 3, generator=g, device="cuda") * 2 - 1
    apply_fn(x)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    y = apply_fn(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    got = {k: counts[k] for k in ("fused_rcab", "rcab_excite")}
    want = {"fused_rcab": RCAN_GROUPS * RCAN_BLOCKS,
            "rcab_excite": RCAN_GROUPS}
    waves = kernels.fused_rcab.waves
    print(f"  launches per forward {got} (expected {want}), fused_rcab "
          f"waves / launches {waves / max(1, got['fused_rcab'])}", flush=True)
    if got != want or waves != got["fused_rcab"]:
        fail(f"RCANKernelApply: launch counts {got} != {want}, or "
             f"{waves} waves")
    with torch.no_grad():
        ref = net(x)
    k = 4 * apply_fn.min_halo  # the fold is exact inside this HR border
    d = (127.5 * (y - ref))[:, k:-k, k:-k].abs()
    rms, worst = float(d.pow(2).mean().sqrt()), float(d.max())
    print(f"  apply (bf16) vs plain RCAN (f32) inside a {k} px border: rms "
          f"{rms:.4f} LSB, max {worst:.4f} LSB, "
          f"{100 * float((d > 1.5).float().mean()):.4f}% off by > 1.5 LSB "
          f"(pass: rms <= {RCAN_RMS_LSB}, max <= {RCAN_MAX_LSB})",
          flush=True)
    if not (rms <= RCAN_RMS_LSB and worst <= RCAN_MAX_LSB):
        fail("RCANKernelApply disagrees with the plain RCAN")
    t = timed_ms(lambda: apply_fn(x), 1, 5, 1)
    print(f"  apply: {t['ms']:.3f} ms per tile batch [min {t['min']:.3f}, "
          f"max {t['max']:.3f}]  [{card}]", flush=True)
    res.update(launches=got, apply_rms_lsb=rms, apply_max_lsb=worst,
               apply_ms=t["ms"])
    del apply_fn, net
    torch.cuda.empty_cache()
    return res


def phase_bench(card: str) -> dict:
    """The port's headline benchmark, ``python -m pesr_torch.bench``
    (bench.py's contract): at its defaults in a subprocess (its JSON line
    with the card beside it; bench.py's keys); the scale sweep
    (:func:`_bench_sweep`); ``BENCH_MESH=2`` as two gloo ranks on the one
    card (one line, from rank 0, with the mesh keys)."""
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    out = subprocess.run([sys.executable, "-m", "pesr_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=400)
    for line in out.stderr.rstrip().splitlines():
        print(f"  {line}", flush=True)
    if out.returncode != 0:
        fail(f"python -m pesr_torch.bench exited {out.returncode}")
    defaults = _bench_line(out.stdout, "python -m pesr_torch.bench")
    if (set(defaults) != BENCH_KEYS
            or set(defaults["paths"]) != {"int8-w8a8", "bf16"}
            or defaults["metric"] != "tiled_x4_inference_throughput"
            or defaults["precision"] != "int8-w8a8"):
        fail(f"python -m pesr_torch.bench printed a malformed line: "
             f"{defaults}")
    t_defaults = time.perf_counter() - t0
    print(f"[bench] python -m pesr_torch.bench at its defaults (x4, 8 "
          f"images 510 x 336, 32 x 256, best of 5): {json.dumps(defaults)} "
          f"[{card}]", flush=True)
    t1 = time.perf_counter()
    print("[bench] scale sweep in this process: 2 images, best of 2 "
          "passes, then 8 images, one pass", flush=True)
    sweep = _bench_sweep(card)
    t_sweep = time.perf_counter() - t1
    t1 = time.perf_counter()
    mesh_env = {"BENCH_MESH": "2", "BENCH_IMAGES": "2", "BENCH_REPEATS": "1"}
    print(f"[bench] {mesh_env} as {PAR_RANKS} gloo ranks on one card "
          f"(semantics, not speed)", flush=True)
    outs = _run_ranks([sys.executable, "-m", "pesr_torch.bench"],
                      timeout=400, env=mesh_env)
    mesh = _bench_line("".join(outs), "BENCH_MESH=2")
    if (len([x for x in outs[0].splitlines() if x.startswith("{")]) != 1
            or set(mesh) != BENCH_KEYS | {"mesh_devices",
                                          "mesh_total_mps_headline"}
            or mesh["mesh_devices"] != 2
            or mesh["mesh_total_mps_headline"] != round(
                2 * mesh["value"], 3)):
        fail(f"BENCH_MESH=2: malformed line or not from rank 0: {mesh}")
    print(f"  BENCH_MESH=2 line: {json.dumps(mesh)} [{card}]", flush=True)
    print(f"[bench] phase took {time.perf_counter() - t0:.1f} s: defaults "
          f"{t_defaults:.1f} s, sweep {t_sweep:.1f} s, mesh "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    return {"defaults": defaults, "mesh": mesh, **sweep}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of pesr_torch on "
                                 "one GPU")
    ap.add_argument("--int8-first-form", metavar="DIR",
                    help="a checkout holding the int8 block kernel's first "
                    "form (weights in natural output-channel order), to "
                    "build and time in turns with the port's")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 2
    try:
        import pesr_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a pesr-tpu checkout "
              "(pesr_torch not found)", file=sys.stderr)
        return 2

    card = phase_build(args.int8_first_form)
    print(card, flush=True)
    ker = phase_kernels(card)
    main_res = phase_main(card)
    with tempfile.TemporaryDirectory() as workdir:
        train_res = phase_train(card, workdir)
        gan_res = phase_gan(card, train_res["best"], workdir)
        fold_res = phase_fold(card, main_res["mp_per_s"],
                              train_res["steps_per_s"], workdir)
        phase_qat(card, workdir)
        quant_res = phase_quant(card, train_res["best"], workdir)
        data_res = phase_data(card, workdir)
        par_res = phase_parallel(card, workdir)
        serve_res = phase_serve(card, workdir)
        fit_res = phase_fit(workdir)
    bench_res = phase_bench(card)
    rcan_res = phase_rcan(card)
    sources = {"fused_resblock": ("pesr_torch/csrc/resblock.cu",
                                  "pesr_tpu/ops/pallas/resblock.py:96"),
               "fused_upsampler_stage": ("pesr_torch/csrc/upsampler.cu",
                                         "pesr_tpu/ops/pallas/upsampler.py:95")}
    # the folded path's tile batch reaches the resblock kernel only
    fold_rb = fold_res["inference"]["resblock"]
    fold_keys = {name: {f"fold_{k}": (fold_rb[k] if name == "fused_resblock"
                                      else None)
                        for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "library_ms")}
                 for name in sources}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_res["launches"][name],
         "max_abs_err": ker[name]["max_abs_err"], "ms": ker[name]["ms"],
         "plain_ms": ker[name]["plain_ms"],
         "bound_ms": ker[name]["bound_ms"],
         "bound_by": ker[name]["bound_by"],
         "library_ms": ker[name]["library_ms"],
         "train_launches_per_step": train_res["launches_per_step"][name],
         "train_ms": train_res[name]["ms"],
         "train_bound_ms": train_res[name]["bound_ms"],
         "train_library_ms": train_res[name]["library_ms"],
         "gan_launches_per_step": gan_res["launches_per_step"][name],
         "fold_launches": fold_res["inference"]["launches"][name],
         **fold_keys[name],
         **{f"eval_{k}": train_res["eval"][name][k]
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                      "library_ms")},
         "eval_launches": train_res["eval"]["launches"][name],
         "int8_launches": quant_res["int8_launches"][name],
         "synthetic_device_launches_per_step":
             data_res["device_run"]["launches_per_step"][name],
         "f32_train_launches": data_res["f32_launches"][name],
         "bf16_param_launches_per_step":
             data_res["bf16_param_launches_per_step"][name],
         "ddp_launches_per_rank_per_step": {
             c: par_res["train"]["launches"][c][0][name]
             for c in ("pretrain", "gan")},
         "spatial_launches_per_rank": [
             r["tiles"]["launches"][name] for r in par_res["infer"]],
         "artifact_launches_per_forward":
             serve_res["launches"][name] / serve_res["forwards"],
         "train_rows": [r for r in train_res["rows"]
                        if r["kernel"].startswith(name)],
         **bench_keys(bench_res, name)}
        for name, (src, rep) in sources.items()]}
    # The int8 block replaces XLA's fusion of JAX's int8 body_fn (no
    # pallas_call); its path is the quant phase's int8 engine run.
    blk = quant_res["int8_block"]
    line["kernels"].append({
        "name": "fused_resblock_int8", "route": "cuda",
        "source": "pesr_torch/csrc/resblock_int8.cu",
        "replaces": "pesr_tpu/models/quant_apply.py:235",
        "launches": quant_res["int8_block_launches"],
        "max_abs_err": blk["x4"]["max_abs_err"], "ms": blk["x4"]["ms"],
        "plain_ms": blk["x4"]["plain_ms"], "bound_ms": blk["x4"]["bound_ms"],
        "bound_by": blk["x4"]["bound_by"],
        "library_ms": blk["x4"]["library_ms"],
        "shape": blk["x4"]["shape"],
        "int8_forwards": quant_res["int8_forwards"],
        "x8_max_abs_err": blk["x8"]["max_abs_err"],
        "planted_fault_values_differ": quant_res["block_fault"][
            "fault_differ"],
        "turns_ms": ({k: v["ms"] for k, v in blk["x4"]["turns"].items()}
                     if blk["x4"]["turns"] else None),
        "artifact_launches_per_forward":
            serve_res["int8_launches"]["fused_resblock_int8"]
            / serve_res["int8_forwards"],
        **bench_keys(bench_res, "fused_resblock_int8")})
    rb = rcan_res["fused_rcab"]
    line["kernels"] += [
        {"name": "fused_rcab", "route": "cuda",
         "source": "pesr_torch/csrc/rcab.cu", "replaces": None,
         "launches": rcan_res["launches"]["fused_rcab"],
         "max_abs_err": rb["max_abs_err"], "ms": rb["ms"],
         "first_block_ms": rb["first_ms"], "plain_ms": rb["plain_ms"],
         "bound_ms": rb["bound_ms"], "bound_by": rb["bound_by"],
         "library_ms": rb["library_ms"], "shape": rb["shape"],
         "apply_rms_lsb": rcan_res["apply_rms_lsb"],
         "apply_max_lsb": rcan_res["apply_max_lsb"],
         "apply_ms": rcan_res["apply_ms"]},
        {"name": "rcab_excite", "route": "cuda",
         "source": "pesr_torch/csrc/rcab.cu", "replaces": None,
         "launches": rcan_res["launches"]["rcab_excite"],
         "max_abs_err": rb["excite_max_abs_err"], "ms": rb["excite_ms"],
         "shape": rb["shape"]}]
    conv = quant_res["conv"]
    print(f"int8 tail conv and x8 int8 upfold (library route, torch._int_mm;"
          f" not a kernel port): {conv['ms']:.3f} ms at the x4 tail shape, "
          f"bound {conv['bound_ms']:.3f} ms; x8 upfold "
          f"{quant_res['upfold_conv']['ms']:.3f} ms, bound "
          f"{quant_res['upfold_conv']['bound_ms']:.3f} ms", flush=True)
    print(json.dumps({"fit": fit_res}), flush=True)
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
