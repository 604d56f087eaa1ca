#!/usr/bin/env python3
"""Smoke run of the pesr_torch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build   -- compile every CUDA kernel of ``pesr_torch/csrc`` with nvcc
              (set-up), print ptxas' registers / spills and the SASS
              evidence (counts of HGMMA, TMA and SYNCS instructions from
              cuobjdump; a library without HGMMA or TMA loads fails, and
              so does one whose wgmma ptxas serialized), print the
              card's name and power limit.
2. kernels -- each kernel against its plain PyTorch version (f32, TF32
              off, same bf16-rounded inputs): ragged shapes at the edges
              of the kernels' decompositions, C = 64, 128, 256, then the
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

Prints a ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or pesr_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

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


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


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
                                                 resblock_schedule)
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
    px = bsz * h * w
    res["bound_ms"], res["bound_by"] = bound(
        4 * 9 * c * c * px, 2 * px * c * 2 + 2 * 9 * c * c * 2 + 2 * c * 4)
    # Weight bytes L2 serves per launch: every cluster streams both convs'
    # weights once per conv pass (rows / 2 + 1 conv1 + rows / 2 conv2).
    sched = resblock_schedule(bsz, h, w, _max_clusters(c, x.device))
    res["schedule"] = sched
    res["weight_l2_bytes"] = (sched.ctas // CLUSTER * (sched.rows + 1)
                              * 9 * c * c * 2)
    return res


def check_upsampler(bsz, h, w, c, seed, timing=False) -> dict:
    import torch
    import torch.nn.functional as F
    from pesr_torch.ops.kernels import (fused_upsampler_stage,
                                        pack_upsampler_stage,
                                        upsampler_stage_reference)
    from pesr_torch.ops.kernels.upsampler import (_max_clusters,
                                                  upsampler_schedule)
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
    px = bsz * h * w
    res["bound_ms"], res["bound_by"] = bound(
        2 * 9 * c * 4 * c * px,
        px * c * 2 + 4 * px * c * 2 + 9 * c * 4 * c * 2 + 4 * c * 4)
    # Weight bytes L2 serves per launch: one 256-column slice (9 x C x 256
    # bf16) per cluster tile.
    sched = upsampler_schedule(bsz, h, w, c, _max_clusters(x.device))
    res["schedule"] = sched
    res["weight_l2_bytes"] = sched.tiles * 9 * c * 256 * 2
    return res


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "UBLKCP", "SYNCS")


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


def phase_build() -> str:
    from pesr_torch.ops.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    print(f"[build] {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{', '.join(str(p) for p in libs.values())}", flush=True)
    for name, lib in libs.items():
        counts = sass_counts(lib)
        serial = build.LOGS.get(name, "").count("C7512")
        print(f"[build] SASS of lib{name}.so: {counts}; kernels whose wgmma "
              f"ptxas serialized (C7512): {serial}", flush=True)
        if counts["HGMMA"] == 0 or counts["UTMALDG"] == 0:
            fail(f"lib{name}.so has no wgmma (HGMMA) or no TMA load "
                 f"(UTMALDG) in its SASS")
        # ptxas serializes wgmma when the consumers run out of registers:
        # the kernels still agree, but lose their asynchronous mainloop.
        if serial:
            fail(f"ptxas serialized the wgmma of {serial} kernel(s) of "
                 f"lib{name}.so (C7512)")
    return gpu_name_power()


def main_path_tile_batch():
    """The tile batch (images, tile rows, tile cols; halo included) and
    the grid (nh, nw, th, tw) the engine's auto chooser gives N_IMAGES
    images of LR_H x LR_W: the shapes the main path hands the kernels."""
    from pesr_torch.ops.tiling import BatchTiledUpscaler
    eng = BatchTiledUpscaler(lambda x: x, SCALE, "auto", 8)
    nh, nw, th, tw = eng.grid(N_IMAGES, LR_H, LR_W)
    return (N_IMAGES, th + 2 * eng._ov_for(nh), tw + 2 * eng._ov_for(nw)), \
        (nh, nw, th, tw)


def phase_kernels(card: str) -> dict:
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pesr_torch.ops.kernels.resblock import resblock_schedule
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
    (b, th, tw), grid = main_path_tile_batch()
    print(f"[kernels] main-path shapes: tile batch [{b},{th},{tw}] "
          f"(grid nh,nw,th,tw = {grid}), C = {CHANNELS}, on {card}",
          flush=True)
    rb = check_resblock(b, th, tw, CHANNELS, 0.1, seed=1, timing=True)
    check_resblock(b, th, tw, CHANNELS, 1.0, seed=2)
    up1 = check_upsampler(b, th, tw, CHANNELS, seed=3, timing=True)
    up2 = check_upsampler(b, 2 * th, 2 * tw, CHANNELS, seed=4, timing=True)
    for name, r in (("fused_resblock", rb),
                    ("fused_upsampler_stage (stage 1)", up1),
                    ("fused_upsampler_stage (stage 2)", up2)):
        spread = "  ".join(
            f"{k} {r[k]['ms']:.3f} ms [min {r[k]['min']:.3f}, max "
            f"{r[k]['max']:.3f}]" for k in ("time", "plain", "library"))
        print(f"  {name}: kernel {spread}  bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}); 'time' is the kernel, 'plain' the f32 "
              f"plain version, 'library' cuDNN  [{card}]", flush=True)
        gb = r["weight_l2_bytes"] / 1e9
        print(f"    {r['schedule']}: weights from L2 {gb:.2f} GB per launch "
              f"= {gb / r['ms']:.2f} TB/s at the median time", flush=True)
    torch.cuda.empty_cache()
    return {"fused_resblock": rb, "fused_upsampler_stage": up2,
            "upsampler_stage1": up1}


def profile_breakdown(fn, card: str, top: int = 8) -> None:
    """Where the time of one ``fn()`` goes on the device: torch.profiler
    self device time by kernel, and the device's busy share of the wall
    time (the rest is host work, transfers and launch gaps)."""
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

    # Device-side entries only (kernels, memcpy): an aten:: op's self
    # device time repeats the kernels it launched, and a CUDA runtime
    # call's (cudaLaunchKernel, cudaMemcpyAsync) the work it enqueued.
    events = sorted((e for e in prof.key_averages()
                     if dev_us(e) > 0 and not e.key.startswith("aten::")
                     and not e.key.startswith("cuda")),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events)
    print(f"  profile of one batch on {card}: wall {wall_us / 1e3:.2f} ms "
          f"(profiler on), device busy {busy / 1e3:.2f} ms = "
          f"{100 * busy / wall_us:.1f}% of wall", flush=True)
    for e in events[:top]:
        print(f"    {100 * dev_us(e) / max(busy, 1):5.1f}%  "
              f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}",
              flush=True)


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
        counts = kernels.launch_counts()
        want = {"fused_resblock": BLOCKS * forwards,
                "fused_upsampler_stage": 2 * forwards}
        print(f"  {what}: {forwards} generator forwards, launches {counts} "
              f"(expected {want})", flush=True)
        if forwards < 1 or counts != want:
            fail(f"{what}: kernel launch counts {counts} != {want}")
        return counts

    with tempfile.TemporaryDirectory() as tmp:
        print("[main] python -m pesr_torch.test x4 32x256 --tile_size auto "
              "--dataset synthetic (random init, seed 0)", flush=True)
        kernels.reset_launch_counts()
        summary = cli.run(["--dataset", "synthetic", "--scale", str(SCALE),
                           "--num_blocks", str(BLOCKS), "--num_channels",
                           str(CHANNELS), "--tile_size", "auto", "--seed",
                           "0", "--output_dir", tmp])
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


def main() -> int:
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

    card = phase_build()
    print(card, flush=True)
    ker = phase_kernels(card)
    main_res = phase_main(card)
    sources = {"fused_resblock": ("pesr_torch/csrc/resblock.cu",
                                  "pesr_tpu/ops/pallas/resblock.py:96"),
               "fused_upsampler_stage": ("pesr_torch/csrc/upsampler.cu",
                                         "pesr_tpu/ops/pallas/upsampler.py:95")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_res["launches"][name],
         "max_abs_err": ker[name]["max_abs_err"], "ms": ker[name]["ms"],
         "plain_ms": ker[name]["plain_ms"],
         "bound_ms": ker[name]["bound_ms"],
         "bound_by": ker[name]["bound_by"],
         "library_ms": ker[name]["library_ms"]}
        for name, (src, rep) in sources.items()]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
