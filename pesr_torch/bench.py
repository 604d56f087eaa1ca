"""Headline benchmark of the port (counterpart of the repo's ``bench.py``):
tiled whole-image SR throughput on one device, one JSON line.

    python -m pesr_torch.bench
    BENCH_SCALE=2 BENCH_PATHS=int8 python -m pesr_torch.bench

The flagship generator (32 blocks x 256 channels, random weights from
seed 0) runs the device-resident batch engine
(:class:`~pesr_torch.ops.tiling.BatchTiledUpscaler`) over DIV2K-val-sized
synthetic images: ``(2040 // scale) x (1344 // scale)`` LR, so 510 high
and 336 wide at x4, drawn from ``numpy.random.default_rng(0)``.  The
uint8 batch goes to the device before the timed region; a timed pass is
``upscale_batch_device`` plus a fetch of one canvas element, which waits
for the device; the canvas stays on the device.  One untimed warm-up,
then the best of ``BENCH_REPEATS`` passes.

Both precisions are measured in every run: the headline path (int8 W8A8
by default: ``int8_inference`` calibrated on 16 crops of one
``default_rng(1)`` 510 x 336 image, each residual block one launch of
``fused_resblock_int8``) and the bf16 path (``KernelApply``: folded, so
only ``fused_resblock`` runs, or with ``BENCH_FOLD=0`` the chain, where
each x2 stage is a ``fused_upsampler_stage``).

Prints ONE JSON line on stdout, with the keys of ``bench.py``'s:
  {"metric": "tiled_x4_inference_throughput", "value": ...,
   "unit": "MP/s/chip", "precision": ..., "vs_baseline": ...,
   "paths": {"int8-w8a8": {...}, "bf16": {...}}}
``vs_baseline`` is value / 50 (the BASELINE contract's divisor).  With
``BENCH_MESH=N`` it also carries ``mesh_devices`` and
``mesh_total_mps_headline``, and ``value`` is per device.

Env overrides (``bench.py``'s): BENCH_TILE ("auto" or an int),
BENCH_OVERLAP, BENCH_IMAGES, BENCH_BLOCKS, BENCH_CHANNELS, BENCH_REPEATS,
BENCH_QUANT (headline path: int8 | none), BENCH_PATHS (comma list, default
"int8,bf16"), BENCH_FOLD (1 | 0), BENCH_SCALE, BENCH_PROFILE=DIR (a
torch.profiler Chrome trace of the headline path's timed passes into
DIR), BENCH_MESH=N (data parallel over N processes, one device each, the
group brought up from the ``PESR_*`` contract or torchrun's environment;
without a group of N processes it raises).

It runs on the GPU and raises without CUDA; :func:`main` and :func:`run`
take ``device="cpu"`` (the tests), where the kernels' plain versions run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Mapping, Optional

import numpy as np
import torch

from pesr_torch import parallel
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.models.quant_apply import default_calib_tiles, int8_inference
from pesr_torch.ops import kernels
from pesr_torch.ops.tiling import BatchTiledUpscaler
from pesr_torch.utils.device import resolve_device

BASELINE_MPS = 50.0
_CANON = {"int8": "int8-w8a8", "int8-w8a8": "int8-w8a8", "bf16": "bf16"}


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """The run ``BENCH_*`` asks for (:func:`config_from_env`)."""
    tile: object          # "auto" or an int
    overlap: int
    n_images: int
    blocks: int
    channels: int
    repeats: int
    headline: str         # "int8-w8a8" | "bf16"
    paths: tuple          # canonical names, the headline among them
    fold: bool
    scale: int
    profile_dir: str
    mesh_n: int           # 0: no mesh


def config_from_env(env: Optional[Mapping[str, str]] = None) -> BenchConfig:
    """The ``BENCH_*`` variables of ``env`` (default ``os.environ``), each
    unset one at ``bench.py``'s default.  An unknown path, or a batch
    that ``BENCH_MESH`` does not divide, raises ``SystemExit``."""
    env = os.environ if env is None else env
    tile = env.get("BENCH_TILE", "auto")
    n_images = int(env.get("BENCH_IMAGES", "8"))
    mesh_n = int(env.get("BENCH_MESH", "0"))
    headline = ("int8-w8a8" if env.get("BENCH_QUANT", "int8") == "int8"
                else "bf16")
    paths = []
    for name in env.get("BENCH_PATHS", "int8,bf16").split(","):
        name = name.strip()
        if not name:
            continue
        if name not in _CANON:  # typos must fail, not measure bf16
            raise SystemExit(f"BENCH_PATHS: unknown path {name!r} "
                             f"(valid: {sorted(set(_CANON))})")
        paths.append(_CANON[name])
    if headline not in paths:
        paths.insert(0, headline)
    if mesh_n and n_images % mesh_n:
        raise SystemExit(f"BENCH_IMAGES={n_images} not divisible by "
                         f"BENCH_MESH={mesh_n}")
    return BenchConfig(
        tile=tile if tile == "auto" else int(tile),
        overlap=int(env.get("BENCH_OVERLAP", "8")), n_images=n_images,
        blocks=int(env.get("BENCH_BLOCKS", "32")),
        channels=int(env.get("BENCH_CHANNELS", "256")),
        repeats=int(env.get("BENCH_REPEATS", "5")), headline=headline,
        paths=tuple(paths), fold=env.get("BENCH_FOLD", "1") == "1",
        scale=int(env.get("BENCH_SCALE", "4")),
        profile_dir=env.get("BENCH_PROFILE", ""), mesh_n=mesh_n)


def bench_images(scale: int, n_images: int) -> np.ndarray:
    """[n_images, 2040 // scale, 1344 // scale, 3] uint8 from
    ``default_rng(0)``: the same 2040 x 1344 HR output at every scale."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (n_images, 2040 // scale, 1344 // scale, 3),
                        dtype=np.uint8)


def calib_images() -> list:
    """The int8 calibration image: one 510 x 336 uint8 draw of
    ``default_rng(1)``, at every scale."""
    return [np.random.default_rng(1).integers(0, 256, (510, 336, 3),
                                              dtype=np.uint8)]


def build_apply(gen: Generator, path: str, fold: bool, calib_imgs):
    """The apply of one measured path: "int8-w8a8" (W8A8, always folded,
    calibrated on ``default_calib_tiles(calib_imgs)``) or "bf16" (the
    kernel path, folded unless ``fold`` is False)."""
    if path == "int8-w8a8":
        return int8_inference(gen, default_calib_tiles(calib_imgs))
    return KernelApply(gen, fold=fold)


def make_engine(apply_fn, cfg: BenchConfig, device: torch.device,
                mesh=None) -> BatchTiledUpscaler:
    """The batch engine of a path: ``cfg``'s tile, overlap and scale, the
    image batch split over ``mesh`` when one is given."""
    return BatchTiledUpscaler(apply_fn, cfg.scale, cfg.tile, cfg.overlap,
                              device=device, mesh=mesh, mesh_axis="batch")


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (``cpu`` on the CPU; the torch name where nvidia-smi cannot say)."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def measure_path(gen: Generator, cfg: BenchConfig, path: str,
                 imgs_dev: torch.Tensor, calib_imgs, mesh=None,
                 profile: bool = False) -> dict:
    """One path: its apply and engine, a warm-up pass, then the best of
    ``cfg.repeats`` timed passes (``profile``: under torch.profiler, a
    Chrome trace into ``cfg.profile_dir``).  Returns the best pass's
    ``seconds``, the engine's ``grid`` (nh, nw, th, tw) for this rank's
    batch, the generator ``forwards``, the kernels' ``launches`` and
    ``peak_bytes`` (CUDA: the most device memory allocated), all over the
    warm-up and the timed passes."""
    device = imgs_dev.device
    apply_fn = build_apply(gen, path, cfg.fold, calib_imgs)
    tiler = make_engine(apply_fn, cfg, device, mesh)

    def once() -> float:
        t0 = time.perf_counter()
        canvas = tiler.upscale_batch_device(imgs_dev)
        canvas[0, 0, 0, 0].item()   # one element to the host: waits
        return time.perf_counter() - t0

    kernels.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    once()  # kernel builds, cuDNN searches, allocator growth
    if profile:
        with _profiler(device) as prof:
            elapsed = min(once() for _ in range(cfg.repeats))
        os.makedirs(cfg.profile_dir, exist_ok=True)
        trace = os.path.join(cfg.profile_dir, f"bench_{path}.pt.trace.json")
        prof.export_chrome_trace(trace)
        print(f"[bench] trace -> {trace}", file=sys.stderr)
    else:
        elapsed = min(once() for _ in range(cfg.repeats))
    b, h, w = imgs_dev.shape[:3]
    return {"seconds": elapsed, "grid": tiler.grid(b, h, w),
            "forwards": apply_fn.forwards,
            "launches": {**kernels.launch_counts(), "fused_resblock_int8":
                         kernels.fused_resblock_int8.launches},
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None)}


def run(device="cuda", env: Optional[Mapping[str, str]] = None):
    """The benchmark of ``env``'s ``BENCH_*`` (default ``os.environ``) on
    ``device``.  Returns ``(record, details)``: the JSON line's dict, and
    per path :func:`measure_path`'s readings."""
    cfg = config_from_env(env)
    dev, mesh = resolve_device(device), None
    if cfg.mesh_n:
        # one process per device: NCCL when each rank has its own card,
        # gloo where ranks share one (NCCL refuses two ranks on a device)
        backend = ("nccl" if dev.type == "cuda"
                   and cfg.mesh_n <= torch.cuda.device_count() else "gloo")
        parallel.initialize_distributed(required=True, device=device,
                                        backend=backend)
        mesh = parallel.make_mesh(cfg.mesh_n, device)
        dev = mesh.device
    print(f"[bench] device={card_name(dev)} tile={cfg.tile} "
          f"overlap={cfg.overlap} images={cfg.n_images} "
          f"model={cfg.blocks}x{cfg.channels} paths={list(cfg.paths)}",
          file=sys.stderr)
    gen = Generator(cfg.scale, cfg.blocks, cfg.channels, device=dev, seed=0)
    calib = calib_images()
    imgs = bench_images(cfg.scale, cfg.n_images)
    imgs_dev = torch.from_numpy(imgs).to(dev)
    imgs_dev[0, 0, 0, 0].item()     # on the device before any timing

    lr_h, lr_w = imgs.shape[1:3]
    out_mp = cfg.n_images * (lr_h * cfg.scale) * (lr_w * cfg.scale) / 1e6
    n_chips = cfg.mesh_n or 1
    measured, details = {}, {}
    for path in cfg.paths:
        r = measure_path(gen, cfg, path, imgs_dev, calib, mesh,
                         profile=bool(cfg.profile_dir)
                         and path == cfg.headline)
        mps = out_mp / r["seconds"]
        print(f"[bench] {path}: {out_mp:.1f} MP in {r['seconds']:.3f}s "
              f"= {mps / n_chips:.2f} MP/s/chip", file=sys.stderr)
        measured[path] = {"value": round(mps / n_chips, 3),
                          "unit": "MP/s/chip",
                          "vs_baseline": round(mps / n_chips / BASELINE_MPS,
                                               4)}
        details[path] = r
        if dev.type == "cuda":   # the next path does not inherit this one's
            torch.cuda.empty_cache()
    head = measured[cfg.headline]
    record = {"metric": f"tiled_x{cfg.scale}_inference_throughput",
              "value": head["value"], "unit": "MP/s/chip",
              "precision": cfg.headline,
              "vs_baseline": head["vs_baseline"], "paths": measured}
    if cfg.mesh_n:
        record["mesh_devices"] = cfg.mesh_n
        record["mesh_total_mps_headline"] = round(
            head["value"] * cfg.mesh_n, 3)
    return record, details


def main(device="cuda", env: Optional[Mapping[str, str]] = None) -> int:
    """:func:`run`, then the JSON line on stdout (rank 0 only)."""
    try:
        record, _ = run(device, env)
        if parallel.is_primary():
            print(json.dumps(record), flush=True)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
