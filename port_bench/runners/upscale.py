"""Inference cells: photos in host memory through the port's batch
engine, ``BatchTiledUpscaler.upscale_many(images, batch)``, results back
in host memory, as ``python -m pesr_torch.test`` runs it.

Set-up: the weights on the device from the seed
(``reference/weights.py``), the mix's images rendered and brought to
host memory, the program's apply (``path`` "bf16": ``KernelApply`` with
the folded upsampler, the CLI default; "int8": ``int8_inference``
calibrated on the mix's crops), one request of every size class.
Window: closed loop, one client, requests back to back for
``seconds``, each timed from handing its host images to the engine to
its uint8 results in host memory; the window runs from its first
request's start to its last request's end.  Then the peak memory is
read, the program freed, and a seeded sample of the window's results
(one of the largest class among them) compared with the plain
reference on the same images at the engine's grid.
"""

from __future__ import annotations

import gc
import os
import statistics
import sys
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from port_bench.metrics._common import Request
from port_bench.reference import edsr, tiling, w8a8
from port_bench.reference.compare import Tally
from port_bench.reference.weights import make_state_dict
from port_bench.trace import WINDOW, Trace


class Sample:
    """A seeded reservoir of ``k`` of the window's images, one of the
    largest class among them (the last swapped for one drawn from that
    class when the draw holds none)."""

    def __init__(self, k: int, largest: int, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.k, self.largest = k, largest
        self.all: list = []
        self.big: Optional[tuple] = None
        self.seen = self.seen_big = 0

    def offer(self, cls: int, req: int, imgs, outs) -> None:
        for img, out in zip(imgs, outs):
            item = (req, img, out, cls)
            self.seen += 1
            if len(self.all) < self.k:
                self.all.append(item)
            else:
                j = int(self.rng.integers(self.seen))
                if j < self.k:
                    self.all[j] = item
            if cls == self.largest:
                self.seen_big += 1
                if int(self.rng.integers(self.seen_big)) == 0:
                    self.big = item

    def items(self) -> list:
        """``(request, image, output)`` of each sampled image."""
        out = list(self.all)
        if self.big is not None and all(x[3] != self.largest for x in out):
            out[-1] = self.big
        return [x[:3] for x in out]


class Program:
    """The system under test, built from the benchmark's weights."""

    def __init__(self, model: dict, mix: dict, sd, crops, device,
                 path: Optional[str] = None) -> None:
        from pesr_torch.models.generator import Generator
        from pesr_torch.models.kernel_apply import KernelApply
        from pesr_torch.models.quant_apply import int8_inference
        from pesr_torch.ops.tiling import BatchTiledUpscaler
        path = path or mix["path"]
        g = Generator(model["scale"], model["num_blocks"],
                      model["num_channels"], model["res_scale"],
                      model["img_channels"], device=device, seed=None)
        g.load_state_dict(sd)
        if path == "int8":
            apply_fn = int8_inference(g, [crops])
        elif path == "bf16":
            apply_fn = KernelApply(g, fold=True)
        else:
            raise ValueError(f"unknown path {path!r}")
        self.engine = BatchTiledUpscaler(apply_fn, model["scale"],
                                         mix["tile"], mix["overlap"],
                                         device=device)
        self.batch, self.overlap = mix["batch"], mix["overlap"]
        self.min_halo = self.engine.min_halo
        self._grids: dict = {}

    def __call__(self, imgs: List[np.ndarray]) -> List[np.ndarray]:
        return self.engine.upscale_many(imgs, self.batch)

    def grid(self, imgs) -> tuple:
        """The engine's grid for this request (cached by shape: the
        auto chooser's search is host work between requests)."""
        key = (len(imgs),) + imgs[0].shape[:2]
        if key not in self._grids:
            self._grids[key] = tuple(self.engine.grid(*key))
        return self._grids[key]

    def halos(self, grid) -> tuple:
        return tiling.halos(grid, self.overlap, self.min_halo)


def launches() -> dict:
    from pesr_torch.ops import kernels
    return {**kernels.launch_counts(),
            "fused_resblock_int8": kernels.fused_resblock_int8.launches}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(program: Callable, traffic, seconds: float, sample: Sample,
               grid_of: Callable, halos_of: Callable,
               max_requests: Optional[int] = None) -> List[Request]:
    """Requests back to back until ``seconds`` have passed (or
    ``max_requests`` are done)."""
    reqs: List[Request] = []
    it = traffic.requests()
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            while True:
                cls, imgs = next(it)
                a = time.perf_counter()
                outs = program(imgs)
                b = time.perf_counter()
                grid = grid_of(imgs)
                reqs.append(Request(imgs[0].shape[:2], len(imgs), grid,
                                    halos_of(grid), a - t0, b - t0))
                sample.offer(cls, len(reqs) - 1, imgs, outs)
                if b - t0 >= seconds or (max_requests
                                         and len(reqs) >= max_requests):
                    break
    finally:
        gc.enable()
    return reqs


def reference_fn(model: dict, mix: dict, sd, crops, device,
                 bits: Optional[int] = None):
    """The plain forward for ``mix``'s path: float32 EDSR for "bf16", the
    W8A8 forward for "int8" (``bits``: 4 for the control)."""
    if mix["path"] == "int8" or bits:
        q = w8a8.W8A8(sd, model, torch.from_numpy(crops).to(device),
                      bits or 8)
        return q

    def f32(x):
        with edsr.no_tf32():
            return edsr.forward(x, sd, model)
    return f32


def compare(items, reqs: List[Request], model: dict, mix: dict,
            min_halo: int, forward, device) -> Tally:
    """The sampled results against ``forward`` at each one's grid."""
    tally = Tally()
    for req, img, out in items:
        x = torch.from_numpy(np.ascontiguousarray(img))[None].to(device)
        ref = tiling.upscale(x, reqs[req].grid, mix["overlap"], min_halo,
                             model["scale"], forward)[0]
        tally.add(torch.from_numpy(np.ascontiguousarray(out)), ref)
        del ref
    return tally


def run(cell: dict, model: dict, mix: dict, check: dict, args, device,
        t_start: float, shrink: int = 1) -> dict:
    """One run of an inference cell; returns the pieces of the result
    line (see ``run.py``)."""
    from port_bench.traffic.generate import Traffic
    marks = [("start", time.perf_counter() - t_start)]

    def mark(name):
        sync(device)
        marks.append((name, time.perf_counter() - t_start))

    sd = make_state_dict(model, args.seed, device)
    mark("weights")
    traffic = Traffic(mix, model["scale"], args.seed, device, shrink)
    mark("traffic")
    program = Program(model, mix, sd, traffic.crops, device)
    mark("program")
    for imgs in traffic.first_of_each_class():
        program(imgs)
    mark("warm-up")
    setup_s = marks[-1][1]
    print("[port_bench] set-up (s since start): " + ", ".join(
        f"{n} {t:.2f}" for n, t in marks), file=sys.stderr)
    largest = int(np.argmax([h * w for h, w in traffic.classes]))
    sample = Sample(int(check["sample"]), largest, args.seed)
    before = launches()
    prof = None
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        reqs = run_window(program, traffic, args.seconds, sample,
                          program.grid, program.halos)
        sync(device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    after = launches()
    window_s = reqs[-1].end
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trace = None
    if prof is not None and device.type == "cuda":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = Trace.load(path)
        finally:
            os.remove(path)
    del prof
    min_halo = program.min_halo
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    forward = reference_fn(model, mix, sd, traffic.crops, device)
    tally = compare(sample.items(), reqs, model, mix, min_halo, forward,
                    device)
    lat_ms = [1e3 * (r.end - r.start) for r in reqs]
    mp = sum(r.images * r.lr_hw[0] * r.lr_hw[1] for r in reqs) \
        * model["scale"] ** 2 / 1e6
    e2e = {"setup_s": (setup_s, "s"), "mps": (mp / window_s, "MP/s")}
    q = (statistics.quantiles(lat_ms, n=100, method="inclusive")
         if len(lat_ms) > 1 else lat_ms * 99)
    e2e["latency_p50_ms"] = (statistics.median(lat_ms), "ms")
    e2e["latency_p95_ms"] = (q[94], "ms")
    half = len(reqs) // 2
    print(f"[port_bench] request ms p5 {q[4]:.3f} p25 {q[24]:.3f} p50 "
          f"{q[49]:.3f} p75 {q[74]:.3f} p95 {q[94]:.3f} max {max(lat_ms):.3f}; "
          f"first half {reqs[half].start:.3f} s for {half} requests",
          file=sys.stderr)
    print(f"[port_bench] {len(reqs)} requests, "
          f"{sum(r.images for r in reqs)} images, window {window_s:.3f} s, "
          f"compared {tally.images} images, reference saturated "
          f"{tally.clamped_pct():.3f}% of subpixels", file=sys.stderr)
    return {"e2e": e2e, "attempted": sum(r.images for r in reqs),
            "failed": 0, "requests": reqs, "window_s": window_s,
            "launches": {k: after[k] - before[k] for k in after},
            "peak": peak, "trace": trace, "numbers": tally.numbers()}
