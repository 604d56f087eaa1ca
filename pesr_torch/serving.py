"""Serving artifacts (counterpart of ``pesr_tpu/serving.py``): the whole
pad -> tile -> forward -> stitch program of a
:class:`~pesr_torch.ops.tiling.BatchTiledUpscaler` for one input
geometry, exported with ``torch.export`` with the weights baked in as
constants, in ONE file that a serving process loads and runs without the
model-building Python: no generator module, no checkpoint, no flags.
Loading needs this module and the registrations of the two custom ops
(``pesr::fused_resblock``, ``pesr::fused_upsampler_stage``), which it
imports; the program calls the ops, whose CUDA implementations launch
the hand-written kernels (and count the launches) and whose CPU
implementations run the plain versions.

Shapes are part of the artifact, as in JAX: one artifact per served
(batch, H, W).  ``batch="any"`` exports the batch dimension as a
``torch.export.Dim`` with the tile grid chosen for ``trace_batch``: the
engine's Python loops over tile positions, never over the batch, so one
program serves every batch size.

``platforms`` (in the metadata) records the device type the program was
exported on.  Loading on the other device moves the program's constants
there (``torch.export.passes.move_to_device_pass``), so the ops run their
implementation for that device: an artifact exported on a CPU box serves
on the card and the other way round.  The program runs under ``full_f32``
(TF32 off on the card), as the engine's float32 apply does; the bf16
paths are unaffected by it.

Multi-device: a spatial engine (``mesh_axis="tiles"``) exports the
per-rank program ``(imgs, positions) -> cores``, with ``mesh_devices``
= P: every rank of a P-process group loads it and calls it with the same
batch; :class:`ServingUpscaler` gives each rank its share of the tile
positions and does the all-gather and the canvas assembly outside the
program.  Loading it in a smaller process group raises.  A batch-DP
engine is not exported: hermetic single-device replicas shard a batch
with no coordination (load the artifact on every device).  A spatial
artifact is fixed-batch.

Artifact layout (zip):
  meta.json     scale / shapes / grid / precision path / versions
  program.pt2   ``torch.export.save`` of the program (weights as constants)
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Optional

import numpy as np
import torch

from pesr_torch import parallel
from pesr_torch.ops import kernels  # noqa: F401  (registers the custom ops)
from pesr_torch.ops.tiling import gather_canvas, spatial_positions
from pesr_torch.utils.device import full_f32, resolve_device

_META_NAME = "meta.json"
_PROGRAM_NAME = "program.pt2"
# 2: the int8 block's packed weights carry both convs' output channels
# in ``output_channel_orders`` (ops/kernels/resblock_int8.py); a
# version-1 int8 program holds them in natural order and would run
# with its channels permuted, so version 1 is refused.
_FORMAT_VERSION = 2


class _Program(torch.nn.Module):
    """The engine's run for one geometry as a module for ``torch.export``:
    ``imgs -> canvas``, or in spatial mode ``(imgs, positions) ->
    cores``."""

    def __init__(self, run, spatial: bool) -> None:
        super().__init__()
        self._run, self.spatial = run, spatial

    def forward(self, imgs_u8: torch.Tensor,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._run(imgs_u8, pos if self.spatial else None)


def export_upscaler(engine, batch, height: int, width: int, path: str,
                    precision_path: str = "unspecified",
                    trace_batch: int = 8) -> dict:
    """Export ``engine``'s tiled-SR program for input ``[batch, height,
    width, 3]`` uint8 to an artifact at ``path``; returns its metadata.

    ``batch``: an int, or ``"any"`` for a batch dimension that serves
    every size (the tile grid chosen for ``trace_batch``).
    ``precision_path`` is recorded so that a consumer can tell an int8
    artifact from a bf16 one (the program itself is opaque).  On a mesh
    every rank calls it (each traces; rank 0 writes, then all wait)."""
    dynamic = batch in ("any", "dynamic")
    mesh_devices = 0
    if engine.mesh is not None:
        if engine.mesh_axis != "tiles":
            raise ValueError(
                "export_upscaler exports single-device programs for DP "
                "serving: export once and load the artifact on every "
                "device (the batch shards trivially across hermetic "
                "replicas).  Only mesh_axis='tiles' (spatial parallelism: "
                "N devices cooperate on ONE image) exports as a multi-device "
                "artifact.")
        if dynamic:
            raise ValueError(
                "spatial-parallel artifacts are fixed-batch: the program's "
                "share of the tile positions is laid out for one (batch, H, "
                "W); export one artifact per served geometry")
        mesh_devices = int(engine.mesh.size)
    b_trace = trace_batch if dynamic else int(batch)
    run, (nh, nw, th, tw) = engine._build(b_trace, height, width)
    spatial = mesh_devices > 0
    dev = engine.device
    imgs = torch.zeros((b_trace, height, width, 3), dtype=torch.uint8,
                       device=dev)
    args = (imgs,)
    if spatial:
        args += (torch.arange(-(-nh * nw // mesh_devices), device=dev),)
    dims = (({0: torch.export.Dim("batch", min=1, max=1 << 16)},)
            if dynamic else None)
    with torch.no_grad():
        program = torch.export.export(_Program(run, spatial), args,
                                      dynamic_shapes=dims, strict=False)
    s = engine.scale
    meta = {
        "format_version": _FORMAT_VERSION,
        "scale": s,
        "input_shape": ["any" if dynamic else int(batch), height, width, 3],
        "trace_batch": b_trace,
        "input_dtype": "uint8",
        "canvas_shape": ["any" if dynamic else int(batch),
                         nh * th * s, nw * tw * s, 3],
        "output_crop": [height * s, width * s],
        # the halos the program uses per axis (single-tile axes drop to
        # the min_halo floor); "overlap" is the constructor's request
        "grid": {"nh": nh, "nw": nw, "th": th, "tw": tw,
                 "ov_h": engine._ov_for(nh), "ov_w": engine._ov_for(nw),
                 "overlap": engine.ov, "min_halo": engine.min_halo},
        # 0: single-device program; P >= 1: the per-rank program of a
        # spatial engine, which P processes run together
        "mesh_devices": mesh_devices,
        "precision_path": precision_path,
        "platforms": [dev.type],
        "torch_version": torch.__version__,
    }
    if parallel.is_primary(engine.mesh):
        buf = io.BytesIO()
        torch.export.save(program, buf)
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr(_META_NAME, json.dumps(meta, indent=1),
                        zipfile.ZIP_DEFLATED)
            # stored: deflate takes ~10 s for the flagship's 79 MB of
            # weights and saves ~22% of them
            zf.writestr(_PROGRAM_NAME, buf.getvalue(), zipfile.ZIP_STORED)
    parallel.barrier(engine.mesh)
    return meta


class ServingUpscaler:
    """A loaded artifact: ``uint8 [B, H, W, 3] -> uint8 [B, H*s, W*s, 3]``
    on ``device``; stateless, construct once per process.  The canvas is
    cropped to the true output size on the device before the fetch."""

    def __init__(self, meta: dict, program, device: torch.device,
                 mesh=None) -> None:
        self.meta, self.device, self.mesh = meta, device, mesh
        self.scale = int(meta["scale"])
        self.input_shape = tuple(meta["input_shape"])
        self._module = program.module()

    @torch.no_grad()
    def upscale_device(self, imgs_u8) -> torch.Tensor:
        """Device-resident variant (composition with downstream stages)."""
        t = (imgs_u8 if torch.is_tensor(imgs_u8)
             else torch.from_numpy(np.ascontiguousarray(imgs_u8)))
        want, got = self.input_shape, tuple(t.shape)
        shape_ok = (len(got) == 4 and got[1:] == tuple(want[1:])
                    and (want[0] == "any" or got[0] == want[0]))
        if t.dtype != torch.uint8 or not shape_ok:
            raise ValueError(
                f"artifact serves exactly uint8 {tuple(want)}, got {t.dtype} "
                f"{got}: export one artifact per served shape (serving "
                'shapes are static; batch="any" exports a batch-polymorphic '
                "one)")
        t = t.to(self.device)
        ch, cw = self.meta["output_crop"]
        with full_f32(self.device):
            if self.mesh is None:
                return self._module(t)[:, :ch, :cw]
            g = self.meta["grid"]
            n = g["nh"] * g["nw"]
            cores = self._module(t, spatial_positions(self.mesh, n))
        return gather_canvas(self.mesh, cores, g["nh"], g["nw"])[:, :ch, :cw]

    def __call__(self, imgs_u8) -> np.ndarray:
        return self.upscale_device(imgs_u8).cpu().numpy()


def load_upscaler(path: str, device="cuda") -> ServingUpscaler:
    """Load an artifact written by :func:`export_upscaler` onto ``device``
    (the card unless the caller asks for the CPU), moving the program
    there when it was exported on another device type.  A spatial
    artifact of P ranks needs a process group of at least P processes
    (every rank of the first P loads it)."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(_META_NAME))
        blob = zf.read(_PROGRAM_NAME)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported artifact format_version {meta.get('format_version')}"
            f" (this build reads {_FORMAT_VERSION})")
    need = int(meta.get("mesh_devices", 0) or 0)
    mesh = None
    if need:
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < need:
            raise ValueError(f"spatial-parallel artifact needs {need} "
                             f"devices, this process group has {world}")
        mesh = parallel.make_mesh(need, device)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    program = torch.export.load(io.BytesIO(blob))
    if dev.type not in meta["platforms"]:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
    return ServingUpscaler(meta, program, dev, mesh)


def read_meta(path: str) -> dict:
    """Artifact metadata without loading the program (cheap)."""
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read(_META_NAME))
