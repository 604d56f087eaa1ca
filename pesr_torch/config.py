"""Inference options of the port (the test-mode subset of
``pesr_tpu/config.py``).

Flags the port does not implement yet (``--quant``, ``--fold``,
``--self_ensemble``, ``--mesh_shape``, ``--export_artifact``, ...) are
not in the parser, so argparse rejects them instead of ignoring them.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from pesr_torch.scales import upsample_stages


@dataclasses.dataclass(frozen=True)
class Opts:
    scale: int = 4
    num_channels: int = 256
    num_blocks: int = 32
    res_scale: float = 0.1
    test_dataset: str = "Set5"
    data_root: str = "data"
    model_path: str = ""
    output_dir: str = "results"
    tile_size: object = "auto"    # int, 0 = whole image, or "auto"
    tile_overlap: int = 8         # LR halo on each side
    infer_batch: int = 8          # images per device batch
    seed: int = 0
    device: str = "cuda"


def _tile_size(value: str):
    """--tile_size parser: int or the literal "auto"."""
    if value == "auto":
        return value
    return int(value)


def build_parser() -> argparse.ArgumentParser:
    d = Opts()
    p = argparse.ArgumentParser(
        prog="python -m pesr_torch.test",
        description="pesr_torch inference: tiled x-scale SR of an eval set "
                    "on the H100 kernels, PNGs out, PSNR/SSIM printed",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    g = p.add_argument_group("model")
    g.add_argument("--scale", type=int, default=d.scale,
                   help="super-resolution scale (any 2^a*3^b)")
    g.add_argument("--num_channels", type=int, default=d.num_channels)
    g.add_argument("--num_blocks", type=int, default=d.num_blocks)
    g.add_argument("--res_scale", type=float, default=d.res_scale)
    g = p.add_argument_group("data")
    g.add_argument("--dataset", "--test_dataset", dest="test_dataset",
                   default=d.test_dataset,
                   help="'synthetic' or a folder <data_root>/<name>/HR")
    g.add_argument("--data_root", default=d.data_root)
    g.add_argument("--seed", type=int, default=d.seed,
                   help="random init (no --model_path) and synthetic data")
    g = p.add_argument_group("inference")
    g.add_argument("--model_path", default=d.model_path,
                   help="EDSR-style generator .pth (see "
                        "pesr_tpu.convert.save_generator_torch)")
    g.add_argument("--output_dir", default=d.output_dir)
    g.add_argument("--tile_size", type=_tile_size, default=d.tile_size,
                   help='LR tile side, 0 = whole image, or "auto"')
    g.add_argument("--tile_overlap", type=int, default=d.tile_overlap)
    g.add_argument("--infer_batch", type=int, default=d.infer_batch)
    g.add_argument("--device", default=d.device,
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def opts_from_args(argv: Optional[Sequence[str]] = None) -> Opts:
    opts = Opts(**vars(build_parser().parse_args(argv)))
    upsample_stages(opts.scale)  # fail fast on e.g. 5
    return opts
