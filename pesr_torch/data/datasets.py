"""Eval sets on the host (counterpart of parts of
``pesr_tpu/data/datasets.py``): the classic procedural ``synthetic``
corpus, MATLAB-bicubic host resizing, and benchmark folders in the
``<name>/HR`` + ``<name>/LR_bicubic/X<scale>`` layout."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from pesr_torch.ops.resize import resize_kernel_matrix
from pesr_torch.utils.image_io import imread_uint8

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


class SyntheticImages:
    """Procedural HR images: smooth low-frequency fields + fine texture
    (the classic variant of the JAX package's corpus, identical draws).

    Deterministic per (seed, index); a pipeline exerciser, NOT a quality
    benchmark."""

    def __init__(self, num_images: int = 32, height: int = 480,
                 width: int = 480, seed: int = 0) -> None:
        self.num_images = num_images
        self.height, self.width = height, width
        self.seed = seed
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return self.num_images

    def name(self, idx: int) -> str:
        return f"synthetic_{idx:04d}"

    def _render(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.height, self.width
        img = np.zeros((h, w, 3), np.float64)
        # Sum of smooth random cosine gratings at mixed frequencies.
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        for _ in range(6):
            fy, fx = rng.uniform(0.5, 24.0, 2)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.05, 0.35)
            grating = np.cos(2 * np.pi * (fy * yy / h + fx * xx / w) + phase)
            img += amp * grating[:, :, None] * rng.uniform(0.3, 1.0, 3)
        # Piecewise structure: a few random rectangles (edges for SR).
        for _ in range(8):
            y0, x0 = rng.integers(0, max(1, h - 8)), \
                rng.integers(0, max(1, w - 8))
            y1 = y0 + int(rng.integers(min(8, max(2, h // 3) - 1),
                                       max(9, h // 3)))
            x1 = x0 + int(rng.integers(min(8, max(2, w // 3) - 1),
                                       max(9, w // 3)))
            img[y0:y1, x0:x1] += rng.uniform(-0.4, 0.4, 3)
        # Fine noise texture.
        img += rng.normal(0, 0.02, (h, w, 3))
        img = (img - img.min()) / (np.ptp(img) + 1e-9)
        return (img * 255.0).round().astype(np.uint8)

    def get(self, idx: int) -> np.ndarray:
        if idx not in self._cache:
            self._cache[idx] = self._render(idx)
        return self._cache[idx]


def host_bicubic_resize(img: np.ndarray, out_h: int,
                        out_w: int) -> np.ndarray:
    """MATLAB-bicubic resize on host (numpy matmuls) with uint8
    requantization -- LR synthesis and the bicubic upscale baseline."""
    mh = resize_kernel_matrix(img.shape[0], out_h).astype(np.float64)
    mw = resize_kernel_matrix(img.shape[1], out_w).astype(np.float64)
    x = img.astype(np.float64)
    x = np.einsum("oh,hwc->owc", mh, x, optimize=True)
    x = np.einsum("ow,hwc->hoc", mw, x, optimize=True)
    # floor(x + 0.5): MATLAB im2uint8 rounds ties half-AWAY, np.round
    # half-to-even (ties below 0.5 clip to 0, so away == up here).
    return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)


def host_bicubic_downsample(hr: np.ndarray, scale: int) -> np.ndarray:
    """MATLAB-bicubic downsample on host -- how DIV2K LR files were made."""
    h, w = hr.shape[:2]
    h2, w2 = (h // scale) * scale, (w // scale) * scale
    return host_bicubic_resize(hr[:h2, :w2], h2 // scale, w2 // scale)


@dataclasses.dataclass
class EvalSample:
    name: str
    lr: np.ndarray            # HWC uint8
    hr: Optional[np.ndarray]  # HWC uint8 (None if no ground truth)


def _sample(name: str, hr: np.ndarray, lr: Optional[np.ndarray],
            scale: int) -> EvalSample:
    if lr is None:
        lr = host_bicubic_downsample(hr, scale)
    h, w = lr.shape[:2]
    return EvalSample(name, lr, hr[:h * scale, :w * scale])


def load_eval_set(opts, dataset: Optional[str] = None,
                  max_images: Optional[int] = None) -> List[EvalSample]:
    """Load a benchmark set as full images.

    ``synthetic``: the procedural corpus (5 images of 480 x 480, seed
    ``opts.seed + 1``, as the JAX package).  Otherwise
    ``<data_root>/<name>/HR`` with LR from ``LR_bicubic/X<scale>`` (same
    name or DIV2K's ``<stem>x<scale><ext>``), synthesized on host with
    MATLAB bicubic where that folder or file is missing."""
    name = dataset or opts.test_dataset
    scale = opts.scale
    if name.lower() == "synthetic":
        src = SyntheticImages(num_images=max_images or 5, seed=opts.seed + 1)
        return [_sample(src.name(i), src.get(i), None, scale)
                for i in range(len(src))]

    hr_dir = os.path.join(opts.data_root, name, "HR")
    lr_dir = os.path.join(opts.data_root, name, "LR_bicubic", f"X{scale}")
    if not os.path.isdir(hr_dir):
        raise FileNotFoundError(
            f"eval dataset {name!r} not found: expected {hr_dir} (with an "
            f"optional {lr_dir}); or use --dataset synthetic")
    files = sorted(f for f in os.listdir(hr_dir)
                   if f.lower().endswith(_IMG_EXTS))
    if not files:
        raise FileNotFoundError(f"no images under {hr_dir}")
    if max_images is not None:
        files = files[:max_images]
    samples = []
    for f in files:
        stem, ext = os.path.splitext(f)
        lr = None
        for cand in (f, f"{stem}x{scale}{ext}"):
            p = os.path.join(lr_dir, cand)
            if os.path.exists(p):
                lr = imread_uint8(p)
                break
        samples.append(_sample(stem, imread_uint8(os.path.join(hr_dir, f)),
                               lr, scale))
    return samples
