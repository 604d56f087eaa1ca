"""The PIRM perceptual index, PI = 0.5 * ((10 - Ma) + NIQE) (the port's own
copy of ``pesr_tpu/metrics/pirm.py``), per image and over a directory of
SR images:

    python -m pesr_torch.metrics.pirm --dir results/Set5

Both terms are float64 numpy on the host.  Neither packaged model gives
published numbers, so the JSON output names both (``niqe_model``,
``ma_model``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional

import numpy as np

from pesr_torch.metrics.ma import ma_provenance, ma_score
from pesr_torch.metrics.niqe import NiqeModel, _default_model, niqe


def perceptual_index(img: np.ndarray,
                     niqe_model: Optional[NiqeModel] = None,
                     ma_predictor: Optional[Callable] = None) -> float:
    """PI of one HWC uint8 image (lower = better perceived quality)."""
    return 0.5 * ((10.0 - ma_score(img, ma_predictor))
                  + niqe(img, niqe_model))


def evaluate_dir(path: str, niqe_model: Optional[NiqeModel] = None,
                 verbose: bool = True) -> dict:
    """PI, NIQE and Ma over the images of a directory: their means, the
    per-image spreads (``*_std``), the standard error of the mean PI
    (``pi_sem``) and the models' provenance."""
    from pesr_torch.utils.image_io import imread_uint8

    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    pis, niqes, mas = [], [], []
    for f in files:
        img = imread_uint8(os.path.join(path, f))
        n = niqe(img, niqe_model)
        m = ma_score(img)
        pi = 0.5 * ((10.0 - m) + n)
        pis.append(pi)
        niqes.append(n)
        mas.append(m)
        if verbose:
            print(f"{f}: PI {pi:.3f}  NIQE {n:.3f}  Ma~ {m:.3f}")
    n = len(files)
    return {"pi": float(np.mean(pis)), "niqe": float(np.mean(niqes)),
            "ma": float(np.mean(mas)), "n_images": n,
            "pi_std": float(np.std(pis)),
            "pi_sem": float(np.std(pis) / np.sqrt(n)),
            "niqe_std": float(np.std(niqes)),
            "ma_std": float(np.std(mas)),
            "niqe_model": (niqe_model or _default_model()).provenance,
            "ma_model": ma_provenance()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True,
                   help="directory of SR images (pesr_torch.test output)")
    p.add_argument("--niqe_model", default="",
                   help="optional .npz pristine model (metrics.niqe)")
    args = p.parse_args(argv)
    model = NiqeModel.load(args.niqe_model) if args.niqe_model else None
    print(json.dumps(evaluate_dir(args.dir, model)))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
