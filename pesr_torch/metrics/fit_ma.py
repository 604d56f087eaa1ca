"""Fit the Ma regression forests on the synthetic corpus and save them in
the :class:`MaModel` npz schema (``$PESR_MA_MODEL``):

    python -m pesr_torch.metrics.fit_ma --out pesr_torch/metrics/ma_model_synthetic.npz

The port's copy of ``pesr_tpu/metrics/fit_ma.py``, with the same
functions, flags, defaults, printed lines and exit code.  Training
signal: the published Ma regressor was trained on human opinion scores
of SR outputs, which are not available here.  The stand-in target is a
degradation-ladder ordinal score: each pristine image spawns variants
from pristine through mild blur, bicubic down/up at growing scales and
heavy blur, with fixed scores in [1, 9.5] ordered by severity (plus a
noise rung, so the forests learn that high-frequency energy alone is not
quality).  The fitted model tracks the real metric's ordering on SR-style
degradations through the genuine three-family feature pipeline
(``ma_features.py``); absolute values are NOT published-Ma comparable,
and the npz embeds a ``provenance`` string that ``pirm.py`` reports.

The forests come from ``forest.py``, which builds scikit-learn's
``RandomForestRegressor`` trees node for node without it, so at the
defaults this writes the arrays of the packaged
``ma_model_synthetic.npz`` bitwise.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np

from pesr_torch.metrics.forest import fit_forest, forest_arrays
from pesr_torch.metrics.ma_features import _GROUPS, MaModel, \
    extract_ma_features


def degradation_ladder(hr: np.ndarray, rng: np.random.Generator
                       ) -> List[Tuple[np.ndarray, float]]:
    """(variant, target score) pairs for one pristine HWC uint8 image.

    Scores are a fixed ordinal ladder, not calibrated opinion scores —
    see the module docstring."""
    from scipy.ndimage import gaussian_filter

    from pesr_torch.data.datasets import (host_bicubic_downsample,
                                          host_bicubic_resize)

    def blur(img: np.ndarray, sigma: float) -> np.ndarray:
        out = np.stack([gaussian_filter(img[..., c].astype(np.float64),
                                        sigma) for c in range(3)], -1)
        return np.clip(out + 0.5, 0, 255).astype(np.uint8)

    def down_up(img: np.ndarray, s: int) -> np.ndarray:
        h, w = img.shape[:2]
        return host_bicubic_resize(host_bicubic_downsample(img, s), h, w)

    noisy = np.clip(hr.astype(np.float64)
                    + rng.normal(0.0, 8.0, hr.shape) + 0.5,
                    0, 255).astype(np.uint8)
    return [
        (hr, 9.5),
        (blur(hr, 0.6), 7.5),
        (down_up(hr, 2), 6.5),
        (noisy, 5.5),
        (down_up(hr, 3), 5.0),
        (down_up(hr, 4), 3.5),
        (blur(down_up(hr, 4), 1.0), 2.5),
        (blur(hr, 2.5), 1.5),
    ]


def crops_from_images(images: List[np.ndarray], crop: int = 192,
                      max_crops_per_image: int = 4) -> List[np.ndarray]:
    """Deterministic grid of up to N crop x crop windows per image, corners
    first: turns arbitrarily sized pristine sources (e.g. the natural
    registry) into ladder-ready HR patches."""
    out: List[np.ndarray] = []
    for img in images:
        h, w = img.shape[:2]
        if h < crop or w < crop:
            continue
        nh, nw = h // crop, w // crop
        coords = [(i, j) for i in range(nh) for j in range(nw)]
        coords.sort(key=lambda ij: (min(ij[0], nh - 1 - ij[0])
                                    + min(ij[1], nw - 1 - ij[1])))
        for i, j in coords[:max_crops_per_image]:
            out.append(img[i * crop:(i + 1) * crop,
                           j * crop:(j + 1) * crop])
    return out


def build_training_set(num_images: int = 24, crop: int = 192,
                       seed: int = 77,
                       hr_images: Optional[List[np.ndarray]] = None
                       ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Feature matrices per group + target vector over the ladder.

    ``hr_images``: explicit pristine HR sources (cropped to ``crop``
    windows); default is the deterministic synthetic corpus."""
    if hr_images is not None:
        patches = crops_from_images(hr_images, crop=crop)
    else:
        from pesr_torch.data.datasets import SyntheticImages
        src = SyntheticImages(num_images=num_images, height=crop,
                              width=crop, seed=seed)
        patches = [src.get(i) for i in range(len(src))]
    rng = np.random.default_rng(seed)
    cols: Dict[str, List[np.ndarray]] = {g: [] for g in _GROUPS}
    ys: List[float] = []
    for hr in patches:
        for variant, score in degradation_ladder(hr, rng):
            feats = extract_ma_features(variant)
            for g in _GROUPS:
                cols[g].append(feats[g])
            ys.append(score)
    return ({g: np.stack(v) for g, v in cols.items()},
            np.asarray(ys, np.float64))


def fit_forests(x: Dict[str, np.ndarray], y: np.ndarray,
                n_trees: int = 12, max_depth: int = 7, seed: int = 77,
                provenance: Optional[str] = None) -> MaModel:
    """Fit the per-group forests from already-extracted feature matrices
    (``build_training_set`` output)."""
    arrays: Dict[str, np.ndarray] = {}
    for g in _GROUPS:
        arrays.update(forest_arrays(
            fit_forest(x[g], y, n_trees=n_trees, max_depth=max_depth,
                       seed=seed), g))
    arrays["combine_w"] = np.full(3, 1 / 3, np.float32)
    arrays["combine_b"] = np.float32(0.0)
    arrays["provenance"] = np.str_(provenance or (
        "synthetic-fitted: degradation-ladder ordinal targets on the "
        "deterministic synthetic corpus (pesr_torch/metrics/fit_ma.py) — "
        "ordering-faithful for SR degradations, NOT published-Ma "
        "comparable"))
    return MaModel(arrays)


def fit_ma_model(num_images: int = 24, n_trees: int = 12,
                 max_depth: int = 7, seed: int = 77,
                 hr_images: Optional[List[np.ndarray]] = None,
                 provenance: Optional[str] = None) -> MaModel:
    x, y = build_training_set(num_images=num_images, seed=seed,
                              hr_images=hr_images)
    return fit_forests(x, y, n_trees=n_trees, max_depth=max_depth,
                       seed=seed, provenance=provenance)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--num_images", type=int, default=24)
    p.add_argument("--n_trees", type=int, default=12)
    p.add_argument("--max_depth", type=int, default=7)
    p.add_argument("--seed", type=int, default=77)
    args = p.parse_args(argv)

    model = fit_ma_model(args.num_images, args.n_trees, args.max_depth,
                         args.seed)
    model.save(args.out)

    # Held-out sanity: the fitted score must order pristine > bicubic
    # x4 up > heavy blur on images the fit never saw.
    from pesr_torch.data.datasets import SyntheticImages
    src = SyntheticImages(num_images=4, height=192, width=192, seed=991)
    rng = np.random.default_rng(0)
    ok = 0
    for i in range(len(src)):
        ladder = degradation_ladder(src.get(i), rng)
        s_hr = model(ladder[0][0])
        s_mid = model(ladder[5][0])   # down_up x4
        s_bad = model(ladder[7][0])   # blur 2.5
        ok += (s_hr > s_mid > s_bad)
        print(f"holdout {i}: hr {s_hr:.2f}  x4-up {s_mid:.2f}  "
              f"blur {s_bad:.2f}")
    print(f"ordering correct on {ok}/{len(src)} held-out images")
    print(f"saved -> {args.out}")
    return 0 if ok == len(src) else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
