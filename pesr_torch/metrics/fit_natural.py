"""Refit the no-reference metric models on the natural photographs that
ship inside installed packages (``pesr_torch/data/natural.py``) and
write them as the packaged defaults:

    python -m pesr_torch.metrics.fit_natural \\
        [--niqe_out pesr_torch/metrics/niqe_model_natural.npz] \\
        [--ma_out pesr_torch/metrics/ma_model_natural.npz]

The port's copy of ``pesr_tpu/metrics/fit_natural.py``, with the same
flags, defaults, printed lines and exit code.  The NIQE pristine
(mu, cov) is learned from photographs, the class of content MATLAB's
model was fitted on, and the Ma forests' degradation ladder runs over
crops of them (``fit_ma.py``; ``--crop`` and ``--max_crops_per_image``
shape only the holdout crop, as in the JAX package).  Absolute values
stay approximate (a dozen images against NIQE's 125, ordinal ladder
targets against Ma's opinion scores); every npz embeds a provenance
string that ``pirm.py`` reports.  With fewer than 4 registry images the
fit is refused and the packaged models stay.

The validation printed at the end sweeps the registry's holdout
photographs, which the fits never see: NIQE and Ma must order pristine
better than bicubic x4 up better than heavy blur on each, else the exit
code is 1.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

_HERE = os.path.dirname(__file__)
NIQE_NATURAL_PATH = os.path.join(_HERE, "niqe_model_natural.npz")
MA_NATURAL_PATH = os.path.join(_HERE, "ma_model_natural.npz")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--niqe_out", default=NIQE_NATURAL_PATH)
    p.add_argument("--ma_out", default=MA_NATURAL_PATH)
    p.add_argument("--sharpness_threshold", type=float, default=0.75)
    p.add_argument("--crop", type=int, default=192)
    p.add_argument("--max_crops_per_image", type=int, default=4)
    p.add_argument("--n_trees", type=int, default=12)
    p.add_argument("--max_depth", type=int, default=7)
    p.add_argument("--seed", type=int, default=77)
    args = p.parse_args(argv)

    from pesr_torch.data import natural
    from pesr_torch.metrics.fit_ma import (crops_from_images,
                                           degradation_ladder, fit_ma_model)
    from pesr_torch.metrics.niqe import NiqeModel, fit_niqe_model, niqe

    named = natural.load_natural_images()
    if len(named) < 4:
        raise SystemExit(
            f"only {len(named)} curated natural images found on this "
            "machine — refusing to fit (the packaged synthetic-fitted "
            "models stay the default)")
    names = [n for n, _ in named]
    images = [img for _, img in named]
    print(f"fitting on {len(images)} natural images: {', '.join(names)}")

    prov_base = (f"natural-image-fitted on {len(images)} photographs "
                 f"bundled with installed packages ({', '.join(names)}; "
                 "pesr_torch/data/natural.py registry)")

    niqe_model = fit_niqe_model(
        images, sharpness_threshold=args.sharpness_threshold,
        provenance=prov_base + " — closest available stand-in for the "
        "125-photograph MATLAB pristine corpus")
    niqe_model.save(args.niqe_out)
    print(f"saved NIQE pristine model -> {args.niqe_out}")

    ma_model = fit_ma_model(
        n_trees=args.n_trees, max_depth=args.max_depth, seed=args.seed,
        hr_images=images,
        provenance=prov_base + " — degradation-ladder ordinal targets "
        "(pesr_torch/metrics/fit_ma.py), ordering-faithful for SR "
        "degradations, NOT published-Ma comparable")
    ma_model.save(args.ma_out)
    print(f"saved Ma forest -> {args.ma_out}")

    # held-out validation on the never-fitted photographs
    holdouts = natural.load_holdout_images()
    rc = 0
    if not holdouts:
        print("no holdout images available; skipping validation")
        return rc
    niqe_m = NiqeModel.load(args.niqe_out)
    for hname, holdout in holdouts:
        ladder = degradation_ladder(holdout, np.random.default_rng(0))
        n_scores = {}
        for variant, score in (ladder[0], ladder[5], ladder[7]):
            n_scores[score] = niqe(variant, niqe_m)
        print(f"holdout[{hname}] NIQE: pristine {n_scores[9.5]:.2f}  "
              f"x4-up {n_scores[3.5]:.2f}  blur {n_scores[1.5]:.2f}")
        if not n_scores[9.5] < n_scores[3.5] < n_scores[1.5]:
            print(f"WARNING: NIQE degradation ordering violated on "
                  f"holdout {hname}")
            rc = 1
        crop_hold = crops_from_images([holdout], crop=args.crop,
                                      max_crops_per_image=1)
        if crop_hold:
            lad = degradation_ladder(crop_hold[0],
                                     np.random.default_rng(0))
            s_hr, s_mid, s_bad = (ma_model(lad[0][0]),
                                  ma_model(lad[5][0]),
                                  ma_model(lad[7][0]))
            print(f"holdout[{hname}] Ma: pristine {s_hr:.2f}  "
                  f"x4-up {s_mid:.2f}  blur {s_bad:.2f}")
            if not s_hr > s_mid > s_bad:
                print(f"WARNING: Ma degradation ordering violated on "
                      f"holdout {hname}")
                rc = 1
    print("ok" if rc == 0 else "completed with ordering warnings")
    return rc


if __name__ == "__main__":
    import sys
    sys.exit(main())
