"""The Ma et al. (2017) SR quality score (the port's own copy of
``pesr_tpu/metrics/ma.py``).

The published score is a learned regressor (MATLAB code and trained
forests) that is not in this repository.  ``ma_score`` resolves, in
order: an explicit ``predictor``; the forest in ``$PESR_MA_MODEL``; the
packaged natural-image forest (``ma_model_natural.npz``); the packaged
synthetic forest (``ma_model_synthetic.npz``); the fixed approximation
``ma_score_approx``.  Every forest runs the three-family feature pipeline
of ``ma_features``.  ``ma_provenance`` names the one in use.  None of
them gives published Ma numbers.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional, Tuple

import numpy as np

from pesr_torch.metrics.ma_features import (MaModel, dct_matrix,
                                            load_ma_model)
from pesr_torch.metrics.niqe import _rgb2gray, compute_mscn

_HERE = os.path.dirname(__file__)
_DEFAULT_FOREST_PATHS = (os.path.join(_HERE, "ma_model_natural.npz"),
                         os.path.join(_HERE, "ma_model_synthetic.npz"))


def ma_score_approx(img: np.ndarray, block: int = 32) -> float:
    """Approximate Ma score in [0, 10] (higher = better perceived SR),
    from the mean high-frequency DCT energy ratio of 32 x 32 blocks
    (energy outside the lowest 8 x 8 corner) and the MSCN variance, each
    through a fixed logistic (constants not fitted to any reference)."""
    gray = _rgb2gray(img) / 255.0
    h, w = gray.shape
    nh, nw = h // block, w // block
    if nh == 0 or nw == 0:
        raise ValueError(f"image {gray.shape} smaller than block {block}")
    d = dct_matrix(block)
    hf_ratios = []
    for i in range(nh):
        for j in range(nw):
            c = d @ gray[i * block:(i + 1) * block,
                         j * block:(j + 1) * block] @ d.T
            energy = c * c
            total = float(energy.sum()) + 1e-12
            low = float(energy[:8, :8].sum())
            hf_ratios.append((total - low) / total)
    hf = float(np.mean(hf_ratios))
    mscn, _ = compute_mscn(gray * 255.0)
    spread = float(np.var(mscn))
    s_hf = 1.0 / (1.0 + np.exp(-(hf - 0.10) / 0.04))
    s_sp = 1.0 / (1.0 + np.exp(-(spread - 0.55) / 0.15))
    return float(10.0 * (0.6 * s_hf + 0.4 * s_sp))


def _real_model() -> Tuple[Optional[MaModel], str]:
    """The forest-backed regressor and the path it came from
    (``(None, "")`` when there is none): ``$PESR_MA_MODEL`` > the packaged
    natural forest > the packaged synthetic forest.  Resolved once per
    value of the variable."""
    return _forest_for(os.environ.get("PESR_MA_MODEL", ""))


@functools.lru_cache(maxsize=4)
def _forest_for(env: str) -> Tuple[Optional[MaModel], str]:
    model = load_ma_model(env or None)
    if model is not None:
        return model, env
    if env:
        print(f"[ma] WARNING: PESR_MA_MODEL={env} does not exist; falling "
              "back to the packaged forest")
    for path in _DEFAULT_FOREST_PATHS:
        if os.path.exists(path):
            return MaModel.load(path), path
    return None, ""


def ma_score(img: np.ndarray,
             predictor: Optional[Callable[[np.ndarray], float]] = None
             ) -> float:
    """Ma score of one HWC uint8 image (higher = better)."""
    if predictor is not None:
        return float(predictor(img))
    model, _ = _real_model()
    if model is not None:
        return float(model(img))
    return ma_score_approx(img)


def ma_provenance() -> str:
    """Which predictor ``ma_score`` without a ``predictor`` uses now."""
    model, path = _real_model()
    if model is not None:
        embedded = model.arrays.get("provenance")
        return (f"forest:{path}"
                + (f" — {embedded}" if embedded is not None else ""))
    return ("approximation: fixed logistic constants "
            "(ma.ma_score_approx) — NOT published-Ma comparable")
