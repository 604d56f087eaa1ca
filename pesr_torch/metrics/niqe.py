"""NIQE, the Natural Image Quality Evaluator (Mittal, Soundararajan,
Bovik 2013): the NIQE half of the PIRM perceptual index.  The port's own
float64 numpy copy of ``pesr_tpu/metrics/niqe.py``, run on the host as
the JAX package runs it; it needs no scipy.

The MATLAB reference pipeline:

* luminance (MATLAB ``rgb2gray`` coefficients);
* MSCN coefficients with a 7 x 7 Gaussian (sigma 7/6) local mean and
  standard deviation;
* per 96 x 96 block, 18 features: the GGD fit of the MSCN field (2) and
  the AGGD fits of its four pairwise-product orientations (4 x 4);
* two scales (the second after MATLAB-bicubic 0.5x with antialias), 36;
* the score: a Mahalanobis-style distance between the image's (mean,
  covariance) over blocks and a pristine model's (mu, cov).

The canonical pristine model ships with MATLAB and is not here.  The
packaged ones are copies of the JAX package's: fitted on photographs
found in installed packages (``niqe_model_natural.npz``, preferred) and
on the synthetic corpus (``niqe_model.npz``).  ``$PESR_NIQE_MODEL``
overrides both; ``python -m pesr_torch.metrics.niqe --fit_dir`` refits
one from a folder of pristine images.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Iterable, Optional, Tuple

import numpy as np

from pesr_torch.ops.resize import resize_kernel_matrix

_HERE = os.path.dirname(__file__)
_DEFAULT_MODEL_PATH = os.path.join(_HERE, "niqe_model.npz")
_NATURAL_MODEL_PATH = os.path.join(_HERE, "niqe_model_natural.npz")

# Gamma-ratio lookup for the GGD / AGGD shape fits:
# r(a) = gamma(2/a)^2 / (gamma(1/a) gamma(3/a)) on a in [0.2, 10].
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.array([math.gamma(2.0 / a) ** 2
                   / (math.gamma(1.0 / a) * math.gamma(3.0 / a))
                   for a in _GAM])


def _rgb2gray(img: np.ndarray) -> np.ndarray:
    """MATLAB rgb2gray (values stay in [0, 255])."""
    if img.ndim == 2:
        return img.astype(np.float64)
    x = img.astype(np.float64)
    return 0.2989 * x[..., 0] + 0.5870 * x[..., 1] + 0.1140 * x[..., 2]


def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    w = np.outer(k, k)
    return w / w.sum()


def _filter2_same(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'same' correlation with replicated borders (the NIQE code's
    ``imfilter(..., 'replicate')``)."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, ph), (pw, pw)), mode="edge")
    h, w = img.shape
    windows = np.lib.stride_tricks.as_strided(
        padded, (h, w, kh, kw), padded.strides * 2)
    return np.einsum("ijkl,kl->ij", windows, kernel, optimize=True)


def compute_mscn(gray: np.ndarray, c: float = 1.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """MSCN coefficients and the local-sigma field."""
    w = _gaussian_window()
    mu = _filter2_same(gray, w)
    sigma = np.sqrt(np.abs(_filter2_same(gray * gray, w) - mu * mu))
    return (gray - mu) / (sigma + c), sigma


def _estimate_ggd(vec: np.ndarray) -> Tuple[float, float]:
    """Generalized Gaussian fit -> (alpha, sigma^2)."""
    sigma_sq = float(np.mean(vec ** 2))
    e_abs = float(np.mean(np.abs(vec)))
    rho = sigma_sq / (e_abs ** 2 + 1e-12)
    alpha = _GAM[np.argmin(np.abs(_R_GAM - 1.0 / (rho + 1e-12)))]
    return float(alpha), sigma_sq


def _estimate_aggd(vec: np.ndarray) -> Tuple[float, float, float, float]:
    """Asymmetric GGD fit -> (alpha, mean, sigma_l^2, sigma_r^2)."""
    left = vec[vec < 0]
    right = vec[vec > 0]
    sigma_l_sq = float(np.mean(left ** 2)) if left.size else 0.0
    sigma_r_sq = float(np.mean(right ** 2)) if right.size else 0.0
    sigma_l = np.sqrt(sigma_l_sq)
    sigma_r = np.sqrt(sigma_r_sq)
    gamma_hat = sigma_l / (sigma_r + 1e-12)
    r_hat = (float(np.mean(np.abs(vec))) ** 2) / (
        float(np.mean(vec ** 2)) + 1e-12)
    r_hat_norm = r_hat * (gamma_hat ** 3 + 1) * (gamma_hat + 1) / (
        (gamma_hat ** 2 + 1) ** 2 + 1e-12)
    alpha = float(_GAM[np.argmin((_R_GAM - r_hat_norm) ** 2)])
    const = math.sqrt(math.gamma(1.0 / alpha) / math.gamma(3.0 / alpha))
    mean_param = (sigma_r - sigma_l) * (
        math.gamma(2.0 / alpha) / math.gamma(1.0 / alpha)) * const
    return alpha, float(mean_param), sigma_l_sq, sigma_r_sq


def _block_features(mscn: np.ndarray) -> np.ndarray:
    """The 18 NIQE features of one block's MSCN field."""
    feats = list(_estimate_ggd(mscn.ravel()))
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):  # H, V, D1, D2
        # Circular shifts, as MATLAB's circshift in the reference code
        # that the pristine models are fitted against: the pairwise
        # products wrap around at the block's edges.
        shifted = np.roll(np.roll(mscn, dy, axis=0), dx, axis=1)
        feats.extend(_estimate_aggd((mscn * shifted).ravel()))
    return np.asarray(feats, np.float64)


def _halve(gray: np.ndarray) -> np.ndarray:
    """MATLAB ``imresize(im, 0.5)`` with antialias: the resize's float32
    matrices, applied in float64."""
    h, w = gray.shape
    mh = resize_kernel_matrix(h, h // 2).astype(np.float64)
    mw = resize_kernel_matrix(w, w // 2).astype(np.float64)
    return mh @ gray @ mw.T


def extract_niqe_features(img: np.ndarray, block: int = 96,
                          sharpness_threshold: Optional[float] = None
                          ) -> np.ndarray:
    """Per-block features [n_blocks, 36] over two scales.

    ``sharpness_threshold`` in (0, 1] selects blocks as a fit does (mean
    local sigma above threshold x the largest block's); None keeps every
    block, as a score does.  Raises ValueError for an image smaller than
    one block."""
    gray = _rgb2gray(img)
    h, w = gray.shape
    nh, nw = h // block, w // block
    if nh == 0 or nw == 0:
        raise ValueError(f"image {gray.shape} smaller than NIQE block "
                         f"{block}")
    gray = gray[:nh * block, :nw * block]
    per_scale = []
    keep = None
    for scale_idx in range(2):
        b = block // (2 ** scale_idx)
        mscn, sigma = compute_mscn(gray)
        feats, sharps = [], []
        for i in range(nh):
            for j in range(nw):
                feats.append(_block_features(
                    mscn[i * b:(i + 1) * b, j * b:(j + 1) * b]))
                sharps.append(np.mean(
                    sigma[i * b:(i + 1) * b, j * b:(j + 1) * b]))
        feats = np.stack(feats)
        if scale_idx == 0 and sharpness_threshold is not None:
            sharps = np.asarray(sharps)
            keep = sharps > sharpness_threshold * sharps.max()
            if keep.sum() < 2:
                keep = np.ones(len(feats), bool)
        per_scale.append(feats)
        if scale_idx == 0:
            gray = _halve(gray)
    all_feats = np.concatenate(per_scale, axis=1)
    return all_feats[keep] if keep is not None else all_feats


@dataclasses.dataclass
class NiqeModel:
    mu: np.ndarray    # [36]
    cov: np.ndarray   # [36, 36]
    provenance: str = ""  # what the pristine model was fitted on

    def save(self, path: str) -> None:
        np.savez(path, mu=self.mu, cov=self.cov,
                 provenance=np.str_(self.provenance))

    @classmethod
    def load(cls, path: str) -> "NiqeModel":
        data = np.load(path)
        prov = (str(data["provenance"]) if "provenance" in data.files
                else f"{os.path.basename(path)} (no provenance recorded)")
        return cls(mu=data["mu"], cov=data["cov"], provenance=prov)


def fit_niqe_model(images: Iterable[np.ndarray],
                   sharpness_threshold: float = 0.75,
                   provenance: str = "") -> NiqeModel:
    """Fit a pristine model from HWC uint8 (or [0, 255] float) images."""
    feats = np.concatenate([
        extract_niqe_features(img, sharpness_threshold=sharpness_threshold)
        for img in images])
    return NiqeModel(mu=feats.mean(axis=0), cov=np.cov(feats.T),
                     provenance=provenance)


def _default_model() -> NiqeModel:
    """The pristine model a score uses when none is given:
    ``$PESR_NIQE_MODEL`` > the packaged natural-image fit > the packaged
    synthetic fit > a fit on the synthetic corpus now.  Resolved once per
    value of the variable."""
    return _model_for(os.environ.get("PESR_NIQE_MODEL", ""))


@functools.lru_cache(maxsize=4)
def _model_for(env: str) -> NiqeModel:
    if env and os.path.exists(env):
        return NiqeModel.load(env)
    if env:
        print(f"[niqe] WARNING: PESR_NIQE_MODEL={env} does not exist; "
              "falling back to the packaged pristine model")
    for path in (_NATURAL_MODEL_PATH, _DEFAULT_MODEL_PATH):
        if os.path.exists(path):
            return NiqeModel.load(path)
    from pesr_torch.data.datasets import SyntheticImages
    src = SyntheticImages(num_images=24, height=480, width=480, seed=1234)
    model = fit_niqe_model(
        [src.get(i) for i in range(len(src))],
        provenance="synthetic-fitted (deterministic synthetic corpus) "
                   "— NOT comparable to published NIQE")
    try:
        model.save(_DEFAULT_MODEL_PATH)
    except OSError:
        pass  # a read-only install keeps the fit in this process only
    return model


def niqe_from_features(feats: np.ndarray, model: NiqeModel) -> float:
    """NIQE score from an ``extract_niqe_features`` matrix."""
    feats = feats[np.isfinite(feats).all(axis=1)]
    if feats.shape[0] == 0:
        raise ValueError("no finite NIQE feature blocks in image")
    mu_t = feats.mean(axis=0)
    # One block has no sample covariance: pool with the pristine one
    # alone, as MATLAB's formula reduces to.
    cov_t = (np.cov(feats.T) if feats.shape[0] > 1
             else np.zeros_like(model.cov))
    pooled = (model.cov + cov_t) / 2.0
    diff = model.mu - mu_t
    return float(np.sqrt(diff @ np.linalg.pinv(pooled) @ diff))


def niqe(img: np.ndarray, model: Optional[NiqeModel] = None) -> float:
    """NIQE score of one HWC uint8 image (lower = more natural)."""
    return niqe_from_features(extract_niqe_features(img),
                              model or _default_model())


def main(argv=None) -> int:
    """Refit the NIQE pristine model from a directory of natural images:

        python -m pesr_torch.metrics.niqe --fit_dir <HR images> \\
            [--out pesr_torch/metrics/niqe_model.npz] [--max_images N]
    """
    import argparse

    from pesr_torch.utils.image_io import imread_uint8

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--fit_dir", required=True)
    p.add_argument("--out", default=_DEFAULT_MODEL_PATH)
    p.add_argument("--max_images", type=int, default=200)
    p.add_argument("--sharpness_threshold", type=float, default=0.75)
    args = p.parse_args(argv)
    files = sorted(
        f for f in os.listdir(args.fit_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    )[:args.max_images]
    if not files:
        raise SystemExit(f"no images under {args.fit_dir}")
    print(f"fitting NIQE pristine model on {len(files)} images ...")
    model = fit_niqe_model(
        (imread_uint8(os.path.join(args.fit_dir, f)) for f in files),
        args.sharpness_threshold,
        provenance=f"fitted on {args.fit_dir} ({len(files)} images)")
    model.save(args.out)
    print(f"saved {args.out} (mu[0]={model.mu[0]:.4f})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
