"""Ma et al. (2017) no-reference SR quality metric: the feature pipeline
and a regressor whose weights load from an ``.npz``.  The port's own
float64 numpy copy of ``pesr_tpu/metrics/ma_features.py``; it needs no
scipy (the block DCTs are products with the orthonormal DCT-II matrix).

Three statistic families over a 3-scale pyramid, each fed to a
regression forest, the three predictions combined:

1. local frequency: 5 x 5 block-DCT coefficient statistics (GGD shape,
   coefficient of variation, high-frequency energy ratio);
2. global frequency: db2 wavelet subband statistics (GGD fits of the
   detail bands per level and cross-level energy ratios), with the
   periodized boundary extension that keeps the transform orthogonal;
3. spatial: eigen-spectra of the local 5 x 5 patch covariance.

Pooling is the mean and the 10th percentile.  The packaged forests
(``ma_model_natural.npz``, ``ma_model_synthetic.npz``) are copies of the
JAX package's; :class:`MaModel` documents the array format.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Optional

import numpy as np

from pesr_torch.metrics.niqe import _estimate_ggd, _halve, _rgb2gray


@functools.lru_cache(maxsize=8)
def dct_matrix(n: int) -> np.ndarray:
    """The orthonormal DCT-II matrix D (n x n, float64): ``D @ x`` is
    ``scipy.fft.dct(x, norm="ortho")`` and ``D @ B @ D.T`` the 2-D
    transform of a block B."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    d = np.sqrt(2.0 / n) * np.cos(np.pi * (2.0 * i + 1.0) * k / (2.0 * n))
    d[0] /= np.sqrt(2.0)
    return d


# --------------------------------------------------------------------------
# Feature group 1: block-DCT statistics over 3 scales
# --------------------------------------------------------------------------


def _block_dct_stats(gray: np.ndarray, block: int = 5):
    """Per-block 2-D DCT stats of one scale: (GGD alpha of the AC
    coefficients, coefficient of variation, HF energy ratio), each pooled
    as mean and 10th percentile."""
    h, w = gray.shape
    nh, nw = h // block, w // block
    if nh == 0 or nw == 0:
        raise ValueError(f"image {gray.shape} smaller than DCT block")
    blocks = gray[:nh * block, :nw * block].reshape(
        nh, block, nw, block).transpose(0, 2, 1, 3)
    d = dct_matrix(block)
    coefs = d @ blocks @ d.T
    alphas, covs, hfs = [], [], []
    for i in range(nh):
        for j in range(nw):
            c = coefs[i, j]
            ac = c.ravel()[1:]
            alpha, _ = _estimate_ggd(ac)
            alphas.append(alpha)
            mu = np.mean(np.abs(ac)) + 1e-12
            covs.append(float(np.std(np.abs(ac)) / mu))
            e = c * c
            total = float(e.sum()) + 1e-12
            hfs.append(1.0 - float(e[:2, :2].sum()) / total)
    out = []
    for v in (alphas, covs, hfs):
        v = np.asarray(v)
        out += [float(v.mean()), float(np.percentile(v, 10))]
    return out  # 6 per scale


def dct_features(gray: np.ndarray, scales: int = 3) -> np.ndarray:
    """[scales * 6] block-DCT features over the dyadic pyramid."""
    feats = []
    g = gray.astype(np.float64)
    for _ in range(scales):
        feats += _block_dct_stats(g)
        g = _halve(g)
    return np.asarray(feats, np.float64)


# --------------------------------------------------------------------------
# Feature group 2: wavelet subband statistics (db2, 3 levels)
# --------------------------------------------------------------------------

# Daubechies-2 analysis filters (orthonormal).
_DB2_LO = np.array([1 + np.sqrt(3), 3 + np.sqrt(3),
                    3 - np.sqrt(3), 1 - np.sqrt(3)]) / (4 * np.sqrt(2))
_DB2_HI = _DB2_LO[::-1] * np.array([1, -1, 1, -1])


def _dwt_1d(x: np.ndarray, axis: int):
    """One periodized DWT level along ``axis`` (orthogonal: the subband
    energies sum to the input's); returns (approx, detail), each of
    length floor(n / 2) (an odd extent drops its last sample)."""
    n = x.shape[axis] - (x.shape[axis] % 2)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, n)
    x = x[tuple(sl)]
    ext = [(0, 0)] * x.ndim
    ext[axis] = (0, len(_DB2_LO) - 2)
    xe = np.pad(x, ext, mode="wrap")

    def corr(filt):
        out = None
        for k, f in enumerate(filt):
            s = [slice(None)] * x.ndim
            s[axis] = slice(k, k + n, 2)
            term = f * xe[tuple(s)]
            out = term if out is None else out + term
        return out

    return corr(_DB2_LO), corr(_DB2_HI)


def dwt2(gray: np.ndarray):
    """One 2-D DWT level -> (LL, (LH, HL, HH))."""
    lo, hi = _dwt_1d(gray, 0)
    ll, lh = _dwt_1d(lo, 1)
    hl, hh = _dwt_1d(hi, 1)
    return ll, (lh, hl, hh)


def wavelet_features(gray: np.ndarray, levels: int = 3) -> np.ndarray:
    """[levels * 6 + (levels - 1)] features: per level and detail band
    the GGD alpha and log-energy, then the fine / coarse energy ratio of
    consecutive levels."""
    g = gray.astype(np.float64)
    feats, energies = [], []
    for _ in range(levels):
        g, bands = dwt2(g)
        level_e = 0.0
        for band in bands:
            alpha, sigma_sq = _estimate_ggd(band.ravel())
            feats += [alpha, float(np.log1p(sigma_sq))]
            level_e += float(np.mean(band * band))
        energies.append(level_e + 1e-12)
    for k in range(len(energies) - 1):
        feats.append(float(energies[k] / energies[k + 1]))
    return np.asarray(feats, np.float64)


# --------------------------------------------------------------------------
# Feature group 3: patch-PCA eigen-spectra over 3 scales
# --------------------------------------------------------------------------


def pca_features(gray: np.ndarray, patch: int = 5, scales: int = 3,
                 stride: int = 3) -> np.ndarray:
    """[scales * patch^2] normalized eigen-spectra of the local patch
    covariance: sharp images spread their variance across many
    directions, blur concentrates it in the first few."""
    feats = []
    g = gray.astype(np.float64)
    for _ in range(scales):
        h, w = g.shape
        if h < patch or w < patch:
            feats += [0.0] * (patch * patch)
            continue
        ys = np.arange(0, h - patch + 1, stride)
        xs = np.arange(0, w - patch + 1, stride)
        rows = ys[:, None, None, None] + np.arange(patch)[None, :, None, None]
        cols = xs[None, None, :, None] + np.arange(patch)[None, None, None, :]
        patches = g[rows, cols].reshape(len(ys) * len(xs), -1)
        patches = patches - patches.mean(axis=1, keepdims=True)
        cov = patches.T @ patches / max(len(patches) - 1, 1)
        eig = np.linalg.eigvalsh(cov)[::-1]
        eig = eig / (eig.sum() + 1e-12)
        feats += [float(v) for v in eig]
        g = _halve(g)
    return np.asarray(feats, np.float64)


def extract_ma_features(img: np.ndarray) -> Dict[str, np.ndarray]:
    """The three Ma feature groups of one HWC uint8 (or grayscale)
    image, keyed ``dct`` / ``wavelet`` / ``pca``."""
    gray = _rgb2gray(img)
    return {"dct": dct_features(gray), "wavelet": wavelet_features(gray),
            "pca": pca_features(gray)}


# --------------------------------------------------------------------------
# Loadable regressor
# --------------------------------------------------------------------------

_GROUPS = ("dct", "wavelet", "pca")


def _predict_forest(x: np.ndarray, left: np.ndarray, right: np.ndarray,
                    feature: np.ndarray, threshold: np.ndarray,
                    value: np.ndarray, offsets: np.ndarray) -> float:
    """Mean prediction of a CART forest stored as flat node arrays:
    ``left[i] == -1`` marks a leaf predicting ``value[i]``; an interior
    node routes to ``left[i]`` if ``x[feature[i]] <= threshold[i]`` else
    to ``right[i]`` (child indices local to the tree); ``offsets[[t,
    t + 1]]`` bracket tree ``t``'s nodes."""
    preds = []
    for t in range(len(offsets) - 1):
        base = int(offsets[t])
        i = base
        while left[i] != -1:
            i = base + int(left[i] if x[feature[i]] <= threshold[i]
                           else right[i])
        preds.append(float(value[i]))
    return float(np.mean(preds))


@dataclasses.dataclass
class MaModel:
    """Three per-group regressors and their combination weights.

    npz format: for each group g in dct / wavelet / pca EITHER a forest
    (``{g}_children_left``, ``{g}_children_right``, ``{g}_feature``,
    ``{g}_threshold``, ``{g}_value``: flat node arrays, child indices
    local to their tree; ``{g}_tree_offsets`` [n_trees + 1]) OR a linear
    model (``{g}_linear_w`` [D], ``{g}_linear_b`` []); and ``combine_w``
    [3], ``combine_b`` [] for the weighted sum (default: the mean)."""

    arrays: Dict[str, np.ndarray]

    @classmethod
    def load(cls, path: str) -> "MaModel":
        with np.load(path) as z:
            return cls({k: z[k] for k in z.files})

    def save(self, path: str) -> None:
        np.savez(path, **self.arrays)

    def _group_predict(self, g: str, x: np.ndarray) -> float:
        a = self.arrays
        if f"{g}_linear_w" in a:
            return float(x @ a[f"{g}_linear_w"] + a[f"{g}_linear_b"])
        return _predict_forest(
            x, a[f"{g}_children_left"], a[f"{g}_children_right"],
            a[f"{g}_feature"], a[f"{g}_threshold"], a[f"{g}_value"],
            a[f"{g}_tree_offsets"])

    def predict(self, feats: Dict[str, np.ndarray]) -> float:
        w = self.arrays.get("combine_w", np.full(3, 1 / 3))
        b = float(self.arrays.get("combine_b", 0.0))
        return sum(float(wg) * self._group_predict(g, feats[g])
                   for wg, g in zip(w, _GROUPS)) + b

    def __call__(self, img: np.ndarray) -> float:
        return self.predict(extract_ma_features(img))


def load_ma_model(path: Optional[str] = None) -> Optional[MaModel]:
    """The Ma regressor from ``path`` or ``$PESR_MA_MODEL``; None when
    neither names an existing file."""
    path = path or os.environ.get("PESR_MA_MODEL", "")
    if path and os.path.exists(path):
        return MaModel.load(path)
    return None
