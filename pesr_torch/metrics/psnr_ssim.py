"""PSNR / SSIM with the SR-literature conventions: the port's own copy of
``pesr_tpu/metrics/psnr_ssim.py`` (numpy only).

The reference's utils compute PSNR on the luma (Y) channel of the
ITU-R BT.601 YCbCr transform (MATLAB ``rgb2ycbcr`` — Y in [16, 235]),
after cropping a ``scale``-pixel border.  SSIM follows Wang et al. 2004:
11x11 Gaussian window (sigma 1.5), K1=0.01, K2=0.03, L=255, same Y/crop
conventions.  These are the numbers README tables and the 0.05 dB parity
contract (BASELINE.md) are defined over, so the conventions must match
exactly.

numpy implementation (float64): eval runs per-image on host; exactness
matters more than device placement here.
"""

from __future__ import annotations

import numpy as np


def rgb2y(img: np.ndarray) -> np.ndarray:
    """Y of MATLAB rgb2ycbcr for uint8-range inputs (values in [0, 255]):
    float64 in [16, 235]."""
    x = img.astype(np.float64)
    return (65.481 * x[..., 0] + 128.553 * x[..., 1]
            + 24.966 * x[..., 2]) / 255.0 + 16.0


def _prep(sr: np.ndarray, hr: np.ndarray, crop: int, on_y: bool):
    if sr.shape != hr.shape:
        raise ValueError(f"shape mismatch {sr.shape} vs {hr.shape}")
    a = sr.astype(np.float64)
    b = hr.astype(np.float64)
    if on_y and a.ndim == 3 and a.shape[-1] == 3:
        a, b = rgb2y(a), rgb2y(b)
    if crop > 0:
        a = a[crop:-crop, crop:-crop]
        b = b[crop:-crop, crop:-crop]
    return a, b


def calc_psnr(sr: np.ndarray, hr: np.ndarray, crop_border: int = 4,
              on_y: bool = True) -> float:
    """PSNR in dB over [0,255]-range images (Y channel, cropped border)."""
    a, b = _prep(sr, hr, crop_border, on_y)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k /= k.sum()
    return np.outer(k, k)


def _filter2_valid(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'valid' 2-D correlation via stride tricks (no scipy dependency on
    the metrics path)."""
    kh, kw = kernel.shape
    h, w = img.shape
    shape = (h - kh + 1, w - kw + 1, kh, kw)
    strides = img.strides * 2
    windows = np.lib.stride_tricks.as_strided(img, shape, strides)
    return np.einsum("ijkl,kl->ij", windows, kernel, optimize=True)


def calc_ssim(sr: np.ndarray, hr: np.ndarray, crop_border: int = 4,
              on_y: bool = True) -> float:
    """SSIM (Wang et al. 2004, MATLAB ssim_index conventions)."""
    a, b = _prep(sr, hr, crop_border, on_y)
    if a.ndim == 3:  # average channel SSIMs when not on Y
        return float(np.mean([
            calc_ssim(a[..., c], b[..., c], 0, False)
            for c in range(a.shape[-1])]))

    k = _gaussian_kernel()
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2

    mu1 = _filter2_valid(a, k)
    mu2 = _filter2_valid(b, k)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2_valid(a * a, k) - mu1_sq
    sigma2_sq = _filter2_valid(b * b, k) - mu2_sq
    sigma12 = _filter2_valid(a * b, k) - mu12

    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(np.mean(ssim_map))
