"""MATLAB-``imresize``-equivalent bicubic resize (counterpart of
``pesr_tpu/ops/resize.py``; the numpy weights are the port's own copy).

MATLAB's "contributions" algorithm exactly: cubic kernel with a = -0.5,
support widened by 1/scale when downscaling (antialias), symmetric
(mirrored) edges with per-row weight aggregation, separable per axis.
Each axis becomes a dense ``(out_size, in_size)`` matrix, so a resize is
two matmuls (:func:`imresize`, on tensors).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pesr_torch.utils.device import full_f32


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB's bicubic kernel (Keys 1981, a = -0.5)."""
    absx = np.abs(x)
    absx2 = absx * absx
    absx3 = absx2 * absx
    f = (1.5 * absx3 - 2.5 * absx2 + 1.0) * (absx <= 1)
    f += (-0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0) * \
        ((1 < absx) & (absx <= 2))
    return f


@functools.lru_cache(maxsize=128)
def _contributions(in_size: int, out_size: int,
                   antialias: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-pixel indices [out, P] (folded into the input range by
    symmetric mirroring) and row-normalized float64 weights [out, P]."""
    scale = out_size / in_size
    kernel_width = 4.0
    if scale < 1 and antialias:
        kernel_width /= scale

    # Output-pixel centers in input coordinates (0-based form of MATLAB's
    # u = x/scale + 0.5*(1 - 1/scale) with 1-based x).
    x = np.arange(out_size, dtype=np.float64)
    u = (x + 0.5) / scale - 0.5

    left = np.floor(u - kernel_width / 2).astype(np.int64)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :]

    dist = u[:, None] - indices
    if scale < 1 and antialias:
        weights = scale * _cubic(scale * dist)
    else:
        weights = _cubic(dist)
    weights /= np.sum(weights, axis=1, keepdims=True)

    # Symmetric edges: MATLAB folds out-of-range taps with
    # aux = [1:L, L:-1:1]; duplicate columns keep their weights and the
    # matrix form sums them, matching MATLAB's aggregation.
    aux = np.concatenate(
        [np.arange(in_size), np.arange(in_size - 1, -1, -1)])
    indices = aux[np.mod(indices, aux.size)]

    # Drop all-zero weight columns (MATLAB does the same compaction).
    nz = ~np.all(weights == 0, axis=0)
    return indices[:, nz].astype(np.int32), weights[:, nz]


@functools.lru_cache(maxsize=128)
def resize_kernel_matrix(in_size: int, out_size: int,
                         antialias: bool = True) -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix for one axis:
    row i holds the bicubic weights of output pixel i."""
    indices, weights = _contributions(in_size, out_size, antialias)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    out_idx = np.repeat(np.arange(out_size), indices.shape[1])
    np.add.at(mat, (out_idx, indices.ravel()), weights.ravel())
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _kernel_matrix(in_size: int, out_size: int, antialias: bool,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_kernel_matrix(in_size, out_size,
                                                 antialias)).to(device)


def imresize(img: torch.Tensor, out_hw: Tuple[int, int],
             antialias: bool = True) -> torch.Tensor:
    """MATLAB-equivalent bicubic resize of NHWC images: float32 in and
    out, one f32 matmul per resized axis.  Values are not clipped
    (MATLAB clips only on integer output)."""
    h, w = img.shape[1:3]
    oh, ow = out_hw
    x = img.float()
    with full_f32(x.device):
        if oh != h:
            x = torch.einsum("oh,bhwc->bowc",
                             _kernel_matrix(h, oh, antialias, x.device), x)
        if ow != w:
            x = torch.einsum("ow,bhwc->bhoc",
                             _kernel_matrix(w, ow, antialias, x.device), x)
    return x.contiguous()
