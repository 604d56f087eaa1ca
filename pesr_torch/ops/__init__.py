"""Tensor ops of the port: pixel shuffle, bicubic weights, tiling and the
hand-written CUDA kernels (``pesr_torch.ops.kernels``)."""

from pesr_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from pesr_torch.ops.resize import imresize, resize_kernel_matrix

__all__ = [
    "pixel_shuffle",
    "pixel_unshuffle",
    "imresize",
    "resize_kernel_matrix",
]
