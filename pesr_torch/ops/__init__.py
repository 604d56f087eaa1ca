"""Tensor ops of the port: pixel shuffle, bicubic weights, tiling and the
hand-written CUDA kernels (``pesr_torch.ops.kernels``)."""
