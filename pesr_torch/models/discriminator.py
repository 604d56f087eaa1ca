"""SRGAN-style strided-conv discriminator (counterpart of
``pesr_tpu/models/discriminator.py``).

{3x3 conv stride 1, 3x3 conv stride 2} pairs over the channel schedule
(64 -> 128 -> 256 -> 512 by default), batch-statistics normalisation and
LeakyReLU(0.2) after every conv but the first, then flatten -> dense
(1024) -> LeakyReLU -> dense(1): raw float32 logits [B, 1], no sigmoid.

As in the JAX module:

* the normalisation uses the statistics of the batch it is given (biased
  variance, eps 1e-5, in float32) and keeps no running statistics, so
  applying D to HR and to SR separately is not the same model as applying
  it to their concatenation;
* spectral normalisation is stateless: a power iteration from the ones
  vector, 10 iterations on every call, differentiated through (not
  ``torch.nn.utils.spectral_norm``, whose persistent ``u`` is another
  algorithm);
* convs pad (1, 1) explicitly at both strides and compute in ``dtype``,
  bias added in ``dtype``;
* on a mesh of P processes (:func:`set_batch_stats_mesh`) the batch
  statistics are the GLOBAL batch's, as under JAX's jit over a sharded
  batch: two differentiable all-reduces per norm (the sum, then the
  squared deviations from the global mean), whose backward carries every
  rank's gradient through them, the gradient penalty's double backward
  included.

The module takes NHWC images (the generator's output layout) and runs
NCHW; its dense head flattens (C, H, W), the torch SRGAN order, so its
state_dict is the ``.pth`` that ``pesr_tpu.convert.load_discriminator_
weights`` reads.  ``hr_size`` sizes the head, since torch needs
``in_features`` at construction.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pesr_torch.models.generator import init_weights
from pesr_torch.parallel import sum_all
from pesr_torch.utils.device import resolve_device


SN_ITERS = 10
LEAK = 0.2


def spectral_normalize(w: torch.Tensor) -> torch.Tensor:
    """``w / sigma``, sigma the top singular value of the OIHW kernel as a
    [kh * kw * Cin, Cout] matrix, estimated by ``SN_ITERS`` power
    iterations from the ones vector (cold on every call).  The rows are
    in (Cin, kh, kw) order here, (kh, kw, Cin) in the JAX module's HWIO
    reshape: a row permutation, under which this iteration and sigma are
    the same."""
    mat = w.flatten(1).t().float()
    u = torch.full((mat.shape[0],), 1.0 / math.sqrt(mat.shape[0]),
                   dtype=torch.float32, device=w.device)
    for _ in range(SN_ITERS):
        v = mat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
    sigma = u @ (mat @ v)
    return (w / (sigma + 1e-12)).to(w.dtype)


class SNConv(nn.Module):
    """3x3 conv, padding (1, 1), stride 1 or 2, with optional stateless
    spectral normalisation; computes in ``dtype``."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 use_sn: bool = False, dtype: torch.dtype = torch.bfloat16,
                 device=None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        self.stride, self.use_sn, self.dtype = stride, use_sn, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = spectral_normalize(self.weight) if self.use_sn else self.weight
        return F.conv2d(x.to(self.dtype), w.to(self.dtype),
                        self.bias.to(self.dtype), stride=self.stride,
                        padding=1)


class BatchStatNorm(nn.Module):
    """Batch normalisation on the statistics of the batch at hand only
    (training-mode math, no running statistics), in float32, cast back to
    the input's dtype.

    Written out from ``var_mean`` as the JAX module writes it, not
    ``F.batch_norm``: the gradient penalty differentiates D twice, and
    ``F.batch_norm``'s double backward lost ~1% of D's gradient in f32
    (CPU, after one D update) where this form agrees with float64 to
    1e-6."""

    def __init__(self, c: int, eps: float = 1e-5, device=None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.eps = eps
        self.mesh = None  # set_batch_stats_mesh: statistics over a mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.mesh is not None and self.mesh.collective:
            dims = (0, 2, 3)
            n = xf.shape[0] * xf.shape[2] * xf.shape[3] * self.mesh.size
            mean = sum_all(self.mesh, xf.sum(dims, keepdim=True)) / n
            dev = xf - mean
            var = sum_all(self.mesh, (dev * dev).sum(dims, keepdim=True)) / n
        else:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0,
                                       keepdim=True)
        scale = torch.rsqrt(var + self.eps) * self.weight.view(1, -1, 1, 1)
        return ((xf - mean) * scale + self.bias.view(1, -1, 1, 1)).to(x.dtype)


def set_batch_stats_mesh(d: nn.Module, mesh) -> None:
    """Take every ``BatchStatNorm`` of ``d`` over the global batch of
    ``mesh`` (None: this process's batch)."""
    for m in d.modules():
        if isinstance(m, BatchStatNorm):
            m.mesh = mesh


def head_side(hr_size: int, n_stages: int) -> int:
    """Side of the map the dense head flattens: ``hr_size`` after one
    stride-2 conv (ceil halving) per stage."""
    for _ in range(n_stages):
        hr_size = -(-hr_size // 2)
    return hr_size


class Discriminator(nn.Module):
    """Strided-conv discriminator: NHWC images -> float32 logits [B, 1].

    ``channel_schedule`` sets the widths; left None they are
    ``base_channels`` x (1, 2, 4, 8).  Modules register in forward order
    (``conv0``, ``conv0s``, ``bn0``, then ``conv{i}``, ``bn{i}a``,
    ``conv{i}s``, ``bn{i}b`` per stage, ``fc0``, ``fc1``): the SRGAN
    registration order, 2 x stages convs, 2 x stages - 1 norms and 2
    dense layers, which the positional converters read."""

    def __init__(self, hr_size: int, base_channels: int = 64,
                 channel_schedule: Optional[Sequence[int]] = None,
                 dense_features: int = 1024, spectral_norm: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 seed: Optional[int] = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        sched = (tuple(channel_schedule) if channel_schedule is not None
                 else tuple(base_channels * m for m in (1, 2, 4, 8)))
        self.schedule, self.dtype = sched, dtype
        kw = dict(use_sn=spectral_norm, dtype=dtype, device=dev)
        self.conv0 = SNConv(3, sched[0], 1, **kw)
        self.conv0s = SNConv(sched[0], sched[0], 2, **kw)
        self.bn0 = BatchStatNorm(sched[0], device=dev)
        cin = sched[0]
        for i, ch in enumerate(sched[1:], start=1):
            setattr(self, f"conv{i}", SNConv(cin, ch, 1, **kw))
            setattr(self, f"bn{i}a", BatchStatNorm(ch, device=dev))
            setattr(self, f"conv{i}s", SNConv(ch, ch, 2, **kw))
            setattr(self, f"bn{i}b", BatchStatNorm(ch, device=dev))
            cin = ch
        side = head_side(hr_size, len(sched))
        self.fc0 = nn.Linear(sched[-1] * side * side, dense_features,
                             device=dev)
        self.fc1 = nn.Linear(dense_features, 1, device=dev)
        if seed is not None:
            init_weights(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def act(v):
            return F.leaky_relu(v, LEAK)

        x = act(self.conv0(x.permute(0, 3, 1, 2).to(self.dtype)))
        x = act(self.bn0(self.conv0s(x)))
        for i in range(1, len(self.schedule)):
            x = act(getattr(self, f"bn{i}a")(getattr(self, f"conv{i}")(x)))
            x = act(getattr(self, f"bn{i}b")(getattr(self, f"conv{i}s")(x)))
        dt = self.dtype
        x = x.flatten(1)
        x = act(F.linear(x, self.fc0.weight.to(dt), self.fc0.bias.to(dt)))
        return F.linear(x, self.fc1.weight.to(dt),
                        self.fc1.bias.to(dt)).float()
