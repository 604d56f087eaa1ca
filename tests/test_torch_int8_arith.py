"""The bit tricks of the int8 block kernel (``pesr_torch/csrc/
resblock_int8.cu``, ``conv3x3_s8.cuh``), modelled in numpy as the CUDA
computes them, against the PyTorch ops of its plain version on the CPU
(``pesr_torch/ops/kernels/resblock_int8.py``): the kernel is bitwise the
plain version only if each trick is bitwise the operation it replaces.

* ``rint_bits``: rint of a clamped float as the low byte of ``t + 1.5 x
  2^23`` (the quantizer and the requant);
* the requant's clip at 0 by ``mul.rn.sat.f32`` with 2^-7 and its rint by
  ``fma(c, 128, 1.5 x 2^23)``;
* ``cvt.rn.bf16x2.f32``: each half rounded to bf16 as a single conversion;
* ``mul.rn.bf16x2`` / ``add.rn.bf16x2`` on bf16 operands: the exact
  result rounded once to bf16, which is the f32 operation rounded to bf16
  (PyTorch's bf16 arithmetic).

Tolerance: none, every comparison is of bits.  Nothing here needs JAX or a
GPU; the kernel itself is held to the plain version by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from pesr_torch.ops.kernels import resblock_int8 as rb8

MAGIC = np.float32(12582912.0)  # 1.5 x 2^23


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def rint_bits(t, lo):
    """The kernel's ``rint_bits``: ``fminf(fmaxf(t, lo), 127) + 1.5 x
    2^23`` in f32, its low byte as int8."""
    c = np.minimum(np.maximum(_f32(t), np.float32(lo)), np.float32(127))
    return ((c + MAGIC).view(np.uint32) & 0xFF).astype(np.uint8).view(
        np.int8)


def requant_bits(t):
    """The kernel's ``requant`` after ``f32(acc) * m + b``: ``c =
    sat(min(t, 127) * 2^-7)`` (mul.rn.sat.f32), then ``fma(c, 128, 1.5 x
    2^23)`` (exact in float64, rounded once to f32), the low byte."""
    c = np.clip(np.minimum(_f32(t), np.float32(127)) * np.float32(2 ** -7),
                np.float32(0), np.float32(1))
    r = (c.astype(np.float64) * 128 + float(MAGIC)).astype(np.float32)
    return (r.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def bf16_bits_rne(x):
    """cvt.rn.bf16.f32 (each half of cvt.rn.bf16x2.f32) on finite f32:
    the upper 16 bits after adding 0x7fff plus the kept lsb."""
    u = _f32(x).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def round_once_to_bf16(x):
    """An exact float64 value rounded once, to nearest even, to bf16 (8
    significant bits, subnormal quantum 2^-133, overflow to inf); bits."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)
    quantum = np.ldexp(1.0, np.maximum(e - 8, -133))
    r = np.round(x / quantum) * quantum
    r = np.where(np.abs(r) >= 2.0 ** 128, np.copysign(np.inf, x), r)
    return torch.from_numpy(r.astype(np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("lo", [-127.0, 0.0])
def test_rint_bits_every_step(lo):
    """rint(clip(t, lo, 127)) for every t with |t| <= 127.5 at 2^-10 steps
    (all ties of rint) and beyond the clip, as torch rounds (half to even)
    and clamps it."""
    t = np.concatenate([np.arange(-127.5 * 1024, 127.5 * 1024 + 1) / 1024,
                        [-3e38, -1e9, -128.5, -127.51, 127.51, 128.5, 1e9,
                         3e38, -0.0, 1e-40, -1e-40]]).astype(np.float32)
    want = torch.clamp(torch.round(torch.from_numpy(t)), lo, 127).to(
        torch.int8).numpy()
    np.testing.assert_array_equal(rint_bits(t, lo), want)


def test_requant_saturation_form():
    """The requant's clip-by-saturation and fused rint equal torch's
    ``clamp(round(clamp_min(t, 0)), -127, 127)`` on every t in [-2, 130]
    at 2^-12 steps, ties, f32 subnormals and huge values."""
    t = np.concatenate([np.arange(-2 * 4096, 130 * 4096 + 1) / 4096,
                        [0.5, 1.5, 126.5, 127.5, 127.49999, 0.50000006,
                         1e-45, 1e-40, 1.1754942e-38, -1e-40, -0.0, 3e38,
                         -3e38, 2.0 ** 22 + 0.5, 2.0 ** 24]]).astype(
                             np.float32)
    tt = torch.from_numpy(t)
    want = torch.clamp(torch.round(torch.clamp_min(tt, 0.0)), -127, 127).to(
        torch.int8).numpy()
    np.testing.assert_array_equal(requant_bits(t), want)


def test_requant_chain_matches_plain_requant():
    """The whole requant, ``f32(acc)`` rounded to nearest, a multiply and
    an add each rounded, then the saturation form, bitwise
    ``resblock_int8.requant`` on random accumulators and the test
    vectors' scales (ties reached through m = 2^-10, b = 0.5)."""
    rng = np.random.default_rng(0)
    acc = rng.integers(-2 ** 25, 2 ** 25, 200_000, dtype=np.int64).astype(
        np.int32)
    acc[:1000] = rng.integers(-600, 600, 1000)
    m = np.where(np.arange(acc.size) % 4 == 1, 2.0 ** -10,
                 rng.uniform(1e-6, 1e-3, acc.size)).astype(np.float32)
    b = np.where(np.arange(acc.size) % 4 == 1, 0.5,
                 rng.uniform(-20, 20, acc.size)).astype(np.float32)
    t = acc.astype(np.float32) * m + b          # two f32 roundings
    got = requant_bits(t)
    want = rb8.requant(torch.from_numpy(acc), torch.from_numpy(m),
                       torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((t - np.floor(t) == 0.5) & (t > 0) & (t < 127)).sum() > 0
    assert (want == 127).sum() > 0 and (want == 0).sum() > 0


def test_paired_bf16_rounding_is_single_rounding():
    """cvt.rn.bf16x2.f32's halves, modelled as the add-0x7fff rounding,
    equal ``.to(torch.bfloat16)`` on ties (both parities), f32 subnormals,
    the bf16 subnormal edge, +-max f32 (overflow to inf) and random
    values."""
    rng = np.random.default_rng(1)
    exps = rng.integers(1, 255, 4096).astype(np.uint32) << 23
    ties = np.concatenate([exps | 0x8000, exps | 0x18000,
                           exps | 0x8001, exps | 0x7FFF]).view(np.float32)
    rand = rng.integers(0, 0x7F800000, 200_000, dtype=np.int64).astype(
        np.uint32).view(np.float32)
    edge = np.array([3.4028235e38, 1.1754942e-38, 1e-45, 9.2e-41,
                     1.0019531, 1.0058594, 0.0, 65504.0],
                    dtype=np.float32)
    x = np.concatenate([ties, rand, edge])
    x = np.concatenate([x, -x])
    want = _bits(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(bf16_bits_rne(x), want)


def _bf16_samples(n, seed):
    """Random finite bf16 values (bits), every exponent, both signs."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 0x7F80, n).astype(np.uint16)
    bits |= (rng.integers(0, 2, n) << 15).astype(np.uint16)
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def test_bf16x2_mul_equals_f32_mul_rounded():
    """mul.rn.bf16x2 (the exact product rounded once to bf16) equals
    ``a * b`` in torch's bf16 (f32 product, exact, then rounded) for
    random bf16 pairs whose product is a normal f32 (the residual's
    ``res_scale * y2``), and at the test's res_scale 0.1 and 1.0."""
    a, b = _bf16_samples(300_000, 2), _bf16_samples(300_000, 3)
    exact = a.double() * b.double()
    normal = (exact.abs() >= 2.0 ** -126) & (exact.abs() < 2.0 ** 127)
    a, b, exact = a[normal], b[normal], exact[normal]
    np.testing.assert_array_equal(round_once_to_bf16(exact.numpy()),
                                  _bits(a * b))
    for rs in (0.1, 1.0):
        r = torch.full_like(b, rs)
        ex = r.double() * b.double()
        ok = (ex.abs() >= 2.0 ** -126) & (ex.abs() < 2.0 ** 127)
        np.testing.assert_array_equal(round_once_to_bf16(ex[ok].numpy()),
                                      _bits(r[ok] * b[ok]))


def test_bf16x2_add_equals_f32_add_rounded():
    """add.rn.bf16x2 (the exact sum rounded once to bf16) equals ``a + b``
    in torch's bf16 (the f32 sum, rounded, then rounded to bf16: 24 >= 2
    x 8 + 2 bits) for random bf16 pairs of every exponent gap with a
    normal f32 sum, and for carries ~N(0, 1) plus res_scale-sized
    terms."""
    a, b = _bf16_samples(300_000, 4), _bf16_samples(300_000, 5)
    rng = np.random.default_rng(6)
    y = torch.from_numpy(rng.standard_normal(200_000).astype(
        np.float32)).to(torch.bfloat16)
    t = torch.from_numpy((rng.standard_normal(200_000) * 0.1).astype(
        np.float32)).to(torch.bfloat16)
    a, b = torch.cat([a, y]), torch.cat([b, t])
    exact = a.double() + b.double()
    ok = ((exact.abs() >= 2.0 ** -126) & (exact.abs() < 2.0 ** 127)) | (
        exact == 0)
    np.testing.assert_array_equal(round_once_to_bf16(exact[ok].numpy()),
                                  _bits(a[ok] + b[ok]))

