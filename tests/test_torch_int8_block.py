"""The fused int8 residual block's Python side
(``pesr_torch/ops/kernels/resblock_int8.py``) on the CPU: its plain
version against the JAX package's int8 block arithmetic, the kernel's
weight layout, its schedule, the wrapper's checks, and ``torch.export``
of an int8 apply through the custom op.

Tolerances: bitwise everywhere (integers, and bf16 outputs of the same
IEEE operations in the same order).  The CUDA kernel itself runs only on
the card: ``chip_smoke.py``'s quant phase holds it to the plain version
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu.models import quant_apply as jq
from pesr_torch.models import quant_apply as tq
from pesr_torch.ops import kernels
from pesr_torch.ops.int8_conv import int8_conv_im2col
from pesr_torch.ops.kernels import resblock_int8 as rb8
from pesr_torch.ops.kernels.resblock import resblock_tiles

T = torch.from_numpy
C = 16


def _inputs(seed, c=C, shape=(2, 9, 11)):
    """A bf16 carry and one block's JAX-layout parameters (numpy), drawn
    so that the quantizer and the requant round ties and clip: every
    other channel's qin1 is 64 (|y| in [1, 2) gives x.5, |y| >= 2
    clips), and a quarter of conv1's output channels have sparse +-1
    weights with m1 qin2 = 0.5 and bias1 qin2 = 0.5 (an even accumulator
    lands on a tie)."""
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal((*shape, c)).astype(
        np.float32) * 2).to(torch.bfloat16)
    w1 = rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8)
    w2 = rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8)
    tie = np.arange(c) % 4 == 1
    sparse = rng.choice([-1, 0, 0, 0, 1], (3, 3, c, c)).astype(np.int8)
    w1[..., tie] = sparse[..., tie]
    spread = np.sqrt(9 * c) * 127 / np.sqrt(3) * 40
    qin1 = np.where(np.arange(c) % 2 == 0, 64.0,
                    rng.uniform(20, 60, c)).astype(np.float32)
    m1 = np.where(tie, 0.25, rng.uniform(0.5, 1.5, c) * 60 / spread)
    qin2 = np.where(tie, 2.0, rng.uniform(1, 3, c))
    bias1 = np.where(tie, 0.25, rng.uniform(-10, 10, c))
    c1 = {"w_q": w1, "qin": qin1, "m": m1.astype(np.float32),
          "bias": bias1.astype(np.float32)}
    c2 = {"w_q": w2, "qin": qin2.astype(np.float32),
          "m": (rng.uniform(0.5, 1.5, c) / spread).astype(np.float32),
          "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
    return y, c1, c2


def _port_args(c1, c2):
    """The plain version's arguments after the carry: OHWI int8 weights
    and the f32 vectors, ``m1 qin2`` and ``bias1 qin2`` formed in f32 as
    ``Int8Apply`` forms them."""
    w1 = T(c1["w_q"]).permute(3, 0, 1, 2).contiguous()
    w2 = T(c2["w_q"]).permute(3, 0, 1, 2).contiguous()
    return (w1, T(c1["qin"]), T(c1["m"]) * T(c2["qin"]),
            T(c1["bias"]) * T(c2["qin"]), w2, T(c2["m"]), T(c2["bias"]))


def _jax_block(carry, c1, c2, res_scale):
    """JAX's int8 block, ``body_fn`` of ``make_int8_apply``
    (pesr_tpu/models/quant_apply.py:235-254), statement for statement."""
    xq1 = jnp.clip(jnp.round(carry.astype(jnp.float32) * c1["qin"]),
                   -127, 127).astype(jnp.int8)
    acc1 = jq._conv_int8(xq1, c1["w_q"])
    t = (acc1.astype(jnp.float32) * (c1["m"] * c2["qin"])
         + c1["bias"] * c2["qin"])
    xq2 = jnp.clip(jnp.round(jnp.maximum(t, 0.0)), -127, 127).astype(jnp.int8)
    acc2 = jq._conv_int8(xq2, c2["w_q"])
    y = (acc2.astype(jnp.float32) * c2["m"] + c2["bias"]).astype(jnp.bfloat16)
    return carry + jnp.asarray(res_scale, jnp.bfloat16) * y


@pytest.mark.parametrize("seed,res_scale", [(0, 0.1), (1, 1.0), (2, 0.1)])
def test_reference_equals_jax_block_bitwise(seed, res_scale):
    """The plain version equals JAX's block run op by op, bitwise, on
    inputs whose quantizer and requant tie and clip at 0 and 127."""
    y, c1, c2 = _inputs(seed)
    args = _port_args(c1, c2)
    got = rb8.int8_resblock_reference(y, *args, res_scale)
    with jax.disable_jit():
        want = np.asarray(_jax_block(jnp.asarray(y.float().numpy()).astype(
            jnp.bfloat16), c1, c2, res_scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    # the inputs reach the rounding and clipping cases
    w1, qin1, mq, bq = args[:4]
    s1 = y.float() * qin1
    assert (s1 - s1.floor() == 0.5).sum() > 0
    assert (s1.abs() > 127.5).sum() > 0
    t = rb8.int8_conv_reference(rb8.quantize_act(y, qin1), w1).float() \
        * mq + bq
    h = rb8.requant(rb8.int8_conv_reference(rb8.quantize_act(y, qin1), w1),
                    mq, bq)
    assert ((t - t.floor() == 0.5) & (t > 0) & (t < 127)).sum() > 0
    assert (h == 127).sum() > 0 and (h == 0).sum() > 0


def test_wrapper_on_the_cpu_is_the_plain_version():
    """``fused_resblock_int8`` on CPU tensors runs the plain version on
    the packed weights (bitwise, at C = 64 too) and counts no launch;
    the ``_int_mm`` route of the plain version is bitwise the same."""
    kernels.reset_launch_counts()
    for c, seed in ((C, 3), (64, 4)):
        y, c1, c2 = _inputs(seed, c, (1, 5, 7))
        args = _port_args(c1, c2)
        w1, w2 = rb8.pack_int8_block_weights(args[0], args[4])
        ref = rb8.int8_resblock_reference(y, *args, 0.1)
        got = rb8.fused_resblock_int8(y, w1, *args[1:4], w2, *args[5:], 0.1)
        assert torch.equal(got, ref)
        assert torch.equal(rb8.int8_resblock_reference(
            y, *args, 0.1, conv=int8_conv_im2col), ref)
    assert rb8.fused_resblock_int8.launches == 0


@pytest.mark.parametrize("c", [16, 64, 256])
def test_pack_int8_block_weights_layout(c):
    """Packed ``[dy][dx][n][i]`` holds OHWI ``w1[o1[n], dy, dx, i]`` and
    ``w2[o2[n], dy, dx, i]``, the output channels in the kernel's orders
    (``output_channel_orders``: conv1's column 64 u + 8 i + 2 r + e is
    channel 64 u + 16 r + 2 i + e, conv2's column 32 i + 8 e + 2 r + f is
    channel 32 i + 8 r + 2 e + f; the identities at C = 16), contiguous
    int8; unpacking inverts it."""
    rng = np.random.default_rng(c)
    w1 = rng.integers(-127, 128, (c, 3, 3, c)).astype(np.int8)
    w2 = rng.integers(-127, 128, (c, 3, 3, c)).astype(np.int8)
    p1, p2 = rb8.pack_int8_block_weights(T(w1), T(w2))
    assert p1.shape == p2.shape == (3, 3, c, c)
    assert p1.is_contiguous() and p2.is_contiguous()
    assert p1.dtype == p2.dtype == torch.int8
    o1, o2 = (o.numpy() for o in rb8.output_channel_orders(c))
    assert sorted(o1) == sorted(o2) == list(range(c))
    if c % 64 == 0:
        assert list(o1[:10]) == [0, 1, 16, 17, 32, 33, 48, 49, 2, 3]
        assert list(o2[:10]) == [0, 1, 8, 9, 16, 17, 24, 25, 2, 3]
        assert o1[c - 64 + 8 * 7 + 2 * 3 + 1] == c - 64 + 16 * 3 + 2 * 7 + 1
        assert o2[c - 32 + 8 * 3 + 2 * 1 + 1] == c - 32 + 8 * 1 + 2 * 3 + 1
    else:
        assert list(o1) == list(o2) == list(range(c))
    for p, w, order in ((p1, w1, o1), (p2, w2, o2)):
        for dy, dx, n, i in ((0, 0, 0, 0), (2, 1, c - 1, 3), (1, 2, 5, c - 2)):
            assert p[dy, dx, n, i] == w[order[n], dy, dx, i]
        np.testing.assert_array_equal(
            p.numpy(), np.transpose(w[order], (1, 2, 0, 3)))
    u1, u2 = rb8.unpack_int8_block_weights(p1, p2)
    np.testing.assert_array_equal(u1.numpy(), w1)
    np.testing.assert_array_equal(u2.numpy(), w2)


@pytest.mark.parametrize("shape,want", [
    # x4 folded tile batch: 9 strips x 7 segments of 50 rows x 2 images
    ((2, 342, 516), (126, 1, 485_146_755_072, 416_349_683_712)),
    # x8 tile batch: 5 strips x 13 segments of 14 rows x 2 images
    ((2, 178, 263), (130, 1, 147_220_070_400, 110_448_082_944)),
])
def test_resblock_int8_work_pinned(shape, want):
    """CTAs, waves and (computed, useful) conv MACs of the int8 engines'
    tile batches at C = 256 on 66 clusters, and the strip segments
    covering every output pixel exactly once."""
    assert tuple(rb8.resblock_int8_work(*shape)) == want
    sched = rb8.resblock_int8_schedule(*shape)
    assert sched.span == 0
    seen = np.zeros(shape, np.int32)
    for _, b, y0, y1, x0, x1 in resblock_tiles(sched, *shape):
        seen[b, y0:y1, x0:x1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", [(1, 40, 40), (3, 5, 1), (2, 7, 2),
                                   (1, 3, 130)])
def test_resblock_int8_schedule_covers_small_tiles(shape):
    """Line mode with a ragged last strip covers every W >= 1: the small
    tiles (chip_smoke's 40 x 40 apply check, widths 1 and 2, one past two
    strips) get every pixel once and whole clusters."""
    sched = rb8.resblock_int8_schedule(*shape)
    assert sched.span == 0 and sched.ctas % 2 == 0 and sched.rows % 2 == 0
    seen = np.zeros(shape, np.int32)
    for _, b, y0, y1, x0, x1 in resblock_tiles(sched, *shape):
        seen[b, y0:y1, x0:x1] += 1
    assert (seen == 1).all()


def test_wrapper_raises_off_cpu_and_cuda_and_on_kernel_widths():
    """Another device raises; the CUDA implementation's checks refuse a C
    the kernel does not take, wrong dtypes and misshapen weights."""
    y, c1, c2 = _inputs(5)
    args = _port_args(c1, c2)
    w1, w2 = rb8.pack_int8_block_weights(args[0], args[4])
    packed = (w1, *args[1:4], w2, *args[5:])
    with pytest.raises(ValueError, match="unsupported device"):
        rb8.fused_resblock_int8(y.to("meta"), *(t.to("meta") for t in packed),
                                0.1)
    vec = packed[1:4] + packed[5:]
    with pytest.raises(ValueError, match="takes C in"):
        rb8._check(y, w1, w2, vec)
    y, c1, c2 = _inputs(6, 64, (1, 3, 4))
    args = _port_args(c1, c2)
    w1, w2 = rb8.pack_int8_block_weights(args[0], args[4])
    vec = args[1:4] + args[5:]
    rb8._check(y, w1, w2, vec)
    with pytest.raises(ValueError, match="bf16"):
        rb8._check(y.float(), w1, w2, vec)
    with pytest.raises(ValueError, match="w2 must be"):
        rb8._check(y, w1, w2.permute(2, 3, 0, 1)[:, :, :3, :3], vec)
    with pytest.raises(ValueError, match="mq must be"):
        rb8._check(y, w1, w2, (vec[0], vec[1].double(), *vec[2:]))


def test_export_of_int8_apply_calls_the_op():
    """``torch.export`` of a 2-block ``Int8Apply`` on the CPU traces the
    block through ``pesr::fused_resblock_int8`` (twice, via its fake
    implementation), and the program equals the live apply bitwise."""
    from pesr_torch.models.generator import Generator
    gen = Generator(2, 2, C, device="cpu", seed=0)
    x = np.random.default_rng(7).uniform(-1, 1, (1, 12, 10, 3)).astype(
        np.float32)
    apply = tq.int8_inference(gen, [x])

    class Program(torch.nn.Module):
        def forward(self, t):
            return apply.uint8_variant(t)

    with torch.no_grad():
        ep = torch.export.export(Program(), (T(x),), strict=False)
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.pesr.fused_resblock_int8.default) == 2
    np.testing.assert_array_equal(ep.module()(T(x)).numpy(),
                                  apply.uint8_variant(T(x)).numpy())
