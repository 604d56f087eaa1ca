"""pesr_torch ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both.  The JAX
Pallas kernels run in interpret mode, as tests/test_pallas.py runs them;
the port's kernel wrappers, given CPU tensors, run their plain PyTorch
versions.  Tolerances are float32 ones: both sides compute the same
convs in f32 with a different summation order (atol 1e-5 for O(1)
values, as tests/test_pallas.py holds the Pallas kernels).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pesr_tpu.data.augment import denormalize_to_uint8 as jax_denorm
from pesr_tpu.data.augment import normalize_uint8 as jax_norm
from pesr_tpu.ops.pallas import (fused_resblock as jax_fused_resblock,
                                 fused_upsampler_stage as jax_fused_up,
                                 resblock_reference as jax_resblock_ref,
                                 upsampler_stage_reference as jax_up_ref)
from pesr_tpu.ops.pallas.common import (conv3x3_shift_acc as jax_shift_acc,
                                        halo_tiles as jax_halo_tiles,
                                        untile as jax_untile)
from pesr_tpu.ops.pixel_shuffle import pixel_shuffle as jax_pixel_shuffle
from pesr_torch.data.augment import denormalize_to_uint8, normalize_uint8
from pesr_torch.ops import kernels
from pesr_torch.ops.kernels import (fused_resblock, fused_upsampler_stage,
                                    pack_resblock, pack_upsampler_stage,
                                    resblock_reference,
                                    upsampler_stage_reference)
from pesr_torch.ops.kernels.common import conv3x3_shift_acc, halo_tiles, untile
from pesr_torch.ops.kernels.resblock import (CLUSTER, FLAT_W,
                                             resblock_schedule,
                                             resblock_tiles, resblock_work,
                                             unpack_resblock)
from pesr_torch.ops.kernels.upsampler import (TILE_W, unpack_upsampler_stage,
                                              upsampler_schedule,
                                              upsampler_tiles,
                                              upsampler_work)
from pesr_torch.ops.pixel_shuffle import pixel_shuffle

T = torch.from_numpy


def _resblock_inputs(c=8, b=2, h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, h, w, c)).astype(f),
            (rng.standard_normal((3, 3, c, c)) * 0.1).astype(f),
            (rng.standard_normal((c,)) * 0.1).astype(f),
            (rng.standard_normal((3, 3, c, c)) * 0.1).astype(f),
            (rng.standard_normal((c,)) * 0.1).astype(f))


@pytest.mark.parametrize("r,c", [(2, 4), (3, 2)])
def test_pixel_shuffle_matches_jax_and_torch_nchw(r, c):
    x = np.random.default_rng(r).standard_normal(
        (2, 5, 7, c * r * r)).astype(np.float32)
    ours = pixel_shuffle(T(x), r).numpy()
    np.testing.assert_array_equal(ours, np.asarray(
        jax_pixel_shuffle(jnp.asarray(x), r)))
    nchw = torch.pixel_shuffle(T(x).permute(0, 3, 1, 2), r)
    np.testing.assert_array_equal(ours, nchw.permute(0, 2, 3, 1).numpy())


def test_normalize_denormalize_match_jax_bitwise():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    np.testing.assert_array_equal(normalize_uint8(T(u8)).numpy(),
                                  np.asarray(jax_norm(jnp.asarray(u8))))
    y = np.linspace(-1.2, 1.2, 20001, dtype=np.float32)
    np.testing.assert_array_equal(denormalize_to_uint8(T(y)).numpy(),
                                  np.asarray(jax_denorm(jnp.asarray(y))))


def test_denormalize_rounds_the_exact_tie_half_away():
    # A float32 x with (x + 1) * 127.5 == 128.5 exactly in float32.
    x = np.float32(128.5 / 127.5 - 1.0)
    while np.float32((x + np.float32(1)) * np.float32(127.5)) < 128.5:
        x = np.nextafter(x, np.float32(1))
    while np.float32((x + np.float32(1)) * np.float32(127.5)) > 128.5:
        x = np.nextafter(x, np.float32(-1))
    assert np.float32((x + np.float32(1)) * np.float32(127.5)) == 128.5
    t = torch.tensor([x])
    assert int(denormalize_to_uint8(t)[0]) == 129
    assert int(jax_denorm(jnp.asarray([x]))[0]) == 129
    # torch.round is half-to-even and would write 128
    assert int(torch.round((t + 1) * 127.5)[0]) == 128


@pytest.mark.parametrize("h,w,tile,res_scale", [
    (16, 16, (8, 8), 0.1),    # exact tiles
    (19, 23, (8, 8), 0.3),    # ragged tiles and edges
    (10, 12, (16, 16), 0.1),  # one tile covers the image
])
def test_resblock_plain_matches_jax_kernel_and_reference(h, w, tile,
                                                         res_scale):
    x, w1, b1, w2, b2 = _resblock_inputs(h=h, w=w)
    jx = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    pallas = np.asarray(jax_fused_resblock(*jx, res_scale=res_scale,
                                           tile=tile, interpret=True))
    ref = np.asarray(jax_resblock_ref(*jx, res_scale=res_scale))
    ours = resblock_reference(*map(T, (x, w1, b1, w2, b2)),
                              res_scale=res_scale).numpy()
    np.testing.assert_allclose(ours, pallas, atol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("c,h,w", [(8, 11, 14), (256, 8, 8)])
def test_upsampler_plain_matches_jax_kernel(c, h, w):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, 4 * c)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((4 * c,)) * 0.05).astype(np.float32)
    jx = [jnp.asarray(a) for a in (x, wt, b)]
    pallas = np.asarray(jax_fused_up(*jx, tile=(8, 8), interpret=True))
    ours = upsampler_stage_reference(T(x), T(wt), T(b)).numpy()
    assert ours.shape == (1, 2 * h, 2 * w, c)
    # C=256 sums 2304 products per output (test_pallas.py: 3e-5 there)
    np.testing.assert_allclose(ours, pallas, atol=1e-5 if c < 64 else 3e-5)
    np.testing.assert_allclose(ours, np.asarray(jax_up_ref(*jx)),
                               atol=1e-5 if c < 64 else 3e-5)


@pytest.mark.parametrize("c", [8, 64, 128])
def test_upsampler_packing_round_trips(c):
    rng = np.random.default_rng(c)
    wt = T(rng.standard_normal((3, 3, c, 4 * c)).astype(np.float32))
    b = T(rng.standard_normal((4 * c,)).astype(np.float32))
    wp, bp = pack_upsampler_stage(wt, b, torch.float32)
    w2, b2 = unpack_upsampler_stage(wp, bp)
    assert torch.equal(w2, wt) and torch.equal(b2, b)
    if c % 64 == 0:
        # packed column g*256 + q*64 + t is torch column (g*64 + t)*4 + q
        assert torch.equal(wp[:, :, 256 * (c // 64 - 1) + 64 * 3 + 5, :],
                           wt[..., (64 * (c // 64 - 1) + 5) * 4 + 3])


def test_kernel_wrappers_on_cpu_take_the_plain_path_and_count_nothing():
    kernels.reset_launch_counts()
    x, w1, b1, w2, b2 = map(T, _resblock_inputs(c=8, h=9, w=13, seed=3))
    got = fused_resblock(x, *pack_resblock(
        w1.permute(3, 2, 0, 1), b1, w2.permute(3, 2, 0, 1), b2,
        torch.float32), res_scale=0.2)
    np.testing.assert_array_equal(
        got.numpy(), resblock_reference(x, w1, b1, w2, b2, 0.2).numpy())
    wt = T(np.random.default_rng(4).standard_normal(
        (3, 3, 8, 32)).astype(np.float32))
    b = T(np.zeros(32, np.float32))
    got = fused_upsampler_stage(x, *pack_upsampler_stage(wt, b,
                                                         torch.float32))
    np.testing.assert_array_equal(got.numpy(),
                                  upsampler_stage_reference(x, wt, b).numpy())
    assert kernels.launch_counts() == {"fused_resblock": 0,
                                       "fused_upsampler_stage": 0,
                                       "fused_rcab": 0, "rcab_excite": 0}


def test_kernel_wrappers_refuse_a_device_they_do_not_serve():
    x = torch.empty((1, 4, 4, 64), device="meta")
    w = torch.empty((3, 3, 64, 64), device="meta")
    b = torch.empty((64,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_resblock(x, w, b, w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_upsampler_stage(x, w, b)


def test_common_plain_versions_match_jax():
    rng = np.random.default_rng(5)
    tile = rng.standard_normal((7, 9, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    np.testing.assert_allclose(
        conv3x3_shift_acc(T(tile), T(w), T(b)).numpy(),
        np.asarray(jax_shift_acc(jnp.asarray(tile), jnp.asarray(w),
                                 jnp.asarray(b))), atol=1e-5)
    x = rng.standard_normal((2, 11, 13, 3)).astype(np.float32)
    tiles, nh, nw = halo_tiles(T(x), 4, 5, halo=2)
    jtiles, jnh, jnw = jax_halo_tiles(jnp.asarray(x), 4, 5, halo=2)
    assert (nh, nw) == (jnh, jnw)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jtiles))
    cores = tiles[:, 2:-2, 2:-2]
    back = untile(cores, 2, nh, nw, 11, 13).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(jax_untile(jnp.asarray(cores.numpy()), 2, nh, nw,
                                    11, 13)))


@pytest.mark.parametrize("c", [8, 64])
def test_packed_layouts_round_trip_and_match_pallas(c):
    """The kernels' K-major packings ((3, 3, C_out, C_in) per conv) turn
    back into the HWIO weights, and the wrappers' CPU path on the packed
    weights matches the JAX package's Pallas kernels."""
    x, w1, b1, w2, b2 = _resblock_inputs(c=c, b=1, h=9, w=11, seed=c)
    packed = pack_resblock(T(w1).permute(3, 2, 0, 1), T(b1),
                           T(w2).permute(3, 2, 0, 1), T(b2), torch.float32)
    assert packed[0].shape == (3, 3, c, c) and packed[0].is_contiguous()
    # packed[0][dy, dx, o, i] is HWIO w1[dy, dx, i, o]
    assert float(packed[0][1, 2, 3, 5]) == float(w1[1, 2, 5, 3])
    for got, want in zip(unpack_resblock(*packed), (w1, b1, w2, b2)):
        assert torch.equal(got, T(want))
    jx = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    pallas = np.asarray(jax_fused_resblock(*jx, res_scale=0.5, tile=(8, 8),
                                           interpret=True))
    ours = fused_resblock(T(x), *packed, res_scale=0.5).numpy()
    np.testing.assert_allclose(ours, pallas, atol=1e-5 if c < 64 else 3e-5)

    rng = np.random.default_rng(c + 1)
    wt = (rng.standard_normal((3, 3, c, 4 * c)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((4 * c,)) * 0.05).astype(np.float32)
    wp, bp = pack_upsampler_stage(T(wt), T(b), torch.float32)
    assert wp.shape == (3, 3, 4 * c, c) and wp.is_contiguous()
    w_back, b_back = unpack_upsampler_stage(wp, bp)
    assert torch.equal(w_back, T(wt)) and torch.equal(b_back, T(b))
    pallas = np.asarray(jax_fused_up(jnp.asarray(x), jnp.asarray(wt),
                                     jnp.asarray(b), tile=(8, 8),
                                     interpret=True))
    ours = fused_upsampler_stage(T(x), wp, bp).numpy()
    np.testing.assert_allclose(ours, pallas, atol=1e-5 if c < 64 else 3e-5)


# (batch, H, W): narrower than a strip, a width one past a strip multiple
# (62), a height one row past a segment boundary, a height shorter than
# one segment with a batch of 3, and the main path's tile batch.  Then
# narrow widths around the edges of the 16-pixel warp rows, the flat
# mode's widest image (48) and the 64-pixel rows and segments, at
# batches 1, 3 and 16 (the training batch at its 48 rows).
_NARROW_W = (1, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64, 65, 95, 96, 97,
             127, 128, 129)
_SCHEDULE_SHAPES = ([(1, 5, 3), (1, 1, 1), (1, 9, 63), (2, 49, 510),
                     (3, 5, 1426), (2, 336, 510)]
                    + [(b, h, w) for w in _NARROW_W
                       for b, h in ((1, 5), (3, 7), (16, 48))])
# The inference and eval tile batches (chain and folded x4 inference of
# two 336 x 510 images, TiledUpscaler's 96 + 2 x 8 eval tiles in batches
# of 8 and their x2 stages) and the schedules they got before flat mode
# and the paired upsampler tiles: unchanged.
_PINNED_RESBLOCK = {(2, 336, 510): (48, 9, 7, 126, 0),
                    (2, 342, 516): (50, 9, 7, 126, 0),
                    (8, 112, 112): (14, 2, 8, 128, 0)}
_PINNED_UPSAMPLER = {(2, 336, 510): (5376, 168, 8, 132),
                     (2, 672, 1020): (21504, 336, 16, 132),
                     (8, 112, 112): (1792, 56, 2, 132),
                     (8, 224, 224): (7168, 112, 4, 132)}


@pytest.mark.parametrize("bsz,h,w", _SCHEDULE_SHAPES)
def test_resblock_schedule_covers_every_output_once(bsz, h, w):
    sched = resblock_schedule(bsz, h, w, clusters=132 // CLUSTER)
    assert sched.ctas % CLUSTER == 0
    if sched.span:
        assert FLAT_W[0] <= w <= FLAT_W[1] and sched.span % 64 == 0
        assert sched.ctas * sched.span >= bsz * h * w
    else:
        assert sched.rows % 2 == 0
        assert sched.ctas >= bsz * sched.strips * sched.segs
    seen = np.zeros((bsz, h, w), np.int32)
    for _, b, y0, y1, x0, x1 in resblock_tiles(sched, bsz, h, w):
        seen[b, y0:y1, x0:x1] += 1
    assert (seen == 1).all()
    if (bsz, h, w) == (2, 49, 510):
        assert h % sched.rows == 1          # one row past a segment
    if (bsz, h, w) == (3, 5, 1426):
        assert sched.rows > h               # shorter than one segment
    if (bsz, h, w) == (2, 336, 510):
        # one wave of clusters on the H100's 132 SMs
        assert sched[:3] == (48, 9, 7) and sched.ctas <= 132


def _old_upsampler_tiles(bsz, h, w, c, tiles, rpairs, ctas):
    """The tile list before CTA tiles were paired across rows: the two
    CTAs of a cluster on neighbouring segments of one row pair."""
    xgroups = -(-(-(-w // TILE_W)) // CLUSTER)
    groups = c // 64
    for cta in range(ctas):
        rank = cta % CLUSTER
        for t in range(cta // CLUSTER, tiles, ctas // CLUSTER):
            rest, g = divmod(t, groups)
            rest, xg = divmod(rest, xgroups)
            b, rp = divmod(rest, rpairs)
            x0 = (CLUSTER * xg + rank) * TILE_W
            for y in (2 * rp, 2 * rp + 1):
                if b < bsz and y < h and x0 < w:
                    yield cta, b, g, y, x0, min(x0 + TILE_W, w)


@pytest.mark.parametrize("bsz,h,w", _SCHEDULE_SHAPES + [(2, 672, 1020)])
@pytest.mark.parametrize("c", [64, 128, 256])
def test_upsampler_schedule_covers_every_conv_pixel_once(bsz, h, w, c):
    sched = upsampler_schedule(bsz, h, w, c, clusters=132 // CLUSTER)
    assert sched.ctas % CLUSTER == 0 and CLUSTER <= sched.ctas <= 132
    seen = np.zeros((bsz, c // 64, h, w), np.int32)
    for _, b, g, y, x0, x1 in upsampler_tiles(sched, bsz, h, w, c):
        assert x0 < w  # no CTA takes a segment outside the image
        seen[b, g, y, x0:x1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", sorted(_PINNED_RESBLOCK))
def test_resblock_inference_and_eval_schedules_are_unchanged(shape):
    assert resblock_schedule(*shape) == _PINNED_RESBLOCK[shape]


@pytest.mark.parametrize("shape", sorted(_PINNED_UPSAMPLER))
def test_upsampler_inference_and_eval_tile_lists_are_unchanged(shape):
    sched = upsampler_schedule(*shape, 256)
    assert sched == _PINNED_UPSAMPLER[shape]
    assert (list(upsampler_tiles(sched, *shape, 256))
            == list(_old_upsampler_tiles(*shape, 256, sched.tiles,
                                         sched.rpairs, sched.ctas)))


# (kind, shape, ceiling); the earlier decompositions computed 2.67x
# (upsampler, one CTA of each cluster on a segment past W = 48), 1.33x
# and 1.56x (resblock, 64-pixel rows for 48 columns, 8 hidden rows per 6).
@pytest.mark.parametrize("kind,shape,ceiling", [
    ("upsampler", (16, 48, 48), 1.40),
    ("upsampler", (16, 96, 96), 1.34),
    ("resblock", (16, 48, 48), 1.40)])
def test_training_shapes_compute_little_beyond_the_useful_work(
        kind, shape, ceiling):
    """Computed / useful conv MACs at the training shapes (C = 256), as
    the kernels' tile lists give them, under each ceiling."""
    work = (upsampler_work(*shape, 256) if kind == "upsampler"
            else resblock_work(*shape, 256))
    assert work[0] / work[1] <= ceiling


def test_work_counts_follow_the_tile_lists():
    """resblock_work / upsampler_work against the tile lists' own
    counts: at [16, 48, 48] the resblock's 116 flat CTAs run 6 steps of
    128 pixels each, the upsampler's 768 cluster tiles 2 CTAs x 128
    pixels x 4 phases of 64 channels."""
    comp, useful = resblock_work(16, 48, 48, 256)
    assert resblock_schedule(16, 48, 48) == (0, 0, 0, 116, 320)
    assert comp == 116 * 6 * 128 * 9 * 256 * 256
    assert useful == 2 * 16 * 48 * 48 * 9 * 256 * 256
    comp, useful = upsampler_work(16, 48, 48, 256)
    assert comp == 768 * 2 * 128 * 256 * 9 * 256
    assert useful == 16 * 48 * 48 * 1024 * 9 * 256
    # line mode: rows / 2 + 1 conv1 and rows / 2 conv2 steps per CTA
    comp, _ = resblock_work(2, 336, 510, 64)
    assert comp == 126 * 49 * 128 * 9 * 64 * 64
