"""The batch engine's host staging (``BatchTiledUpscaler.upscale_many``):
each chunk goes up from, and comes back through, a buffer the engine
owns and reuses (page-locked on CUDA), and every result lands in fresh
host memory of its own.  Results bitwise the engine's device canvas,
never aliasing the staging, the growth and the counters on the CPU; the
page-locked buffers and one upload and one download per chunk on a
card."""

import json

import numpy as np
import pytest
import torch

from pesr_torch.models.generator import Generator
from pesr_torch.ops.tiling import BatchTiledUpscaler

SCALE = 2


def _engine(device="cpu", staged_bytes=0):
    """An engine that stages every chunk from ``staged_bytes`` of result
    on (the tests' photos are far below the default)."""
    gen = Generator(SCALE, 2, 8, device=device, seed=0)
    engine = BatchTiledUpscaler(gen, SCALE, 8, 2, device=device)
    engine._STAGED_BYTES = staged_bytes
    return engine


def _images(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in shapes]


# three 13 x 17 (chunks of 2 and a partial 1) between two 9 x 11
MIXED = [(13, 17), (9, 11), (13, 17), (9, 11), (13, 17)]


def _device_chunk(engine, imgs, se):
    h, w = imgs[0].shape[:2]
    batch = np.stack(imgs)
    if se:
        return engine.upscale_batch_se_device(batch).cpu().numpy()
    return engine.upscale_batch_device(batch)[
        :, :h * SCALE, :w * SCALE].cpu().numpy()


@pytest.mark.parametrize("se", [False, True])
def test_results_are_bitwise_the_device_canvas_of_each_chunk(se):
    engine = _engine()
    imgs = _images(MIXED)
    outs = engine.upscale_many(imgs, 2, se=se)
    for chunk in ([0, 2], [4], [1, 3]):
        want = _device_chunk(engine, [imgs[i] for i in chunk], se)
        for k, i in enumerate(chunk):
            assert outs[i].shape == (MIXED[i][0] * SCALE,
                                     MIXED[i][1] * SCALE, 3)
            assert outs[i].dtype == np.uint8
            np.testing.assert_array_equal(outs[i], want[k])
    assert engine.staged == 3


@pytest.mark.parametrize("se", [False, True])
def test_only_chunks_from_the_threshold_on_are_staged(se):
    # results of the chunks: (2, 13x17) 5,304 B; (1, 13x17) 2,652 B and
    # (2, 9x11) 2,376 B take the pageable copies
    engine = _engine(staged_bytes=2 * 13 * 17 * 3 * SCALE ** 2)
    imgs = _images(MIXED)
    outs = engine.upscale_many(imgs, 2, se=se)
    assert (engine.staged, engine.staging_grows) == (1, 2)
    assert engine.stage["out"].numel() == 2 * 13 * 17 * 3 * SCALE ** 2
    for chunk in ([0, 2], [4], [1, 3]):
        want = _device_chunk(engine, [imgs[i] for i in chunk], se)
        for k, i in enumerate(chunk):
            np.testing.assert_array_equal(outs[i], want[k])
    default = _engine(staged_bytes=BatchTiledUpscaler._STAGED_BYTES)
    default.upscale_many(imgs, 2, se=se)
    assert (default.staged, default.staging_grows) == (0, 0)
    assert default.stage == {"in": None, "out": None}


def test_a_growth_is_a_pin_range_in_its_chunk_step(tmp_path):
    engine = _engine()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.upscale_many(_images(MIXED), 2)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                        for e in json.load(f)["traceEvents"]
                        if e.get("cat") == "user_annotation"
                        and e["name"].startswith("pesr."))
    pins = [(a, b) for a, b, n in ranges if n == "pesr.pin"]
    holders = [[n for a, b, n in ranges if a <= pa and pb <= b
                and n in ("pesr.stack", "pesr.download")] for pa, pb in pins]
    # the first chunk grows the input (in its stack) and the output (in
    # its download); the later, smaller chunks grow nothing
    assert holders == [["pesr.stack"], ["pesr.download"]]
    assert engine.staging_grows == 2


@pytest.mark.parametrize("se", [False, True])
def test_a_later_call_leaves_earlier_results_alone(se):
    engine = _engine()
    first = engine.upscale_many(_images(MIXED, seed=1), 2, se=se)
    kept = [o.copy() for o in first]
    second = engine.upscale_many(_images(MIXED, seed=2), 2, se=se)
    assert engine.staging_grows == 2
    for a, b, k in zip(first, second, kept):
        np.testing.assert_array_equal(a, k)
        assert not np.array_equal(a, b)
    staging = (engine.stage["in"].numpy(), engine.stage["out"].numpy())
    for out in first + second:
        assert not any(np.shares_memory(out, buf) for buf in staging)


def test_staging_grows_only_for_a_larger_chunk():
    engine = _engine()
    small, big = _images([(9, 11)] * 2), _images([(13, 17)] * 2)
    in_bytes = lambda imgs: sum(im.nbytes for im in imgs)  # noqa: E731
    engine.upscale_many(small, 2)
    assert engine.staging_grows == 2        # input and output, once each
    assert engine.stage["in"].numel() == in_bytes(small)
    assert engine.stage["out"].numel() == in_bytes(small) * SCALE ** 2
    engine.upscale_many(small, 2)
    engine.upscale_many(small[:1], 2)       # fewer bytes: the same buffers
    assert engine.staging_grows == 2
    engine.upscale_many(big, 2)
    assert engine.staging_grows == 4
    assert engine.stage["in"].numel() == in_bytes(big)
    assert engine.stage["out"].numel() == in_bytes(big) * SCALE ** 2
    engine.upscale_many(small + big, 2)
    assert engine.staging_grows == 4
    assert engine.staged == 6


@pytest.mark.parametrize("se", [False, True])
def test_warmup_grows_the_staging_to_the_largest_chunk(se):
    engine = _engine()
    imgs = _images(MIXED)
    engine.warmup_many(imgs, 2, se=se)
    # distinct (batch, shape): (2, 13x17), (1, 13x17), (2, 9x11)
    assert engine.staged == 3
    largest = 2 * 13 * 17 * 3
    assert engine.stage["in"].numel() == largest
    assert engine.stage["out"].numel() == largest * SCALE ** 2
    grows = engine.staging_grows
    assert 2 <= grows <= 4
    engine.upscale_many(imgs, 2, se=se)
    engine.upscale_many(imgs[::-1], 2, se=se)
    assert engine.staging_grows == grows
    assert engine.staged == 3 + 3 + 3


def test_a_non_uint8_image_is_refused():
    with pytest.raises(TypeError):
        _engine().upscale_many([np.zeros((9, 11, 3), np.float32)])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the README's `-m cuda` command)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_staging_is_page_locked_and_one_copy_each_way_per_chunk(card,
                                                                 tmp_path):
    engine = _engine(card)
    imgs = _images(MIXED)
    engine.warmup_many(imgs, 2)
    assert engine.stage["in"].is_pinned() and engine.stage["out"].is_pinned()
    grows = engine.staging_grows
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        outs = engine.upscale_many(imgs, 2)
    torch.cuda.synchronize(card)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e["name"] for e in events if e.get("cat") == "gpu_memcpy"]
    assert sum("HtoD" in n for n in copies) == 3
    assert sum("DtoH" in n for n in copies) == 3
    assert not any(e.get("name") == "pesr.pin" for e in events)
    assert engine.staging_grows == grows
    for chunk in ([0, 2], [4], [1, 3]):
        want = _device_chunk(engine, [imgs[i] for i in chunk], False)
        for k, i in enumerate(chunk):
            np.testing.assert_array_equal(outs[i], want[k])
