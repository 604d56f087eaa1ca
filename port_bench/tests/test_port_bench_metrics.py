"""The per-layer readers on a made-up trace."""

import json

import pytest

from port_bench.metrics import (fused_resblock_int8_roofline, idle_pct,
                                memcpy_ms, mfu, tiled_px_ratio)
from port_bench.metrics._common import Context, Request
from port_bench.reference import counts
from port_bench.tests.helpers import ROOT
from port_bench.trace import Trace

MODEL = dict(family="edsr", scale=4, num_blocks=2, num_channels=256,
             img_channels=3)


def _events(kernel_us=100.0, n_kernels=4):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "port_bench.window",
           "ts": 1000.0, "dur": 1000.0, "pid": 1, "tid": 7},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
           "ts": 1700.0, "dur": 250.0, "pid": 1, "tid": 7},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": 1900.0, "dur": 50.0, "pid": 0, "tid": 1}]
    for i in range(n_kernels):
        ev.append({"ph": "X", "cat": "kernel",
                   "name": "void resblock_int8_kernel<256>(CUtensorMap)",
                   "ts": 1100.0 + 150.0 * i, "dur": kernel_us, "pid": 0,
                   "tid": 1})
    ev.append({"ph": "X", "cat": "kernel", "name": "outside", "ts": 5000.0,
               "dur": 10.0, "pid": 0, "tid": 1})
    return ev


def _ctx(trace, launches=4, requests=1):
    reqs = [Request((10, 10), 2, (1, 1, 10, 10), (3, 3), 0.0, 0.001)
            for _ in range(requests)]
    return Context(MODEL, {"path": "int8"}, reqs, 0.001,
                   {"fused_resblock_int8": launches}, trace)


def test_busy_idle_memcpy():
    t = Trace(_events())
    assert t.window_us == 1000.0 and t.busy_us() == pytest.approx(450.0)
    assert idle_pct.read(_ctx(t), "mps") == pytest.approx(55.0)
    assert memcpy_ms.read(_ctx(t), "mps") == pytest.approx(0.05)
    ops = dict(t.top_ops())
    assert ops["resblock_int8_kernel<256>"] == pytest.approx(4e-4)
    gaps = dict(t.idle_gaps())
    assert gaps["cudaMemcpyAsync"] == pytest.approx(2.5e-4)


def test_roofline_counts_every_launch_at_its_shape():
    t = Trace(_events())
    # one request, one tile of 16 x 16 with halos, 2 images, 2 blocks
    least = 2 * counts.resblock_seconds(2, 16, 16, 256, True)
    got = fused_resblock_int8_roofline.read(_ctx(t, launches=2), "")
    assert got is None      # the counter disagrees with the trace
    t2 = Trace(_events(n_kernels=2))
    got = fused_resblock_int8_roofline.read(_ctx(t2, launches=2), "")
    assert got == pytest.approx(100.0 * least / 200e-6)


def test_no_device_metric_without_a_trace():
    for reader in (idle_pct, memcpy_ms, mfu, fused_resblock_int8_roofline):
        assert reader.read(_ctx(None), "mps") is None


def test_tiled_px_ratio_and_mfu():
    t = Trace(_events())
    ctx = _ctx(t, requests=3)
    assert tiled_px_ratio.read(ctx, "mps") == pytest.approx(2.56)
    px = 3 * 2 * 100
    assert mfu.read(ctx, "mps") == pytest.approx(
        100.0 * counts.model_seconds(MODEL, "int8", px) / 0.001)


@pytest.mark.parametrize("config", ["pesr_x4", "edsr_x2"])
@pytest.mark.parametrize("path", ["bf16", "int8"])
def test_mfu_of_edsr_is_its_folded_count(config, path):
    """EDSR's count written out, bit for bit: per LR pixel 2 9 C^2 x 2
    operations a residual block and 2 9 C^2 the tail conv (int8 on the
    int8 path), 2 9 3 C the head conv and 2 25 C 3 s^2 the folded
    upsampler (a 5 x 5 support at every scale) in bf16."""
    model = json.loads((ROOT / f"port_bench/configs/{config}.json")
                       .read_text())
    c, s, n = model["num_channels"], model["scale"], model["num_blocks"]
    trunk = 2 * n * 2 * 9 * c * c + 2 * 9 * c * c
    edge = 2 * 9 * 3 * c + 2 * 25 * c * 3 * s * s
    low, bf16 = (trunk, edge) if path == "int8" else (0, trunk + edge)
    for px, window in ((1, 0.25), (171_360, 1.0), (8 * 510 * 336 * 37, 51.2)):
        reqs = [Request((px, 1), 1, (1, 1, px, 1), (0, 0), 0.0, window)]
        ctx = Context(model, {"path": path}, reqs, window, {},
                      Trace(_events()))
        assert mfu.read(ctx, "mps") == (
            100.0 * (px * (low / 1979e12 + bf16 / 989e12)) / window)
