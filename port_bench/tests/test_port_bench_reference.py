"""The frozen references and counts agree with the port at a tiny size
(the port is imported here, in the test, never by the references)."""

import numpy as np
import pytest
import torch

from pesr_torch.models.fold import fold_upsampler
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import Float32Apply
from pesr_torch.models.quant_apply import collect_calibration, int8_inference
from pesr_torch.ops.kernels.resblock import resblock_work
from pesr_torch.ops.tiling import BatchTiledUpscaler
from port_bench.reference import counts, edsr, tiling, w8a8, weights
from port_bench.traffic.render import render

MODEL = dict(scale=4, num_blocks=2, num_channels=64, res_scale=0.1,
             img_channels=3, bias_std=0.01)


def _setup(scale=4, seed=3):
    model = {**MODEL, "scale": scale}
    sd = weights.make_state_dict(model, seed, torch.device("cpu"))
    g = Generator(scale, 2, 64, 0.1, device="cpu", seed=None)
    g.load_state_dict(sd)
    gen = torch.Generator().manual_seed(seed)
    imgs = render(gen, 2, 37, 29, (0.06, 0.24))
    return model, sd, g, imgs


@pytest.mark.parametrize("scale", [2, 4])
def test_edsr_forward_is_the_generator(scale):
    model, sd, g, imgs = _setup(scale)
    x = imgs.float() / 127.5 - 1.0
    with torch.no_grad():
        torch.testing.assert_close(edsr.forward(x, sd, model), g(x),
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("fold, tile", [(False, 16), (True, 16),
                                        (True, "auto")])
def test_tiling_is_the_engine(fold, tile):
    model, sd, g, imgs = _setup()
    eng = BatchTiledUpscaler(Float32Apply(g, fold=fold), 4, tile, 8,
                             device="cpu")
    out = eng.upscale_batch_device(imgs, float_out=True)[:, :37 * 4, :29 * 4]
    ref = tiling.upscale(imgs, eng.grid(2, 37, 29), 8, eng.min_halo, 4,
                         lambda x: edsr.forward(x, sd, model))
    assert eng.grid(2, 37, 29)[:2] != (1, 1) or tile == "auto"
    torch.testing.assert_close(ref, out, rtol=0, atol=2e-3)


def test_w8a8_is_the_int8_path():
    """Given the program's own calibration the reference is the
    program's int8 path to within the bf16 rounding of its fold;
    calibrated on its own it stays within the int8 noise."""
    model, sd, g, imgs = _setup()
    crops = (render(torch.Generator().manual_seed(9), 4, 24, 24,
                    (0.06, 0.24)).float() / 127.5 - 1.0)
    eng = BatchTiledUpscaler(int8_inference(g, [crops.numpy()]), 4, "auto",
                             8, device="cpu")
    out = eng.upscale_batch_device(imgs, float_out=True)[:, :37 * 4, :29 * 4]
    grid = eng.grid(2, 37, 29)

    out = out.clamp(0, 255)

    def ref(q):
        return tiling.upscale(imgs, grid, 8, eng.min_halo, 4, q).clamp(0, 255)

    own = ref(w8a8.W8A8(sd, model, crops))
    c = collect_calibration(g, [crops.numpy()])
    amax = {"in1": [torch.from_numpy(v) for v in c["body/in1"]],
            "in2": [torch.from_numpy(v) for v in c["body/in2"]],
            "tail": torch.from_numpy(c["tail_in"])}
    real = w8a8.calibrate
    w8a8.calibrate = lambda *a: amax
    try:
        same = ref(w8a8.W8A8(sd, model, crops))
    finally:
        w8a8.calibrate = real
    # the fold's bf16 output rounds by up to half a bf16 ulp: 0.25 LSB
    # near 255 (2^-9 x 127.5), plus the bias added in bf16
    assert float((same - out).abs().max()) < 1.0
    assert float((own - out).pow(2).mean().sqrt()) < 1.0
    w4 = ref(w8a8.W8A8(sd, model, crops, bits=4))
    assert float((w4 - out).pow(2).mean().sqrt()) > 3.0


@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_fold_support_is_the_folds(scale):
    model = {**MODEL, "scale": scale}
    sd = weights.make_state_dict(model, 1, torch.device("cpu"))
    kernel, _, _ = fold_upsampler(sd, scale)
    assert counts.fold_support(scale) >= kernel.shape[-1]


def test_resblock_ops_are_the_useful_macs():
    for shape in ((8, 144, 342), (1, 134, 134), (16, 48, 48)):
        _, useful_macs = resblock_work(*shape, 256)
        assert 2 * useful_macs == 2 * counts.conv_ops(256, 256) * np.prod(shape)


def test_flagship_ops_per_lr_pixel():
    model = dict(scale=4, num_blocks=32, num_channels=256, img_channels=3)
    low, bf16 = counts.model_ops_per_lr_px(model, "bf16")
    assert low == 0 and abs(bf16 / 1e6 - 77.3) < 0.1
    low, edge = counts.model_ops_per_lr_px(model, "int8")
    assert low + edge == bf16
