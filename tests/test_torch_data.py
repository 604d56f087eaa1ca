"""The port's own copies of JAX-free modules (scales, bicubic weights,
synthetic corpus, PSNR/SSIM) and its eval-set loader, held bitwise
against the JAX package on the CPU."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from pesr_tpu import scales as jax_scales
from pesr_tpu.data import datasets as jax_datasets
from pesr_tpu.metrics import psnr_ssim as jax_metrics
from pesr_tpu.ops.resize import resize_kernel_matrix as jax_resize_matrix
from pesr_torch import scales
from pesr_torch.data import datasets
from pesr_torch.metrics import psnr_ssim
from pesr_torch.ops.resize import resize_kernel_matrix
from pesr_torch.utils.image_io import imwrite_uint8


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 6, 8, 12])
def test_scales_match_jax(scale):
    assert scales.upsample_stages(scale) == jax_scales.upsample_stages(scale)
    assert scales.fold_min_halo(scale) == jax_scales.fold_min_halo(scale)


def test_scales_reject_what_jax_rejects():
    for bad in (0, 5, 7):
        with pytest.raises(ValueError):
            scales.upsample_stages(bad)


@pytest.mark.parametrize("n_in,n_out", [(120, 480), (480, 120), (37, 11)])
def test_resize_matrix_matches_jax(n_in, n_out):
    np.testing.assert_array_equal(resize_kernel_matrix(n_in, n_out),
                                  jax_resize_matrix(n_in, n_out))


def test_synthetic_corpus_and_host_bicubic_match_jax():
    ours = datasets.SyntheticImages(2, 64, 96, seed=3)
    ref = jax_datasets.SyntheticImages(2, 64, 96, seed=3)
    for i in range(2):
        np.testing.assert_array_equal(ours.get(i), ref.get(i))
        assert ours.name(i) == ref.name(i)
    hr = ours.get(1)
    np.testing.assert_array_equal(
        datasets.host_bicubic_downsample(hr, 4),
        jax_datasets.host_bicubic_downsample(hr, 4))


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0, 255
                ).astype(np.uint8)
    assert psnr_ssim.calc_psnr(a, b, 4) == jax_metrics.calc_psnr(a, b, 4)
    assert psnr_ssim.calc_ssim(a, b, 4) == jax_metrics.calc_ssim(a, b, 4)


def test_load_eval_set_synthetic_matches_jax():
    opts = SimpleNamespace(test_dataset="synthetic", scale=4, seed=0,
                           data_root="data")
    ours = datasets.load_eval_set(opts, max_images=2)
    ref = jax_datasets.load_eval_set(opts, max_images=2)
    for o, r in zip(ours, ref):
        assert o.name == r.name
        np.testing.assert_array_equal(o.lr, r.lr)
        np.testing.assert_array_equal(o.hr, r.hr)


def test_load_eval_set_folder_layout(tmp_path):
    """<name>/HR + <name>/LR_bicubic/X<s>: DIV2K-named LR files are used,
    a missing LR file is synthesized with MATLAB bicubic."""
    rng = np.random.default_rng(1)
    hr = [rng.integers(0, 256, (26, 34, 3), dtype=np.uint8) for _ in range(2)]
    root = tmp_path / "Set2"
    imwrite_uint8(root / "HR" / "0001.png", hr[0])
    imwrite_uint8(root / "HR" / "0002.png", hr[1])
    lr0 = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    imwrite_uint8(root / "LR_bicubic" / "X4" / "0001x4.png", lr0)
    opts = SimpleNamespace(test_dataset="Set2", scale=4, seed=0,
                           data_root=str(tmp_path))
    s = datasets.load_eval_set(opts)
    assert [x.name for x in s] == ["0001", "0002"]
    np.testing.assert_array_equal(s[0].lr, lr0)
    np.testing.assert_array_equal(s[0].hr, hr[0][:24, :32])
    np.testing.assert_array_equal(
        s[1].lr, datasets.host_bicubic_downsample(hr[1], 4))
    with pytest.raises(FileNotFoundError, match="synthetic"):
        datasets.load_eval_set(SimpleNamespace(
            test_dataset="nope", scale=4, seed=0, data_root=str(tmp_path)))
    assert os.path.isdir(root / "HR")
