"""The port's ``synthetic_device`` renderer on ``device="cpu"``.
``jax.random`` cannot be reproduced, so it is held to the properties the
JAX renderer's own tests assert (tests/test_device_synth.py): uint8
covering 0..255, determinism, content fixed by the global sample index,
distinct samples, fresh content after a resume, the band below the LR
Nyquist; and to JAX's band, feature counts, epoch length and eval-set
layout.  Then a short ``run_training`` on it."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pesr_tpu.config import Opts as JaxOpts
from pesr_tpu.data import datasets as jax_datasets
from pesr_tpu.data import device_synth as jax_ds
from pesr_torch.config import Opts
from pesr_torch.data import datasets
from pesr_torch.data import device_synth as ds
from pesr_torch.data.datasets import host_bicubic_downsample
from pesr_torch.training import loop

TINY = Opts(num_blocks=2, num_channels=8, patch_size=12, batch_size=4,
            steps_per_epoch=2, train_dataset="synthetic_device",
            valid_dataset="synthetic_device", scale=2, device="cpu")


def test_render_is_uint8_over_0_255_and_deterministic():
    a = ds.render_hr_batch(7, 3, 64, 4, "cpu")
    assert a.shape == (3, 64, 64, 3) and a.dtype == torch.uint8
    assert a.device.type == "cpu"
    flat = a.reshape(3, -1)
    assert (flat.amin(1) == 0).all() and (flat.amax(1) == 255).all()
    assert torch.equal(a, ds.render_hr_batch(7, 3, 64, 4, "cpu"))
    assert not torch.equal(a, ds.render_hr_batch(8, 3, 64, 4, "cpu"))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(ds.render_hr_batch(g1, 2, 32, 2, "cpu"),
                       ds.render_hr_batch(g2, 2, 32, 2, "cpu"))


def test_samples_are_index_determined_and_distinct():
    b4 = ds.render_hr_batch(3, 4, 48, 4, "cpu")
    b2 = ds.render_hr_batch(3, 2, 48, 4, "cpu")
    assert torch.equal(b4[:2], b2)
    assert len({bytes(b4[i].numpy()) for i in range(4)}) == 4


@pytest.mark.parametrize("key", [0, 1, 2])
def test_band_sits_below_the_lr_nyquist(key):
    f_lo, f_hi = ds.band_for_scale(4)
    assert (f_lo, f_hi) == jax_ds.band_for_scale(4)
    assert f_hi <= 0.5 / 4
    img = ds.render_hr_batch(key, 1, 192, 4, "cpu")[0].numpy()
    g = img.mean(-1).astype(np.float64)
    g -= g.mean()
    power = np.abs(np.fft.rfft2(g)) ** 2
    r = np.hypot(np.fft.fftfreq(g.shape[0])[:, None],
                 np.fft.rfftfreq(g.shape[1])[None, :])
    tot = power.sum()
    assert power[r >= 0.125].sum() / tot < 0.12
    assert power[(r >= f_lo) & (r < 0.125)].sum() / tot > 0.15


def test_parameters_keep_jax_s_feature_counts_and_ranges():
    hp, scale = 96, 3
    f_lo, f_hi = ds.band_for_scale(scale)
    table = ds._param_table(hp, f_lo, f_hi)
    counts = {name: n for name, n, _, _ in table}
    # 3 base gratings (2 frequencies each), 6 windowed gratings, 2
    # boards, 4 strokes, 2 edges, as JAX's _render_one
    assert (counts["fb"], counts["f"], counts["fc"], counts["ang"],
            counts["eth"]) == (6, 6, 2, 4, 2)
    p = ds.draw_params(11, 5, hp, scale)
    at = 0
    for _, n, lo, hi in table:
        block = p[:, at:at + n]
        assert (block >= lo - 1e-6).all() and (block <= hi + 1e-6).all()
        at += n
    assert p.shape == (5, at)
    assert torch.equal(ds.draw_params(11, 2, hp, scale), p[:2])


def test_stream_yields_device_batches_and_folds_the_resume_step():
    st = ds.DeviceSyntheticStream(TINY, "cpu")
    lr, hr = next(st)
    assert lr is None and hr.shape == (4, 24, 24, 3)
    assert hr.dtype == torch.uint8 and hr.device.type == "cpu"
    assert not torch.equal(hr, next(st)[1])          # the stream advances
    again = next(ds.DeviceSyntheticStream(TINY, "cpu"))[1]
    resumed = next(ds.DeviceSyntheticStream(TINY, "cpu", start_step=100))[1]
    assert torch.equal(hr, again)                    # same seed, same stream
    assert not torch.equal(hr, resumed)              # fresh data on resume
    assert torch.equal(resumed, next(ds.DeviceSyntheticStream(
        TINY, "cpu", start_step=100))[1])
    st.close()


def test_stream_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.DeviceSyntheticStream(TINY, "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.render_hr_batch(0, 1, 8, 2)


def test_epoch_length_and_eval_set_as_jax():
    jopts = JaxOpts(train_dataset="synthetic_device", scale=2)
    assert datasets.train_num_images(TINY) == 32 == \
        jax_datasets.train_num_images(jopts)
    samples = datasets.load_eval_set(TINY, "synthetic_device", 2)
    theirs = jax_datasets.load_eval_set(jopts, "synthetic_device", 2)
    assert [s.name for s in samples] == [s.name for s in theirs] == [
        "device_000", "device_001"]
    for s, t in zip(samples, theirs):
        assert s.hr.shape == t.hr.shape == (480, 480, 3)
        assert s.lr.shape == t.lr.shape == (240, 240, 3)
        assert s.hr.dtype == s.lr.dtype == np.uint8
        np.testing.assert_array_equal(s.lr, host_bicubic_downsample(s.hr, 2))
    assert len(datasets.load_eval_set(TINY, "synthetic_device")) == 5


def test_run_training_on_the_device_corpus(tmp_path, capsys, monkeypatch):
    """2 epochs x 2 steps with eval on the device-rendered set: the loop
    takes the rendered batches as they are (no host upload)."""
    uploads = []
    real = loop.host_to_device
    monkeypatch.setattr(loop, "host_to_device",
                        lambda t, d: uploads.append(t.shape) or real(t, d))
    opts = dataclasses.replace(TINY, num_epochs=2, num_valids=1,
                               log_every=1, eval_pi=False,
                               check_point=str(tmp_path / "exp"))
    summary = loop.run_training(opts)
    out = capsys.readouterr().out
    assert "HR source: rendered on the device (synthetic_device)" in out
    assert summary["steps"] == 4 and summary["train_forwards"] == 4
    assert np.isfinite(summary["val_psnr"]) and summary["val_psnr"] > 0
    assert uploads == []
    with open(tmp_path / "exp" / "pretrain.jsonl") as f:
        l1s = [r["l1"] for r in map(json.loads, f) if "l1" in r]
    assert len(l1s) == 4 and all(np.isfinite(l1s))
    assert os.path.isdir(tmp_path / "exp" / "step_4")
