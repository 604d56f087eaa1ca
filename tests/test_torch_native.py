"""The port's native data core (``pesr_torch/data/native``: its own copy
of ``sampler.cpp``, built into ``pesr_torch/_build/``) against the JAX
package's on the CPU: PNG decode, the crop sampler and the train stream
that prefers it, bit for bit; the encoder round trip; and the fallbacks,
each printed with its reason."""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest

from pesr_tpu.config import Opts as JaxOpts
from pesr_tpu.data import datasets as jax_datasets
from pesr_tpu.data import native as jax_native
from pesr_torch.config import Opts
from pesr_torch.data import datasets, native
from pesr_torch.utils.image_io import imread_uint8, imwrite_uint8

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_builds_into_the_port_build_dir():
    assert native.available(), native.unavailable_reason()
    assert native.unavailable_reason() is None
    path = native.lib_path()
    assert path.is_file()
    assert os.path.commonpath([str(path), os.path.join(
        _REPO, "pesr_torch", "_build")]) == os.path.join(
            _REPO, "pesr_torch", "_build")
    src = os.path.join(_REPO, "pesr_torch", "data", "native", "sampler.cpp")
    with open(src, "rb") as a, open(os.path.join(
            _REPO, "pesr_tpu", "data", "native", "sampler.cpp"), "rb") as b:
        assert a.read() == b.read()   # a copy, not a variant


def _pil_png(path, mode, rng):
    from PIL import Image
    if mode == "I;16":
        arr = rng.integers(0, 65536, (23, 31), dtype=np.uint16)
        Image.fromarray(arr).save(path)
        return
    rgb = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
    im = Image.fromarray(rgb)
    if mode == "RGBA":
        im.putalpha(Image.fromarray(rng.integers(0, 256, (23, 31),
                                                 dtype=np.uint8)))
    elif mode != "RGB":
        im = im.convert(mode)
    im.save(path)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "I;16"])
def test_decode_png_equals_jax_and_pillow(tmp_path, mode):
    path = str(tmp_path / "x.png")
    _pil_png(path, mode, np.random.default_rng(len(mode)))
    ours = native.decode_png(path)
    assert ours.dtype == np.uint8 and ours.shape == (23, 31, 3)
    np.testing.assert_array_equal(ours, jax_native.decode_png(path))
    if mode != "I;16":   # Pillow clips 16-bit gray; libpng keeps the MSB
        np.testing.assert_array_equal(ours, imread_uint8(path))
    np.testing.assert_array_equal(datasets.decode_image(path), ours)


def test_sampler_batches_equal_jax():
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (48 + 16 * i, 64 + 8 * i, 3),
                         dtype=np.uint8) for i in range(5)]
    ours = native.NativePatchSampler(imgs, 32, 24, seed=9)
    one = native.NativePatchSampler(imgs, 32, 24, seed=9, threads=1)
    theirs = jax_native.NativePatchSampler(imgs, 32, 24, seed=9)
    for step in (0, 1, 17):
        a = ours.sample(step)
        np.testing.assert_array_equal(a, theirs.sample(step))
        np.testing.assert_array_equal(a, one.sample(step))
    assert len(ours) == 5
    lr, hr = next(ours)
    assert lr is None
    np.testing.assert_array_equal(hr, theirs.sample(0))
    np.testing.assert_array_equal(next(ours)[1], theirs.sample(1))


def _png_folder(root, n=3, hw=(70, 90)):
    hr_dir = os.path.join(root, "DIV2K", "DIV2K_train_HR")
    src = datasets.SyntheticImages(n, *hw, seed=4)
    for i in range(n):
        imwrite_uint8(os.path.join(hr_dir, f"{i:04d}.png"), src.get(i))
    return hr_dir


@pytest.mark.parametrize("dataset, start_step", [("DIV2K", 0),
                                                 ("DIV2K", 11),
                                                 ("synthetic", 3)])
def test_train_iterator_takes_the_native_sampler_as_jax(tmp_path, capsys,
                                                        dataset, start_step):
    _png_folder(str(tmp_path))
    kw = dict(train_dataset=dataset, data_root=str(tmp_path), patch_size=12,
              batch_size=5, seed=7)
    ours, from_files = datasets.make_train_iterator(Opts(**kw), start_step)
    theirs, _ = jax_datasets.make_train_iterator(JaxOpts(**kw), start_step)
    try:
        out = capsys.readouterr().out
        n = 3 if dataset == "DIV2K" else 32
        assert f"HR source: native sampler ({n} images, " in out
        assert not from_files
        for _ in range(3):
            (a_lr, a), (b_lr, b) = next(ours), next(theirs)
            assert a_lr is None and b_lr is None
            assert a.shape == (5, 48, 48, 3)
            np.testing.assert_array_equal(a, b)
    finally:
        ours.close()
        theirs.close()


def test_fallbacks_to_patch_iterator_print_their_reason(tmp_path, capsys,
                                                        monkeypatch):
    hr_dir = _png_folder(str(tmp_path), hw=(40, 40))
    opts = Opts(train_dataset="DIV2K", data_root=str(tmp_path),
                patch_size=8, batch_size=2)

    def reason():
        it, _ = datasets.make_train_iterator(opts)
        next(it)
        it.close()
        out = capsys.readouterr().out
        assert "HR source: PatchIterator (" in out
        return out

    big = dataclasses.replace(opts, patch_size=12)   # 48 px > 40 px
    it, _ = datasets.make_train_iterator(big)
    it.close()
    assert "native sampler refused the corpus" in capsys.readouterr().out
    monkeypatch.setattr(datasets, "_NATIVE_CACHE_BYTES", 100)
    assert "budget" in reason()
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "unavailable_reason", lambda: "no libpng")
    assert "native data library unavailable: no libpng" in reason()
    lr_dir = os.path.join(str(tmp_path), "DIV2K", "DIV2K_train_LR_bicubic",
                          "X4")
    for f in os.listdir(hr_dir):
        img = imread_uint8(os.path.join(hr_dir, f))
        imwrite_uint8(os.path.join(lr_dir, f), img[::4, ::4])
    assert "LR files" in reason()


def test_encode_round_trip_and_bad_inputs(tmp_path):
    img = np.random.default_rng(11).integers(0, 256, (65, 43, 3),
                                             dtype=np.uint8)
    path = str(tmp_path / "x.png")
    native.encode_png(path, img)
    np.testing.assert_array_equal(native.decode_png(path), img)
    np.testing.assert_array_equal(imread_uint8(path), img)
    np.testing.assert_array_equal(jax_native.decode_png(path), img)
    with pytest.raises(ValueError, match="HWC uint8"):
        native.encode_png(path, img.astype(np.float32))
    with pytest.raises(ValueError, match="HWC uint8"):
        native.encode_png(path, img[..., 0])
    with pytest.raises(IOError):
        native.encode_png(str(tmp_path / "no" / "dir.png"), img)
    (tmp_path / "not.png").write_bytes(b"not a png")
    with pytest.raises(IOError, match="PNG header"):
        native.decode_png(str(tmp_path / "not.png"))
    with pytest.raises(IOError):
        native.decode_png(str(tmp_path / "missing.png"))
    small = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="smaller than the 32-px patch"):
        native.NativePatchSampler([small], 32, 2, 0)
    with pytest.raises(ValueError, match="HWC uint8"):
        native.NativePatchSampler([small.astype(np.float32)], 8, 2, 0)
    with pytest.raises(ValueError, match="no images"):
        native.NativePatchSampler([], 8, 2, 0)


def test_an_unbuildable_library_says_why_and_pillow_decodes(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "CXX_CMD", ("/nonexistent/g++",))
    assert native.get_lib() is None and not native.available()
    assert "nonexistent" in native.unavailable_reason()
    with pytest.raises(ImportError, match="unavailable"):
        native.decode_png("x.png")
    img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    imwrite_uint8(str(tmp_path / "y.png"), img)
    np.testing.assert_array_equal(
        datasets.decode_image(str(tmp_path / "y.png")), img)
    monkeypatch.setattr(datasets, "imread_uint8", _no_pillow)
    with pytest.raises(ImportError, match="native PNG decoder is "
                                          "unavailable too"):
        datasets.decode_image(str(tmp_path / "y.png"))


def _no_pillow(path):
    raise ImportError(f"reading {path} needs Pillow, which is not installed")


def test_synthetic_source_through_the_sampler_equals_jax_at_the_flagship():
    """The native stream over the in-memory corpus at the flagship's
    HR patch (192) and batch (16), first step, as the JAX package."""
    opts = SimpleNamespace(train_dataset="synthetic", seed=0, scale=4)
    src = datasets._resolve_train_source(opts)
    imgs = [src.get(i) for i in range(4)]
    ours = native.NativePatchSampler(imgs, 192, 16, seed=0)
    theirs = jax_native.NativePatchSampler(imgs, 192, 16, seed=0)
    np.testing.assert_array_equal(ours.sample(), theirs.sample())
