"""The port's extra corpora against the JAX package on the CPU: the
``synthetic_hard`` / ``synthetic_hard_x4`` renders and the ``natural``
photographs (registry, train source, eval set) bit for bit, and the
errors where a corpus cannot be read."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from pesr_tpu.data import datasets as jax_datasets
from pesr_tpu.metrics import natural_images as jax_natural
from pesr_torch.data import datasets, natural


def _opts(**kw):
    base = dict(scale=4, seed=0, data_root="data", train_dataset="synthetic",
                test_dataset="synthetic", device="cpu")
    return SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("variant", ["hard", "hard_x4"])
@pytest.mark.parametrize("hw, seed", [((24, 40), 3), ((96, 96), 1),
                                      ((130, 70), 0)])
def test_hard_variants_equal_jax_on_small_canvases(variant, hw, seed):
    ours = datasets.SyntheticImages(2, *hw, seed=seed, variant=variant)
    theirs = jax_datasets.SyntheticImages(2, *hw, seed=seed, variant=variant)
    for i in range(2):
        assert ours.name(i) == theirs.name(i)
        np.testing.assert_array_equal(ours.get(i), theirs.get(i))


@pytest.mark.parametrize("variant", ["hard", "hard_x4"])
def test_hard_variants_equal_jax_at_480(variant):
    ours = datasets.SyntheticImages(4, seed=2, variant=variant).get(3)
    theirs = jax_datasets.SyntheticImages(4, seed=2, variant=variant).get(3)
    assert ours.shape == (480, 480, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_unknown_variant_raises_as_jax():
    with pytest.raises(ValueError, match="unknown synthetic variant"):
        datasets.SyntheticImages(variant="harder")


def _assert_same_samples(ours, theirs):
    assert [s.name for s in ours] == [s.name for s in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.lr, b.lr)
        np.testing.assert_array_equal(a.hr, b.hr)


@pytest.mark.parametrize("name, scale", [("synthetic_hard", 2),
                                         ("synthetic_hard_x4", 4)])
def test_load_eval_set_of_the_hard_variants_equals_jax(name, scale):
    opts = _opts(scale=scale, seed=5)
    ours = datasets.load_eval_set(opts, name, 1)
    _assert_same_samples(ours, jax_datasets.load_eval_set(opts, name, 1))
    assert ours[0].name.startswith({"synthetic_hard": "synthhard_",
                                    "synthetic_hard_x4": "synthhardx4_"}[name])


def test_natural_registry_is_jax_s():
    fields = ("module", "relpath", "treatment", "holdout", "name")
    assert ([tuple(getattr(e, f) for f in fields) for e in natural.REGISTRY]
            == [tuple(getattr(e, f) for f in fields)
                for e in jax_natural.REGISTRY])
    assert natural.holdout_names() == jax_natural.holdout_names()
    for e, je in zip(natural.REGISTRY, jax_natural.REGISTRY):
        assert natural.resolve(e) == jax_natural.resolve(je)


def _installed():
    paths = [natural.resolve(e) for e in natural.REGISTRY]
    if not any(paths):
        pytest.skip("no package of the natural registry is installed here")


def test_natural_eval_set_equals_jax():
    """All installed photographs, holdouts included, at x4: names, HR
    (the halved JPEG through the port's MATLAB bicubic) and host-bicubic
    LR bit for bit."""
    _installed()
    opts = _opts()
    ours = datasets.load_eval_set(opts, "natural")
    _assert_same_samples(ours, jax_datasets.load_eval_set(opts, "natural"))
    assert set(natural.holdout_names()) & {s.name for s in ours}


def test_natural_train_source_leaves_the_holdouts_out():
    _installed()
    opts = _opts(train_dataset="natural")
    ours = datasets._resolve_train_source(opts)
    theirs = jax_datasets._resolve_train_source(opts)
    names = [ours.name(i) for i in range(len(ours))]
    assert names == [theirs.name(i) for i in range(len(theirs))]
    assert not set(names) & set(natural.holdout_names())
    assert datasets.train_num_images(opts) == len(names) > 0
    for i in (0, len(ours) - 1):
        np.testing.assert_array_equal(ours.get(i), theirs.get(i))


def test_natural_without_its_packages_raises_a_clear_error(monkeypatch):
    monkeypatch.setattr(natural, "_package_dir", lambda module: None)
    for fn in (lambda: datasets.NaturalImages(),
               lambda: datasets.load_eval_set(_opts(), "natural"),
               lambda: datasets.train_num_images(
                   _opts(train_dataset="natural"))):
        with pytest.raises(FileNotFoundError) as e:
            fn()
        msg = str(e.value)
        assert "nothing is downloaded" in msg
        for module in ("sklearn", "matplotlib", "gymnasium_robotics",
                       "dm_control", "pygame"):
            assert module in msg


def test_natural_jpeg_without_pillow_says_so(monkeypatch):
    entry = next(e for e in natural.REGISTRY if e.relpath.endswith(".jpg"))
    path = natural.resolve(entry)
    if path is None:
        pytest.skip(f"{entry.module} is not installed here")

    def no_pillow(p):
        raise ImportError(f"reading {p} needs Pillow, which is not installed")

    monkeypatch.setattr(datasets, "imread_uint8", no_pillow)
    with pytest.raises(ImportError, match="needs Pillow"):
        natural.load_natural_images()


@pytest.mark.parametrize("name", ["synthetic_hard_x4", "synthetic_device"])
def test_the_test_cli_reads_the_new_sets(tmp_path, name):
    from pesr_torch import test as cli
    summary = cli.run(["--dataset", name, "--device", "cpu", "--num_blocks",
                       "2", "--num_channels", "8", "--output_dir",
                       str(tmp_path)])
    assert len(os.listdir(summary["out_dir"])) == 5
    assert np.isfinite(summary["psnr"])
