"""The port's PIRM perceptual index (``pesr_torch/metrics/{niqe, ma,
ma_features, pirm}.py``) and ``--eval_pi`` against the JAX package's, on
the CPU.

Both sides are float64 numpy on the same uint8 images, with scipy's
gamma (NIQE's table) and scipy's DCT (the Ma features) on both.
Tolerances: the NIQE and Ma feature arrays and a refit NIQE model's
mu and cov bitwise; NIQE, Ma and PI per image 1e-6 absolute (a larger
gap would be a fault, not noise); ``val_pi`` of the whole self-validation 1e-2 (the
two engines' SR outputs may differ by 1 LSB on < 0.1% of their values).
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu import config as jax_config
from pesr_tpu.training import loop as jax_loop
from pesr_torch import train as train_cli
from pesr_torch.config import Opts, opts_from_args
from pesr_torch.convert import state_dict_from_jax
from pesr_torch.data.datasets import EvalSample, SyntheticImages
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.ops.tiling import TiledUpscaler
from pesr_torch.training import loop
from pesr_torch.utils.image_io import imwrite_uint8

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODS = ("niqe", "ma", "ma_features", "pirm")
J = {m: importlib.import_module(f"pesr_tpu.metrics.{m}") for m in _MODS}
P = {m: importlib.import_module(f"pesr_torch.metrics.{m}") for m in _MODS}


def _synthetic_sr(h, w, seed):
    """An SR-like image: a synthetic HR of h x w through a x2 bicubic
    round trip, so it has the blur of an upscale."""
    from pesr_torch.data.datasets import host_bicubic_resize
    hr = SyntheticImages(1, h, w, seed=seed).get(0)
    lr = host_bicubic_resize(hr, h // 2, w // 2)
    return host_bicubic_resize(lr, h, w)


def _demo_srs():
    """x4 outputs of the demo checkpoint (8 x 64) on two synthetic LR
    images, through the port's engine in f32."""
    from pesr_tpu.convert import export_torch_generator
    from pesr_tpu.training.checkpoint import restore_generator_params
    params, _ = restore_generator_params(os.path.join(_REPO, "demo",
                                                      "checkpoint"))
    gen = Generator(4, 8, 64, device="cpu", seed=None)
    gen.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                         export_torch_generator(params, 4).items()})
    src = SyntheticImages(2, 192, 256, seed=11)
    from pesr_torch.data.datasets import host_bicubic_downsample
    lrs = [host_bicubic_downsample(src.get(i), 4) for i in range(2)]
    eng = TiledUpscaler(KernelApply(gen, torch.float32), 4, 96, 8, 8,
                        device="cpu")
    return eng.upscale_many(lrs)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


def test_gamma_table_and_dct_match_scipy():
    from scipy.fft import dctn
    assert _rel(P["niqe"]._R_GAM, J["niqe"]._R_GAM) < 1e-13
    for n in (5, 32):
        b = np.random.default_rng(n).normal(size=(3, 4, n, n))
        d = P["ma_features"].dct_matrix(n)
        np.testing.assert_allclose(d @ b @ d.T,
                                   dctn(b, axes=(2, 3), norm="ortho"),
                                   atol=1e-13)


@pytest.mark.parametrize("source", ["synthetic", "noise", "demo"])
def test_niqe_ma_and_pi_per_image_match_jax(source):
    if source == "demo":
        imgs = _demo_srs()
    elif source == "noise":
        imgs = [np.random.default_rng(1).integers(0, 256, (192, 288, 3),
                                                  dtype=np.uint8)]
    else:
        imgs = [_synthetic_sr(288, 384, seed=2)]
    for img in imgs:
        jf, pf = (J["niqe"].extract_niqe_features(img),
                  P["niqe"].extract_niqe_features(img))
        np.testing.assert_array_equal(pf, jf)
        jm, pm = (J["ma_features"].extract_ma_features(img),
                  P["ma_features"].extract_ma_features(img))
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_array_equal(pm[k], jm[k], err_msg=k)
        for fn in (("niqe", "niqe"), ("ma", "ma_score"),
                   ("ma", "ma_score_approx"), ("pirm", "perceptual_index")):
            want = getattr(J[fn[0]], fn[1])(img)
            got = getattr(P[fn[0]], fn[1])(img)
            assert abs(got - want) <= 1e-6, (fn, got, want)


def test_fit_and_pi_on_a_refit_model_match_jax():
    imgs = [SyntheticImages(3, 192, 192, seed=4).get(i) for i in range(3)]
    jm = J["niqe"].fit_niqe_model(imgs, provenance="t")
    pm = P["niqe"].fit_niqe_model(imgs, provenance="t")
    np.testing.assert_array_equal(pm.mu, jm.mu)
    np.testing.assert_array_equal(pm.cov, jm.cov)
    img = _synthetic_sr(192, 192, seed=5)
    assert abs(P["pirm"].perceptual_index(img, pm)
               - J["pirm"].perceptual_index(img, jm)) <= 1e-6
    with pytest.raises(ValueError, match="smaller than NIQE block"):
        P["niqe"].niqe(np.zeros((95, 200, 3), np.uint8))


def test_evaluate_dir_matches_jax(tmp_path, capsys):
    for i in range(2):
        imwrite_uint8(tmp_path / f"sr_{i}.png", _synthetic_sr(192, 256, i))
    want = J["pirm"].evaluate_dir(str(tmp_path), verbose=False)
    assert P["pirm"].main(["--dir", str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k].replace("pesr_torch", "pesr_tpu") == v, k
        else:
            assert got[k] == pytest.approx(v, abs=1e-6), k


def test_model_resolution_follows_the_environment(tmp_path, monkeypatch):
    niqe, ma = P["niqe"], P["ma"]
    assert "natural" in niqe._default_model().provenance
    assert ma.ma_provenance().startswith(
        "forest:" + os.path.join(_REPO, "pesr_torch", "metrics",
                                 "ma_model_natural.npz"))
    model = niqe.NiqeModel(np.zeros(36), np.eye(36), "unit model")
    model.save(str(tmp_path / "m.npz"))
    monkeypatch.setenv("PESR_NIQE_MODEL", str(tmp_path / "m.npz"))
    assert niqe._default_model().provenance == "unit model"
    monkeypatch.setenv("PESR_MA_MODEL", str(tmp_path / "missing.npz"))
    assert "ma_model_natural" in ma.ma_provenance()


def test_val_pi_matches_jax():
    """``evaluate`` with PI on, synthetic x4, the same f32 weights."""
    arch = dict(scale=4, num_blocks=2, num_channels=8)
    kw = dict(**arch, valid_dataset="synthetic", num_valids=2)
    jopts = jax_config.Opts(**kw, compute_dtype="float32")
    jgen = jax_loop.build_generator(jopts)
    params = jgen.init(jax.random.key(1), jnp.zeros((1, 8, 8, 3)))["params"]
    want = jax_loop.evaluate(jopts, jgen.apply, params)
    gen = Generator(**arch, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 4))
    got = loop.evaluate(Opts(**kw, device="cpu"),
                        KernelApply(gen, torch.float32))
    assert set(got) == set(want) == {"val_psnr", "val_ssim", "val_pi"}
    assert got["val_pi"] == pytest.approx(want["val_pi"], abs=1e-2)


def test_score_outputs_without_hr_or_computable_pi():
    opts = Opts(scale=2, valid_dataset="v", device="cpu")
    big = _synthetic_sr(192, 192, seed=6)
    small = np.zeros((40, 40, 3), np.uint8)
    hr = [EvalSample("a", None, big), EvalSample("b", None, None)]
    got = loop.score_outputs(opts, hr, [big, small])
    assert set(got) == {"val_psnr", "val_ssim", "val_pi"}
    assert got["val_pi"] == pytest.approx(
        P["pirm"].perceptual_index(big), abs=1e-12)   # small one left out
    no_hr = [EvalSample("a", None, None), EvalSample("b", None, None)]
    assert set(loop.score_outputs(opts, no_hr, [big, small])) == {"val_pi"}
    with pytest.raises(loop.EvalSkip, match="not computable"):
        loop.score_outputs(opts, no_hr[1:], [small])
    with pytest.raises(loop.EvalSkip, match="disabled"):
        loop.score_outputs(opts, no_hr, [big, small], compute_pi=False)


_CLI = ["--device", "cpu", "--num_blocks", "2", "--num_channels", "8",
        "--scale", "2", "--batch_size", "2", "--patch_size", "12",
        "--train_dataset", "synthetic", "--steps_per_epoch", "2",
        "--num_epochs", "1", "--log_every", "2", "--num_valids", "1"]


@pytest.mark.parametrize("argv", [[], ["--eval_pi"], ["--no_eval_pi"]])
def test_eval_pi_flag_parses_as_jax_does(argv):
    assert (opts_from_args(_CLI + argv, mode="train").eval_pi
            == jax_config.opts_from_args(argv, mode="train").eval_pi)


@pytest.mark.parametrize("flag", ["--eval_pi", "--no_eval_pi"])
def test_train_cli_logs_val_pi_unless_told_not_to(tmp_path, capsys, flag):
    assert train_cli.main(_CLI + [flag, "--valid_dataset", "synthetic",
                                  "--check_point", str(tmp_path)]) == 0
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1][
        len("[done] "):])
    assert np.isfinite(done["val_psnr"])
    assert ("val_pi" in done) == (flag == "--eval_pi")
    if flag == "--eval_pi":
        assert np.isfinite(done["val_pi"])


def test_train_cli_on_a_set_without_hr(tmp_path, capsys):
    """An LR-only validation set: val_pi is logged, no best/ is written
    (best is chosen by PSNR) and nothing raises."""
    rng = np.random.default_rng(8)
    for i in range(2):
        imwrite_uint8(tmp_path / "data" / "lronly" / "LR" / f"{i}.png",
                      rng.integers(0, 256, (56, 60, 3), dtype=np.uint8))
    ck = tmp_path / "ck"
    assert train_cli.main(_CLI + [
        "--valid_dataset", "lronly", "--data_root", str(tmp_path / "data"),
        "--check_point", str(ck)]) == 0
    out = capsys.readouterr().out
    done = json.loads(out.strip().splitlines()[-1][len("[done] "):])
    assert np.isfinite(done["val_pi"]) and "val_psnr" not in done
    assert "best_psnr" not in done and not (ck / "best").exists()
    recs = [json.loads(line) for line in open(ck / "pretrain.jsonl")]
    assert any("val_pi" in r for r in recs)
