"""The port's int8 quality guard (``int8_agreement_db``,
``int8_inference_guarded``), the f32 apply and the ``--quant`` /
``--quant_guard_db`` / ``--compute_dtype`` flow of ``python -m
pesr_torch.test``, on the CPU, against the JAX package where it has a
counterpart (``tests/test_quant_stress.py``'s ladder).

Tolerances: agreement within 0.1 dB of JAX's when both int8 applies are
held to one reference (JAX's bf16 folded outputs); each against its own
bf16 folded engine, the port reads up to 1 dB lower (measured 60.97 vs
61.89 dB on the demo checkpoint): its reference is the kernel path's
plain version, which adds its residual in f32 and rounds once where
JAX's rounds the product and the sum to bf16 (the two references are
65.5 dB apart), and that noise adds to the int8 path's.  The float32
folded apply within 2e-5 of JAX's ``folded_inference(float32)`` on
outputs of O(1) (JAX's own fold tolerance).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu.models import Generator as JaxGenerator
from pesr_tpu.models import fold as jfold
from pesr_tpu.models import quant_apply as jq
from pesr_torch import test as cli
from pesr_torch.config import Opts
from pesr_torch.convert import load_generator_pth, state_dict_from_jax
from pesr_torch.data.datasets import load_eval_set
from pesr_torch.models import quant_apply as tq
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import Float32Apply, KernelApply
from pesr_torch.ops import kernels
from pesr_torch.scales import fold_min_halo

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """demo/checkpoint (x4, 8 x 64) as JAX params and the port's generator
    (through pesr_tpu.convert's .pth), and the calibration tiles of
    JAX's stress suite: 4 crops of 64 px from two synthetic eval images."""
    from pesr_tpu.convert import save_generator_torch
    from pesr_tpu.training.checkpoint import restore_generator_params
    params, _ = restore_generator_params(os.path.join(_REPO, "demo",
                                                      "checkpoint"))
    pth = str(tmp_path_factory.mktemp("demo") / "g.pth")
    save_generator_torch(params, 4, pth)
    gen = Generator(4, 8, 64, device="cpu", seed=None)
    gen.load_state_dict(load_generator_pth(pth, 8, 4))
    lrs = [s.lr for s in load_eval_set(Opts(num_blocks=8, num_channels=64),
                                       "synthetic", 2)]
    return params, gen, tq.default_calib_tiles(lrs, tile=64, max_tiles=4)


def _dark_tiles():
    """Near-black calibration tiles (JAX's calibration-shift stress)."""
    rng = np.random.default_rng(0)
    return [np.full((4, 64, 64, 3), -0.95, np.float32)
            + 0.02 * rng.standard_normal((4, 64, 64, 3)).astype(np.float32)]


def test_agreement_db_matches_jax(demo):
    params, gen, calib = demo
    japply, jv = jq.int8_inference(params, 4, calib)
    want = jq.int8_agreement_db(japply, jv, params, 4, calib)
    ours = tq.int8_inference(gen, calib)
    bapply, bv = jfold.folded_inference(params, 4, dtype=jnp.bfloat16)
    f_bf16 = jax.jit(bapply)

    def jax_bf16(x):
        return T(np.array(f_bf16(bv, jnp.asarray(x.numpy())), np.float32))

    same_ref = tq.int8_agreement_db(ours, gen, calib, bf16_engine=jax_bf16)
    assert abs(same_ref - want) <= 0.1, (same_ref, want)
    own_ref = tq.int8_agreement_db(ours, gen, calib)
    assert 55.0 < own_ref <= want and want - own_ref <= 1.0, (own_ref, want)


def test_guard_serves_healthy_int8_and_rescues_calibration_shift(demo):
    params, gen, calib = demo
    apply_ok, rep_ok = tq.int8_inference_guarded(gen, calib,
                                                 probe_tiles=calib)
    assert isinstance(apply_ok, tq.Int8Apply)
    assert rep_ok["served"] == "int8" and not rep_ok["fallback"], rep_ok
    assert rep_ok["agreement_db"] > 58.0, rep_ok

    apply_bad, rep_bad = tq.int8_inference_guarded(gen, _dark_tiles(),
                                                   probe_tiles=calib)
    assert rep_bad["agreement_db"] < 50.0, rep_bad
    assert rep_bad["recalibrated"] and not rep_bad["fallback"], rep_bad
    assert rep_bad["served"] == "int8_recalibrated", rep_bad
    assert rep_bad["agreement_db_recalibrated"] > 58.0, rep_bad
    assert isinstance(apply_bad, tq.Int8Apply)
    # the rescued engine is the healthy one: calibrated on the probe
    x = T(calib[0][:1])
    assert torch.equal(apply_bad(x), apply_ok(x))


def test_guard_falls_back_when_recalibration_cannot_save(demo, capsys):
    params, gen, calib = demo
    apply_fn, rep = tq.int8_inference_guarded(gen, _dark_tiles(),
                                              probe_tiles=calib,
                                              min_agreement_db=200.0)
    assert rep["fallback"] and rep["served"] == "bf16", rep
    assert "agreement_db_recalibrated" in rep and not rep["recalibrated"]
    assert isinstance(apply_fn, KernelApply) and apply_fn.fold is not None
    err = capsys.readouterr().err
    assert "recalibrating on the probe" in err and "FALLING BACK" in err

    apply32, rep32 = tq.int8_inference_guarded(
        gen, calib, probe_tiles=calib, min_agreement_db=200.0,
        fallback_dtype=torch.float32)
    assert rep32["served"] == "float32" and rep32["fallback"], rep32
    assert "agreement_db_recalibrated" not in rep32, rep32
    assert isinstance(apply32, Float32Apply)
    assert apply32.min_halo == fold_min_halo(4)


def _tiny(rs=0.1, scale=2, seed=0):
    jgen = JaxGenerator(scale=scale, num_blocks=2, num_channels=8,
                        res_scale=rs)
    params = jax.tree_util.tree_map(np.asarray, jgen.init(
        jax.random.key(seed), jnp.zeros((1, 16, 16, 3)))["params"])
    gen = Generator(scale, 2, 8, res_scale=rs, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(params, scale))
    rng = np.random.default_rng(0)
    tiles = tq.default_calib_tiles(
        [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)], tile=32,
        max_tiles=4)
    return params, gen, tiles


def test_guard_respects_res_scale():
    """The agreement reference is built with the generator's res_scale: a
    reference at another res_scale reads >10 dB lower, and a floor
    between the two keeps int8."""
    _, gen, tiles = _tiny(rs=0.3)
    other = Generator(2, 2, 8, res_scale=0.1, device="cpu", seed=None)
    other.load_state_dict(gen.state_dict())
    apply_fn = tq.int8_inference(gen, tiles)
    a_right = tq.int8_agreement_db(apply_fn, gen, tiles)
    a_wrong = tq.int8_agreement_db(apply_fn, other, tiles)
    assert a_right > a_wrong + 10.0, (a_right, a_wrong)
    _, rep = tq.int8_inference_guarded(
        gen, tiles, min_agreement_db=(a_right + a_wrong) / 2.0)
    assert not rep["fallback"] and abs(rep["agreement_db"] - a_right) < 1.0


@pytest.mark.parametrize("floor", [20.0, 200.0])
def test_guard_report_equals_jax(floor):
    """The same report keys and rung as JAX's guard; agreement within
    0.1 dB."""
    params, gen, tiles = _tiny()
    dark = [np.clip(tiles[0] * 0.1 - 0.9, -1, 1)]
    _, _, want = jq.int8_inference_guarded(params, 2, dark,
                                           probe_tiles=tiles,
                                           min_agreement_db=floor)
    _, got = tq.int8_inference_guarded(gen, dark, probe_tiles=tiles,
                                       min_agreement_db=floor)
    assert set(got) == set(want), (got, want)
    for key in ("served", "recalibrated", "fallback", "min_agreement_db"):
        assert got[key] == want[key], (key, got, want)
    for key in ("agreement_db", "agreement_db_recalibrated"):
        if key in want:
            assert abs(got[key] - want[key]) <= 0.1, (key, got, want)


@pytest.mark.parametrize("fold", [True, False])
def test_float32_apply_matches_jax(fold):
    """``--compute_dtype float32``: the f32 folded apply against JAX's
    ``folded_inference(float32)``, the chain against the f32 Generator."""
    params, gen, tiles = _tiny(scale=4)
    x = tiles[0][:2]
    ours = Float32Apply(gen, fold=fold)
    got = ours(T(x))
    assert got.dtype == torch.float32 and ours.forwards == 1
    if fold:
        japply, jv = jfold.folded_inference(params, 4, dtype=jnp.float32)
    else:
        japply = JaxGenerator(scale=4, num_blocks=2, num_channels=8,
                              dtype=jnp.float32).apply
        jv = {"params": params}
    want = np.asarray(japply(jv, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    if fold:
        u8 = np.asarray(japply.uint8_variant(jv, jnp.asarray(x)))
        d = np.abs(ours.uint8_variant(T(x)).numpy().astype(int) - u8)
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


_TINY = ["--num_blocks", "2", "--num_channels", "8", "--dataset",
         "synthetic", "--device", "cpu"]


def _pngs(res):
    return sorted(os.listdir(res["out_dir"]))


@pytest.mark.parametrize("floor,served", [(20, "int8-w8a8"),
                                          (200, "folded-bfloat16")])
def test_cli_quant_guard_serves_and_falls_back(floor, served, tmp_path,
                                               capsys):
    """``--quant int8 --quant_guard_db N``: 20 dB serves int8, 200 dB falls
    back to the bf16 folded kernel path; both exit 0 and write the PNGs."""
    kernels.reset_launch_counts()
    assert cli.main(_TINY + ["--quant", "int8", "--quant_guard_db",
                             str(floor), "--output_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "int8 quality guard: {" in out and served in out
    if floor == 200:
        assert "using folded bfloat16 path (quality-guard fallback)" in out
    else:
        assert "using int8 W8A8 inference path (calibrated)" in out
    assert len(os.listdir(tmp_path / "synthetic")) == 5
    assert kernels.launch_counts() == {"fused_resblock": 0,
                                       "fused_upsampler_stage": 0,
                                       "fused_rcab": 0, "rcab_excite": 0}


@pytest.mark.parametrize("extra,forwards", [
    (["--tile_size", "0"], 1 + 5), (["--self_ensemble"], 8 + 8),
    (["--compute_dtype", "float32"], 1 + 1)])
def test_cli_quant_int8_in_every_engine(extra, forwards, tmp_path):
    """``--quant int8`` in the whole-image engine (a warm-up forward, then
    one per image), with the self-ensemble in the batch engine (8 branches
    in warm-up, 8 for the one batch of 5 images), and with
    ``--compute_dtype float32``, which only sets the guard's fallback: it
    still serves int8 (a warm-up and one batch)."""
    res = cli.run(_TINY + ["--quant", "int8", "--output_dir",
                           str(tmp_path)] + extra)
    assert res["precision"] == "int8-w8a8" and res["quant_guard"] is None
    assert res["forwards"] == forwards, res
    assert len(_pngs(res)) == 5 and np.isfinite(res["psnr"])


def test_cli_int8_whole_image_equals_tiled_single_tile(tmp_path):
    """At 120 x 120 LR the auto tile is the whole image: both engines pad
    the fold's min_halo by replication and give the same int8 output."""
    a = cli.run(_TINY + ["--quant", "int8", "--tile_size", "0",
                         "--output_dir", str(tmp_path / "a")])
    b = cli.run(_TINY + ["--quant", "int8", "--output_dir",
                         str(tmp_path / "b")])
    assert a["psnr"] == b["psnr"], (a, b)


@pytest.mark.parametrize("extra,label", [([], "folded-float32"),
                                         (["--no_fold"], "float32")])
def test_cli_compute_dtype_float32(extra, label, tmp_path, capsys):
    res = cli.run(_TINY + ["--compute_dtype", "float32", "--output_dir",
                           str(tmp_path)] + extra)
    out = capsys.readouterr().out
    assert res["precision"] == label and label in out
    assert "compute float32: plain PyTorch convs with TF32 off" in out
    b = cli.run(_TINY + ["--output_dir", str(tmp_path / "bf16")] + extra)
    assert abs(res["psnr"] - b["psnr"]) < 0.05, (res, b)
