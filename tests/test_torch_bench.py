"""The port's headline benchmark (``python -m pesr_torch.bench``) against
the repo's ``bench.py``, on the CPU at 2 blocks x 16 channels.

* The JSON line: the port's keys, metric, unit, precision and path names
  equal those of one real run of ``bench.py`` (JAX on the CPU) at the
  same ``BENCH_*`` environment; ``vs_baseline`` is value / 50.
* The paths on the same weights (JAX's init carried across with
  ``state_dict_from_jax``), the same batch (the bench's first image) and
  the same tile grid, canvases against ``bench._build_apply`` in JAX's
  ``BatchTiledUpscaler``:

  - int8: ``tests/test_torch_quant.py``'s bound against JAX's jitted
    apply (at most 8 LSB, mean below 1.0);
  - the folded engine in float32 on both sides:
    ``tests/test_torch_fold.py``'s bound (at most 1 LSB, on fewer than
    0.1% of the values);
  - bf16 folded, the bench's own path: at most 2 LSB on fewer than 10% of
    the values.  JAX rounds each conv's output to bf16 and then adds the
    bf16 bias, and scales the residual by bf16(0.1); the port adds the
    bias in the f32 accumulator, as its kernels do, so about 8% of the
    uint8 values move by 1 LSB (measured 7.6-8.0% at x2-x8, at most 2
    LSB on one value at x4; with JAX's rounding order replayed in the
    port, 0.13%).
  - the calibration tiles and the bench's images: bitwise.

* ``BENCH_*`` parsing, the refusal without CUDA, and ``BENCH_MESH=2`` on
  two gloo processes (tests/test_torch_ddp.py's :func:`run_group`).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import bench as jax_bench  # noqa: E402
from pesr_tpu.models import Generator as JaxGenerator  # noqa: E402
from pesr_tpu.models import fold as jfold  # noqa: E402
from pesr_tpu.models import quant_apply as jq  # noqa: E402
from pesr_tpu.ops.tiling import BatchTiledUpscaler as JaxTiler  # noqa: E402
from pesr_torch import bench  # noqa: E402
from pesr_torch.convert import state_dict_from_jax  # noqa: E402
from pesr_torch.models.generator import Generator  # noqa: E402
from pesr_torch.models.kernel_apply import KernelApply  # noqa: E402
from tests.test_torch_ddp import run_group  # noqa: E402

# the cut environment of every run here: x8 keeps bench.py's run short
CUT = {"BENCH_BLOCKS": "2", "BENCH_CHANNELS": "16", "BENCH_IMAGES": "1",
       "BENCH_REPEATS": "1", "BENCH_SCALE": "8"}
_MESH_KEYS = {"mesh_devices", "mesh_total_mps_headline"}


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _jax_bench_record():
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(CUT, JAX_PLATFORMS="cpu", PESR_ALLOW_CPU_BENCH="1")
    out = subprocess.run([sys.executable, "bench.py"], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = _json_lines(out.stdout)
    assert len(lines) == 1, out.stdout
    return lines[0]


def test_json_line_has_bench_py_keys(capsys):
    want = _jax_bench_record()
    assert bench.main(device="cpu", env=CUT) == 0
    captured = capsys.readouterr()
    assert captured.out.count("\n") == 1
    got = json.loads(captured.out)
    assert set(got) == set(want)
    for key in ("metric", "unit", "precision"):
        assert got[key] == want[key], key
    assert got["metric"] == "tiled_x8_inference_throughput"
    assert set(got["paths"]) == set(want["paths"]) == {"int8-w8a8", "bf16"}
    for name, p in got["paths"].items():
        assert set(p) == set(want["paths"][name])
        assert p["unit"] == "MP/s/chip" and p["value"] > 0
        assert p["vs_baseline"] == round(p["value"] / 50, 4)
    assert got["value"] == got["paths"]["int8-w8a8"]["value"]
    assert got["vs_baseline"] == round(got["value"] / 50, 4)
    assert "[bench] device=cpu tile=auto overlap=8 images=1 model=2x16 " \
           "paths=['int8-w8a8', 'bf16']" in captured.err


def _pair(scale):
    """bench.py's generator and its init (``key(0)``), and the port's
    generator on the same weights."""
    jgen = JaxGenerator(scale=scale, num_blocks=2, num_channels=16)
    variables = jax.jit(jgen.init)(jax.random.key(0),
                                   jnp.zeros((1, 16, 16, 3)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    gen = Generator(scale, 2, 16, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(params, scale))
    return jgen, variables, gen


def _lsb(got, want):
    assert got.shape == want.shape   # the same padded grid
    return np.abs(got.astype(int) - want.astype(int))


def test_inputs_and_calibration_tiles_are_bench_py_s():
    """bench.py draws them inline (``bench.py:132-140``)."""
    want_calib = np.random.default_rng(1).integers(0, 256, (510, 336, 3),
                                                   dtype=np.uint8)
    calib = bench.calib_images()
    assert len(calib) == 1 and np.array_equal(calib[0], want_calib)
    got, want = (bench.default_calib_tiles(calib),
                 jq.default_calib_tiles([want_calib]))
    assert len(got) == len(want) == 1 and got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    for scale in (2, 3, 4, 6, 8):
        want_imgs = np.random.default_rng(0).integers(
            0, 256, (3, 2040 // scale, 1344 // scale, 3), dtype=np.uint8)
        np.testing.assert_array_equal(bench.bench_images(scale, 3),
                                      want_imgs)


@pytest.mark.parametrize("scale", [3, 4])
def test_paths_match_bench_py_on_the_same_weights(scale):
    jgen, variables, gen = _pair(scale)
    cfg = bench.config_from_env({"BENCH_SCALE": str(scale)})
    imgs = bench.bench_images(scale, 1)
    calib = bench.calib_images()
    cpu = torch.device("cpu")

    def ours(apply_fn):
        eng = bench.make_engine(apply_fn, cfg, cpu)
        out = eng.upscale_batch_device(torch.from_numpy(imgs)).numpy()
        return out, eng.grid(*imgs.shape[:3])[2:]

    def theirs(fn, pvars, tile):
        return np.asarray(JaxTiler(fn, pvars, scale, tile, cfg.overlap)
                          .upscale_batch_device(jnp.asarray(imgs)))

    got, tile = ours(bench.build_apply(gen, "int8-w8a8", True, calib))
    want = theirs(*jax_bench._build_apply(jgen, variables, scale, "int8",
                                          True, calib), tile)
    d = _lsb(got, want)
    assert d.max() <= 8 and d.mean() < 1.0, (d.max(), d.mean())

    got, tile = ours(KernelApply(gen, torch.float32, fold=True))
    want = theirs(*jfold.folded_inference(variables["params"], scale,
                                          dtype=jnp.float32), tile)
    d = _lsb(got, want)
    assert d.max() <= 1 and np.mean(d > 0) < 1e-3, (d.max(), np.mean(d > 0))

    got, tile = ours(bench.build_apply(gen, "bf16", True, calib))
    want = theirs(*jax_bench._build_apply(jgen, variables, scale, "bf16",
                                          True, calib), tile)
    d = _lsb(got, want)
    assert d.max() <= 2 and np.mean(d > 0) < 0.1, (d.max(), np.mean(d > 0))


def test_defaults_are_bench_py_s():
    cfg = bench.config_from_env({})
    assert (cfg.tile, cfg.overlap, cfg.n_images, cfg.blocks, cfg.channels,
            cfg.repeats, cfg.scale, cfg.fold, cfg.mesh_n, cfg.profile_dir
            ) == ("auto", 8, 8, 32, 256, 5, 4, True, 0, "")
    assert cfg.headline == "int8-w8a8"
    assert cfg.paths == ("int8-w8a8", "bf16")
    cfg = bench.config_from_env({"BENCH_TILE": "96", "BENCH_FOLD": "0"})
    assert cfg.tile == 96 and not cfg.fold


@pytest.mark.parametrize("env,headline,paths", [
    ({"BENCH_QUANT": "none"}, "bf16", ("int8-w8a8", "bf16")),
    ({"BENCH_PATHS": "bf16"}, "int8-w8a8", ("int8-w8a8", "bf16")),
    ({"BENCH_QUANT": "none", "BENCH_PATHS": "int8"}, "bf16",
     ("bf16", "int8-w8a8")),
    ({"BENCH_PATHS": "int8-w8a8, ,int8"}, "int8-w8a8",
     ("int8-w8a8", "int8-w8a8")),
])
def test_paths_and_headline_parse_as_bench_py(env, headline, paths):
    cfg = bench.config_from_env(env)
    assert cfg.headline == headline and cfg.paths == paths


def test_headline_bf16_leads_the_record():
    record, details = bench.run("cpu", dict(CUT, BENCH_QUANT="none",
                                            BENCH_PATHS="bf16"))
    assert record["precision"] == "bf16"
    assert list(record["paths"]) == ["bf16"]
    assert record["value"] == record["paths"]["bf16"]["value"]
    d = details["bf16"]
    # warm-up + one timed pass, one forward each (one tile at x8); on the
    # CPU the plain versions run and no kernel is launched
    assert d["forwards"] == 2 and d["grid"] == (1, 1, 255, 168)
    assert d["launches"] == {"fused_resblock": 0, "fused_upsampler_stage": 0,
                             "fused_rcab": 0, "rcab_excite": 0,
                             "fused_resblock_int8": 0}
    assert d["peak_bytes"] is None and d["seconds"] > 0


def test_profile_traces_the_headline_path_only(tmp_path, capsys):
    bench.run("cpu", dict(CUT, BENCH_PROFILE=str(tmp_path)))
    assert sorted(os.listdir(tmp_path)) == ["bench_int8-w8a8.pt.trace.json"]
    with open(tmp_path / "bench_int8-w8a8.pt.trace.json") as fh:
        assert json.load(fh)["traceEvents"]
    assert f"[bench] trace -> {tmp_path}" in capsys.readouterr().err


@pytest.mark.parametrize("env,match", [
    ({"BENCH_PATHS": "int8,fp16"}, "unknown path 'fp16'"),
    ({"BENCH_IMAGES": "3", "BENCH_MESH": "2"}, "not divisible"),
])
def test_bad_environment_refuses(env, match):
    with pytest.raises(SystemExit, match=match):
        bench.config_from_env(env)


def test_mesh_without_a_process_group_raises(monkeypatch):
    for k in ("PESR_COORDINATOR", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no cluster configured"):
        bench.run("cpu", dict(CUT, BENCH_IMAGES="2", BENCH_MESH="2"))


def test_raises_without_cuda_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(env=CUT)
    env = dict(os.environ, **CUT)
    out = subprocess.run([sys.executable, "-m", "pesr_torch.bench"],
                         cwd=_REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA is not available" in out.stderr


def test_mesh_of_two_gloo_ranks_prints_one_line(monkeypatch):
    for k, v in dict(CUT, BENCH_IMAGES="2", BENCH_MESH="2").items():
        monkeypatch.setenv(k, v)
    outs = run_group(lambda r: [sys.executable, "-c",
                                "from pesr_torch import bench; "
                                "bench.main(device='cpu')"])
    lines = [x for out in outs for x in _json_lines(out)]
    assert len(lines) == 1 and _json_lines(outs[0]) == lines
    rec = lines[0]
    assert set(rec) == {"metric", "value", "unit", "precision",
                        "vs_baseline", "paths"} | _MESH_KEYS
    assert rec["mesh_devices"] == 2
    assert rec["mesh_total_mps_headline"] == round(rec["value"] * 2, 3)
