"""The port's CLI (``python -m pesr_torch.test``), its import rule, and the
demo checkpoint carried across from the JAX package, on the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

from pesr_torch import test as cli
from pesr_torch.utils.image_io import encode_png, imwrite_uint8

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = ["--num_blocks", "2", "--num_channels", "8", "--dataset",
         "synthetic"]


def test_cli_on_cpu_writes_pngs_and_prints_psnr(tmp_path, capsys):
    assert cli.main(_TINY + ["--device", "cpu", "--output_dir",
                             str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "WARNING: no --model_path" in out
    assert "mean PSNR" in out and "MP/s on cpu" in out
    pngs = sorted(os.listdir(tmp_path / "synthetic"))
    assert pngs == [f"synthetic_{i:04d}.png" for i in range(5)]
    with open(tmp_path / "synthetic" / pngs[0], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_whole_image_mode_matches_tiled_auto(tmp_path):
    a = cli.run(_TINY + ["--device", "cpu", "--tile_size", "0",
                         "--output_dir", str(tmp_path / "a")])
    b = cli.run(_TINY + ["--device", "cpu", "--no_fold", "--output_dir",
                         str(tmp_path / "b")])
    # 120 x 120 LR images fit one auto tile: the same whole-image forward
    assert a["psnr"] == b["psnr"] and a["forwards"] == 6 and b["forwards"] == 2


def test_cli_without_device_raises_when_cuda_is_missing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_TINY + ["--output_dir", str(tmp_path)])


@pytest.mark.parametrize("flag", [["--param_dtype", "float32"],
                                  ["--use_pallas"],
                                  ["--remat"],
                                  ["--grad_accum", "2"],
                                  ["--unroll_body"]])
def test_cli_rejects_flags_the_port_lacks(flag):
    with pytest.raises(SystemExit):
        cli.main(_TINY + ["--device", "cpu"] + flag)


def test_cli_refuses_an_orbax_directory_with_the_conversion_hint():
    with pytest.raises(SystemExit, match="save_generator_torch"):
        cli.main(_TINY + ["--device", "cpu", "--model_path",
                          os.path.join(_REPO, "demo", "checkpoint")])


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _torch_spectral_norm(path):
    """Uses of torch's spectral norm (``torch.nn.utils.spectral_norm``,
    ``...parametrizations.spectral_norm``, or either imported by name)."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr == "spectral_norm"
                and ast.unparse(node.value).endswith(("utils",
                                                      "parametrizations"))):
            yield ast.unparse(node)
        elif isinstance(node, ast.ImportFrom) and any(
                a.name == "spectral_norm" for a in node.names):
            yield f"from {node.module} import spectral_norm"


def test_port_imports_nothing_of_jax_or_pesr_tpu():
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO, "pesr_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    scanned = {os.path.relpath(f, _REPO) for f in files}
    assert {"pesr_torch/train.py", "pesr_torch/losses.py",
            "pesr_torch/training/loop.py", "pesr_torch/training/steps.py",
            "pesr_torch/training/state.py",
            "pesr_torch/training/checkpoint.py",
            "pesr_torch/models/discriminator.py",
            "pesr_torch/models/vgg.py", "pesr_torch/convert.py",
            "pesr_torch/models/fold.py", "pesr_torch/data/natural.py",
            "pesr_torch/data/device_synth.py",
            "pesr_torch/data/native/__init__.py",
            "pesr_torch/utils/memory.py", "pesr_torch/serving.py",
            "pesr_torch/parallel/__init__.py",
            "pesr_torch/parallel/mesh.py"} <= scanned
    bad = [(os.path.relpath(f, _REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "pesr_tpu")]
    assert not bad, bad
    # the discriminator's spectral norm is the JAX package's stateless
    # one, not torch's (whose persistent u is another algorithm)
    sn = [(os.path.relpath(f, _REPO), u) for f in files
          for u in _torch_spectral_norm(f)]
    assert not sn, sn


def test_png_writer_round_trips_through_pillow(tmp_path):
    from PIL import Image
    img = np.random.default_rng(0).integers(0, 256, (17, 23, 3),
                                            dtype=np.uint8)
    imwrite_uint8(tmp_path / "a" / "x.png", img)
    with Image.open(tmp_path / "a" / "x.png") as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))


def test_demo_checkpoint_reproduces_the_jax_psnr(tmp_path):
    """demo/checkpoint (x4, 8 x 64) restored through pesr_tpu, written as a
    .pth and run through the port's kernel path with the CLI's default
    folded upsampler (bf16, plain versions on the CPU): demo/README.md
    measures 44.11 dB on synthetic."""
    from pesr_tpu.convert import save_generator_torch
    from pesr_tpu.training.checkpoint import restore_generator_params
    params, _ = restore_generator_params(os.path.join(_REPO, "demo",
                                                      "checkpoint"))
    pth = str(tmp_path / "demo.pth")
    save_generator_torch(params, 4, pth)
    res = cli.run(["--dataset", "synthetic", "--model_path", pth,
                   "--num_blocks", "8", "--num_channels", "64", "--device",
                   "cpu", "--output_dir", str(tmp_path)])
    assert abs(res["psnr"] - 44.11) <= 0.05, res
    assert abs(res["bicubic_psnr"] - 43.14) <= 0.005, res
