"""Serving artifacts of the port (``pesr_torch/serving.py``), case by case
against the JAX package's ``tests/test_serving.py``: export the tiled
engine with ``torch.export``, reload it without model code, and hold it
bitwise to the live engine.  On the CPU the kernel ops run their plain
versions, inside the artifact as in the engine.  JAX's Pallas-interpreter
refusal and its ``gpu``/``cuda`` platform alias have no counterpart (the
port has no interpreter mode; its platform names are torch's device
types).  The 2-rank cases run this file as a script under the ``PESR_*``
contract (tests/test_torch_ddp.py's :func:`run_group`)."""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from pesr_torch import test as test_cli  # noqa: E402
from pesr_torch.models.generator import Generator  # noqa: E402
from pesr_torch.models.kernel_apply import (Float32Apply,  # noqa: E402
                                            KernelApply)
from pesr_torch.ops.tiling import BatchTiledUpscaler  # noqa: E402
from pesr_torch.parallel import Mesh  # noqa: E402
from pesr_torch.serving import (export_upscaler, load_upscaler,  # noqa: E402
                                read_meta)
from tests.test_torch_ddp import (run_group, run_workers,  # noqa: E402
                                  worker_mesh)

CPU = torch.device("cpu")


def _engine(kind="chain", scale=2, c=8, blocks=2, tile=16, ov=4, **kw):
    gen = Generator(scale, blocks, c, device="cpu", seed=0)
    ap = (Float32Apply(gen) if kind == "float32"
          else KernelApply(gen, fold=kind == "folded"))
    return BatchTiledUpscaler(ap, scale, tile, ov, device="cpu", **kw)


def _imgs(b=2, h=21, w=17, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["chain", "folded", "float32"])
def test_export_load_roundtrip_bitwise(tmp_path, kind):
    engine = _engine(kind)
    imgs = _imgs()
    path = os.path.join(tmp_path, "up.pesr")
    meta = export_upscaler(engine, *imgs.shape[:3], path,
                           precision_path="f32")
    assert meta["scale"] == 2 and meta["output_crop"] == [42, 34]

    served = load_upscaler(path, device="cpu")
    got = served(imgs)
    ref = engine.upscale_batch(imgs)
    assert got.dtype == np.uint8 and got.shape == (2, 42, 34, 3)
    np.testing.assert_array_equal(got, ref)

    # Metadata reads without touching the program.
    m = read_meta(path)
    assert m["precision_path"] == "f32"
    assert m["platforms"] == ["cpu"]
    assert m["torch_version"] == torch.__version__


def test_serving_rejects_wrong_shape_and_dtype(tmp_path):
    engine = _engine()
    path = os.path.join(tmp_path, "up.pesr")
    export_upscaler(engine, 2, 21, 17, path)
    served = load_upscaler(path, device="cpu")
    with pytest.raises(ValueError, match="static"):
        served(_imgs(b=1))
    with pytest.raises(ValueError, match="static"):
        served(_imgs().astype(np.float32))


def test_export_dynamic_batch(tmp_path):
    """batch="any": ONE artifact serves every batch size, bitwise-equal
    to the live engine; H/W stay pinned."""
    engine = _engine()
    path = os.path.join(tmp_path, "dyn.pesr")
    meta = export_upscaler(engine, "any", 21, 17, path, trace_batch=3)
    assert meta["input_shape"][0] == "any" and meta["trace_batch"] == 3
    served = load_upscaler(path, device="cpu")
    for b in (1, 2, 5):
        imgs = _imgs(b=b, seed=b)
        np.testing.assert_array_equal(served(imgs),
                                      engine.upscale_batch(imgs))
    with pytest.raises(ValueError, match="static"):
        served(_imgs(b=2, h=20, w=17))  # wrong height still rejected


def test_export_cross_device_metadata(tmp_path):
    """``platforms`` records the exporting device; an artifact loaded on
    another device type is moved there (here: the record rewritten to
    ``cuda`` makes the CPU load move the program), still exact.  Loading
    runs on the card unless the caller asks for the CPU."""
    engine = _engine()
    imgs = _imgs(b=1)
    path = os.path.join(tmp_path, "xdev.pesr")
    meta = export_upscaler(engine, *imgs.shape[:3], path)
    assert meta["platforms"] == ["cpu"]
    with zipfile.ZipFile(path) as zf:
        files = {n: zf.read(n) for n in zf.namelist()}
    meta["platforms"] = ["cuda"]
    files["meta.json"] = json.dumps(meta).encode()
    with zipfile.ZipFile(path, "w") as zf:
        for n, blob in files.items():
            zf.writestr(n, blob)
    served = load_upscaler(path, device="cpu")
    assert served.device == CPU
    np.testing.assert_array_equal(served(imgs), engine.upscale_batch(imgs))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_upscaler(path)


def test_export_rejects_mesh_engine(tmp_path):
    engine = _engine(mesh=Mesh(2, 0, CPU, "gloo"), mesh_axis="batch")
    with pytest.raises(ValueError, match="single-device"):
        export_upscaler(engine, 2, 21, 17, os.path.join(tmp_path, "x.pesr"))


def test_spatial_export_is_fixed_batch(tmp_path):
    engine = _engine(tile=10, mesh=Mesh(2, 0, CPU, "gloo"),
                     mesh_axis="tiles")
    with pytest.raises(ValueError, match="fixed-batch"):
        export_upscaler(engine, "any", 30, 26,
                        os.path.join(tmp_path, "no.pesr"))


def worker_spatial(workdir):
    mesh = worker_mesh()
    engine = BatchTiledUpscaler(
        KernelApply(Generator(2, 2, 8, device="cpu", seed=0)), 2, 10, 4,
        mesh=mesh, mesh_axis="tiles")
    imgs = _imgs(b=1, h=30, w=26)
    path = os.path.join(workdir, "sp.pesr")
    meta = export_upscaler(engine, 1, 30, 26, path)
    served = load_upscaler(path, device="cpu")
    got = served(imgs)
    torch.save({"meta": meta, "got": got,
                "ref": engine.upscale_batch(imgs),
                "dev": served.upscale_device(torch.from_numpy(imgs)),
                "positions": engine.grid(1, 30, 26)},
               os.path.join(workdir, f"sp_{mesh.rank}.pt"))


def test_export_spatial_parallel_roundtrip_and_too_few_ranks(tmp_path):
    """mesh_axis='tiles' exports the per-rank program: both ranks load
    it, each runs its share of the tile positions and the all-gather
    outside the program assembles the live spatial engine's canvas,
    bitwise.  One process cannot load it."""
    run_workers(__file__, "spatial", tmp_path)
    for r in range(2):
        res = torch.load(os.path.join(tmp_path, f"sp_{r}.pt"),
                         weights_only=False)
        assert res["meta"]["mesh_devices"] == 2
        nh, nw = res["positions"][:2]
        assert nh * nw % 2 == 1          # the last rank's share is padded
        np.testing.assert_array_equal(res["got"], res["ref"])
        np.testing.assert_array_equal(res["dev"].numpy(), res["got"])
    path = os.path.join(tmp_path, "sp.pesr")
    assert read_meta(path)["mesh_devices"] == 2
    with pytest.raises(ValueError, match="needs 2 devices"):
        load_upscaler(path, device="cpu")


_CLI = ["--dataset", "synthetic", "--scale", "2", "--num_blocks", "2",
        "--num_channels", "8", "--infer_batch", "2", "--device", "cpu"]


@pytest.mark.parametrize("flags, label", [
    (["--compute_dtype", "float32", "--no_fold"], "float32"),
    ([], "folded-bfloat16"),
    (["--quant", "int8"], "int8-w8a8")])
def test_cli_export_artifact_flag(tmp_path, capsys, flags, label):
    """``--export_artifact`` end to end: flags -> checkpointless tiny
    model -> an artifact that serves the advertised shape, labelled with
    the precision JAX's test.py prints for the same flags."""
    path = os.path.join(tmp_path, "cli.pesr")
    assert test_cli.main(_CLI + flags + ["--export_artifact", path]) == 0
    out = capsys.readouterr().out
    assert f"exported serving artifact to {path}" in out and label in out
    assert read_meta(path)["precision_path"] == label
    served = load_upscaler(path, device="cpu")
    b, h, w, _ = served.input_shape
    assert b == 2
    out = served(_imgs(b, h, w))
    assert out.shape == (b, 2 * h, 2 * w, 3) and out.dtype == np.uint8


def test_cli_export_spatial_mesh(tmp_path):
    """``--mesh_axis tiles --export_artifact`` on 2 ranks ships a 2-rank
    artifact, written once."""
    path = os.path.join(tmp_path, "sp.pesr")
    outs = run_group(lambda r: [sys.executable, "-m", "pesr_torch.test",
                                *_CLI, "--infer_batch", "1", "--distributed",
                                "--mesh_shape", "2", "--mesh_axis", "tiles",
                                "--tile_size", "48",
                                "--export_artifact", path])
    assert all("exported serving artifact" in o for o in outs)
    meta = read_meta(path)
    assert meta["mesh_devices"] == 2 and meta["input_shape"][0] == 1


def test_cli_export_spatial_mesh_of_one(tmp_path):
    """``--mesh_shape 1 --mesh_axis tiles --export_artifact`` in one
    process: the per-rank program of a one-rank mesh (``mesh_devices``
    1, as JAX records it) loads and serves bitwise the artifact of the
    same flags without a mesh."""
    flags = _CLI + ["--infer_batch", "1", "--tile_size", "48"]
    paths = {k: os.path.join(tmp_path, f"{k}.pesr") for k in ("one", "plain")}
    assert test_cli.main(flags + ["--mesh_shape", "1", "--mesh_axis",
                                  "tiles", "--export_artifact",
                                  paths["one"]]) == 0
    assert test_cli.main(flags + ["--export_artifact", paths["plain"]]) == 0
    meta = read_meta(paths["one"])
    assert meta["mesh_devices"] == 1 and read_meta(
        paths["plain"])["mesh_devices"] == 0
    assert meta["grid"]["nh"] * meta["grid"]["nw"] > 1
    served = {k: load_upscaler(p, device="cpu") for k, p in paths.items()}
    assert served["one"].mesh is not None and served["one"].mesh.size == 1
    imgs = _imgs(*meta["input_shape"][:3])
    np.testing.assert_array_equal(served["one"](imgs), served["plain"](imgs))


def test_cli_export_rejects_whole_image_mode():
    with pytest.raises(SystemExit, match="tiled mode"):
        test_cli.main(["--dataset", "synthetic", "--tile_size", "0",
                       "--export_artifact", "/tmp/never.pesr"])


def test_cli_export_rejects_mesh_flag():
    with pytest.raises(SystemExit, match="mesh_shape"):
        test_cli.main(["--dataset", "synthetic", "--mesh_shape", "2",
                       "--export_artifact", "/tmp/never.pesr"])


def test_cli_export_rejects_self_ensemble():
    with pytest.raises(SystemExit, match="self_ensemble"):
        test_cli.main(["--dataset", "synthetic", "--self_ensemble",
                       "--export_artifact", "/tmp/never.pesr"])


def test_export_int8_path(tmp_path):
    """The int8 W8A8 apply exports and reloads exactly like the float
    path (scales baked in as constants)."""
    from pesr_torch.models.quant_apply import (default_calib_tiles,
                                               int8_inference)
    gen = Generator(2, 2, 8, device="cpu", seed=0)
    imgs = _imgs(b=1, h=24, w=20, seed=3)
    engine = BatchTiledUpscaler(
        int8_inference(gen, default_calib_tiles([imgs[0]])), 2, 16, 4,
        device="cpu")
    path = os.path.join(tmp_path, "up_int8.pesr")
    export_upscaler(engine, *imgs.shape[:3], path,
                    precision_path="int8-w8a8")
    served = load_upscaler(path, device="cpu")
    np.testing.assert_array_equal(served(imgs), engine.upscale_batch(imgs))
    assert read_meta(path)["precision_path"] == "int8-w8a8"


def test_load_refuses_artifact_of_older_format(tmp_path):
    """An int8 artifact of format version 1 holds its block weights in
    natural output-channel order, which today's packing does not read:
    loading one raises instead of serving permuted channels."""
    from pesr_torch.models.quant_apply import (default_calib_tiles,
                                               int8_inference)
    gen = Generator(2, 2, 8, device="cpu", seed=0)
    imgs = _imgs(b=1, h=24, w=20, seed=3)
    engine = BatchTiledUpscaler(
        int8_inference(gen, default_calib_tiles([imgs[0]])), 2, 16, 4,
        device="cpu")
    path = os.path.join(tmp_path, "up_int8.pesr")
    export_upscaler(engine, *imgs.shape[:3], path,
                    precision_path="int8-w8a8")
    assert read_meta(path)["format_version"] == 2
    old = os.path.join(tmp_path, "up_int8_v1.pesr")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(old, "w") as dst:
        for info in src.infolist():
            data = src.read(info.filename)
            if info.filename == "meta.json":
                meta = json.loads(data)
                meta["format_version"] = 1
                data = json.dumps(meta).encode()
            dst.writestr(info, data)
    with pytest.raises(ValueError, match="format_version 1"):
        load_upscaler(old, device="cpu")


@pytest.mark.parametrize("case", ["chain x2", "folded x4, overlap 0"])
def test_meta_grid_equals_jax(tmp_path, case):
    """``meta["grid"]`` (the halos the program actually uses per axis,
    the min_halo floor applied) is JAX's ``export_upscaler`` meta for the
    same engine geometry."""
    import jax
    import jax.numpy as jnp
    from pesr_tpu.models import Generator as JaxGenerator
    from pesr_tpu.models.fold import folded_inference
    from pesr_tpu.ops.tiling import BatchTiledUpscaler as JaxEngine
    from pesr_tpu.serving import export_upscaler as jax_export
    folded = case.startswith("folded")
    scale, ov, (h, w) = (4, 0, (12, 40)) if folded else (2, 4, (21, 17))
    jgen = JaxGenerator(scale=scale, num_blocks=1, num_channels=8,
                        dtype=jnp.float32)
    variables = jgen.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    apply_fn = jgen.apply
    if folded:
        apply_fn, variables = folded_inference(variables["params"], scale,
                                               dtype=jnp.float32)
    theirs = jax_export(JaxEngine(apply_fn, variables, scale, tile_size=16,
                                  overlap=ov), 1, h, w,
                        os.path.join(tmp_path, "jax.pesr"))
    ours = export_upscaler(_engine("folded" if folded else "chain", scale,
                                   blocks=1, ov=ov), 1, h, w,
                           os.path.join(tmp_path, "torch.pesr"))
    assert ours["grid"] == theirs["grid"]
    for k in ("input_shape", "canvas_shape", "output_crop", "scale",
              "mesh_devices", "trace_batch", "input_dtype"):
        assert ours[k] == theirs[k], k
    if folded:
        g = ours["grid"]
        assert g["min_halo"] == 3 and g["overlap"] == 0
        assert (g["nw"] > 1 and g["ov_w"] >= 3) or g["nw"] == 1


def test_loaded_artifact_needs_no_model_code(tmp_path):
    """A fresh process that imports only ``pesr_torch.serving`` serves the
    artifact: no generator module, checkpoint or flags."""
    engine = _engine("folded")
    imgs = _imgs(b=1)
    path = os.path.join(tmp_path, "up.pesr")
    export_upscaler(engine, *imgs.shape[:3], path)
    np.save(os.path.join(tmp_path, "imgs.npy"), imgs)
    code = ("import sys, numpy as np, pesr_torch.serving as s\n"
            f"up = s.load_upscaler({path!r}, device='cpu')\n"
            f"out = up(np.load({os.path.join(tmp_path, 'imgs.npy')!r}))\n"
            f"np.save({os.path.join(tmp_path, 'out.npy')!r}, out)\n"
            "mods = [m for m in sys.modules if m.startswith('pesr_torch.')]\n"
            "assert 'pesr_torch.models.generator' not in mods, mods\n"
            "assert 'pesr_torch.training.checkpoint' not in mods, mods\n"
            "assert 'pesr_torch.config' not in mods, mods\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=_REPO)
    np.testing.assert_array_equal(np.load(os.path.join(tmp_path, "out.npy")),
                                  engine.upscale_batch(imgs))


if __name__ == "__main__":
    {"spatial": worker_spatial}[sys.argv[1]](sys.argv[2])
