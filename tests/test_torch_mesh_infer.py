"""Multi-device inference of the port on 2 gloo processes on the CPU:
``BatchTiledUpscaler(mesh=..., mesh_axis="tiles"|"batch")`` must give
every rank the canvas of the single-process engine at the same geometry,
bitwise (JAX's ``tests/distributed_worker.py::run_spatial_inference``
checks the same invariant): the kernel chain and the folded apply, a
batch that 2 does not divide, tile grids of 6 and of 3 positions (3: the
last rank's share is padded), the float canvas of the self-ensemble, and
``upscale_many`` over mixed sizes.  Then the test CLI's ``--mesh_shape 2
--mesh_axis tiles`` (and ``batch``) end to end: the PNGs of the
single-process run.  The workers are this file run as a script under the
``PESR_*`` contract (tests/test_torch_ddp.py's :func:`run_group`)."""

import os
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from pesr_torch.models.generator import Generator  # noqa: E402
from pesr_torch.models.kernel_apply import KernelApply  # noqa: E402
from pesr_torch.ops.tiling import BatchTiledUpscaler  # noqa: E402
from tests.test_torch_ddp import (run_group, run_workers,  # noqa: E402
                                  worker_mesh)

GEOMETRIES = {"6 positions": (6, 2), "3 positions": ((5, 12), 2)}
APPLIES = ("chain", "folded")


def _imgs(b, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                dtype=np.uint8)


def _apply(kind):
    return KernelApply(Generator(2, 2, 8, device="cpu", seed=0),
                       fold=kind == "folded")


def worker_infer(workdir):
    mesh = worker_mesh()
    out, ref = {}, {}
    imgs = _imgs(3, 13, 11, 0)
    mixed = [_imgs(1, 13, 11, 1)[0], _imgs(1, 9, 14, 2)[0],
             _imgs(1, 13, 11, 3)[0]]
    for kind in APPLIES:
        ap = _apply(kind)
        for geo, (tile, ov) in GEOMETRIES.items():
            single = BatchTiledUpscaler(ap, 2, tile, ov, device="cpu")
            for axis in ("tiles", "batch"):
                eng = BatchTiledUpscaler(ap, 2, tile, ov, mesh=mesh,
                                         mesh_axis=axis)
                key = f"{kind}/{geo}/{axis}"
                out[key] = eng.upscale_batch_device(imgs)
                out[key + "/float"] = eng.upscale_batch_device(
                    imgs, float_out=True)
                out[key + "/se"] = eng.upscale_batch_se_device(imgs[:1])
                out[key + "/many"] = eng.upscale_many(mixed, 2)
                ref[key] = single.upscale_batch_device(imgs)
                ref[key + "/float"] = single.upscale_batch_device(
                    imgs, float_out=True)
                ref[key + "/se"] = single.upscale_batch_se_device(imgs[:1])
                ref[key + "/many"] = single.upscale_many(mixed, 2)
                out[key + "/grid"] = eng.grid(3, 13, 11)
                ref[key + "/grid"] = single.grid(3, 13, 11)
    torch.save({"out": out, "ref": ref},
               os.path.join(workdir, f"infer_{mesh.rank}.pt"))


@pytest.fixture(scope="module")
def infer_results(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh_infer")
    run_workers(__file__, "infer", wd)
    return [torch.load(os.path.join(wd, f"infer_{r}.pt"), weights_only=False)
            for r in range(2)]


def _equal(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("axis", ["tiles", "batch"])
@pytest.mark.parametrize("geo", list(GEOMETRIES))
@pytest.mark.parametrize("kind", APPLIES)
def test_mesh_canvas_is_bitwise_the_single_process_engine(infer_results,
                                                          kind, geo, axis):
    key = f"{kind}/{geo}/{axis}"
    for r, res in enumerate(infer_results):
        for part in ("", "/float", "/se", "/many", "/grid"):
            assert _equal(res["out"][key + part], res["ref"][key + part]), \
                (r, key + part)
    assert infer_results[0]["out"][key].shape[0] == 3


_TEST = ["-m", "pesr_torch.test", "--device", "cpu", "--dataset",
         "synthetic", "--scale", "2", "--num_blocks", "2", "--num_channels",
         "8", "--tile_size", "48", "--infer_batch", "3"]


def test_cli_mesh_axes_write_the_single_process_pngs(tmp_path):
    single = str(tmp_path / "single")
    run_group(lambda r: [sys.executable, *_TEST, "--output_dir", single],
              nproc=1)
    names = sorted(os.listdir(os.path.join(single, "synthetic")))
    assert len(names) == 5
    for axis in ("tiles", "batch"):
        d = str(tmp_path / axis)
        outs = run_group(lambda r: [sys.executable, *_TEST, "--distributed",
                                    "--mesh_shape", "2", "--mesh_axis",
                                    axis, "--output_dir", d])
        for r, out in enumerate(outs):
            assert f"inference mesh: 2 process(es), {axis}-sharded; " \
                   f"rank {r} on cpu" in out
            assert "mean PSNR" in out
        assert sorted(os.listdir(os.path.join(d, "synthetic"))) == names
        for n in names:
            with open(os.path.join(single, "synthetic", n), "rb") as a, \
                    open(os.path.join(d, "synthetic", n), "rb") as b:
                assert a.read() == b.read(), (axis, n)


if __name__ == "__main__":
    {"infer": worker_infer}[sys.argv[1]](sys.argv[2])
