"""The port's process-group layer (``pesr_torch/parallel``) against the
JAX package's ``pesr_tpu/parallel``, in one process on the CPU: the mesh
bounds, the ``PESR_*`` bring-up contract case by case, this rank's block
of a batch, the per-process train streams (bitwise JAX's with
``jax.process_count`` / ``jax.process_index`` patched to 2 / r) and the
``synthetic_device`` samples of a global index.  The collectives run in
real gloo processes in tests/test_torch_ddp.py,
tests/test_torch_mesh_infer.py and tests/test_torch_serving.py."""

import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pesr_tpu import config as jax_config
from pesr_tpu.data import datasets as jax_datasets
from pesr_tpu.parallel import mesh as jax_mesh
from pesr_torch import parallel
from pesr_torch import test as test_cli
from pesr_torch.config import Opts, opts_from_args
from pesr_torch.data import datasets
from pesr_torch.data.device_synth import DeviceSyntheticStream
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.ops.tiling import BatchTiledUpscaler
from pesr_torch.parallel import Mesh

CPU = torch.device("cpu")
_ENV = ("PESR_COORDINATOR", "PESR_NUM_PROCESSES", "PESR_PROCESS_ID",
        "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def fake_mesh(rank, size=2):
    """A mesh's coordinates without a process group (no collective is
    called by the code under test)."""
    return Mesh(size, rank, CPU, "gloo")


def test_make_mesh_bounds_without_a_process_group():
    m = parallel.make_mesh(device="cpu")
    assert (m.size, m.rank, m.device, m.collective) == (1, 0, CPU, False)
    assert parallel.make_mesh(1, "cpu").size == 1
    with pytest.raises(ValueError, match="requested 2 devices, have 1") as e:
        parallel.make_mesh(2, "cpu")
    assert "torchrun" in str(e.value) and "PESR_COORDINATOR" in str(e.value)
    with pytest.raises(ValueError):
        parallel.make_mesh(0, "cpu")
    # JAX raises the same way when the request exceeds its devices
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        jax_mesh.make_mesh(9)


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _capture(monkeypatch):
    """Record what each side's bring-up is called with, instead of
    bringing a cluster up."""
    got = {"torch": None, "jax": None}

    def torch_init(backend, timeout=None, **kw):
        got["torch"] = dict(backend=backend, **kw)

    def jax_init(**kw):
        got["jax"] = kw

    monkeypatch.setattr(dist, "init_process_group", torch_init)
    monkeypatch.setattr(jax.distributed, "initialize", jax_init)
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    return got


def test_initialize_distributed_reads_the_pesr_contract_as_jax(clean_env):
    got = _capture(clean_env)
    clean_env.setenv("PESR_COORDINATOR", "10.0.0.1:1234")
    clean_env.setenv("PESR_NUM_PROCESSES", "4")
    clean_env.setenv("PESR_PROCESS_ID", "2")
    assert parallel.initialize_distributed(required=True, device="cpu")
    assert jax_mesh.initialize_distributed(required=True)
    assert got["jax"] == {"coordinator_address": "10.0.0.1:1234",
                          "num_processes": 4, "process_id": 2}
    assert got["torch"] == {"backend": "gloo",
                            "init_method": "tcp://10.0.0.1:1234",
                            "world_size": 4, "rank": 2}


def test_initialize_distributed_backend_is_a_parameter(clean_env):
    got = _capture(clean_env)
    clean_env.setenv("PESR_COORDINATOR", "127.0.0.1:1")
    clean_env.setenv("PESR_NUM_PROCESSES", "2")
    clean_env.setenv("PESR_PROCESS_ID", "0")
    assert parallel.initialize_distributed(device="cpu", backend="nccl")
    assert got["torch"]["backend"] == "nccl"
    assert parallel.default_backend("cuda") == "nccl"
    assert parallel.default_backend("cpu") == "gloo"


def test_initialize_distributed_takes_torchrun_for_auto_detection(clean_env):
    got = _capture(clean_env)
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        clean_env.setenv(k, v)
    assert parallel.initialize_distributed(device="cpu")
    assert got["torch"] == {"backend": "gloo", "init_method": "env://"}


def test_initialize_distributed_is_a_no_op_without_a_cluster(clean_env):
    got = _capture(clean_env)
    assert parallel.initialize_distributed(device="cpu") is False
    assert got["torch"] is None
    # --distributed with nothing configured fails loudly (JAX's
    # auto-detection raises there too)
    with pytest.raises(RuntimeError, match="no cluster configured"):
        parallel.initialize_distributed(required=True, device="cpu")


def test_initialize_distributed_returns_true_when_already_up(clean_env):
    got = _capture(clean_env)
    clean_env.setattr(dist, "is_initialized", lambda: True)
    clean_env.setattr(jax.distributed, "is_initialized", lambda: True)
    clean_env.setenv("PESR_COORDINATOR", "10.0.0.1:1234")  # not re-read
    assert parallel.initialize_distributed(required=True, device="cpu")
    assert jax_mesh.initialize_distributed(required=True)
    assert got == {"torch": None, "jax": None}


@pytest.mark.parametrize("missing", ["PESR_NUM_PROCESSES", "PESR_PROCESS_ID"])
def test_half_set_coordinator_raises_jax_message(clean_env, missing):
    _capture(clean_env)
    clean_env.setenv("PESR_COORDINATOR", "10.0.0.1:1234")
    clean_env.setenv("PESR_NUM_PROCESSES", "4")
    clean_env.setenv("PESR_PROCESS_ID", "2")
    clean_env.delenv(missing)
    errs = []
    for fn, kw in ((parallel.initialize_distributed, {"device": "cpu"}),
                   (jax_mesh.initialize_distributed, {})):
        with pytest.raises(ValueError) as e:
            fn(**kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert "PESR_NUM_PROCESSES and PESR_PROCESS_ID" in errs[0]


@pytest.mark.parametrize("required", [False, True])
def test_coordinator_set_reraises_a_failed_bring_up(clean_env, required):
    _capture(clean_env)

    def boom(*a, **k):
        raise RuntimeError("no cluster")

    clean_env.setattr(dist, "init_process_group", boom)
    clean_env.setattr(jax.distributed, "initialize", boom)
    clean_env.setenv("PESR_COORDINATOR", "10.0.0.1:1234")
    clean_env.setenv("PESR_NUM_PROCESSES", "4")
    clean_env.setenv("PESR_PROCESS_ID", "2")
    with pytest.raises(RuntimeError, match="no cluster"):
        parallel.initialize_distributed(required=required, device="cpu")
    with pytest.raises(RuntimeError, match="no cluster"):
        jax_mesh.initialize_distributed(required=required)


def test_shard_batch_blocks_and_errors():
    x = np.arange(24).reshape(6, 4)
    t = torch.arange(12).reshape(6, 2)
    for r in range(3):
        got = parallel.shard_batch(fake_mesh(r, 3), {"x": x, "t": (t,)})
        np.testing.assert_array_equal(got["x"], x[2 * r:2 * r + 2])
        assert torch.equal(got["t"][0], t[2 * r:2 * r + 2])
    assert parallel.batch_sharding(fake_mesh(1, 2), 8) == slice(4, 8)
    assert parallel.batch_sharding(None, 5) == slice(0, 5)
    with pytest.raises(ValueError, match="batch dim 5 not divisible by mesh "
                                         "size 2"):
        parallel.shard_batch(fake_mesh(0), np.zeros((5, 1)))


def test_single_process_helpers_run_no_collective():
    t = torch.arange(6.0)
    m = parallel.make_mesh(device="cpu")
    assert parallel.sum_all(m, t) is t
    assert parallel.batch_mean(None, t) == t.mean()
    assert parallel.all_gather_batch(m, t) is t
    assert parallel.all_agree(m, False) is False
    g = [t.clone()]
    parallel.all_reduce_mean_(m, g)
    assert torch.equal(g[0], t)
    net = torch.nn.Linear(2, 2)
    w = net.weight.detach().clone()
    assert parallel.shard_pytree_replicated(m, net) is net
    assert torch.equal(net.weight, w)
    assert parallel.is_primary(m) and parallel.is_primary()


def _opts(**kw):
    base = dict(train_dataset="synthetic", patch_size=8, scale=4,
                batch_size=4, seed=3)
    base.update(kw)
    return Opts(**base), jax_config.Opts(**base)


@pytest.mark.parametrize("start_step", [0, 5])
def test_per_process_batches_equal_jax(monkeypatch, start_step):
    """Each rank's stream (its local batch, its seed) is bitwise JAX's
    process r of 2 (HR-crop mode: the native sampler on both sides)."""
    ours_o, theirs_o = _opts()
    for r in range(2):
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        ours, _ = datasets.make_train_iterator(ours_o, start_step,
                                               mesh=fake_mesh(r))
        theirs, _ = jax_datasets.make_train_iterator(theirs_o, start_step)
        try:
            for _ in range(2):
                a, b = next(ours), next(theirs)
                assert a[1].shape == (2, 32, 32, 3)
                np.testing.assert_array_equal(a[1], b[1])
        finally:
            ours.close()
            theirs.close()


def test_per_process_batch_must_divide(monkeypatch):
    ours_o, theirs_o = _opts(batch_size=3)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    with pytest.raises(ValueError, match="divisible by the process count 2"):
        datasets.make_train_iterator(ours_o, mesh=fake_mesh(0))
    with pytest.raises(ValueError, match="divisible by the process count 2"):
        jax_datasets.make_train_iterator(theirs_o)


@pytest.mark.parametrize("start_step", [0, 3])
def test_synthetic_device_sample_is_fixed_by_its_global_index(start_step):
    opts = Opts(train_dataset="synthetic_device", patch_size=6, scale=2,
                batch_size=4, seed=1)
    whole = DeviceSyntheticStream(opts, "cpu", start_step)
    ranks = [DeviceSyntheticStream(opts, "cpu", start_step, fake_mesh(r))
             for r in range(2)]
    for _ in range(2):
        full = next(whole)[1]
        parts = [next(s)[1] for s in ranks]
        assert parts[0].shape == (2, 12, 12, 3)
        assert torch.equal(torch.cat(parts), full)


def test_engine_mesh_axis_validation_and_a_one_process_mesh():
    ap = KernelApply(Generator(2, 1, 8, device="cpu", seed=0))
    with pytest.raises(ValueError, match="requires a mesh"):
        BatchTiledUpscaler(ap, 2, 8, 2, device="cpu", mesh_axis="tiles")
    with pytest.raises(ValueError, match="'batch' or 'tiles'"):
        BatchTiledUpscaler(ap, 2, 8, 2, device="cpu", mesh_axis="rows")
    imgs = np.random.default_rng(0).integers(0, 256, (3, 13, 11, 3),
                                             dtype=np.uint8)
    ref = BatchTiledUpscaler(ap, 2, 8, 2, device="cpu").upscale_batch(imgs)
    one = parallel.make_mesh(device="cpu")
    for axis in ("batch", "tiles"):
        eng = BatchTiledUpscaler(ap, 2, 8, 2, mesh=one, mesh_axis=axis)
        np.testing.assert_array_equal(eng.upscale_batch(imgs), ref)


def test_auto_tile_chooser_counts_a_ranks_share_as_jax():
    """"auto" under a spatial mesh budgets ceil(T / P) tiles per rank and
    under batch DP sees ceil(B / P) images, as JAX's chooser does."""
    import jax.numpy as jnp
    from pesr_tpu.models import Generator as JaxGenerator
    from pesr_tpu.ops.tiling import BatchTiledUpscaler as JaxEngine
    gen = JaxGenerator(scale=2, num_blocks=1, num_channels=8,
                       dtype=jnp.float32)
    ap = KernelApply(Generator(2, 1, 8, device="cpu", seed=0))
    for axis, n in (("tiles", 2), ("tiles", 4), ("batch", 2)):
        ours = BatchTiledUpscaler(ap, 2, "auto", 8, mesh=fake_mesh(0, n),
                                  mesh_axis=axis)
        ours._AUTO_PIXEL_BUDGET = 1_500_000  # JAX's budget
        theirs = JaxEngine(gen.apply, {}, 2, "auto", 8,
                           mesh=jax_mesh.make_mesh(n), mesh_axis=axis)
        for b, h, w in ((8, 2000, 1400), (1, 339, 510), (3, 900, 700)):
            _, (nh, nw, th, tw) = theirs._build(b, h, w)
            assert ours.grid(b, h, w) == (nh, nw, th, tw), (axis, n, b, h)


def test_cli_flags_of_the_multi_device_paths():
    o = opts_from_args(["--mesh_shape", "2", "--mesh_axis", "tiles",
                        "--export_artifact", "a.pesr", "--distributed"])
    assert (o.mesh_shape, o.mesh_axis, o.export_artifact, o.distributed) == (
        "2", "tiles", "a.pesr", True)
    o = opts_from_args(["--mesh_shape", "2", "--distributed"], mode="train")
    assert (o.mesh_shape, o.distributed) == ("2", True)
    with pytest.raises(SystemExit):
        opts_from_args(["--mesh_axis", "rows"])
    with pytest.raises(SystemExit):
        opts_from_args(["--mesh_axis", "tiles"], mode="train")


def test_cli_mesh_without_a_process_group_names_the_launch(tmp_path):
    with pytest.raises(ValueError, match="torchrun"):
        test_cli.main(["--dataset", "synthetic", "--device", "cpu",
                       "--num_blocks", "1", "--num_channels", "8",
                       "--mesh_shape", "2", "--output_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "synthetic")
