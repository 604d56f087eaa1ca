"""Data-parallel training of the port on 2 gloo processes on the CPU.

The ranks step on their blocks of the same global batches and must
compute what one process computes on the whole batch (JAX's semantics:
one jit over a batch-sharded global batch), within f32 rounding: losses
|d| <= 1e-5 x max(1, |loss|) (the penalty makes D's loss O(10), and its
double backward sums in another order on two ranks: 1.4e-5 at 12.2
measured); parameters |d| <= 1e-5 x the tensor's largest |value|,
except elements whose one-process gradient is noise: within 1e-6 of 0,
or for D with the penalty within 2e-5 (the penalty's gradient atol of
tests/test_torch_gan_models.py).  Gradients that are 0 by symmetry,
such as a conv bias that a norm follows, leave rounding noise of either
sign, which Adam may move by up to 2 lr per step.  Cases: two pretrain
steps; two RaSGAN steps with the gradient penalty and VGG; the same with
``grad_accum 2`` and ``eps`` drawn by the step; two QAT steps.  Three
planted faults (the discriminator's batch statistics, the relativistic
means, or the fake-quant scales taken over the local block) must break
those limits.
The train CLI runs on 2 ranks: one checkpoint, one log, a resume.
tests/test_torch_ddp_jax.py holds the 2-rank GAN step against JAX's on a
2-device mesh.

The workers are this file run as a script (``python
tests/test_torch_ddp.py <mode> <workdir>``) under the ``PESR_*``
contract; every group has a 120 s limit, and its bring-up one of 60 s.
:func:`run_group` is shared with the other multi-process test files.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from pesr_torch import parallel  # noqa: E402
from pesr_torch.config import Opts  # noqa: E402
from pesr_torch.models.discriminator import (Discriminator,  # noqa: E402
                                             set_batch_stats_mesh)
from pesr_torch.training import steps  # noqa: E402
from pesr_torch.training.state import (add_discriminator,  # noqa: E402
                                       create_generator_state, init_vgg)

CPU = torch.device("cpu")
GROUP_TIMEOUT_S = 120
LOSS_RTOL, PARAM_RTOL, NOISE_ATOL, GP_NOISE_ATOL = 1e-5, 1e-5, 1e-6, 2e-5
D_KW = dict(channel_schedule=(4, 8, 8, 8), dense_features=16)
_CLUSTER_ENV = ("PESR_COORDINATOR", "PESR_NUM_PROCESSES", "PESR_PROCESS_ID",
                "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK")


# ---------------------------------------------------------------- groups

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(argv_of_rank, nproc=2, timeout=GROUP_TIMEOUT_S):
    """Start ``nproc`` processes (``argv_of_rank(r)``) under the
    ``PESR_*`` contract on a free localhost port, 2 CPU threads each;
    wait at most ``timeout`` s for all of them (then kill them and fail);
    every one must exit 0.  Returns their outputs."""
    port = _free_port()
    procs = []
    for r in range(nproc):
        env = {k: v for k, v in os.environ.items() if k not in _CLUSTER_ENV}
        env.update(PYTHONPATH=_REPO + os.pathsep + env.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="2", PESR_COORDINATOR=f"127.0.0.1:{port}",
                   PESR_NUM_PROCESSES=str(nproc), PESR_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            argv_of_rank(r), env=env, cwd=_REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"process group did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" + \
            out[-4000:]
    return outs


def run_workers(script, mode, workdir, nproc=2, extra=()):
    """``python <script> <mode> <workdir> *extra`` on ``nproc`` ranks."""
    return run_group(lambda r: [sys.executable, script, mode, str(workdir),
                                *extra], nproc)


def worker_mesh():
    """In a worker: bring the gloo group up from the environment and
    return its mesh."""
    torch.set_num_threads(2)
    parallel.initialize_distributed(required=True, device="cpu",
                                    timeout_s=60)
    return parallel.make_mesh(device="cpu")


# ------------------------------------------------------------ the steps

ARCH = dict(scale=2, num_blocks=2, num_channels=8)
GLOBAL_BATCH, PATCH, LR0 = 8, 8, 1e-4
CASES = {
    "pretrain": dict(phase="pretrain"),
    "gan": dict(phase="train", gan_type="RaSGAN", use_gp=True,
                alpha_vgg=1.0),
    "gan_accum2": dict(phase="train", gan_type="RaSGAN", use_gp=True,
                       grad_accum=2, alpha_vgg=0.0),
    # the fake-quant scales are the global batch's amax
    "qat": dict(phase="qat"),
}
# planted fault -> the case it is planted in
FAULTS = {"local batch statistics in D": "gan",
          "local relativistic means": "gan",
          "local fake-quant scales": "qat"}


def _opts(case):
    return Opts(**ARCH, batch_size=GLOBAL_BATCH, patch_size=PATCH,
                learning_rate=LR0, lr_step=1, steps_per_epoch=1,
                compute_dtype="float32", device="cpu", fold_train=False,
                seed=0, **CASES[case])


def _global_batch(k):
    rng = np.random.default_rng(100 + k)
    hr = PATCH * ARCH["scale"]
    return (torch.from_numpy(rng.uniform(-1, 1, (GLOBAL_BATCH, PATCH, PATCH,
                                                 3)).astype(np.float32)),
            torch.from_numpy(rng.uniform(-1, 1, (GLOBAL_BATCH, hr, hr, 3))
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 1, (GLOBAL_BATCH, 1, 1, 1))
                             .astype(np.float32)))


def _state(case, mesh):
    opts = _opts(case)
    state = create_generator_state(opts, CPU, mesh=mesh)
    if opts.phase == "train":
        d = Discriminator(opts.hr_patch_size, dtype=torch.float32,
                          device="cpu", seed=1, **D_KW)
        add_discriminator(state, opts, CPU, d)
        if opts.alpha_vgg > 0:
            state.vgg = init_vgg(opts, CPU)
        return opts, state, steps.make_gan_step(opts)
    return opts, state, steps.make_pretrain_step(opts)


def _nets(state):
    return {"g": state.generator, "d": state.discriminator}


def _run_case(case, mesh, fault=None):
    """Two steps of ``case`` on this rank's blocks (``mesh`` None: one
    process, the whole batch).  Returns the metrics per step, the final
    parameters, and (one process) where each gradient was noise."""
    opts, state, step = _state(case, mesh)
    block = parallel.batch_sharding(mesh, GLOBAL_BATCH)
    restore = None
    if fault == "local batch statistics in D":
        set_batch_stats_mesh(state.discriminator, None)
    elif fault is not None:
        name, local = (("batch_mean", lambda m, t: t.mean())
                       if fault == "local relativistic means"
                       else ("max_all_", lambda m, t: t))
        restore = (name, getattr(parallel, name))
        setattr(parallel, name, local)
    metrics, noise = [], {}
    try:
        for k in range(2):
            lr, hr, eps = _global_batch(k)
            args = (state, lr[block], hr[block])
            if opts.phase == "train" and opts.grad_accum == 1:
                args += (eps[block],)   # else the step draws eps itself
            m = step(*args)
            metrics.append({n: float(v) for n, v in m.items()})
            for tag, net in _nets(state).items():
                atol = (GP_NOISE_ATOL if tag == "d" and opts.use_gp
                        else NOISE_ATOL)
                for n, p in (net.named_parameters() if net is not None
                             else ()):
                    z = (p.grad is None) or (p.grad.abs() <= atol)
                    key = f"{tag}.{n}"
                    noise[key] = noise.get(key, False) | z
    finally:
        if restore is not None:
            setattr(parallel, *restore)
    params = {f"{tag}.{n}": p.detach().clone()
              for tag, net in _nets(state).items() if net is not None
              for n, p in net.named_parameters()}
    return {"metrics": metrics, "params": params, "noise": noise}


def worker_steps(workdir):
    mesh = worker_mesh()
    out = {}
    for case in CASES:
        out[case] = _run_case(case, mesh)
    for fault, case in FAULTS.items():
        out[fault] = _run_case(case, mesh, fault)
    if mesh.rank == 0:
        for case in CASES:
            out[f"ref:{case}"] = _run_case(case, None)
        torch.save(out, os.path.join(workdir, "steps.pt"))


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    wd = tmp_path_factory.mktemp("ddp_steps")
    run_workers(__file__, "steps", wd)
    return torch.load(os.path.join(wd, "steps.pt"), weights_only=False)


def _agreement(got, ref):
    """(worst loss |d| / tolerance, worst parameter |d| / tolerance) of a
    2-rank run against the one-process run (tolerances as the module
    says)."""
    loss = max(abs(a[k] - b[k]) / (LOSS_RTOL * max(1.0, abs(b[k])))
               for a, b in zip(got["metrics"], ref["metrics"])
               for k in b if k != "psnr")
    worst = 0.0
    for name, want in ref["params"].items():
        d = (got["params"][name] - want).abs()
        tol = PARAM_RTOL * want.abs().max() + torch.where(
            ref["noise"][name], torch.tensor(4 * LR0), torch.tensor(0.0))
        worst = max(worst, float((d / tol).max()))
    return loss, worst


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_one_process(step_results, case):
    got, ref = step_results[case], step_results[f"ref:{case}"]
    assert [sorted(m) for m in got["metrics"]] == \
        [sorted(m) for m in ref["metrics"]]
    loss, worst = _agreement(got, ref)
    assert loss <= 1.0, loss
    assert worst <= 1.0, worst
    # the steps moved the parameters (a no-op would pass the limits too)
    init = _state(case, None)[1].generator.state_dict()
    moved = max(float((ref["params"][f"g.{n}"] - p).abs().max())
                for n, p in init.items())
    assert moved > 10 * PARAM_RTOL


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_local_statistics_fail_the_limits(step_results, fault):
    loss, worst = _agreement(step_results[fault],
                             step_results[f"ref:{FAULTS[fault]}"])
    assert loss > 1.0 or worst > 1.0, (loss, worst)


# ------------------------------------------------------------- the CLI

_TRAIN = ["-m", "pesr_torch.train", "--device", "cpu", "--distributed",
          "--mesh_shape", "2", "--num_blocks", "2", "--num_channels", "8",
          "--scale", "2", "--batch_size", "4", "--patch_size", "8",
          "--steps_per_epoch", "2", "--log_every", "1", "--train_dataset",
          "synthetic", "--valid_dataset", "synthetic", "--num_valids", "1",
          "--no_eval_pi", "--snapshot_every", "1"]


def test_train_cli_on_two_ranks_checkpoints_once_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    outs = run_group(lambda r: [sys.executable, *_TRAIN, "--num_epochs",
                                "1", "--check_point", ck])
    for r, out in enumerate(outs):
        assert f"distributed: process {r} of 2 (gloo)" in out
        assert "mesh: 2 processes (gloo)" in out and "2 of the global " \
            "batch 4 per rank" in out
    done = [json.loads(o.strip().splitlines()[-1][len("[done] "):])
            for o in outs]
    for d in done:
        d.pop("wall_s")
    assert done[0] == done[1]           # the ranks agree on everything
    assert sorted(os.listdir(ck)) == ["best", "pretrain.jsonl", "step_2"]
    with open(os.path.join(ck, "pretrain.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    # rank 0 alone wrote: each step and the eval once
    assert [r["step"] for r in recs if "l1" in r] == [1, 2]
    assert [r["step"] for r in recs if "val_psnr" in r] == [2]
    outs = run_group(lambda r: [sys.executable, *_TRAIN, "--num_epochs",
                                "2", "--check_point", ck, "--resume"])
    for out in outs:
        assert f"resumed from {ck} at step 2" in out
        assert "[ckpt] saved " + os.path.join(ck, "step_4") in out
    assert os.path.isfile(os.path.join(ck, "step_4", "generator.pth"))
    assert not [n for n in os.listdir(ck) if n.endswith(".tmp")]


if __name__ == "__main__":
    {"steps": worker_steps}[sys.argv[1]](sys.argv[2])
