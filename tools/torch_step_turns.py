#!/usr/bin/env python3
"""One flagship pretrain step of ``pesr_torch`` checkouts, in turns on one GPU.

    python3 tools/torch_step_turns.py ROOT [ROOT ...] [--rounds 2]

Each ROOT is the root of a checkout (``.`` for this one; a ``git archive``
of another commit unpacked elsewhere).  Every round runs each ROOT once in
its own process, in order, then in the reverse order (ROOT_A, ROOT_B,
ROOT_B, ROOT_A for two), so that a card that warms or cools during the
call weighs on both alike.  A run builds that checkout's kernels (nvcc,
into its own ``pesr_torch/_build/``) and times the train phase's step of
``chip_smoke.py``: the x4 32 x 256 generator on the kernel chain
(``fold_train=False``), batch 16 of 48 x 48 LR patches, bf16, random
weights from seed 0.  It prints one JSON line per run: the host's queue
time and the wall time of a step (medians of 9 steps after 3 of warm-up),
the device's busy time and kernel launches in a profile of one step, the
convolutions and convolution gradients one step dispatches, and the
card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = r"""
import json, statistics, time, torch
from torch.utils._python_dispatch import TorchDispatchMode
import chip_smoke as c
from pesr_torch.config import Opts
from pesr_torch.models.generator import Generator
from pesr_torch.ops.kernels import build
from pesr_torch.training.state import create_generator_state
from pesr_torch.training.steps import make_pretrain_step


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"convolution": 0, "convolution_backward": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


build.build_all()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
opts = Opts(scale=c.SCALE, num_blocks=c.BLOCKS, num_channels=c.CHANNELS,
            batch_size=c.TRAIN_BATCH, patch_size=c.TRAIN_PATCH,
            fold_train=False, device="cuda")
step = make_pretrain_step(opts)
state = create_generator_state(opts, torch.device("cuda"),
                               Generator(c.SCALE, c.BLOCKS, c.CHANNELS,
                                         seed=0))
lr, hr = c._train_batch(seed=0)
for _ in range(3):
    step(state, lr, hr)
host, wall = [], []
for _ in range(9):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, lr, hr)
    host.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    wall.append(1e3 * (time.perf_counter() - t0))
prof = c.profile_breakdown(lambda: step(state, lr, hr), "", top=0)
with Count() as ops:
    step(state, lr, hr)
print("TURN " + json.dumps({
    "host_ms": statistics.median(host), "wall_ms": statistics.median(wall),
    "device_busy_ms": prof["busy_ms"], "device_launches": prof["launches"],
    "conv_ops": ops.n, "card": c.gpu_name_power()}), flush=True)
"""


def run(root: str) -> dict:
    """One run in ``root``: its JSON line, with the root added."""
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=root,
                         capture_output=True, text=True, timeout=900)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("TURN ")]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"{root}: exit {out.returncode}\n{out.stdout[-3000:]}"
                         f"\n{out.stderr[-3000:]}")
    res = json.loads(lines[-1][5:])
    res["root"] = root
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    roots = [os.path.abspath(r) for r in a.roots]
    for i in range(a.rounds):
        for root in (roots if i % 2 == 0 else roots[::-1]):
            print(json.dumps(run(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
