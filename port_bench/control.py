"""The readings that the limits of ``checks/<cell>.json`` are set from,
in one process per cell (set-up is most of a run):

    python3 -m port_bench.control --workload pesr_x4.batch_int8 \\
        --seeds 11,12,13 [--control] [--requests 4]

For each seed, the cell's own set-up and ``--requests`` requests of its
traffic through the timed path, then the comparison with the cell's
reference: one JSON line per seed with the numbers and whether they
hold the cell's limits.  ``--control`` puts the control in the
program's place, as the configuration's family gives it: the family's
reference one precision below the path's
(``reference/families/<family>.py`` ``control``; EDSR's int8 cells: the
reference in W4A4), else the program's own lower path
(``programs/<family>.py`` ``CONTROL_PATHS``; EDSR's bf16 cells: its int8
W8A8 path).  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np
import torch

from port_bench import programs
from port_bench.runners.upscale import (Program, Sample, compare,
                                        run_window, sync)
from port_bench.reference import families, tiling
from port_bench.run import REHEARSAL_SHRINK, ROOT, find_cell, load_json
from port_bench.traffic.generate import Traffic


class ReferenceEngine:
    """A reference forward in the program's place, at the engine's grid,
    rounded to uint8 as the program rounds."""

    def __init__(self, program: Program, forward, model: dict, mix: dict,
                 device) -> None:
        self.program, self.forward = program, forward
        self.model, self.mix, self.device = model, mix, device

    def __call__(self, imgs):
        x = torch.from_numpy(np.stack(imgs)).to(self.device)
        out = tiling.upscale(x, self.program.grid(imgs), self.mix["overlap"],
                             self.program.min_halo, self.model["scale"],
                             self.forward)
        u8 = torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)
        return list(u8.cpu().numpy())


def readings(workload: str, seed: int, control: bool, requests: int,
             rehearse: bool = False) -> dict:
    cell, model, mix, check = find_cell(load_json(ROOT / "BENCHMARK.json"),
                                        workload)
    shrink = 1
    if rehearse:
        device, shrink = torch.device("cpu"), REHEARSAL_SHRINK
        model = {**model, **model["rehearsal"]}
    else:
        device = torch.device("cuda", 0)
    family = families.load(model)
    sd = family.make_state_dict(model, seed, device)
    traffic = Traffic(mix, model["scale"], seed, device, shrink)
    path = forward = None
    if control:
        forward = family.control(model, mix, sd, traffic.crops, device)
        if forward is None:
            path = programs.load(model).CONTROL_PATHS.get(mix["path"])
            if path is None:
                raise SystemExit(f"{workload}: the family {model['family']!r} "
                                 f"has no control for the {mix['path']!r} "
                                 f"path")
    program = Program(model, mix, sd, traffic.crops, device, path=path)
    engine = program
    if forward is not None:
        engine = ReferenceEngine(program, forward, model, mix, device)
    for imgs in traffic.first_of_each_class():
        engine(imgs)
    sync(device)
    largest = int(np.argmax([h * w for h, w in traffic.classes]))
    sample = Sample(int(check["sample"]), largest, seed)
    reqs = run_window(engine, traffic, float("inf"), sample, program.grid,
                      program.halos, max_requests=requests)
    sync(device)
    min_halo = program.min_halo
    del program, engine, forward
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    forward = family.reference(model, mix, sd, traffic.crops, device)
    tally = compare(sample.items(), reqs, model, mix, min_halo, forward,
                    device)
    numbers = tally.numbers()
    return {"workload": workload, "seed": seed, "control": control,
            "images": tally.images, "clamped_pct": tally.clamped_pct(),
            **numbers,
            "holds": all(numbers[k] <= v for k, v in check["limits"].items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[port_bench.control] needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.control,
                                  args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
