"""The benchmark is data: cells, configurations, mixes, limits and
metric readers load by name, within the contract's limits, and a new
configuration, mix, cell and metric are picked up with no code edit."""

import importlib
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from port_bench import run
from port_bench.reference import families
from port_bench.reference.compare import NAMES
from port_bench.tests.helpers import (ROOT, bench, copy_benchmark,
                                      last_json, run_cli)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


@pytest.mark.parametrize("cell", [c["name"] for c in bench()["workloads"]])
def test_cell_resolves(cell):
    b = bench()
    entry, model, mix, check = run.find_cell(b, cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert mix["path"] in model["precision"]
    assert set(check["limits"]) <= set(NAMES) and check["sample"] >= 1
    e2e = run.metrics_of(b, cell, "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = run.metrics_of(b, cell, "per_layer")
    assert layer and all(m["moves"] in names for m in layer)
    for m in layer:
        family = m["name"].split(".")[0]
        reader = importlib.import_module(f"port_bench.metrics.{family}")
        assert callable(reader.read)


def _config(name: str) -> dict:
    """A configuration of ``BENCHMARK.json``, or ``edsr_x3``: Lim et al.'s
    EDSR x3 (one x3 stage), the flagship's sizes at scale 3."""
    if name == "edsr_x3":
        return {**_config("pesr_x4"), "name": "edsr_x3", "scale": 3,
                "parameters": 43_680_003}
    entry = {c["name"]: c for c in bench()["configs"]}[name]
    model = json.loads((ROOT / entry["file"]).read_text())
    assert model["name"] == name and model["reduced"] == entry["reduced"]
    return model


@pytest.mark.parametrize("config", [c["name"] for c in bench()["configs"]]
                         + ["edsr_x3"])
def test_config_file_states_the_model(config):
    """The common keys, the family's own, and ``parameters`` the sum of
    the family's parameter shapes, which its weights have, in order (at
    the rehearsal sizes)."""
    model = _config(config)
    family = families.load(model)
    for key in families.COMMON_KEYS + family.KEYS:
        assert key in model, key
    shapes = family.param_shapes(model)
    assert sum(math.prod(s) for _, s in shapes) == model["parameters"]
    small = {**model, **model["rehearsal"]}
    sd = family.make_state_dict(small, 1, torch.device("cpu"))
    assert [(k, tuple(v.shape)) for k, v in sd.items()] == \
        [(k, tuple(s)) for k, s in family.param_shapes(small)]


def test_new_config_mix_cell_and_metric_are_picked_up(tmp_path):
    """An x3 configuration, a mix of its own, a cell, its limits and a
    per-layer metric family, added as files and entries only."""
    root = copy_benchmark(tmp_path)
    pb = root / "port_bench"
    model = json.loads((pb / "configs" / "pesr_x4.json").read_text())
    model.update(name="edsr_x3", scale=3)
    (pb / "configs" / "edsr_x3.json").write_text(json.dumps(model))
    mix = json.loads((pb / "mixes" / "batch_bf16.json").read_text())
    mix["classes"][0].update(name="small", hr_hw=[384, 288])
    (pb / "mixes" / "small_bf16.json").write_text(json.dumps(mix))
    (pb / "checks" / "edsr_x3.small_bf16.json").write_text(json.dumps(
        {"sample": 1, "limits": {"rms_lsb": 50.0}}))
    (pb / "metrics" / "images_per_request.py").write_text(
        "def read(ctx, suffix):\n"
        "    return sum(r.images for r in ctx.requests) / len(ctx.requests)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "edsr_x3", "source": "https://example.org",
                         "file": "port_bench/configs/edsr_x3.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "edsr_x3.small_bf16", "config": "edsr_x3",
                           "traffic": "small_bf16", "chips": 1,
                           "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "mps":
            m["workloads"].append("edsr_x3.small_bf16")
    b["per_layer"].append({"name": "images_per_request.mps", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "mps",
                           "workloads": ["edsr_x3.small_bf16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    for trace, key in ((0, "mps"), (1, "images_per_request.mps")):
        r = run_cli(["--workload", "edsr_x3.small_bf16", "--seed", "4",
                     "--seconds", "0.5", "--trace", str(trace),
                     "--rehearse"], root, [root, ROOT])
        assert r.returncode == 0, r.stderr[-2000:]
        line = last_json(r.stdout)
        assert key in line["metrics"] and line["correct"]
    assert line["metrics"]["images_per_request.mps"]["value"] == 8.0


PLAIN_REFERENCE = '''"""A toy family: head conv, two plain convs with a ReLU between, one
sub-pixel stage and the out conv, every conv 3x3 with zero padding 1."""

import torch
import torch.nn.functional as F

from port_bench.reference.counts import conv_ops
from port_bench.reference.weights import conv_params, draw_convs

KEYS = ("num_channels", "bias_std")


def conv_shapes(model):
    c, s = model["num_channels"], model["scale"]
    return [("head", (c, 3, 3, 3)), ("body0", (c, c, 3, 3)),
            ("body1", (c, c, 3, 3)), ("up", (c * s * s, c, 3, 3)),
            ("out", (3, c, 3, 3))]


def param_shapes(model):
    return conv_params(conv_shapes(model))


def make_state_dict(model, seed, device):
    return draw_convs(conv_shapes(model), model["bias_std"], seed, device)


def reference(model, mix, sd, crops, device):
    def forward(x):
        y = x.permute(0, 3, 1, 2).float()
        for name in ("head", "body0", "body1", "up"):
            y = F.conv2d(y, sd[name + ".weight"], sd[name + ".bias"],
                         padding=1)
            y = torch.relu(y) if name == "body0" else y
        y = F.pixel_shuffle(y, model["scale"])
        y = F.conv2d(y, sd["out.weight"], sd["out.bias"], padding=1)
        return y.permute(0, 2, 3, 1)
    return forward


def control(model, mix, sd, crops, device):
    return None


def ops_per_lr_px(model, path):
    c, s = model["num_channels"], model["scale"]
    return 0, (conv_ops(3, c) + 2 * conv_ops(c, c) + conv_ops(c, c * s * s)
               + s * s * conv_ops(c, 3))
'''

PLAIN_PROGRAM = '''"""The toy family's apply: its layers as a torch.nn.Sequential."""

import torch

CONTROL_PATHS = {}


def apply(model, mix, sd, crops, device, path):
    c, s = model["num_channels"], model["scale"]
    def conv(cin, cout):
        return torch.nn.Conv2d(cin, cout, 3, padding=1)
    net = torch.nn.Sequential(conv(3, c), conv(c, c), torch.nn.ReLU(),
                              conv(c, c), conv(c, c * s * s),
                              torch.nn.PixelShuffle(s), conv(c, 3))
    at = {"head": 0, "body0": 1, "body1": 3, "up": 4, "out": 6}
    net.load_state_dict({f"{at[k.split('.')[0]]}.{k.split('.')[1]}": v
                         for k, v in sd.items()})
    net.to(device).eval()

    @torch.no_grad()
    def forward(x):
        return net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return forward


def launches():
    return {}
'''

PLAIN_PROBE = """
import json
import numpy as np
import torch
from port_bench import control
from port_bench.metrics import mfu
from port_bench.metrics._common import Context, Request
from port_bench.reference import families
from port_bench.run import ROOT, find_cell, load_json
from port_bench.runners.upscale import Program
from port_bench.trace import Trace
_, model, mix, _ = find_cell(load_json(ROOT / "BENCHMARK.json"), CELL)
sd = families.load(model).make_state_dict(model, 1, torch.device("cpu"))
program = Program(model, mix, sd, None, torch.device("cpu"))
print(json.dumps(program.grid([np.zeros((24, 16, 3), np.uint8)] * 2)))
window = [{"ph": "X", "cat": "user_annotation", "name": "port_bench.window",
           "ts": 0.0, "dur": 1e6, "pid": 1, "tid": 1}]
req = Request((24, 16), 2, (2, 2, 12, 8), (4, 4), 0.0, 1.0)
print(json.dumps(mfu.read(Context(model, mix, [req], 1.0, {}, Trace(window)),
                          "mps")))
try:
    control.readings(CELL, 1, True, 1, rehearse=True)
except SystemExit as e:
    print(json.dumps(str(e)))
"""


def test_new_family_is_picked_up(tmp_path):
    """A family of another architecture, as new files plus entries: its
    reference and program modules, a configuration, a mix with a
    rectangular tile (which the engine takes), limits, and the cell appended to ``mps``'s and
    ``mfu.mps``'s workloads.  It runs and is correct, ``mps`` and
    ``mfu.mps`` read (the latter from a made-up trace: the CPU gives
    none), its configuration passes the parameter check, and its
    control, of which it has none, stops with a reason."""
    root = copy_benchmark(tmp_path)
    pb = root / "port_bench"
    (pb / "reference" / "families" / "plainsr.py").write_text(PLAIN_REFERENCE)
    (pb / "programs" / "plainsr.py").write_text(PLAIN_PROGRAM)
    # 16 (27 + 1) + 2 16 (144 + 1) + 64 (144 + 1) + 3 (144 + 1)
    (pb / "configs" / "plainsr_x2.json").write_text(json.dumps(
        {"name": "plainsr_x2", "family": "plainsr", "scale": 2,
         "num_channels": 16, "bias_std": 0.01, "parameters": 14_803,
         "precision": {"f32": "float32"}, "assumed": {}, "source": "a test",
         "reduced": [], "rehearsal": {}}))
    (pb / "mixes" / "tiles_f32.json").write_text(json.dumps(
        {"runner": "upscale", "path": "f32", "batch": 2, "pool_blocks": 1,
         "classes": [{"name": "a", "hr_hw": [384, 256], "count": 4}],
         "tile": [12, 8], "overlap": 4, "band": [0.06, 0.24]}))
    cell = "plainsr_x2.tiles_f32"
    (pb / "checks" / f"{cell}.json").write_text(json.dumps(
        {"sample": 2, "limits": {"max_lsb": 1.0}}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "plainsr_x2", "source": "https://example.org",
                         "file": "port_bench/configs/plainsr_x2.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": cell, "config": "plainsr_x2",
                           "traffic": "tiles_f32", "chips": 1,
                           "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("mps", "mfu.mps"):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    for trace in (0, 1):
        r = run_cli(["--workload", cell, "--seed", str(2 ** 31 + 9),
                     "--seconds", "0.3", "--trace", str(trace),
                     "--rehearse"], root, [root, ROOT])
        assert r.returncode == 0, r.stderr[-2000:]
        line = last_json(r.stdout)
        assert line["correct"], line["checks"]
        assert ("mps" in line["metrics"]) == (trace == 0)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(map(str, (root, ROOT)))}
    probe = subprocess.run(
        [sys.executable, "-c", f"CELL = {cell!r}\n" + PLAIN_PROBE],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    grid, share, stop = map(json.loads,
                            probe.stdout.strip().splitlines()[-3:])
    assert grid == [2, 2, 12, 8]
    ops = 2 * 9 * (3 * 16 + 2 * 16 * 16 + 16 * 64 + 4 * 16 * 3)
    assert share == pytest.approx(100.0 * 2 * 24 * 16 * ops / 989e12,
                                  rel=1e-12)
    assert "has no control" in stop
    check = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "port_bench/tests/test_port_bench_data.py", "-k",
         "states_the_model and plainsr"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert check.returncode == 0 and "1 passed" in check.stdout, \
        check.stdout[-2000:]
