"""The benchmark is data: cells, configurations, mixes, limits and
metric readers load by name, within the contract's limits, and a new
configuration, mix, cell and metric are picked up with no code edit."""

import importlib
import json
import re

import pytest

from port_bench import run
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


@pytest.mark.parametrize("config", [c["name"] for c in bench()["configs"]])
def test_config_file_states_the_model(config):
    entry = {c["name"]: c for c in bench()["configs"]}[config]
    model = json.loads((ROOT / entry["file"]).read_text())
    assert model["name"] == config and model["reduced"] == entry["reduced"]
    for key in ("scale", "num_blocks", "num_channels", "res_scale",
                "precision", "assumed", "source"):
        assert key in model
    c, st = model["num_channels"], {2: 1, 4: 2}[model["scale"]]
    params = (9 * 3 * c + c + 2 * model["num_blocks"] * (9 * c * c + c)
              + 9 * c * c + c + st * (9 * c * 4 * c + 4 * c) + 9 * c * 3 + 3)
    assert params == model["parameters"]


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
