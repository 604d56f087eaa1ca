"""RCAN x4 (``rcan_x4``, family ``rcan``): its cell through the CPU
rehearsal, its parameter count, its operation counts and the RCAB
yardstick pinned to hand-computed values, the ``fused_rcab_roofline``
reader on a made-up trace, and a reference that imports nothing of the
port."""

import json
import math
import subprocess
import sys

import pytest

from port_bench.metrics import fused_rcab_roofline
from port_bench.metrics._common import Context, Request
from port_bench.reference.families import rcan
from port_bench.tests.helpers import ROOT, last_json, run_cli
from port_bench.trace import Trace

CELL = "rcan_x4.batch_bf16"


def _model() -> dict:
    return json.loads((ROOT / "port_bench/configs/rcan_x4.json").read_text())


def test_rehearsal_runs_and_is_correct():
    for trace in (0, 1):
        r = run_cli(["--workload", CELL, "--seed", str(2 ** 31 + 21),
                     "--seconds", "0.3", "--trace", str(trace),
                     "--rehearse"], ROOT, [ROOT])
        assert r.returncode == 0, r.stderr[-2000:]
        line = last_json(r.stdout)
        assert line["correct"], line["checks"]
        assert ("mps" in line["metrics"]) == (trace == 0)


def test_parameters_are_rcan_x4s():
    """10 groups x 20 RCAB x 64, reduction 16, x4: 15,592,355."""
    model = _model()
    assert model["parameters"] == 15_592_355
    assert sum(math.prod(s) for _, s in rcan.param_shapes(model)) \
        == 15_592_355
    c, cr = 64, 4
    conv = 9 * c * c + c
    block = 2 * conv + (c * cr + cr) + (cr * c + c)
    hand = ((9 * 3 * c + c) + 10 * (20 * block + conv) + conv
            + 2 * (9 * c * 4 * c + 4 * c) + (9 * c * 3 + 3))
    assert hand == 15_592_355


def test_branch_gain_scales_every_branch_end():
    model = {**_model(), "num_groups": 2, "num_blocks": 2}
    import torch
    one = rcan.make_state_dict({**model, "branch_gain": 1.0}, 3,
                               torch.device("cpu"))
    sd = rcan.make_state_dict(model, 3, torch.device("cpu"))
    ends = set(rcan.branch_ends(model))
    assert ends == {"body.0.body.0.body.2", "body.0.body.1.body.2",
                    "body.1.body.0.body.2", "body.1.body.1.body.2",
                    "body.0.body.2", "body.1.body.2", "body.2"}
    g = model["branch_gain"]
    for k in sd:
        scale = g if k.rsplit(".", 1)[0] in ends else 1.0
        assert torch.equal(sd[k], one[k] * scale), k


def test_ops_per_lr_px_by_hand():
    """Per LR pixel: 2 9 64^2 x (2 x 200 RCAB convs + 10 group convs + the
    trunk conv) + the head 2 9 3 64 + the folded upsampler 2 25 64 48."""
    assert rcan.ops_per_lr_px(_model(), "bf16") == (
        0, 411 * 73_728 + 3_456 + 153_600)
    assert 411 * 73_728 + 3_456 + 153_600 == 30_459_264


def test_rcab_least_time_by_hand():
    """[8, 144, 342] (the cell's tile batch): compute bound, 147,456 FLOP
    a pixel at 989 TFLOP/s; a 2 x 2 tile: the weights' bytes bound it."""
    px = 8 * 144 * 342
    assert rcan.rcab_seconds(_model(), 8, 144, 342) == \
        147_456 * px / 989e12
    assert rcan.rcab_seconds(_model(), 1, 2, 2) == \
        (2 * 4 * 64 * 2 + 2 * 9 * 64 * 64 * 2 + 2 * 64 * 4) / 3.35e12


def _events(blocks, excites, us=10.0):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "port_bench.window",
           "ts": 0.0, "dur": 1e6, "pid": 1, "tid": 7}]
    names = (["void pesr::(anonymous namespace)::rcab_kernel(CUtensorMap)"]
             * blocks + ["void pesr::(anonymous namespace)::"
                         "rcab_excite_kernel(bf16 const*)"] * excites)
    for i, name in enumerate(names):
        ev.append({"ph": "X", "cat": "kernel", "name": name,
                   "ts": 100.0 + 20.0 * i, "dur": us, "pid": 0, "tid": 1})
    return ev


@pytest.mark.parametrize("blocks, excites, counted, ok", [
    (8, 4, (8, 4), True),       # 2 groups x 2 RCAB x 2 positions
    (7, 4, (8, 4), False),      # a block missing from the trace
    (8, 4, (9, 4), False),      # the counter disagrees
    (8, 3, (8, 3), False),      # an excite missing from both
])
def test_roofline_reader(blocks, excites, counted, ok, capsys):
    model = {**_model(), "num_groups": 2, "num_blocks": 2}
    req = Request((10, 20), 2, (1, 2, 10, 10), (3, 8), 0.0, 1.0)
    ctx = Context(model, {"path": "bf16"}, [req], 1.0,
                  {"fused_rcab": counted[0], "rcab_excite": counted[1]},
                  Trace(_events(blocks, excites)))
    got = fused_rcab_roofline.read(ctx, "mps")
    if not ok:
        assert got is None
        assert "no roofline" in capsys.readouterr().err
        return
    least = 2 * 4 * rcan.rcab_seconds(model, 2, 16, 26)
    assert got == pytest.approx(100.0 * least / ((8 + 4) * 10e-6), rel=1e-12)


def test_no_roofline_without_a_trace():
    ctx = Context(_model(), {"path": "bf16"}, [], 1.0, {}, None)
    assert fused_rcab_roofline.read(ctx, "mps") is None


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, port_bench.reference.rcan, "
            "port_bench.reference.families.rcan, "
            "port_bench.metrics.fused_rcab_roofline\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pesr_torch', 'jax', 'pesr_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
