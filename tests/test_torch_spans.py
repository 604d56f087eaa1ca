"""The port's profiler spans (``pesr_torch/utils/spans.py``): a shared
no-op without a profiler, and under one the engine's and the applies'
ranges in the Chrome trace, nested and counted as the benchmark's
readers take them (one ``pesr.request`` per ``upscale_many`` call, per
chunk its steps in order and one ``pesr.forward`` per tile position,
each forward holding the apply's head, trunk, tail and upsample).  Also
the test CLI's ``--profile_dir``."""

import json
import os

import numpy as np
import pytest
import torch

from pesr_torch import test as cli
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.models.quant_apply import int8_inference
from pesr_torch.ops.tiling import BatchTiledUpscaler
from pesr_torch.utils import spans

APPLY_SPANS = ["pesr.head", "pesr.trunk", "pesr.tail", "pesr.upsample"]


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) reached")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch.autograd._profiler_enabled()
    first = spans.span("pesr.request")
    assert all(spans.span(n) is first for n in ("pesr.forward", "x"))
    with spans.span("pesr.request"):
        with spans.span("pesr.forward"):
            pass


def _pesr_spans(path):
    """``(start, end, name, parent name)`` of the trace's ``pesr.*``
    ranges in start order; the parent is the innermost ``pesr.*`` range
    holding it (None at the top)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("pesr."))
    out, stack = [], []
    for a, b, name in ranges:
        while stack and stack[-1][1] < b:
            stack.pop()
        out.append((a, b, name, stack[-1][2] if stack else None))
        stack.append((a, b, name))
    return out


def _apply(kind, gen):
    if kind == "int8":
        calib = np.random.default_rng(1).uniform(
            -1, 1, (2, 24, 24, 3)).astype(np.float32)
        return int8_inference(gen, [calib])
    return KernelApply(gen, fold=kind == "bf16_folded")


# Two chunks each (two 40 x 52 images and one 24 x 30): a multi-tile
# grid (16-px tiles) and a single tile ("auto"), on the bf16 folded
# apply, the int8 apply and the kernel chain.
@pytest.mark.parametrize("kind,tile", [
    ("bf16_folded", 16), ("bf16_folded", "auto"), ("int8", 16),
    ("int8", "auto"), ("chain", 16)])
def test_engine_and_apply_spans_nest_and_count(kind, tile, tmp_path):
    gen = Generator(4, 2, 64, device="cpu", seed=0)
    engine = BatchTiledUpscaler(_apply(kind, gen), 4, tile, 8, device="cpu")
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((40, 52), (24, 30), (40, 52))]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outs = engine.upscale_many(imgs, 8)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    assert [o.shape for o in outs] == [(160, 208, 3), (96, 120, 3),
                                      (160, 208, 3)]

    got = _pesr_spans(path)
    assert [(n, p) for _, _, n, p in got if n == "pesr.request"] == [
        ("pesr.request", None)]
    want = []
    grids = [engine.grid(2, 40, 52), engine.grid(1, 24, 30)]
    for nh, nw, _, _ in grids:
        want += ["pesr.stack", "pesr.upload", "pesr.plan", "pesr.cut"]
        want += ["pesr.forward", "pesr.canvas"] * (nh * nw)
        want += ["pesr.download"]
    assert [n for _, _, n, p in got if p == "pesr.request"] == want
    if tile == 16:
        assert grids[0][:2] == (3, 4)
    else:
        assert all(g[:2] == (1, 1) for g in grids)
    forwards = [(a, b) for a, b, n, _ in got if n == "pesr.forward"]
    inside = [[n for a, b, n, p in got if p == "pesr.forward"
               and fa <= a and b <= fb] for fa, fb in forwards]
    assert inside == [APPLY_SPANS] * len(forwards)
    assert {n for *_, n, p in got if p not in ("pesr.request",
                                               "pesr.forward")} == {
        "pesr.request"}


def test_cli_profile_dir_writes_the_engine_spans(tmp_path, capsys):
    base = ["--num_blocks", "2", "--num_channels", "8", "--dataset",
            "synthetic", "--device", "cpu", "--output_dir",
            str(tmp_path / "o")]
    cli.run(base)
    assert "[profile]" not in capsys.readouterr().out
    assert not any(f.endswith(".pt.trace.json")
                   for _, _, fs in os.walk(tmp_path) for f in fs)
    pdir = tmp_path / "prof"
    cli.run(base + ["--profile_dir", str(pdir)])
    assert "[profile] trace written to" in capsys.readouterr().out
    assert os.listdir(pdir) == ["synthetic.pt.trace.json"]
    names = [n for *_, n, _ in _pesr_spans(pdir / "synthetic.pt.trace.json")]
    assert names.count("pesr.request") == 1
    assert names.count("pesr.forward") >= 1
