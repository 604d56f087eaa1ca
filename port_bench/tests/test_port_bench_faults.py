"""A run with the timed path broken underneath comes out not correct:
for each fault an inference cell can have, on the CPU at the rehearsal
size (the limits are the cells' own)."""

import json

import numpy as np
import pytest

from pesr_torch.models.kernel_apply import KernelApply
from pesr_torch.models.quant_apply import Int8Apply
from pesr_torch.ops.tiling import BatchTiledUpscaler
from port_bench import run

CELLS = ["pesr_x4.batch_int8", "edsr_x2.batch_bf16", "pesr_x4.single_photo"]


def _line(capsys, cell, seed):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", "0", "--rehearse"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _alter(cls, monkeypatch):
    """An answer altered where it is produced: one row of every tile's
    uint8 output off by 40."""
    real = cls._uint8

    def altered(self, x):
        out = real(self, x).clone()
        row = out[:, out.shape[1] // 2]
        out[:, out.shape[1] // 2] = (row.int() + 40).clamp(0, 255).byte()
        return out
    monkeypatch.setattr(cls, "_uint8", altered)


def _half_batch(monkeypatch):
    """Half of every batch left out: its second half answered with the
    first half's results."""
    real = BatchTiledUpscaler.upscale_many

    def half(self, imgs, batch_size=8, se=False):
        k = max(len(imgs) // 2, 1)
        done = real(self, imgs[:k], batch_size, se)
        return done + [done[i % k].copy() for i in range(len(imgs) - k)]
    monkeypatch.setattr(BatchTiledUpscaler, "upscale_many", half)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(capsys, cell):
    assert _line(capsys, cell, 2 ** 31 + 101)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(capsys, monkeypatch, cell):
    _alter(Int8Apply if "int8" in cell else KernelApply, monkeypatch)
    line = _line(capsys, cell, 2 ** 31 + 102)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS[:2])
def test_half_batch_left_out_is_not_correct(capsys, monkeypatch, cell):
    _half_batch(monkeypatch)
    line = _line(capsys, cell, 2 ** 31 + 103)
    assert not line["correct"], line["checks"]
    assert all(np.isfinite(c["value"]) for c in line["checks"].values())
