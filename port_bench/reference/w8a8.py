"""The plain W8A8 forward of the int8 path, with its own calibration and
quantisation, written from the scheme (per-channel symmetric W8A8,
static per-input-channel activation scales, bf16 residual carry):

* calibration: one bf16 forward (each conv rounded to bf16, then its
  bf16 bias added) records every quantised conv's per-channel max
  |input| (``amax``);
* ``s_in = max(amax, 1e-6) / Q`` folds into the kernel, ``w' = w s_in``
  per input channel; ``s_w = max(max |w'|, 1e-12) / Q`` per output
  channel; ``w_q = clip(round(w' / s_w), -Q, Q)`` (float64, round half to
  even); ``Q = 2^(bits - 1) - 1``;
* a residual block: ``q1 = clip(round(f32(y) / s_in1))``; ``h =
  clip(round(max(acc1 m1 q2 + b1 q2, 0)))`` with ``q2 = 1 / s_in2``;
  ``y2 = bf16(acc2 m2 + b2)``; ``y = y + bf16(res_scale) y2`` in bf16;
* the tail conv the same way (``bf16(acc m + b)``) plus the head's skip;
  the head conv and the upsampler stay in floating point.

The integer convolutions are float32 convs of integer values with TF32
off, exact while every partial sum stays below 2^24 (typical sums here
are ~1e5).  The upsampler runs unfolded in float32 on the bf16 trunk
output, where the program runs its bf16 fold: that difference is far
below the limit (see PERF.md).  ``bits=4`` gives the control (W4A4).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference.edsr import no_tf32, upsample


def _conv_bf16(x: torch.Tensor, sd, name: str) -> torch.Tensor:
    y = F.conv2d(x.to(torch.bfloat16), sd[f"{name}.weight"].to(torch.bfloat16),
                 padding=1)
    return y + sd[f"{name}.bias"].to(torch.bfloat16)[:, None, None]


def _amax(t: torch.Tensor) -> torch.Tensor:
    return t.float().abs().amax(dim=(0, 2, 3))


@torch.no_grad()
def calibrate(sd: Dict[str, torch.Tensor], model: dict,
              crops: torch.Tensor) -> Dict[str, list]:
    """Per-channel amax of every quantised conv's input over NHWC [-1, 1]
    ``crops``: ``in1``, ``in2`` (lists over blocks) and ``tail``."""
    rs = torch.tensor(model["res_scale"], dtype=torch.bfloat16,
                      device=crops.device)
    h = _conv_bf16(crops.permute(0, 3, 1, 2), sd, "head.0")
    y, in1, in2 = h, [], []
    for i in range(model["num_blocks"]):
        in1.append(_amax(y))
        t = torch.relu(_conv_bf16(y, sd, f"body.{i}.body.0"))
        in2.append(_amax(t))
        y = y + rs * _conv_bf16(t, sd, f"body.{i}.body.2")
    return {"in1": in1, "in2": in2, "tail": _amax(y)}


def quantize(w: torch.Tensor, b: torch.Tensor, amax: torch.Tensor,
             bits: int) -> Dict[str, torch.Tensor]:
    """An OIHW float kernel and its input's amax -> integer-valued float32
    ``w`` (OIHW), ``qin = 1 / s_in``, ``m = s_w`` and ``bias`` (float32,
    [C, 1, 1] for NCHW broadcasting)."""
    q = float(2 ** (bits - 1) - 1)
    s_in = torch.clamp(amax.double(), min=1e-6) / q
    w_fold = w.double() * s_in[None, :, None, None]
    s_w = torch.clamp(w_fold.abs().amax(dim=(1, 2, 3)), min=1e-12) / q
    w_q = torch.clamp(torch.round(w_fold / s_w[:, None, None, None]), -q, q)
    return {"w": w_q.float(), "qin": (1.0 / s_in).float()[:, None, None],
            "m": s_w.float()[:, None, None],
            "bias": b.float()[:, None, None]}


def _qact(x: torch.Tensor, qin: torch.Tensor, q: float) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() * qin), -q, q)


def _iconv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w, padding=1)


class W8A8:
    """The quantised model of ``sd`` calibrated on ``crops``; ``bits``: 8,
    or 4 for the control."""

    def __init__(self, sd: Dict[str, torch.Tensor], model: dict,
                 crops: torch.Tensor, bits: int = 8) -> None:
        self.sd, self.model, self.q = sd, model, float(2 ** (bits - 1) - 1)
        amax = calibrate(sd, model, crops)
        self.blocks = []
        for i in range(model["num_blocks"]):
            c1 = quantize(sd[f"body.{i}.body.0.weight"],
                          sd[f"body.{i}.body.0.bias"], amax["in1"][i], bits)
            c2 = quantize(sd[f"body.{i}.body.2.weight"],
                          sd[f"body.{i}.body.2.bias"], amax["in2"][i], bits)
            self.blocks.append((c1["w"], c1["qin"], c1["m"] * c2["qin"],
                                c1["bias"] * c2["qin"], c2["w"], c2["m"],
                                c2["bias"]))
        n = model["num_blocks"]
        self.tail = quantize(sd[f"body.{n}.weight"], sd[f"body.{n}.bias"],
                             amax["tail"], bits)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [-1, 1] -> NHWC float32 SR."""
        q = self.q
        rs = torch.tensor(self.model["res_scale"], dtype=torch.bfloat16,
                          device=x.device)
        with no_tf32():
            h = _conv_bf16(x.permute(0, 3, 1, 2), self.sd, "head.0")
            y = h
            for w1, qin1, mq, bq, w2, m2, b2 in self.blocks:
                acc1 = _iconv(_qact(y, qin1, q), w1)
                hid = torch.clamp(torch.round(torch.clamp_min(
                    acc1 * mq + bq, 0.0)), -q, q)
                y2 = (_iconv(hid, w2) * m2 + b2).to(torch.bfloat16)
                y = y + rs * y2
            t = self.tail
            y = (_iconv(_qact(y, t["qin"], q), t["w"]) * t["m"]
                 + t["bias"]).to(torch.bfloat16) + h
            return upsample(y.float(), self.sd, self.model).permute(0, 2, 3, 1)
