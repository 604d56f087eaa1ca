"""Int8 (W8A8) generator inference: calibration, quantization, the int8
apply and its quality guard (counterpart of
``pesr_tpu/models/quant_apply.py``; ``python -m pesr_torch.test --quant
int8 [--quant_guard_db N]``).

Scheme (per-channel symmetric W8A8, bf16 residual carry), as in JAX:

* activation scales are static and per INPUT channel, ``s_in[c] =
  amax_c / 127`` from a calibration forward; they fold exactly into the
  weights (``w'[.., c, o] = w[.., c, o] s_in[c]``);
* weights are int8 per OUTPUT channel of the folded kernel, ``s_w[o] =
  max |w'[.., o]| / 127``; the arithmetic is JAX's float64 numpy, so the
  integers and the float32 vectors are bitwise JAX's;
* each int8 conv accumulates in int32 and dequantizes with one f32
  multiply, then an add, ``acc * s_w + bias``;
* conv1's int32 accumulator goes straight to conv2's int8 input through
  the f32 vectors ``m1 qin2`` and ``bias1 qin2`` (ReLU commutes with the
  positive scale);
* the residual carry, the head conv and (below x8) the folded upsampler
  stay bf16.

Each residual block is one call of
:func:`~pesr_torch.ops.kernels.resblock_int8.fused_resblock_int8` (on the
card one launch of the hand-written s8 ``wgmma`` kernel, on the CPU its
plain version), on weights packed once here.  The tail conv and the x8
int8 upfold, single ``lax.conv``s in JAX, are single
:func:`~pesr_torch.ops.int8_conv.int8_conv` calls (a float64 conv on the
CPU, ``torch._int_mm`` over an int8 im2col on the card).

The int8 path always folds the upsampler (``models/fold.py``), so its
apply carries the fold's ``min_halo``.  Calibration is a bf16 forward
through plain convs (cuDNN on the card, as JAX's ``lax.conv``): the
fused resblock kernel does not expose the ReLU map conv2 reads.  The
guard's bf16 fallback is the folded
:class:`~pesr_torch.models.kernel_apply.KernelApply`.
"""

from __future__ import annotations

import sys
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pesr_torch.data.augment import denormalize_to_uint8
from pesr_torch.models.fold import Fold, fold_upsampler
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import (Float32Apply, KernelApply,
                                            generator_convs)
from pesr_torch.ops.int8_conv import int8_conv
from pesr_torch.ops.kernels.resblock_int8 import (  # noqa: F401
    fused_resblock_int8, pack_int8_block_weights, quantize_act, requant)
from pesr_torch.ops.pixel_shuffle import pixel_shuffle
from pesr_torch.scales import fold_min_halo

QConv = Dict[str, torch.Tensor]


def _conv_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               pads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """bf16 NHWC conv with torch OIHW ``w``, then the bias added in bf16
    (JAX's ``_bias_conv``: two roundings).  ``pads``: None for SAME, or
    ``(lo, hi)`` on both spatial axes."""
    k = w.shape[-1]
    lo, hi = ((k - 1) // 2, k // 2) if pads is None else pads
    xp = F.pad(x.to(torch.bfloat16).permute(0, 3, 1, 2), (lo, hi, lo, hi))
    y = F.conv2d(xp, w.to(torch.bfloat16)).permute(0, 2, 3, 1)
    return y + b.to(torch.bfloat16)


def _amax(t: torch.Tensor) -> torch.Tensor:
    return t.float().abs().amax(dim=(0, 1, 2))


# --------------------------------------------------------------------------
# Calibration
# --------------------------------------------------------------------------


@torch.no_grad()
def calibration_amax(generator: Generator, x: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """One bf16 forward of NHWC ``x`` recording the per-channel max
    |input| of every quantized conv (JAX's ``make_calibration_apply``):
    ``body/in1 [L, C]``, ``body/in2 [L, C]``, ``tail_in [C]`` and
    ``up_in [C]`` (the folded upsampler's input, tail + skip), flat keys.
    The graph stops at the upfold's input, so one tree serves any
    scale."""
    head, blocks, tail, _, _ = generator_convs(generator)
    rs = torch.full((), generator.res_scale, dtype=torch.bfloat16,
                    device=x.device)
    h = _conv_bf16(x, head.weight, head.bias)
    y, in1, in2 = h, [], []
    for c1, c2 in blocks:
        in1.append(_amax(y))
        t = torch.relu(_conv_bf16(y, c1.weight, c1.bias))
        in2.append(_amax(t))
        y = y + rs * _conv_bf16(t, c2.weight, c2.bias)
    tail_in = _amax(y)
    u = _conv_bf16(y, tail.weight, tail.bias) + h
    return {"body/in1": torch.stack(in1), "body/in2": torch.stack(in2),
            "tail_in": tail_in, "up_in": _amax(u)}


def collect_calibration(generator: Generator,
                        tiles: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    """The calibration forward over normalized [-1, 1] NHWC batches
    (numpy) on the generator's device, amax reduced across batches with
    ``np.maximum``; float32 numpy arrays under the keys of
    :func:`calibration_amax`."""
    dev = next(generator.parameters()).device
    acc = None
    for t in tiles:
        x = torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(dev)
        stats = {k: v.cpu().numpy()
                 for k, v in calibration_amax(generator, x).items()}
        acc = stats if acc is None else {k: np.maximum(acc[k], v)
                                         for k, v in stats.items()}
    return acc


# --------------------------------------------------------------------------
# Quantization
# --------------------------------------------------------------------------


def _quantize_conv_folded(kernel: np.ndarray, bias: np.ndarray,
                          amax_in: np.ndarray) -> Dict[str, np.ndarray]:
    """HWIO float kernel + per-input-channel amax -> ``{w_q int8 HWIO,
    qin [Cin] f32 (1 / s_in), m [Cout] f32 (dequant multiplier), bias
    [Cout] f32}``, JAX's float64 arithmetic step for step."""
    kernel = np.asarray(kernel, np.float64)
    s_in = np.maximum(np.asarray(amax_in, np.float64), 1e-6) / 127.0
    w_fold = kernel * s_in[None, None, :, None]
    s_w = np.max(np.abs(w_fold), axis=(0, 1, 2))
    s_w = np.maximum(s_w, 1e-12) / 127.0
    w_q = np.clip(np.round(w_fold / s_w), -127, 127).astype(np.int8)
    return {"w_q": w_q, "qin": (1.0 / s_in).astype(np.float32),
            "m": s_w.astype(np.float32),
            "bias": np.asarray(bias, np.float32)}


def _hwio(w: torch.Tensor) -> np.ndarray:
    """A torch OIHW weight as a float HWIO numpy array (exact)."""
    return w.detach().permute(2, 3, 1, 0).cpu().numpy()


def _bias(b: torch.Tensor) -> np.ndarray:
    return b.detach().cpu().numpy()


def quantize_generator_params(sd: Dict[str, torch.Tensor],
                              calib: Dict[str, np.ndarray], scale: int,
                              quant_fold: bool = False,
                              folded: Optional[Fold] = None) -> dict:
    """Generator state_dict + calibration amax -> the W8A8 weights
    (JAX's ``quantize_generator_params``): ``{"head": (w OIHW, b) bf16,
    "body": [(conv1, conv2) per block], "tail": conv, "upfold": conv or
    (kernel OIHW, bias) bf16, "pads": (lo, hi)}``, each quantized conv
    as :func:`_quantize_conv_folded` gives it (numpy).  The upfold is the
    probe fold of ``models/fold.py`` (``folded`` when the caller has it)
    and int8 only with ``quant_fold``."""
    in1, in2 = calib["body/in1"], calib["body/in2"]
    body = [(_quantize_conv_folded(_hwio(sd[f"body.{i}.body.0.weight"]),
                                   _bias(sd[f"body.{i}.body.0.bias"]),
                                   in1[i]),
             _quantize_conv_folded(_hwio(sd[f"body.{i}.body.2.weight"]),
                                   _bias(sd[f"body.{i}.body.2.bias"]),
                                   in2[i]))
            for i in range(in1.shape[0])]
    n = in1.shape[0]
    kernel, bias, pads = folded or fold_upsampler(sd, scale)
    bf16 = lambda t: t.detach().to(torch.bfloat16)  # noqa: E731
    return {
        "head": (bf16(sd["head.0.weight"]), bf16(sd["head.0.bias"])),
        "body": body,
        "tail": _quantize_conv_folded(_hwio(sd[f"body.{n}.weight"]),
                                      _bias(sd[f"body.{n}.bias"]),
                                      calib["tail_in"]),
        "upfold": (_quantize_conv_folded(_hwio(kernel), _bias(bias),
                                         calib["up_in"]) if quant_fold
                   else (bf16(kernel), bf16(bias))),
        "pads": tuple(pads),
    }


# --------------------------------------------------------------------------
# Inference
# --------------------------------------------------------------------------


class Int8Block(NamedTuple):
    """One residual block's arguments of
    :func:`~pesr_torch.ops.kernels.resblock_int8.fused_resblock_int8`:
    the packed int8 weights and the f32 vectors (conv1's input scale, the
    fused requant's ``m1 qin2`` and ``bias1 qin2``, conv2's dequant)."""
    w1: torch.Tensor
    qin1: torch.Tensor
    mq: torch.Tensor
    bq: torch.Tensor
    w2: torch.Tensor
    m2: torch.Tensor
    b2: torch.Tensor


class Int8Apply:
    """The W8A8 apply (JAX's ``make_int8_apply``): ``apply(x)`` maps an
    NHWC [-1, 1] batch to the bf16 SR batch, after the pixel shuffle, on
    the weights of :func:`quantize_generator_params` moved to ``device``.
    Carries ``min_halo`` (the fold's), ``uint8_variant`` (quantised before
    the shuffle) and ``forwards``, as the folded
    :class:`~pesr_torch.models.kernel_apply.KernelApply`."""

    def __init__(self, q: dict, scale: int, res_scale: float,
                 device) -> None:
        self.scale, self.pads, self.forwards = scale, q["pads"], 0
        dev = torch.device(device)
        self.res_scale = res_scale  # the block rounds it to bf16
        self.head = tuple(t.to(dev) for t in q["head"])
        self.blocks = []
        for c1, c2 in q["body"]:
            a, b = self._conv(c1, dev), self._conv(c2, dev)
            w1, w2 = pack_int8_block_weights(a["w"], b["w"])
            # the fused requant's vectors, formed in f32 as JAX does
            self.blocks.append(Int8Block(w1, a["qin"], a["m"] * b["qin"],
                                         a["bias"] * b["qin"], w2, b["m"],
                                         b["bias"]))
        self.tail = self._conv(q["tail"], dev)
        up = q["upfold"]
        self.upfold = (self._conv(up, dev) if isinstance(up, dict)
                       else tuple(t.to(dev) for t in up))
        self.min_halo = fold_min_halo(scale)
        self.uint8_variant = self._uint8

    @staticmethod
    def _conv(qc: Dict[str, np.ndarray], dev) -> QConv:
        """A quantized conv on ``dev``, its int8 weights OHWI (the layout
        :func:`~pesr_torch.ops.int8_conv.int8_conv` takes)."""
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in qc.items()}
        t["w"] = t.pop("w_q").permute(3, 0, 1, 2).contiguous()
        return t

    @staticmethod
    def _qconv(x: torch.Tensor, c: QConv,
               pads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Static-scale int8 conv: bf16 in, bf16 out, int32 inside."""
        acc = int8_conv(quantize_act(x, c["qin"]), c["w"], pads)
        return (acc.float() * c["m"] + c["bias"]).to(torch.bfloat16)

    def block(self, y: torch.Tensor, i: int) -> torch.Tensor:
        """Residual block ``i`` on the bf16 carry ``y``: int8 conv1, the
        fused requant, int8 conv2, dequant, ``y + bf16(res_scale) y2``,
        as one :func:`fused_resblock_int8`."""
        return fused_resblock_int8(y, *self.blocks[i], self.res_scale)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        """Head, the int8 body, the int8 tail + skip and the upfold:
        NHWC bf16 before the pixel shuffle."""
        self.forwards += 1
        h = _conv_bf16(x, *self.head)
        y = h
        for i in range(len(self.blocks)):
            y = self.block(y, i)
        y = self._qconv(y, self.tail) + h
        up = self.upfold
        if isinstance(up, dict):
            return self._qconv(y, up, self.pads)
        return _conv_bf16(y, *up, self.pads)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self._trunk(x), self.scale)

    @torch.no_grad()
    def _uint8(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(denormalize_to_uint8(self._trunk(x)),
                             self.scale)


def _device(generator: Generator) -> torch.device:
    return next(generator.parameters()).device


def int8_inference(generator: Generator, calib_tiles: Sequence[np.ndarray],
                   quant_fold: Optional[bool] = None,
                   folded: Optional[Fold] = None) -> Int8Apply:
    """Calibrate ``generator`` on ``calib_tiles`` (normalized [-1, 1]
    NHWC numpy batches), quantize it and return its :class:`Int8Apply`
    on the generator's device.  ``quant_fold`` None: the upfold is int8
    from scale 8 up (JAX's auto rule), bf16 below."""
    if quant_fold is None:
        quant_fold = generator.scale >= 8
    calib = collect_calibration(generator, calib_tiles)
    q = quantize_generator_params(generator.state_dict(), calib,
                                  generator.scale, quant_fold, folded)
    return Int8Apply(q, generator.scale, generator.res_scale,
                     _device(generator))


@torch.no_grad()
def int8_agreement_db(apply_int8, generator: Generator,
                      probe_tiles: Sequence[np.ndarray],
                      bf16_engine=None) -> float:
    """Agreement PSNR (dB, 255 peak) between the int8 apply and the bf16
    folded engine it replaces (``KernelApply(generator, fold=True)``
    unless ``bf16_engine`` is given) over normalized NHWC probe batches.
    JAX measured ~62 dB on healthy checkpoints and ~42 dB under
    calibration shift (its ``int8_agreement_db`` note)."""
    ref = (bf16_engine if bf16_engine is not None
           else KernelApply(generator, fold=True))
    dev = _device(generator)
    se, n = 0.0, 0
    for t in probe_tiles:
        x = torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(dev)
        err = (apply_int8(x).double() - ref(x).double()) * 127.5
        se += float((err * err).sum())
        n += err.numel()
    rms = np.sqrt(se / max(n, 1))
    return float(20.0 * np.log10(255.0 / max(rms, 1e-12)))


def int8_inference_guarded(generator: Generator,
                           calib_tiles: Sequence[np.ndarray],
                           probe_tiles: Optional[Sequence[np.ndarray]] = None,
                           min_agreement_db: float = 55.0,
                           quant_fold: Optional[bool] = None,
                           fallback_dtype: Optional[torch.dtype] = None):
    """:func:`int8_inference` behind JAX's quality guard.  Rungs:

    1. int8 calibrated on ``calib_tiles``, its agreement with the bf16
       folded engine measured on ``probe_tiles`` (default: the
       calibration tiles);
    2. below ``min_agreement_db`` and with distinct probe tiles: int8
       recalibrated on the probe tiles (the fix for calibration shift);
    3. still below: the unquantized folded engine, with a loud warning,
       in ``fallback_dtype`` (bf16: the kernel path's ``KernelApply``;
       float32: :class:`Float32Apply`).

    Returns ``(apply, report)``; ``report`` has JAX's keys
    (``agreement_db``, ``min_agreement_db``, ``served`` = "int8" |
    "int8_recalibrated" | "bf16" | "float32", ``recalibrated``,
    ``fallback``, and ``agreement_db_recalibrated`` after rung 2).  The
    agreement reference is always the bf16 engine."""
    folded = fold_upsampler(generator.state_dict(), generator.scale)
    bf16_engine = KernelApply(generator, fold=True, folded=folded)
    probe = probe_tiles if probe_tiles is not None else calib_tiles

    apply_fn = int8_inference(generator, calib_tiles, quant_fold, folded)
    agreement = int8_agreement_db(apply_fn, generator, probe, bf16_engine)
    report = {"agreement_db": round(agreement, 2),
              "min_agreement_db": min_agreement_db,
              "served": "int8", "recalibrated": False, "fallback": False}

    if agreement < min_agreement_db and probe is not calib_tiles:
        print(f"[quant-guard] agreement {agreement:.1f} dB < "
              f"{min_agreement_db:.1f} dB floor with offline calibration "
              f"— recalibrating on the probe (serving-distribution) tiles "
              f"and retrying before falling back.",
              file=sys.stderr, flush=True)
        retry = int8_inference(generator, probe, quant_fold, folded)
        retry_db = int8_agreement_db(retry, generator, probe, bf16_engine)
        report["agreement_db_recalibrated"] = round(retry_db, 2)
        if retry_db >= min_agreement_db:
            apply_fn, agreement = retry, retry_db
            report.update(served="int8_recalibrated", recalibrated=True)
            print(f"[quant-guard] recalibration rescued the int8 engine: "
                  f"agreement {retry_db:.1f} dB >= {min_agreement_db:.1f} "
                  f"dB — serving int8 calibrated on the probe tiles.",
                  file=sys.stderr, flush=True)

    if agreement < min_agreement_db:
        report["fallback"] = True
        print(f"[quant-guard] int8-vs-bf16 agreement {agreement:.1f} dB < "
              f"{min_agreement_db:.1f} dB floor — the quantized engine "
              f"would not hold the quality budget on this checkpoint/"
              f"calibration (likely causes: calibration tiles that do not "
              f"cover the serving distribution, or pathological weight "
              f"statistics).  FALLING BACK to the unquantized folded path "
              f"(slower, exact).", file=sys.stderr, flush=True)
        if fallback_dtype in (None, torch.bfloat16):
            apply_fn, report["served"] = bf16_engine, "bf16"
        else:
            apply_fn = Float32Apply(generator, fold=True, folded=folded)
            report["served"] = "float32"
    return apply_fn, report


def default_calib_tiles(lr_images: Sequence[np.ndarray], tile: int = 96,
                        max_tiles: int = 16, seed: int = 0
                        ) -> Sequence[np.ndarray]:
    """Normalized calibration batches from uint8 LR images: ``max_tiles``
    random ``tile x tile`` crops (edge-padded images smaller than a
    tile), one [N, tile, tile, 3] float32 batch; the same draws from
    ``default_rng(seed)`` as JAX's."""
    rng = np.random.default_rng(seed)
    crops = []
    for _ in range(max_tiles):
        img = lr_images[rng.integers(len(lr_images))]
        h, w = img.shape[:2]
        if h < tile or w < tile:
            pad_h, pad_w = max(0, tile - h), max(0, tile - w)
            img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
            h, w = img.shape[:2]
        y = rng.integers(0, h - tile + 1)
        x = rng.integers(0, w - tile + 1)
        crops.append(img[y:y + tile, x:x + tile])
    batch = np.stack(crops).astype(np.float32) / 127.5 - 1.0
    return [batch]
