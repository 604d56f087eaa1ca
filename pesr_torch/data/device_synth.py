"""The ``synthetic_device`` corpus: HR training patches rendered on the
training device (the port's counterpart of
``pesr_tpu/data/device_synth.py``), so no batch bytes cross the
host-to-device link.

Content follows the JAX renderer's procedural family, feature for
feature, with its counts and parameter ranges: a smooth base of 3
low-frequency cosine gratings, 6 Gaussian-windowed oriented gratings, 2
soft checkerboards (a cosine product at f/sqrt(2) per axis, so the
diagonal lands at f), 4 strokes with a Gaussian cross-profile and 2 soft
step edges inside soft circles.  Feature frequencies lie in a band below
the LR Nyquist of the trained scale (:func:`band_for_scale`), so SR at
that scale can recover them.  Each sample is normalised to the full
uint8 range and rounded half up.

``jax.random`` cannot be reproduced, so the port's pixels are not JAX's;
it keeps the renderer's stated properties instead: uint8 covering
0..255, determinism in (seed, step), sample ``i`` fixed by its global
index whatever the batch size, distinct samples within a batch, fresh
content after a resume's ``start_step``, and the band (at x4 on a 192^2
render: < 12% of the energy at or above 0.125 cycles/px, > 15% in
[f_lo, 0.125)).  Each sample's ~120 parameters are drawn on the host
from a generator seeded by (key, sample index) and go to the device as
one small tensor; the pixels are computed there in float32.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from pesr_torch.utils.device import resolve_device

_M64 = (1 << 64) - 1


def band_for_scale(scale: int) -> Tuple[float, float]:
    """Feature-frequency band in cycles/px of the HR grid: inside
    (0, LR Nyquist = 0.5/scale), with margin at both ends."""
    return 0.175 / scale, 0.48 / scale


def mix_seed(a: int, b: int) -> int:
    """A 63-bit seed from two integers (splitmix64 finaliser): the
    per-sample and per-step streams' seeds."""
    z = (a * 0x9E3779B97F4A7C15 + b + 0x632BE59BD9B4E019) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def _param_table(hp: int, f_lo: float, f_hi: float):
    """(name, count, lo, hi) of every parameter of one sample, in draw
    order; the ranges of JAX's ``_render_one``."""
    tau = 2.0 * math.pi
    return (
        ("fb", 3 * 2, 0.5 / hp, 4.8 / hp), ("phb", 3, 0.0, tau),
        ("ab", 3, 0.05, 0.3), ("cb", 3 * 3, 0.3, 1.0),
        ("f", 6, f_lo, f_hi), ("th", 6, 0.0, math.pi),
        ("cyx", 6 * 2, 0.05 * hp, 0.95 * hp), ("sig", 6, 0.08 * hp, 0.25 * hp),
        ("ph", 6, 0.0, tau), ("ag", 6, 0.25, 0.5), ("cg", 6 * 3, 0.5, 1.0),
        ("fc", 2, f_lo / math.sqrt(2.0), f_hi / math.sqrt(2.0)),
        ("offs", 2 * 2, 0.0, hp), ("ctr", 2 * 2, 0.2 * hp, 0.8 * hp),
        ("half", 2, 0.15 * hp, 0.35 * hp), ("ac", 2, 0.3, 0.6),
        ("cc", 2 * 3, 0.5, 1.0),
        ("p0", 4 * 2, 0.0, hp), ("ang", 4, 0.0, math.pi),
        ("ln", 4, 0.15 * hp, 0.7 * hp), ("thick", 4, 0.5 / f_hi, 0.5 / f_lo),
        ("a_s", 4, -0.9, 0.9),
        ("ec", 2 * 2, 0.0, hp), ("rad", 2, 0.1 * hp, 0.3 * hp),
        ("eth", 2, 0.0, math.pi), ("ae", 2, -0.5, 0.5),
    )


def draw_params(key: int, batch: int, hp: int, scale: int) -> torch.Tensor:
    """[batch, P] float32 parameters on the host; row ``i`` is drawn from
    a generator seeded with ``mix_seed(key, i)`` alone, so it does not
    depend on the batch size."""
    f_lo, f_hi = band_for_scale(scale)
    table = _param_table(hp, f_lo, f_hi)
    lo = torch.tensor([t[2] for t in table for _ in range(t[1])],
                      dtype=torch.float64)
    hi = torch.tensor([t[3] for t in table for _ in range(t[1])],
                      dtype=torch.float64)
    u = torch.stack([
        torch.rand(len(lo), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(
                       mix_seed(key, i)))
        for i in range(batch)])
    return (lo + (hi - lo) * u).float()


def _split(params: torch.Tensor, hp: int, f_lo: float, f_hi: float) -> dict:
    out, at = {}, 0
    for name, n, _, _ in _param_table(hp, f_lo, f_hi):
        out[name] = params[:, at:at + n]
        at += n
    return out


def _render(params: torch.Tensor, hp: int, scale: int) -> torch.Tensor:
    """[B, hp, hp, 3] uint8 from [B, P] float32 parameters on the device
    where the pixels are computed."""
    f_lo, f_hi = band_for_scale(scale)
    p = _split(params, hp, f_lo, f_hi)
    b = params.shape[0]
    dev = params.device
    y = torch.arange(hp, dtype=torch.float32, device=dev).view(1, 1, hp, 1)
    x = torch.arange(hp, dtype=torch.float32, device=dev).view(1, 1, 1, hp)
    tau = 2.0 * math.pi

    def col(name):  # [B, F] -> [B, F, 1, 1]
        return p[name][:, :, None, None]

    def mix(maps, amp, colour):  # [B,F,H,W], [B,F], [B,F,3] -> [B,H,W,3]
        return torch.einsum("bfhw,bfc->bhwc", maps,
                            amp.unsqueeze(-1) * colour)

    # smooth base: 3 full-patch cosine gratings
    fb = p["fb"].view(b, 3, 2)
    arg = tau * (fb[..., 0, None, None] * y + fb[..., 1, None, None] * x) \
        + col("phb")
    img = mix(torch.cos(arg), p["ab"], p["cb"].view(b, 3, 3))

    # windowed oriented gratings in the band
    cyx = p["cyx"].view(b, 6, 2)
    ly = y - cyx[..., 0, None, None]
    lx = x - cyx[..., 1, None, None]
    win = torch.exp(-(ly * ly + lx * lx) / (2.0 * col("sig") ** 2))
    th = col("th")
    carrier = torch.cos(tau * col("f") * (torch.cos(th) * ly
                                          + torch.sin(th) * lx) + col("ph"))
    img = img + mix(win * carrier, p["ag"], p["cg"].view(b, 6, 3))

    # soft checkerboards in a soft rectangular window
    offs, ctr = p["offs"].view(b, 2, 2), p["ctr"].view(b, 2, 2)
    fc, half = col("fc"), col("half")
    by = torch.cos(tau * fc * (y - offs[..., 0, None, None]))
    bx = torch.cos(tau * fc * (x - offs[..., 1, None, None]))
    wy = torch.sigmoid((half - (y - ctr[..., 0, None, None]).abs()) / 3.0)
    wx = torch.sigmoid((half - (x - ctr[..., 1, None, None]).abs()) / 3.0)
    img = img + mix(by * bx * wy * wx, p["ac"], p["cc"].view(b, 2, 3))

    # strokes: a Gaussian ridge along a segment
    p0 = p["p0"].view(b, 4, 2)
    ang, ln = col("ang"), col("ln")
    dy, dx = torch.sin(ang) * ln, torch.cos(ang) * ln
    den = dy * dy + dx * dx + 1e-9
    ry = y - p0[..., 0, None, None]
    rx = x - p0[..., 1, None, None]
    tt = torch.clamp((ry * dy + rx * dx) / den, 0.0, 1.0)
    dist = torch.hypot(ry - tt * dy, rx - tt * dx)
    sig_s = col("thick") / 2.0
    smask = torch.exp(-(dist * dist) / (2.0 * sig_s * sig_s))
    img = img + torch.einsum("bfhw,bf->bhw", smask, p["a_s"]).unsqueeze(-1)

    # soft step edges inside soft circles
    w_e = 0.5 / f_hi
    ec = p["ec"].view(b, 2, 2)
    ey = y - ec[..., 0, None, None]
    ex = x - ec[..., 1, None, None]
    inside = torch.sigmoid((col("rad") - torch.sqrt(ey * ey + ex * ex))
                           / (w_e * 0.5))
    eth = col("eth")
    sd = torch.sin(eth) * ey + torch.cos(eth) * ex
    edges = inside * torch.clamp(sd / w_e + 0.5, 0.0, 1.0)
    img = img + torch.einsum("bfhw,bf->bhw", edges, p["ae"]).unsqueeze(-1)

    flat = img.reshape(b, -1)
    lo = flat.amin(1).view(b, 1, 1, 1)
    span = torch.clamp(flat.amax(1).view(b, 1, 1, 1) - lo, min=1e-9)
    img = (img - lo) / span
    return torch.clamp(torch.floor(img * 255.0 + 0.5), 0.0, 255.0).to(
        torch.uint8)


def render_hr_batch(seed: Union[int, torch.Generator], batch: int, hp: int,
                    scale: int, device="cuda") -> torch.Tensor:
    """[batch, hp, hp, 3] uint8 HR patches on ``device``.  ``seed``: an
    int key, or a ``torch.Generator`` to draw one from.  Sample ``i`` is
    fixed by (key, i)."""
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 1 << 62, (1,), generator=seed))
    dev = resolve_device(device)
    params = draw_params(seed, batch, hp, scale)
    return _render(params.to(dev), hp, scale)


class DeviceSyntheticStream:
    """The train stream of ``synthetic_device``: ``next()`` yields
    ``(None, hr)``, ``hr`` a [batch, patch*scale, patch*scale, 3] uint8
    tensor rendered on ``device``.  Batch ``s`` is rendered from the key
    ``mix_seed(base, s)``, where ``base`` is ``opts.seed``, with
    ``start_step`` folded in on a resume so it continues on fresh
    content."""

    def __init__(self, opts, device, start_step: int = 0) -> None:
        self.device = resolve_device(device)
        self.batch, self.scale = opts.batch_size, opts.scale
        self.hp = opts.patch_size * opts.scale
        self._base = (mix_seed(opts.seed, start_step) if start_step
                      else opts.seed)
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[None, torch.Tensor]:
        key = mix_seed(self._base, self._step)
        self._step += 1
        return None, render_hr_batch(key, self.batch, self.hp, self.scale,
                                     self.device)

    def close(self) -> None:
        """Nothing to release (the loop closes every stream)."""
