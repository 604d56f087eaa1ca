"""Photo-like test images, rendered on the device from a seed.

A copy of the port's ``synthetic_device`` procedural family (itself the
JAX renderer's), cut loose from the program and made rectangular: a
smooth base of 3 low-frequency cosine gratings, 6 Gaussian-windowed
oriented gratings, 2 soft checkerboards, 4 strokes with a Gaussian
cross-profile and 2 soft step edges inside soft circles, normalised to
the full uint8 range.  Feature frequencies lie in ``band`` (cycles per
px); positions are drawn over each axis, sizes against the shorter one.
Parameters come from one ``torch.Generator`` on the device, so a seed
fixes every image.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_TAU = 2.0 * math.pi


def _table(h: int, w: int, f_lo: float, f_hi: float):
    """(name, count, lo, hi) of one image's parameters; ``Y``/``X``
    mark a position along an axis (scaled by h or w)."""
    m = min(h, w)
    return (
        ("fb", 6, 0.5 / m, 4.8 / m), ("phb", 3, 0.0, _TAU),
        ("ab", 3, 0.05, 0.3), ("cb", 9, 0.3, 1.0),
        ("f", 6, f_lo, f_hi), ("th", 6, 0.0, math.pi),
        ("cy", 6, 0.05, 0.95), ("cx", 6, 0.05, 0.95),
        ("sig", 6, 0.08 * m, 0.25 * m),
        ("ph", 6, 0.0, _TAU), ("ag", 6, 0.25, 0.5), ("cg", 18, 0.5, 1.0),
        ("fc", 2, f_lo / math.sqrt(2.0), f_hi / math.sqrt(2.0)),
        ("offs", 4, 0.0, m), ("ctry", 2, 0.2, 0.8), ("ctrx", 2, 0.2, 0.8),
        ("half", 2, 0.15 * m, 0.35 * m), ("ac", 2, 0.3, 0.6),
        ("cc", 6, 0.5, 1.0),
        ("p0y", 4, 0.0, 1.0), ("p0x", 4, 0.0, 1.0), ("ang", 4, 0.0, math.pi),
        ("ln", 4, 0.15 * m, 0.7 * m), ("thick", 4, 0.5 / f_hi, 0.5 / f_lo),
        ("a_s", 4, -0.9, 0.9),
        ("ecy", 2, 0.0, 1.0), ("ecx", 2, 0.0, 1.0),
        ("rad", 2, 0.1 * m, 0.3 * m),
        ("eth", 2, 0.0, math.pi), ("ae", 2, -0.5, 0.5),
    )


@torch.no_grad()
def render(gen: torch.Generator, n: int, h: int, w: int,
           band: Tuple[float, float]) -> torch.Tensor:
    """[n, h, w, 3] uint8 on ``gen``'s device."""
    dev = gen.device
    table = _table(h, w, *band)
    lo = torch.tensor([t[2] for t in table for _ in range(t[1])],
                      device=dev)
    hi = torch.tensor([t[3] for t in table for _ in range(t[1])],
                      device=dev)
    u = torch.rand((n, lo.numel()), generator=gen, device=dev)
    flat = lo + (hi - lo) * u
    p, at = {}, 0
    for name, k, _, _ in table:
        p[name] = flat[:, at:at + k]
        at += k
    p["cy"], p["p0y"], p["ecy"], p["ctry"] = (p[k] * h for k in
                                             ("cy", "p0y", "ecy", "ctry"))
    p["cx"], p["p0x"], p["ecx"], p["ctrx"] = (p[k] * w for k in
                                             ("cx", "p0x", "ecx", "ctrx"))
    y = torch.arange(h, dtype=torch.float32, device=dev).view(1, 1, h, 1)
    x = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, 1, w)

    def col(name):
        return p[name][:, :, None, None]

    def mix(maps, amp, colour):
        return torch.einsum("bfhw,bfc->bhwc", maps,
                            amp.unsqueeze(-1) * colour)

    fb = p["fb"].view(n, 3, 2)
    arg = _TAU * (fb[..., 0, None, None] * y + fb[..., 1, None, None] * x) \
        + col("phb")
    img = mix(torch.cos(arg), p["ab"], p["cb"].view(n, 3, 3))

    ly, lx = y - col("cy"), x - col("cx")
    win = torch.exp(-(ly * ly + lx * lx) / (2.0 * col("sig") ** 2))
    th = col("th")
    carrier = torch.cos(_TAU * col("f") * (torch.cos(th) * ly
                                           + torch.sin(th) * lx) + col("ph"))
    img = img + mix(win * carrier, p["ag"], p["cg"].view(n, 6, 3))

    offs = p["offs"].view(n, 2, 2)
    fc, half = col("fc"), col("half")
    by = torch.cos(_TAU * fc * (y - offs[..., 0, None, None]))
    bx = torch.cos(_TAU * fc * (x - offs[..., 1, None, None]))
    wy = torch.sigmoid((half - (y - col("ctry")).abs()) / 3.0)
    wx = torch.sigmoid((half - (x - col("ctrx")).abs()) / 3.0)
    img = img + mix(by * bx * wy * wx, p["ac"], p["cc"].view(n, 2, 3))

    ang, ln = col("ang"), col("ln")
    dy, dx = torch.sin(ang) * ln, torch.cos(ang) * ln
    den = dy * dy + dx * dx + 1e-9
    ry, rx = y - col("p0y"), x - col("p0x")
    tt = torch.clamp((ry * dy + rx * dx) / den, 0.0, 1.0)
    dist = torch.hypot(ry - tt * dy, rx - tt * dx)
    sig_s = col("thick") / 2.0
    smask = torch.exp(-(dist * dist) / (2.0 * sig_s * sig_s))
    img = img + torch.einsum("bfhw,bf->bhw", smask, p["a_s"]).unsqueeze(-1)

    w_e = 0.5 / band[1]
    ey, ex = y - col("ecy"), x - col("ecx")
    inside = torch.sigmoid((col("rad") - torch.sqrt(ey * ey + ex * ex))
                           / (w_e * 0.5))
    eth = col("eth")
    sd = torch.sin(eth) * ey + torch.cos(eth) * ex
    edges = inside * torch.clamp(sd / w_e + 0.5, 0.0, 1.0)
    img = img + torch.einsum("bfhw,bf->bhw", edges, p["ae"]).unsqueeze(-1)

    flat = img.reshape(n, -1)
    lo_v = flat.amin(1).view(n, 1, 1, 1)
    span = torch.clamp(flat.amax(1).view(n, 1, 1, 1) - lo_v, min=1e-9)
    img = (img - lo_v) / span
    return torch.clamp(torch.floor(img * 255.0 + 0.5), 0.0, 255.0).to(
        torch.uint8)
