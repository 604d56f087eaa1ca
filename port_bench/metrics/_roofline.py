"""A residual-block kernel's share of its roofline: the least time of
every launch of the window at the shape it was given (the counts of
``reference/counts.py``) over the kernels' summed trace time."""

from __future__ import annotations

import sys
from typing import Optional

from port_bench.metrics._common import Context
from port_bench.reference.counts import resblock_seconds


def resblock_roofline(ctx: Context, pattern: str, int8: bool,
                      counter: str) -> Optional[float]:
    if ctx.trace is None:
        return None
    found = ctx.trace.kernels(pattern)
    c, least, launches = ctx.model["num_channels"], 0.0, 0
    for r in ctx.requests:
        nh, nw, th, tw = r.grid
        ovh, ovw = r.halos
        n = nh * nw * ctx.model["num_blocks"]
        launches += n
        least += n * resblock_seconds(r.images, th + 2 * ovh, tw + 2 * ovw,
                                      c, int8)
    counted = ctx.launches.get(counter)
    if not found or len(found) != launches or counted != launches:
        print(f"[port_bench] {counter}: {len(found)} kernels in the trace, "
              f"{counted} counted, {launches} expected from the grids: "
              f"no roofline", file=sys.stderr)
        return None
    return 100.0 * least / (sum(b - a for a, b, _ in found) * 1e-6)
