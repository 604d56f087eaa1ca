"""``fused_rcab`` (csrc/rcab.cu): the RCAB path's share of its roofline
over the window.  The least time of every RCAB at the shape it was
given (``num_groups x num_blocks`` per tile position, the tile with its
halos; ``rcab_seconds`` of ``reference/families/rcan.py``) over the
summed trace time of every kernel the RCAB path launches: the block and
the excite of each group's last block (name patterns of
``programs/rcan.py``), so a design that splits the block into more
kernels reads lower on the same yardstick.  The launches are held to the
counters and the grids: a block per RCAB, an excite per group."""

from __future__ import annotations

import sys

from port_bench.reference.families import rcan as family


def read(ctx, suffix):
    if ctx.trace is None:
        return None
    from port_bench.programs import rcan as program
    m = ctx.model
    blocks = m["num_groups"] * m["num_blocks"]
    least, positions = 0.0, 0
    for r in ctx.requests:
        nh, nw, th, tw = r.grid
        ovh, ovw = r.halos
        positions += nh * nw
        least += nh * nw * blocks * family.rcab_seconds(
            m, r.images, th + 2 * ovh, tw + 2 * ovw)
    found = {}
    for counter, pattern, want in (
            ("fused_rcab", program.BLOCK_PATTERN, positions * blocks),
            ("rcab_excite", program.EXCITE_PATTERN,
             positions * m["num_groups"])):
        found[counter] = ctx.trace.kernels(pattern)
        counted = ctx.launches.get(counter)
        if not found[counter] or len(found[counter]) != want \
                or counted != want:
            print(f"[port_bench] fused_rcab_roofline: {counter}: "
                  f"{len(found[counter])} kernels in the trace, {counted} "
                  f"counted, {want} expected from the grids: no roofline",
                  file=sys.stderr)
            return None
    spent = sum(b - a for ks in found.values() for a, b, _ in ks) * 1e-6
    return 100.0 * least / spent
