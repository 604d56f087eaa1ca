"""The program's own ranges in the window (``pesr_torch/utils/spans.py``:
``record_function`` ranges of the calling thread, on the host's clock),
grouped by request and held against the runner's requests: one
``pesr.request`` range per request, and in each as many
``pesr.forward`` ranges as its grid has tile positions.  A program
without the ranges (or a count that disagrees) gives None.

The trace's device events are on another clock, which on the H100 has
been seen to wander from the host's by up to 7.5 ms within a window, at
up to 1.6 ms a second (a kernel stamped before the call that launched
it).  So a request's device operations are found by order, not by time
(the engine waits for each request's download, so the window's
operations split after each device-to-host copy, one part per request),
and are placed on the host's clock by the offset at the nearest upload:
the upload waits for the device, so the first operation after it starts
as its launch call starts (~10 us later)."""

from __future__ import annotations

import bisect
import dataclasses
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from port_bench.metrics._common import Context

REQUEST = "pesr.request"
Span = Tuple[float, float]


def request_spans(ctx: Context, metric: str
                  ) -> Optional[List[Tuple[Span, Dict[str, List[Span]]]]]:
    """Per request of the window, in order: its ``pesr.request`` range
    and the ``pesr.*`` ranges and CUDA runtime calls inside it by name
    (host us)."""
    if ctx.trace is None or not ctx.requests:
        return None
    host = ctx.trace.host
    starts = [a for a, _, _ in host]
    reqs = [(a, b) for a, b, n in host if n == REQUEST]
    if len(reqs) != len(ctx.requests):
        print(f"[port_bench] {metric}: {len(reqs)} {REQUEST} ranges in the "
              f"trace, {len(ctx.requests)} requests: no reading",
              file=sys.stderr)
        return None
    out = []
    for k, ((a, b), r) in enumerate(zip(reqs, ctx.requests)):
        inner: Dict[str, List[Span]] = defaultdict(list)
        for s, e, n in host[bisect.bisect_left(starts, a):
                            bisect.bisect_right(starts, b)]:
            if n.startswith(("pesr.", "cuda")) and n != REQUEST and e <= b:
                inner[n].append((s, e))
        nh, nw = r.grid[:2]
        if len(inner["pesr.forward"]) != nh * nw:
            print(f"[port_bench] {metric}: request {k} holds "
                  f"{len(inner['pesr.forward'])} pesr.forward ranges, its "
                  f"grid {nh} x {nw}: no reading", file=sys.stderr)
            return None
        out.append(((a, b), inner))
    return out


LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemsetAsync",
            "cudaMemcpyAsync")


@dataclasses.dataclass
class Aligned:
    """A request whose device operations the trace holds, from its
    upload to its device-to-host copy: ``ops`` ``(start, end, cat,
    name)`` on the device's clock, and the device's clock minus the
    host's at its upload (``before``) and at the next request's
    (``after``; this request's own for the window's last)."""
    span: Span
    inner: Dict[str, List[Span]]
    ops: list
    before: float
    after: float


def _offset(inner: Dict[str, List[Span]], ops: list) -> Optional[float]:
    """The device's clock minus the host's at the first operation after
    the request's upload, or None."""
    up = [i for i, (_, _, c, n) in enumerate(ops)
          if c == "gpu_memcpy" and "HtoD" in n]
    if len(inner["pesr.upload"]) != 1 or not up or up[0] + 1 >= len(ops):
        return None
    done = inner["pesr.upload"][0][1]
    calls = [a for name in LAUNCHES for a, _ in inner[name] if a >= done]
    return ops[up[0] + 1][0] - min(calls) if calls else None


def aligned_requests(ctx: Context, metric: str) -> Optional[List[Aligned]]:
    """The window's requests with their device operations placed (see
    the module's note); a request whose upload or copy the traced window
    cut off is left out, with a line on stderr."""
    reqs = request_spans(ctx, metric)
    if reqs is None:
        return None
    dev = ctx.trace.device
    cuts = [i for i, (_, _, c, name) in enumerate(dev)
            if c == "gpu_memcpy" and "DtoH" in name]
    if not len(reqs) - 1 <= len(cuts) <= len(reqs):
        print(f"[port_bench] {metric}: {len(cuts)} device-to-host copies "
              f"in the trace, {len(reqs)} requests: no reading",
              file=sys.stderr)
        return None
    parts = [dev[lo + 1:hi + 1] for lo, hi in zip([-1] + cuts, cuts)]
    offsets = [_offset(inner, ops) for (_, inner), ops in zip(reqs, parts)]
    out = []
    for k, (((span, inner), ops), before) in enumerate(
            zip(zip(reqs, parts), offsets)):
        after = offsets[k + 1] if k + 1 < len(offsets) else before
        if before is not None and after is not None:
            out.append(Aligned(span, inner, ops, before, after))
    if len(out) < len(reqs):
        print(f"[port_bench] {metric}: {len(reqs) - len(out)} of "
              f"{len(reqs)} requests left out (the traced window cut off "
              f"their upload or copy)", file=sys.stderr)
    if not out:
        return None
    return out
