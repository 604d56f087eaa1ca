"""The device's idle ms inside a request, mean over the window's
requests: its ``pesr.request`` range less the union of its own kernel,
memcpy and memset intervals (placed on the host's clock as
``_spans.py`` says: its first operation by the offset at its upload, its
last by the offset at the next one).  With ``idle_pct`` it splits the
window's idle time into the program's share (inside requests) and the
caller's (between them)."""

from port_bench.metrics._spans import aligned_requests


def busy_us(ops) -> float:
    """The length of the union of the ``(start, end, ...)`` intervals,
    sorted by start."""
    total, hi = 0.0, float("-inf")
    for a, b, *_ in ops:
        if b > hi:
            total += b - max(a, hi)
            hi = b
    return total


def idle_us(r) -> float:
    """Before the first operation, between operations, after the last."""
    first, last = r.ops[0][0], max(b for _, b, *_ in r.ops)
    return ((first - r.before - r.span[0]) + (last - first - busy_us(r.ops))
            + (r.span[1] - (last - r.after)))


def read(ctx, suffix):
    reqs = aligned_requests(ctx, "request_idle_ms")
    if reqs is None:
        return None
    return sum(idle_us(r) for r in reqs) * 1e-3 / len(reqs)
