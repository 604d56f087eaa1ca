"""Host ms a request spends issuing its forwards: its ``pesr.forward``
ranges summed, mean over the window's requests.  Beside the device's
busy ms in a request it says whether the host or the device sets a
small photo's pace (a forward never waits on the device)."""

from port_bench.metrics._spans import request_spans


def read(ctx, suffix):
    reqs = request_spans(ctx, "enqueue_ms")
    if reqs is None:
        return None
    return sum(b - a for _, inner in reqs
               for a, b in inner["pesr.forward"]) * 1e-3 / len(reqs)
