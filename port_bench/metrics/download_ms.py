"""The time a finished result takes to reach host memory: per request,
ms from the start of its device-to-host memcpy (placed on the host's
clock by the offset at the next upload, ``_spans.py``) to the end of its
``pesr.download`` range, mean over the window's requests.  The pageable
copy's host staging is in it, which ``memcpy_ms`` does not see."""

import sys

from port_bench.metrics._spans import aligned_requests


def read(ctx, suffix):
    reqs = aligned_requests(ctx, "download_ms")
    if reqs is None:
        return None
    total = 0.0
    for r in reqs:
        down = r.inner["pesr.download"]
        if len(down) != 1:
            print(f"[port_bench] download_ms: a request holds {len(down)} "
                  f"pesr.download ranges: no reading", file=sys.stderr)
            return None
        total += down[0][1] - (r.ops[-1][0] - r.after)
    return total * 1e-3 / len(reqs)
