"""Probe of ``torch._int_mm`` and the port's int8 conv on one GPU.

    python tools/int8_mm_probe.py

Prints Python, PyTorch, CUDA and the card's name; checks ``_int_mm``
against a float64 product with the weights column-major (the int8 conv's
layout) and row-major at a few shapes (K and N multiples of 8, M > 16);
then ``pesr_torch.ops.int8_conv.int8_conv`` against its plain version at
a tiny shape and at the folded x4 tile batch [2, 342, 516, 256], with
the mean time of 5 calls (CUDA events).  A quick first check of the
int8 route on a new card or PyTorch build; ``chip_smoke.py`` holds the
whole int8 path.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_mm_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from pesr_torch.ops.int8_conv import int8_conv, int8_conv_reference
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for m, k, n in ((17, 72, 16), (32, 2304, 256), (1000, 20736, 192)):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda")
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda")
        ref = (a.double() @ w.double().t()).to(torch.int32)
        for name, mat2 in (("w.t() col-major", w.t()),
                           ("contiguous [K,N]", w.t().contiguous())):
            try:
                out = torch._int_mm(a, mat2)
                print(m, k, n, name,
                      "ok" if torch.equal(out, ref) else "WRONG", flush=True)
            except RuntimeError as e:
                print(m, k, n, name, "raised", str(e)[:200], flush=True)
    for b, h, w, c, n in ((1, 2, 3, 64, 64), (2, 342, 516, 256, 256)):
        x = torch.randint(-127, 128, (b, h, w, c), dtype=torch.int8,
                          device="cuda")
        wq = torch.randint(-127, 128, (n, 3, 3, c), dtype=torch.int8,
                           device="cuda")
        same = torch.equal(int8_conv_reference(x, wq), int8_conv(x, wq))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            int8_conv(x, wq)
        end.record()
        torch.cuda.synchronize()
        print((b, h, w, c, n), "equal", same, "ms",
              start.elapsed_time(end) / 5, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
