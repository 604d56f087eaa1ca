"""``fused_resblock_int8`` (csrc/resblock_int8.cu): its share of its
roofline over the window, at the int8 peak."""

from port_bench.metrics._roofline import resblock_roofline

PATTERN = r"resblock_int8_kernel"


def read(ctx, suffix):
    return resblock_roofline(ctx, PATTERN, True, "fused_resblock_int8")
