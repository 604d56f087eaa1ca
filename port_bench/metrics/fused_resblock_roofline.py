"""``fused_resblock`` (csrc/resblock.cu, bf16): its share of its
roofline over the window."""

from port_bench.metrics._roofline import resblock_roofline

PATTERN = r"resblock(_flat)?_kernel"


def read(ctx, suffix):
    return resblock_roofline(ctx, PATTERN, False, "fused_resblock")
