"""Hand-written Hopper kernels (``pesr_torch/csrc``), each with its plain
PyTorch version beside it and a launch counter on its wrapper, and a
differentiable form (``*_train``: the kernel forward, a backward
recomputed through the plain version)."""

from pesr_torch.ops.kernels.resblock import (fused_resblock,  # noqa: F401
                                             fused_resblock_train,
                                             pack_resblock,
                                             resblock_reference)
from pesr_torch.ops.kernels.upsampler import (  # noqa: F401
    fused_upsampler_stage, fused_upsampler_stage_train, pack_upsampler_stage,
    upsampler_stage_reference)


def reset_launch_counts() -> None:
    fused_resblock.launches = 0
    fused_upsampler_stage.launches = 0


def launch_counts() -> dict:
    return {"fused_resblock": fused_resblock.launches,
            "fused_upsampler_stage": fused_upsampler_stage.launches}
