"""Hand-written Hopper kernels (``pesr_torch/csrc``), each with its plain
PyTorch version beside it and a launch counter on its wrapper; the two
bf16 kernels also have a differentiable form (``*_train``: the kernel
forward, a backward of library convolution gradients that recomputes
only what they read).  :func:`launch_counts` gives the bf16 kernels'
counters, RCAN's block and excite (``rcab.py``, inference only) among
them; the int8 block's (an inference-only path) is
``fused_resblock_int8.launches``, and ``fused_rcab.waves`` counts the
RCAB's waves of CTAs: :func:`reset_launch_counts` resets both too."""

from pesr_torch.ops.kernels.resblock import (fused_resblock,  # noqa: F401
                                             fused_resblock_train,
                                             pack_resblock,
                                             resblock_reference)
from pesr_torch.ops.kernels.upsampler import (  # noqa: F401
    fused_upsampler_stage, fused_upsampler_stage_train, pack_upsampler_stage,
    upsampler_stage_reference)
from pesr_torch.ops.kernels.resblock_int8 import (  # noqa: F401
    fused_resblock_int8, int8_resblock_reference, pack_int8_block_weights)
from pesr_torch.ops.kernels.rcab import (  # noqa: F401
    excite_reference, fused_rcab, pack_squeeze, rcab_excite, rcab_reference)


def reset_launch_counts() -> None:
    fused_resblock.launches = 0
    fused_upsampler_stage.launches = 0
    fused_resblock_int8.launches = 0
    fused_rcab.launches = 0
    fused_rcab.waves = 0
    rcab_excite.launches = 0


def launch_counts() -> dict:
    return {"fused_resblock": fused_resblock.launches,
            "fused_upsampler_stage": fused_upsampler_stage.launches,
            "fused_rcab": fused_rcab.launches,
            "rcab_excite": rcab_excite.launches}
