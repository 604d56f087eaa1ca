"""RCAN through the port: ``pesr_torch.models.rcan.RCAN`` with the
benchmark's weights, applied by ``RCANKernelApply`` with the folded
upsampler on "bf16": one ``fused_rcab`` launch per RCAB and one
``rcab_excite`` per residual group.  The program has no lower path
(the control is the reference's float8 forward).

Imports the port at once, so a checkout whose ``pesr_torch`` has no
RCAN stops before any set-up."""

from __future__ import annotations

from pesr_torch.models.rcan import RCAN
from pesr_torch.models.rcan_apply import RCANKernelApply

CONTROL_PATHS: dict = {}
# the RCAB path's kernels in a trace (fused_rcab_roofline): the block
# and the excite of a group's last block
BLOCK_PATTERN = r"rcab_kernel"
EXCITE_PATTERN = r"rcab_excite_kernel"


def apply(model: dict, mix: dict, sd, crops, device, path: str):
    if path != "bf16":
        raise ValueError(f"unknown path {path!r}")
    m = RCAN(model["scale"], model["num_groups"], model["num_blocks"],
             model["num_channels"], model["reduction"], model["img_channels"],
             device=device, seed=None)
    m.load_state_dict({**m.state_dict(), **sd}, strict=True)
    return RCANKernelApply(m)


def launches() -> dict:
    from pesr_torch.ops import kernels
    counts = kernels.launch_counts()
    return {k: counts[k] for k in ("fused_rcab", "rcab_excite")}
