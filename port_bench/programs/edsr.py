"""EDSR through the port: ``pesr_torch.models.generator.Generator`` with
the benchmark's weights, applied by ``KernelApply`` with the folded
upsampler on "bf16" (the test CLI's default) or by ``int8_inference``
calibrated on the mix's crops on "int8"."""

from __future__ import annotations

CONTROL_PATHS = {"bf16": "int8"}


def apply(model: dict, mix: dict, sd, crops, device, path: str):
    from pesr_torch.models.generator import Generator
    from pesr_torch.models.kernel_apply import KernelApply
    from pesr_torch.models.quant_apply import int8_inference
    g = Generator(model["scale"], model["num_blocks"], model["num_channels"],
                  model["res_scale"], model["img_channels"], device=device,
                  seed=None)
    g.load_state_dict(sd)
    if path == "int8":
        return int8_inference(g, [crops])
    if path == "bf16":
        return KernelApply(g, fold=True)
    raise ValueError(f"unknown path {path!r}")


def launches() -> dict:
    from pesr_torch.ops import kernels
    return {**kernels.launch_counts(),
            "fused_resblock_int8": kernels.fused_resblock_int8.launches}
