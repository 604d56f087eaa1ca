"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device without CUDA raises:
    the port never carries on quietly on the CPU; the caller asks for it
    with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


def host_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``.  To a CUDA device the copy goes
    through pinned memory and does not wait: a copy from pageable memory
    synchronizes the stream, so the host could not queue the next step
    while the device runs this one."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@contextlib.contextmanager
def full_f32(device: torch.device):
    """float32 matmuls and cuDNN convs in full f32 (no TF32) on a CUDA
    device for the block, whatever the process set: cuDNN's convs default
    to TF32 (a 10-bit mantissa, ~1e-3 relative), which neither the LR
    synthesis' 0.05 dB parity budget nor a fold of the upsampler survives."""
    if device.type != "cuda":
        yield
        return
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
