"""Device selection for the port's entry points."""

from __future__ import annotations

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
