"""Named host ranges of the program, for the profiler.

``with span("pesr.forward"): ...`` is ``torch.profiler.record_function``
while a ``torch.profiler`` is recording, so the range lands in the same
Chrome trace as the device's kernel and memcpy events, nested in the
ranges open around it on the calling thread.  (The trace maps the
device's clock onto the host's only roughly: on the H100 the two were
seen to wander apart by up to 7.5 ms within a minute, so match device
work to a range by order, not by time alone.)  Without a profiler it
is one shared no-op context: a ``record_function`` costs ~13 us a range
even then, the flag read ~0.1 us.

Nothing switches the spans on but a running profiler: the train CLI's
``--profile_dir``, the test CLI's ``--profile_dir``, the benchmark's
``--trace 1`` or a caller's own ``torch.profiler.profile``.
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a range while a
    profiler records on this thread, else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def start_profile(device: torch.device) -> torch.profiler.profile:
    """A started ``torch.profiler`` of the host and, on a CUDA device, of
    the device (the CLIs' ``--profile_dir``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof: torch.profiler.profile, device: torch.device,
                 path: str, why: str = "") -> None:
    """Stop ``prof`` after the device has caught up and write its Chrome
    trace to ``path``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}" + (f" ({why})" if why else ""))
