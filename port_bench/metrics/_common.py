"""What every reader gets: :class:`Context`."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from port_bench.trace import Trace


@dataclasses.dataclass
class Request:
    """One request of the window: its images' LR size and count, the
    engine's grid and halos for it, and its host times (s)."""
    lr_hw: tuple
    images: int
    grid: tuple          # (nh, nw, th, tw), as the engine reports it
    halos: tuple         # (ovh, ovw) LR px
    start: float
    end: float


@dataclasses.dataclass
class Context:
    """A run's readings: the configuration and mix, the requests of the
    window, the window's host seconds, the kernels' launch counts over
    it, and the device trace (None without ``--trace 1`` or a card)."""
    model: dict
    mix: dict
    requests: List[Request]
    window_s: float
    launches: dict
    trace: Optional[Trace]
