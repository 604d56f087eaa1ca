"""Reading a torch.profiler Chrome trace of a measured window.

The window is the host span ``port_bench.window`` that the runner opens
around it; device operations are the trace's ``kernel``, ``gpu_memcpy``
and ``gpu_memset`` events that start inside it.  Times are in
microseconds, as the trace has them."""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
WINDOW = "port_bench.window"


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name)
    return name.replace("void ", "", 1).strip()[:160]


class Trace:
    """The device and host events of one window."""

    def __init__(self, events: List[dict]) -> None:
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"no {WINDOW!r} span in the trace")
        w = spans[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_tid = w.get("tid")
        self.device = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e.get("cat"), e.get("name", ""))
             for e in events if e.get("ph") == "X"
             and e.get("cat") in DEVICE_CATS
             and self.t0 <= float(e["ts"]) < self.t1))
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", ""))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("tid") == self.window_tid
            and e.get("name") != WINDOW
            and float(e["ts"]) < self.t1
            and float(e["ts"]) + float(e.get("dur", 0.0)) > self.t0)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device-operation intervals, clipped to the
        window."""
        out: List[List[float]] = []
        for a, b, _, _ in self.device:
            b = min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernels(self, pattern: str) -> List[Tuple[float, float, str]]:
        """``(start, end, name)`` of the kernels whose name matches the
        regular expression."""
        rx = re.compile(pattern)
        return [(a, b, n) for a, b, c, n in self.device
                if c == "kernel" and rx.search(n)]

    def sum_us(self, cat: str) -> float:
        return sum(b - a for a, b, c, _ in self.device if c == cat)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The device operations that took most time, in seconds."""
        acc: Dict[str, float] = defaultdict(float)
        for a, b, c, name in self.device:
            key = short_name(name) if c == "kernel" else c
            acc[key] += (b - a) * 1e-6
        return sorted(acc.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The window's idle time between device operations, summed by
        the innermost host call running at each gap's midpoint (host
        calls of one thread nest), in seconds, most first."""
        busy = self.busy()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = sorted((edges[i] + (edges[i + 1] - edges[i]) / 2.0,
                       edges[i + 1] - edges[i])
                      for i in range(0, len(edges) - 1, 2)
                      if edges[i + 1] > edges[i])
        acc: Dict[str, float] = defaultdict(float)
        stack: list = []
        j = 0
        for mid, length in gaps:
            while j < len(self.host) and self.host[j][0] <= mid:
                while stack and stack[-1][1] < self.host[j][0]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "(host code outside torch calls)"
            acc[name] += length * 1e-6
        return sorted(acc.items(), key=lambda kv: -kv[1])[:n]
