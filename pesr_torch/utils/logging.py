"""Running means and the training loop's scalar log (counterpart of
``pesr_tpu/utils/logging.py``, without the TensorBoard mirror)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from pesr_torch.parallel import is_primary


class AverageMeter:
    """Running average of a scalar stream."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricLogger:
    """Scalar logger: one JSON record per call appended to
    ``<log_dir>/<name>.jsonl`` (when ``log_dir``), mirrored to stdout.

    In a process group only rank 0 writes the file: the scalars are the
    same on every rank, and every rank appending to one file on shared
    storage would interleave them.  stdout stays per process."""

    def __init__(self, log_dir: Optional[str], name: str = "train") -> None:
        self._fh = None
        if log_dir and is_primary():
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a",
                            buffering=1)
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = "") -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        body = " ".join(f"{k}={v:.4g}" for k, v in rec.items()
                        if k not in ("step", "time"))
        print(f"[{prefix or 'train'} step {step}] {body}", flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
