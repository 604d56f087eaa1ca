"""Training entry point of the port (counterpart of the repo's
``train.py``): the L1 pretrain phase through the hand-written kernels.

    python -m pesr_torch.train --phase pretrain --train_dataset DIV2K \\
        --batch_size 16 --patch_size 48 --scale 4
    python -m pesr_torch.train --device cpu --num_blocks 2 \\
        --num_channels 16 --batch_size 2 --patch_size 24 \\
        --steps_per_epoch 4 --num_epochs 1 --train_dataset synthetic \\
        --valid_dataset synthetic --check_point /tmp/c

Prints the JSONL scalars as they are logged and a last ``[done] {...}``
summary line.
"""

from __future__ import annotations

import json
import sys

from pesr_torch.config import opts_from_args
from pesr_torch.training.loop import run_training


def main(argv=None) -> int:
    summary = run_training(opts_from_args(argv, mode="train"))
    print("[done] " + json.dumps({k: round(v, 4)
                                  for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
