"""Training entry point of the port (counterpart of the repo's
``train.py``): the L1 pretrain phase through the hand-written kernels.

    python -m pesr_torch.train --phase pretrain --train_dataset DIV2K \\
        --batch_size 16 --patch_size 48 --scale 4
    python -m pesr_torch.train --device cpu --num_blocks 2 \\
        --num_channels 16 --batch_size 2 --patch_size 24 \\
        --steps_per_epoch 4 --num_epochs 1 --train_dataset synthetic \\
        --valid_dataset synthetic --check_point /tmp/c

Prints the JSONL scalars as they are logged and a last ``[done] {...}``
summary line.  Data parallel on N processes, one device each:

    torchrun --nproc_per_node 2 -m pesr_torch.train --distributed \
        --mesh_shape 2 ...
    PESR_COORDINATOR=host:port PESR_NUM_PROCESSES=2 PESR_PROCESS_ID=r \
        python -m pesr_torch.train --distributed --mesh_shape 2 ...
"""

from __future__ import annotations

import json
import sys

import torch.distributed as dist

from pesr_torch import parallel
from pesr_torch.config import opts_from_args
from pesr_torch.training.loop import run_training


def main(argv=None) -> int:
    opts = opts_from_args(argv, mode="train")
    if opts.distributed:
        parallel.initialize_distributed(required=True, device=opts.device)
        print(f"distributed: process {dist.get_rank()} of "
              f"{dist.get_world_size()} ({dist.get_backend()})")
    try:
        summary = run_training(opts)
    finally:
        if opts.distributed:
            dist.destroy_process_group()
    print("[done] " + json.dumps({k: round(v, 4)
                                  for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
