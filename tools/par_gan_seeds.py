"""Readings of ``chip_smoke.py``'s 2-rank GAN check over several seeds,
on one GPU.

    python tools/par_gan_seeds.py [SEED ...]      # default: 0 1 2 3

For each seed (G's and D's weights, the global batches), runs the
parallel phase's GAN comparison as the phase runs it: two gloo ranks x 8
on the card against one process x 16, each step from one state, plus
one step with the planted local-statistics fault.  Prints per step
|d d_loss|, |d g_loss|, the least gradient cosine over G's and over D's
tensors with the tensor that sets it (D's exact-zero-gradient tensors
left out, as the phase does, and kept, ``cos_d_all``), and whether the
step is within ``chip_smoke.GAN_LIMITS``; then the card's name and
power limit.  Shows how far a healthy run stays from the limits and a
faulty one from a pass, beyond the phase's one seed.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("par_gan_seeds: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(a) for a in argv] or [0, 1, 2, 3]
    keys = ("d_loss", "d_loss_ref", "g_loss", "g_loss_ref", "cos_g",
            "worst_g", "cos_d", "worst_d", "cos_d_all", "worst_d_all")
    with tempfile.TemporaryDirectory() as workdir:
        for seed in seeds:
            cs._run_ranks(cs._rank_argv(
                f"rank_train({workdir!r}, seed={seed}, cases=('gan',))"))
            with open(os.path.join(workdir, "par_train.json")) as fh:
                res = json.load(fh)
            for case in ("gan", "fault"):
                for k, r in enumerate(res[case]):
                    print(json.dumps({
                        "seed": seed, "case": case, "step": k + 1,
                        **{n: r[n] for n in keys},
                        "within": cs._par_within("gan", r)}), flush=True)
    print(cs.gpu_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
