"""The one traffic generator: it reads a mix file and the run's seed and
gives the images, the calibration crops and the order of the requests.

A mix (``mixes/<name>.json``) names its size ``classes`` by HR size
(the LR size is ``hr // scale`` for each configuration), each with a
``count`` per block of requests.  Every block holds the same images in
another order, shuffled by the seed; ``pool_blocks`` blocks of distinct
images are rendered at set-up, on the device, and kept in host memory,
where the requests start.  A request is ``batch`` consecutive images of
the sequence, all of one size class (the classes of a batched mix have
``count`` a multiple of ``batch``).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from port_bench.traffic.render import render


def lr_size(hr_hw, scale: int) -> Tuple[int, int]:
    return hr_hw[0] // scale, hr_hw[1] // scale


class Traffic:
    """The images and requests of ``mix`` for a model at ``scale``,
    from ``seed`` (any non-negative integer), rendered on ``device``;
    ``shrink`` divides every HR size (a CPU rehearsal)."""

    def __init__(self, mix: dict, scale: int, seed: int,
                 device: torch.device, shrink: int = 1) -> None:
        self.batch = int(mix["batch"])
        self.rng = np.random.default_rng(seed)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        band = tuple(mix["band"])
        self.classes = []       # per class: LR (h, w)
        self.slots: List[int] = []   # class of each slot of a block
        for k, cls in enumerate(mix["classes"]):
            if cls["count"] % self.batch:
                raise ValueError(f"class {cls['name']}: count "
                                 f"{cls['count']} is not a multiple of the "
                                 f"batch {self.batch}")
            hr = [v // shrink for v in cls["hr_hw"]]
            self.classes.append(lr_size(hr, scale))
            self.slots += [k] * cls["count"]
        self.pool_blocks = int(mix["pool_blocks"])
        # images[b][slot]: HWC uint8 numpy, block b of the pool
        self.images = [[None] * len(self.slots)
                       for _ in range(self.pool_blocks)]
        for k, (h, w) in enumerate(self.classes):
            where = [(b, s) for b in range(self.pool_blocks)
                     for s, c in enumerate(self.slots) if c == k]
            for at in range(0, len(where), 8):
                part = where[at:at + 8]
                imgs = render(gen, len(part), h, w, band).cpu().numpy()
                for (b, s), img in zip(part, imgs):
                    self.images[b][s] = img
        cal = mix.get("calibration")
        self.crops = None
        if cal:
            h, w = lr_size([v // shrink for v in cal["hr_hw"]], scale)
            img = render(gen, 1, h, w, band)[0].cpu().numpy()
            t, n = min(int(cal["crop"]), h, w), int(cal["crops"])
            ys = self.rng.integers(0, h - t + 1, n)
            xs = self.rng.integers(0, w - t + 1, n)
            crops = np.stack([img[y:y + t, x:x + t] for y, x in zip(ys, xs)])
            self.crops = crops.astype(np.float32) / 127.5 - 1.0

    def first_of_each_class(self) -> List[List[np.ndarray]]:
        """One request's images of every class (the warm-up)."""
        out = []
        for k in range(len(self.classes)):
            slots = [s for s, c in enumerate(self.slots) if c == k]
            out.append([self.images[0][s] for s in slots[:self.batch]])
        return out

    def requests(self) -> Iterator[Tuple[int, List[np.ndarray]]]:
        """``(class, images)`` forever: block after block, each block's
        slots in a fresh seeded order, grouped by class into requests of
        ``batch`` images in the order their first slot comes."""
        n_block = 0
        while True:
            block = self.images[n_block % self.pool_blocks]
            order = self.rng.permutation(len(self.slots))
            pending: dict = {}
            for s in order:
                k = self.slots[s]
                pending.setdefault(k, []).append(block[s])
                if len(pending[k]) == self.batch:
                    yield k, pending.pop(k)
            n_block += 1
