"""The generator: a seed fixes the images and the order; every seed gets
the same sizes; requests are batches of one size class."""

import collections
import itertools
import json

import numpy as np
import pytest
import torch

from port_bench.tests.helpers import ROOT
from port_bench.traffic.generate import Traffic


def _mix(name):
    return json.loads((ROOT / "port_bench" / "mixes" / f"{name}.json")
                      .read_text())


def _take(t, n):
    return list(itertools.islice(t.requests(), n))


def test_same_seed_same_traffic():
    cpu = torch.device("cpu")
    a = Traffic(_mix("single_photo"), 4, 2 ** 31 + 5, cpu, shrink=8)
    b = Traffic(_mix("single_photo"), 4, 2 ** 31 + 5, cpu, shrink=8)
    for (ka, ia), (kb, ib) in zip(_take(a, 45), _take(b, 45)):
        assert ka == kb and all(np.array_equal(x, y) for x, y in zip(ia, ib))
    np.testing.assert_array_equal(a.crops, b.crops)


def test_every_seed_sends_the_same_sizes():
    cpu = torch.device("cpu")
    blocks = []
    for seed in (1, 2, 3):
        t = Traffic(_mix("single_photo"), 4, seed, cpu, shrink=8)
        reqs = _take(t, 40)
        blocks.append([k for k, _ in reqs])
        for half in (reqs[:20], reqs[20:]):
            assert collections.Counter(k for k, _ in half) == {
                0: 6, 1: 6, 2: 5, 3: 3}
    assert blocks[0] != blocks[1] != blocks[2]


def test_shares_put_the_percentiles_inside_classes():
    counts = [c["count"] for c in _mix("single_photo")["classes"]]
    cum = np.cumsum(counts) / sum(counts)
    assert list(cum) == pytest.approx([0.3, 0.6, 0.85, 1.0])
    assert 0.3 < 0.5 < 0.6 and 0.85 < 0.95 < 1.0


@pytest.mark.parametrize("mix, scale, lr", [("batch_int8", 4, (63, 42)),
                                            ("batch_bf16", 2, (127, 84))])
def test_batches_are_of_one_size(mix, scale, lr):
    t = Traffic(_mix(mix), scale, 9, torch.device("cpu"), shrink=8)
    for k, imgs in _take(t, 5):
        assert len(imgs) == 8
        assert {im.shape for im in imgs} == {lr + (3,)}
    assert t.crops.shape[0] == 16 and t.crops.dtype == np.float32


def test_images_look_like_photos():
    t = Traffic(_mix("batch_int8"), 4, 11, torch.device("cpu"), shrink=4)
    img = t.images[0][0].astype(np.float64)
    assert img.min() == 0 and img.max() == 255
    # smooth: neighbouring pixels close on average, unlike uniform noise
    assert np.abs(np.diff(img, axis=0)).mean() < 20
