"""The port's metric-model fitters (``pesr_torch/metrics/forest.py``,
``fit_ma.py``, ``fit_natural.py``), the holdout loaders of
``pesr_torch/data/natural.py`` and ``pixel_unshuffle``, on the CPU.

The port fits without scikit-learn; scikit-learn and ``pesr_tpu`` appear
only here, as the references.  Tolerances: the forests' arrays bitwise
(float32 thresholds and values, and each tree's float64 ones); the
ladder's uint8 variants, the crops and the Ma features (float64; the
port's block DCT and gamma table are scipy's, as JAX's) bitwise;
NIQE's natural ``mu`` / ``cov`` bitwise JAX's refit on the same images.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pesr_torch.data import natural as P_natural
from pesr_torch.metrics import fit_ma as P_fit_ma
from pesr_torch.metrics import fit_natural as P_fit_natural
from pesr_torch.metrics import forest
from pesr_torch.metrics.ma_features import MaModel

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PACKAGED = os.path.join(_REPO, "pesr_torch", "metrics",
                         "ma_model_synthetic.npz")


def _assert_arrays_bitwise(got: dict, want: dict) -> None:
    """Every array but ``provenance`` equal in dtype, shape and bytes."""
    keys = set(want) - {"provenance"}
    assert set(got) - {"provenance"} == keys
    for k in sorted(keys):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


# --------------------------------------------------------------------------
# (a) the forest against scikit-learn
# --------------------------------------------------------------------------


def _forest_case(kind: str, n: int, f: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "integer":              # heavy ties on every feature
        x = rng.integers(0, 4, (n, f)).astype(np.float64)
    elif kind == "continuous":
        x = rng.normal(size=(n, f))
    elif kind == "near":               # float32 ulps at 1.0: values tied
        x = 1.0 + rng.normal(size=(n, f)) * 3e-7   # or within 1e-7
    else:                              # "mixed"
        x = rng.normal(size=(n, f))
        x[:, ::3] = np.round(x[:, ::3] * 2)          # tied columns
        if f > 2:
            x[:, 1] = x[:, 0]                        # a duplicated column
        if f > 3:
            x[:, 2] = 1.5                            # a constant column
        k = max(1, n // 4)
        x[:k] = x[n - k:]                            # duplicated rows
    y = (rng.normal(size=n) if seed % 2
         else rng.integers(0, 5, n).astype(np.float64))
    return x, y


# (kind, n rows, features, trees, max depth, seed): n 5-200, features
# 1-80, trees 1-12, depth 1-8 and unlimited
_FOREST_CASES = [
    ("near", 150, 10, 3, None, 13),
    ("integer", 60, 5, 2, None, 14),
    ("integer", 5, 1, 1, 1, 0),
    ("integer", 37, 6, 4, 8, 1),
    ("integer", 120, 20, 3, 5, 2),
    ("integer", 200, 9, 2, 8, 3),
    ("continuous", 7, 80, 2, 3, 4),
    ("continuous", 64, 12, 12, 4, 5),
    ("continuous", 200, 75, 3, 7, 77),
    ("mixed", 16, 4, 5, 8, 7),
    ("mixed", 90, 30, 6, 6, 8),
    ("mixed", 150, 3, 12, 2, 9),
    ("mixed", 200, 18, 2, 8, 11),
    ("mixed", 41, 1, 3, 8, 12),
]


@pytest.mark.parametrize("kind,n,f,trees,depth,seed", _FOREST_CASES)
def test_forest_matches_sklearn_node_for_node(kind, n, f, trees, depth,
                                              seed):
    ensemble = pytest.importorskip("sklearn.ensemble")
    from pesr_tpu.metrics.fit_ma import _export_forest
    x, y = _forest_case(kind, n, f, seed)
    ref = ensemble.RandomForestRegressor(
        n_estimators=trees, max_depth=depth, random_state=seed).fit(x, y)
    got = forest.fit_forest(x, y, n_trees=trees, max_depth=depth, seed=seed)
    _assert_arrays_bitwise(forest.forest_arrays(got, "g"),
                           _export_forest(ref, "g"))
    for est, tree in zip(ref.estimators_, got):
        t = est.tree_
        assert np.array_equal(t.threshold, tree.threshold)
        assert np.array_equal(t.value.reshape(-1), tree.value)
    assert sum(t.node_count for t in got) > len(got)  # the trees split


def test_simultaneous_sort_orders_ties_as_sklearn():
    sorting = pytest.importorskip("sklearn.utils._sorting")
    rng = np.random.default_rng(0)
    for n in (1, 2, 15, 16, 17, 64, 200, 513):
        for vals in (rng.integers(0, 3, n), rng.integers(0, 40, n),
                     rng.normal(size=n), np.zeros(n),
                     np.arange(n)[::-1], np.arange(n) % 7):
            v = np.ascontiguousarray(vals, np.float32)
            rows = np.arange(n, dtype=np.intp)[::-1].copy()
            want_v, want_r = v.copy(), rows.copy()
            sorting._py_simultaneous_sort(want_v, want_r, n,
                                          use_three_way_partition=True)
            got_v, got_r = v.tolist(), rows.tolist()
            forest.simultaneous_sort(got_v, got_r)
            assert got_r == want_r.tolist()
            assert np.array_equal(np.asarray(got_v, np.float32), want_v)


def test_heapsort_fallback_sorts():
    """The introsort's heapsort (past 2 log2 n partition levels) keeps
    values and rows paired and sorted."""
    rng = np.random.default_rng(1)
    v = rng.integers(0, 9, 100).astype(np.float64).tolist()
    rows = list(range(100))
    pairs = sorted(zip(v, rows))
    forest._introsort_3way(v, rows, 0, 100, 0)
    assert v == sorted(v)
    assert sorted(zip(v, rows)) == pairs


def test_forest_refuses_bad_input():
    x = np.ones((4, 2))
    with pytest.raises(ValueError, match="finite"):
        forest.fit_forest(np.where(np.eye(4, 2) > 0, np.nan, x),
                          np.arange(4.0), n_trees=1)
    with pytest.raises(ValueError, match="pair up"):
        forest.fit_forest(x, np.arange(3.0), n_trees=1)
    with pytest.raises(ValueError, match=">= 1"):
        forest.fit_forest(x, np.arange(4.0), n_trees=0)


# --------------------------------------------------------------------------
# (b)-(d) fit_ma against JAX's and the packaged model
# --------------------------------------------------------------------------


def test_ladder_crops_and_training_set_match_jax():
    from pesr_tpu.data.datasets import SyntheticImages as JSynth
    from pesr_tpu.metrics import fit_ma as J_fit_ma
    img = JSynth(num_images=1, height=96, width=120, seed=3).get(0)
    ladders = [f.degradation_ladder(img, np.random.default_rng(5))
               for f in (P_fit_ma, J_fit_ma)]
    assert len(ladders[0]) == len(ladders[1]) == 8
    for (pv, ps), (jv, js) in zip(*ladders):
        assert ps == js and pv.dtype == jv.dtype == np.uint8
        assert np.array_equal(pv, jv)

    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8)
            for s in ((200, 700, 3), (100, 400, 3), (600, 600, 3))]
    for kw in ({}, {"crop": 96, "max_crops_per_image": 5}):
        pc = P_fit_ma.crops_from_images(imgs, **kw)
        jc = J_fit_ma.crops_from_images(imgs, **kw)
        assert len(pc) == len(jc) > 0
        assert all(np.array_equal(a, b) for a, b in zip(pc, jc))

    (px, py), (jx, jy) = (f.build_training_set(num_images=2)
                          for f in (P_fit_ma, J_fit_ma))
    assert np.array_equal(py, jy) and len(py) == 16
    for g in ("dct", "wavelet", "pca"):
        assert px[g].shape == jx[g].shape
        np.testing.assert_array_equal(px[g], jx[g])


def test_fit_ma_model_matches_jax():
    from pesr_tpu.metrics import fit_ma as J_fit_ma
    got = P_fit_ma.fit_ma_model(num_images=4)
    want = J_fit_ma.fit_ma_model(num_images=4)
    _assert_arrays_bitwise(got.arrays, want.arrays)
    assert "pesr_torch/metrics/fit_ma.py" in str(got.arrays["provenance"])


def test_fit_ma_cli_refits_the_packaged_model(tmp_path):
    out = tmp_path / "ma.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "pesr_torch.metrics.fit_ma", "--out",
         str(out)], cwd=_REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ordering correct on 4/4 held-out images" in proc.stdout
    _assert_arrays_bitwise(MaModel.load(str(out)).arrays,
                           MaModel.load(_PACKAGED).arrays)


# --------------------------------------------------------------------------
# (e) fit_natural against JAX's on the same small images
# --------------------------------------------------------------------------


def _small_registry_images(count: int):
    """``count`` registry photographs, 288 x 288 crops of their corners."""
    out = []
    for e in P_natural.REGISTRY:
        path = P_natural.resolve(e)
        if path and not e.holdout:
            out.append((e.name, P_natural._load(e, path)[:288, :288]))
        if len(out) == count:
            return out
    pytest.skip("fewer registry images installed than the test needs")


def _patch_registries(monkeypatch, named, holdouts):
    from pesr_tpu.metrics import natural_images as J_natural
    for mod in (P_natural, J_natural):
        monkeypatch.setattr(mod, "load_natural_images", lambda: named)
        monkeypatch.setattr(mod, "load_holdout_images", lambda: holdouts)


def test_fit_natural_matches_jax(monkeypatch, tmp_path, capsys):
    from pesr_tpu.metrics import fit_natural as J_fit_natural
    named = _small_registry_images(5)
    _patch_registries(monkeypatch, named[:4], named[4:])
    rcs, outs = [], []
    for side, mod in (("port", P_fit_natural), ("jax", J_fit_natural)):
        niqe, ma = tmp_path / f"{side}_niqe.npz", tmp_path / f"{side}_ma.npz"
        rcs.append(mod.main(["--niqe_out", str(niqe), "--ma_out", str(ma)]))
        outs.append(capsys.readouterr().out.replace(str(niqe), "NIQE")
                    .replace(str(ma), "MA"))
    assert rcs[0] == rcs[1]
    assert outs[0] == outs[1]
    assert "holdout[" in outs[0] and "fitting on 4 natural images" in outs[0]
    _assert_arrays_bitwise(MaModel.load(str(tmp_path / "port_ma.npz")).arrays,
                           MaModel.load(str(tmp_path / "jax_ma.npz")).arrays)
    pn, jn = (np.load(tmp_path / f"{s}_niqe.npz") for s in ("port", "jax"))
    for k in ("mu", "cov"):
        np.testing.assert_array_equal(pn[k], jn[k])
    assert "pesr_torch/data/natural.py registry" in str(pn["provenance"])


def test_fit_natural_refuses_below_four_images(monkeypatch, tmp_path):
    from pesr_tpu.metrics import fit_natural as J_fit_natural
    named = _small_registry_images(3)
    _patch_registries(monkeypatch, named, [])
    msgs = []
    for mod in (P_fit_natural, J_fit_natural):
        with pytest.raises(SystemExit) as e:
            mod.main(["--niqe_out", str(tmp_path / "n.npz"),
                      "--ma_out", str(tmp_path / "m.npz")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("only 3 curated natural images found")
    assert not list(tmp_path.iterdir())


# --------------------------------------------------------------------------
# (f) the holdout loaders, (g) pixel_unshuffle, (h) no scikit-learn
# --------------------------------------------------------------------------


def test_holdout_loaders_match_jax():
    from pesr_tpu.metrics import natural_images as J_natural
    got, want = P_natural.load_holdout_images(), J_natural.load_holdout_images()
    if not want:
        pytest.skip("no holdout photograph installed here")
    assert [n for n, _ in got] == [n for n, _ in want]
    assert set(n for n, _ in got) <= set(P_natural.holdout_names())
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    one, j_one = P_natural.load_holdout_image(), J_natural.load_holdout_image()
    assert (one is None) == (j_one is None)
    if j_one is not None:
        assert np.array_equal(one, j_one)


@pytest.mark.parametrize("r", [1, 2, 3])
def test_pixel_unshuffle_matches_jax(r):
    import jax.numpy as jnp
    from pesr_tpu.ops.pixel_shuffle import pixel_unshuffle as j_unshuffle
    from pesr_torch.ops import pixel_shuffle, pixel_unshuffle
    x = np.random.default_rng(r).normal(size=(2, 3 * r, 5 * r, 4)) \
        .astype(np.float32)
    got = pixel_unshuffle(torch.from_numpy(x), r)
    assert tuple(got.shape) == (2, 3, 5, 4 * r * r)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_unshuffle(jnp.asarray(x), r)))
    assert torch.equal(pixel_shuffle(got, r), torch.from_numpy(x))
    assert torch.equal(pixel_unshuffle(pixel_shuffle(got, r), r), got)


def test_pixel_unshuffle_refuses_indivisible_sides():
    from pesr_tpu.ops.pixel_shuffle import pixel_unshuffle as j_unshuffle
    from pesr_torch.ops import pixel_unshuffle
    x = np.zeros((1, 6, 5, 2), np.float32)
    with pytest.raises(ValueError) as got:
        pixel_unshuffle(torch.from_numpy(x), 2)
    with pytest.raises(ValueError) as want:
        j_unshuffle(x, 2)
    assert str(got.value) == str(want.value)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_sklearn():
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO, "pesr_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    scanned = {os.path.relpath(f, _REPO) for f in files}
    assert {"pesr_torch/metrics/forest.py", "pesr_torch/metrics/fit_ma.py",
            "pesr_torch/metrics/fit_natural.py"} <= scanned
    bad = [(os.path.relpath(f, _REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] == "sklearn"]
    assert not bad, bad
    # nor through another module: a fit in a fresh interpreter
    code = ("import sys, numpy as np; "
            "from pesr_torch.metrics import fit_ma, fit_natural, forest; "
            "forest.fit_forest(np.eye(6), np.arange(6.0), 2, 3, 0); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('sklearn', 'jax', 'flax', 'pesr_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=_REPO, check=True,
                   timeout=120)
