"""A regression forest fitter in numpy that builds the trees of
scikit-learn's ``RandomForestRegressor(n_estimators, max_depth,
random_state)`` at its other defaults node for node: the same bootstrap,
the same per-tree feature visiting order, the same float arithmetic and
so the same splits, thresholds and leaf values.  It fits the Ma forests
(``fit_ma.py``) where scikit-learn is not installed.

The defaults it reproduces: ``bootstrap=True`` with as many draws as
rows, ``max_features=1.0``, ``criterion="squared_error"``,
``min_samples_split=2``, ``min_samples_leaf=1``, no minimum weight and
``min_impurity_decrease=0``; X is cast to float32, y stays float64, and
non-finite X is refused (scikit-learn routes NaN specially; nothing here
needs it).  What decides a tree, in the order it happens:

- Seeds: ``RandomState(seed)`` draws one ``randint(2**31 - 1)`` per tree.
  A tree's ``RandomState(tree_seed)`` draws its bootstrap rows
  (``randint(0, n, n)``, counted into integer sample weights; rows of
  weight 0 leave the tree); a second ``RandomState(tree_seed)`` draws the
  state of the splitter's 32-bit xorshift generator.
- Nodes are built depth first, left child first; node ids run in that
  preorder.  A node is a leaf at ``max_depth``, below 2 rows, or at an
  impurity <= float64 eps; its value is the weighted mean of y.
- A node visits every feature in a Fisher-Yates order drawn from the
  xorshift generator, skipping features its ancestors found constant and
  recording those it finds constant itself (max <= min + 1e-7 in
  float32); one feature array persists across the whole build.
- Each visited feature sorts the node's rows by its value with the
  library's introsort (median of three, three-way partition, heapsort
  past 2 log2 n levels, insertion sort below 16 rows), in place on the
  order the previous feature left.  The candidate split positions lie
  between values more than 1e-7 apart; the left sums are updated from
  the previous position, or from the node's end when that is nearer.
  The proxy ``sum_l^2 / w_l + sum_r^2 / w_r`` replaces the best only when
  strictly greater; the threshold is ``v[p-1] / 2 + v[p] / 2`` in float64.
- The best split partitions the rows, in the order the last visited
  feature left, by swapping from the right end; children impurities are
  summed in that order, and a split whose impurity improvement is below
  -eps makes a leaf.

The sums are sequential (``np.cumsum``), in the order the library adds
them.  Where a feature's values in a node are all distinct the sorted
order is unique, so it is found with numpy's sort for all such features
of a node at once; a feature with tied values goes through the introsort
itself, because the order of tied rows changes the rounding of the sums.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

RAND_R_MAX = 0x7FFFFFFF           # the xorshift's range, 2^31 - 1
_SEED_MAX = np.iinfo(np.int32).max
FEATURE_THRESHOLD = np.float32(1e-7)
EPSILON = float(np.finfo(np.float64).eps)
TREE_LEAF = -1
TREE_UNDEFINED = -2


@dataclasses.dataclass
class Tree:
    """One fitted tree as flat node arrays in preorder: a leaf has
    ``children_left == children_right == -1``, ``feature == -2`` and
    ``threshold == -2.0``; an interior node sends a row left when
    ``x[feature] <= threshold``.  ``value`` is the node's mean target."""

    children_left: np.ndarray   # int64
    children_right: np.ndarray  # int64
    feature: np.ndarray         # int64
    threshold: np.ndarray       # float64
    value: np.ndarray           # float64

    @property
    def node_count(self) -> int:
        return len(self.value)


def _rand_r(state: List[int]) -> int:
    """The library's ``our_rand_r``: one 32-bit xorshift step on
    ``state[0]``, reduced below 2^31."""
    s = state[0] or 1
    s ^= (s << 13) & 0xFFFFFFFF
    s ^= s >> 17
    s ^= (s << 5) & 0xFFFFFFFF
    state[0] = s
    return s % (RAND_R_MAX + 1)


# --------------------------------------------------------------------------
# The library's introsort of (values, rows), in place on Python lists
# --------------------------------------------------------------------------


def _swap(v: list, ix: list, i: int, j: int) -> None:
    v[i], v[j] = v[j], v[i]
    ix[i], ix[j] = ix[j], ix[i]


def _median3(v: list, lo: int, n: int) -> float:
    a, b, c = v[lo], v[lo + n // 2], v[lo + n - 1]
    if a < b:
        if b < c:
            return b
        return c if a < c else a
    if b < c:
        return a if a < c else c
    return b


def _insertion_sort(v: list, ix: list, lo: int, n: int) -> None:
    for i in range(lo + 1, lo + n):
        tv, ti = v[i], ix[i]
        j = i
        while j > lo and v[j - 1] > tv:
            v[j] = v[j - 1]
            ix[j] = ix[j - 1]
            j -= 1
        v[j] = tv
        ix[j] = ti


def _sift_down(v: list, ix: list, lo: int, start: int, end: int) -> None:
    root = start
    while True:
        child = root * 2 + 1
        maxind = root
        if child < end and v[lo + maxind] < v[lo + child]:
            maxind = child
        if child + 1 < end and v[lo + maxind] < v[lo + child + 1]:
            maxind = child + 1
        if maxind == root:
            return
        _swap(v, ix, lo + root, lo + maxind)
        root = maxind


def _heapsort(v: list, ix: list, lo: int, n: int) -> None:
    start = (n - 2) // 2
    while True:
        _sift_down(v, ix, lo, start, n)
        if start == 0:
            break
        start -= 1
    end = n - 1
    while end > 0:
        _swap(v, ix, lo, lo + end)
        _sift_down(v, ix, lo, 0, end)
        end -= 1


def _introsort_3way(v: list, ix: list, lo: int, n: int, maxd: int) -> None:
    while n > 15:
        if maxd <= 0:
            _heapsort(v, ix, lo, n)
            return
        maxd -= 1
        pivot = _median3(v, lo, n)
        i = left = 0
        right = n
        while i < right:
            a = v[lo + i]
            if a < pivot:
                _swap(v, ix, lo + i, lo + left)
                i += 1
                left += 1
            elif a > pivot:
                right -= 1
                _swap(v, ix, lo + i, lo + right)
            else:
                i += 1
        _introsort_3way(v, ix, lo, left, maxd)
        lo += right
        n -= right
    _insertion_sort(v, ix, lo, n)


def simultaneous_sort(values: list, rows: list) -> None:
    """Sort ``values`` and ``rows`` together by value, in place, exactly
    as the library's ``simultaneous_sort(..., use_three_way_partition=
    True)`` orders them (ties included)."""
    n = len(values)
    if n:
        _introsort_3way(values, rows, 0, n, 2 * int(math.log2(n)))


# --------------------------------------------------------------------------
# One tree
# --------------------------------------------------------------------------


def _seq_sum(a: np.ndarray, start: float = 0.0) -> float:
    """``start + a[0] + a[1] + ...`` added left to right."""
    return float(np.cumsum(np.concatenate(([start], a)))[-1])


def _proxy(sl: float, wl: float, total: float, wn: float) -> float:
    sr, wr = total - sl, wn - wl
    return sl * sl / wl + sr * sr / wr


class _TreeGrower:
    """Grows one tree depth first with the best splitter.  ``x`` is
    float32 [n, F], ``y`` float64 [n], ``weight`` float64 [n]."""

    def __init__(self, x: np.ndarray, y: np.ndarray, weight: np.ndarray,
                 tree_seed: int, max_depth: Optional[int]):
        self.x, self.y, self.w = x, y, weight
        self.xw = weight * y            # the library's w * y
        self.max_depth = max_depth
        self.rand = [int(np.random.RandomState(tree_seed)
                         .randint(0, RAND_R_MAX))]
        n_features = x.shape[1]
        self.features = list(range(n_features))
        self.constant_features = [0] * n_features
        self.w_all = _seq_sum(weight)

    # -- the Fisher-Yates visit of one node -------------------------------

    def _visit(self, constant: np.ndarray, n_known: int):
        """Draw the node's features as the library's best splitter does.
        Returns the features it sorts, in order, and the count of constant
        features its children inherit."""
        feats, consts = self.features, self.constant_features
        f_i = n_features = len(feats)
        n_visited = n_found = n_drawn = 0
        n_total = n_known
        sorted_feats = []
        while f_i > n_total and (n_visited < n_features
                                 or n_visited <= n_found + n_drawn):
            n_visited += 1
            f_j = n_drawn + _rand_r(self.rand) % (f_i - n_found - n_drawn)
            if f_j < n_known:
                feats[n_drawn], feats[f_j] = feats[f_j], feats[n_drawn]
                n_drawn += 1
                continue
            f_j += n_found
            f = feats[f_j]
            sorted_feats.append(f)
            if constant[f]:
                feats[f_j], feats[n_total] = feats[n_total], feats[f_j]
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            feats[f_i], feats[f_j] = feats[f_j], feats[f_i]
        feats[:n_known] = consts[:n_known]
        consts[n_known:n_total] = feats[n_known:n_total]
        return sorted_feats, n_total

    # -- the criterion along one sorted feature ---------------------------

    def _scan(self, vals: np.ndarray, rows: np.ndarray, total: float,
              wn: float):
        """Best (proxy, position) of one feature whose rows are in the
        exact sorted order: the left sums follow the library's path (from
        the last position, or back from the end when that is nearer)."""
        n = len(rows)
        xw, w = self.xw[rows], self.w[rows]
        cand = np.flatnonzero(vals[1:] > vals[:-1] + FEATURE_THRESHOLD) + 1
        best, best_p = -math.inf, -1
        pos, sl, wl = 0, 0.0, 0.0
        for p in cand.tolist():
            if p - pos <= n - p:
                sl = _seq_sum(xw[pos:p], sl)
                wl = _seq_sum(w[pos:p], wl)
            else:
                sl = _seq_sum(-xw[p:][::-1], total)
                wl = _seq_sum(-w[p:][::-1], wn)
            pos = p
            proxy = _proxy(sl, wl, total, wn)
            if proxy > best:
                best, best_p = proxy, p
        return best, best_p

    def _split(self, rows: np.ndarray, n_known: int, total: float,
               wn: float):
        """The library's ``node_split_best`` on the node's rows (in their
        current order).  Returns the split, (feature, threshold, position,
        rows in the partitioned order) or None, and the count of constant
        features the children inherit."""
        x = self.x
        xn = x[rows]
        lo, hi = xn.min(axis=0), xn.max(axis=0)
        constant = hi <= lo + FEATURE_THRESHOLD
        sorted_feats, n_total = self._visit(constant, n_known)
        if not sorted_feats:
            return None, n_total

        # every sorted feature at once: a stable sort is the exact order
        # where a feature's values are distinct
        xc = xn[:, sorted_feats]
        order = np.argsort(xc, axis=0, kind="stable")
        v = np.take_along_axis(xc, order, axis=0)
        tied = (v[1:] == v[:-1]).any(axis=0)
        n = len(rows)
        p_all = np.arange(1, n)[:, None]
        cand = v[1:] > v[:-1] + FEATURE_THRESHOLD
        last = np.maximum.accumulate(np.where(cand, p_all, 0), axis=0)
        prev = np.vstack([np.zeros_like(last[:1]), last[:-1]])
        backward = (cand & (p_all - prev > n - p_all)).any(axis=0)
        cs = np.cumsum(self.xw[rows][order], axis=0)[:-1]
        cw = np.cumsum(self.w[rows][order], axis=0)[:-1]
        with np.errstate(divide="ignore", invalid="ignore"):
            prox = cs * cs / cw + (total - cs) * (total - cs) / (wn - cw)
        prox = np.where(cand, prox, -np.inf)
        arg = np.argmax(prox, axis=0)

        best = (-math.inf, None, None, None)    # proxy, feature, pos, vals
        # the rows' current order: an array, or k for numpy's order of
        # sorted_feats[k]
        cur: object = rows
        for k, f in enumerate(sorted_feats):
            if hi[f] == lo[f]:
                continue                        # all equal: order unchanged
            if not tied[k]:
                cur = k                         # unique: numpy's order
                vals = v[:, k]
            else:
                cur_rows = rows[order[:, cur]] if isinstance(cur, int) \
                    else cur
                vl = x[cur_rows, f].tolist()
                rl = cur_rows.tolist()
                simultaneous_sort(vl, rl)
                cur = np.asarray(rl, np.intp)
                vals = np.asarray(vl, np.float32)
            if constant[f]:
                continue
            if tied[k] or backward[k]:
                srt = rows[order[:, k]] if isinstance(cur, int) else cur
                proxy, p = self._scan(vals, srt, total, wn)
            else:
                p = int(arg[k]) + 1
                proxy = float(prox[p - 1, k]) if cand[p - 1, k] else -math.inf
            if proxy > best[0]:
                best = (proxy, f, p, vals)
        proxy, f, p, vals = best
        if f is None:
            return None, n_total
        threshold = float(vals[p - 1]) / 2.0 + float(vals[p]) / 2.0

        # partition_samples_final: swap rows going right to the far end
        part = (rows[order[:, cur]] if isinstance(cur, int)
                else cur).tolist()
        go_left = (x[:, f].astype(np.float64) <= threshold).tolist()
        i, j = 0, n
        while i < j:
            if go_left[part[i]]:
                i += 1
            else:
                j -= 1
                part[i], part[j] = part[j], part[i]
        return (f, threshold, p, np.asarray(part, np.intp)), n_total

    def _children_impurity(self, part: np.ndarray, p: int, total: float,
                           sq_total: float, wn: float):
        """Impurities of both children and the split's improvement
        weights, summed in the partitioned order as the library does."""
        n = len(part)
        xw, w, y = self.xw[part], self.w[part], self.y[part]
        if p <= n - p:
            sl, wl = _seq_sum(xw[:p]), _seq_sum(w[:p])
        else:
            sl = _seq_sum(-xw[p:][::-1], total)
            wl = _seq_sum(-w[p:][::-1], wn)
        sr, wr = total - sl, wn - wl
        sq_l = _seq_sum(xw[:p] * y[:p])
        ml, mr = sl / wl, sr / wr
        imp_l = sq_l / wl - ml * ml
        imp_r = (sq_total - sq_l) / wr - mr * mr
        return imp_l, imp_r, wl, wr

    def build(self) -> Tree:
        left, right, feature, threshold, value = [], [], [], [], []
        rows0 = np.flatnonzero(self.w != 0.0)
        # (rows, depth, parent, is_left, impurity, n_constant)
        stack = [(rows0, 0, -1, False, math.inf, 0)]
        first = True
        while stack:
            rows, depth, parent, is_left, impurity, n_const = stack.pop()
            n = len(rows)
            xw, y = self.xw[rows], self.y[rows]
            total = _seq_sum(xw)
            sq_total = _seq_sum(xw * y)
            wn = _seq_sum(self.w[rows])
            is_leaf = ((self.max_depth is not None and depth >= self.max_depth)
                       or n < 2)
            if first:
                mean = total / wn
                impurity = sq_total / wn - mean * mean
                first = False
            is_leaf = is_leaf or impurity <= EPSILON
            split = None
            if not is_leaf:
                split, n_const = self._split(rows, n_const, total, wn)
                if split is None:
                    is_leaf = True
                else:
                    imp_l, imp_r, wl, wr = self._children_impurity(
                        split[3], split[2], total, sq_total, wn)
                    improvement = (wn / self.w_all) * (
                        impurity - (wr / wn * imp_r) - (wl / wn * imp_l))
                    is_leaf = improvement + EPSILON < 0.0
            node = len(value)
            if parent >= 0:
                (left if is_left else right)[parent] = node
            left.append(TREE_LEAF)
            right.append(TREE_LEAF)
            value.append(total / wn)
            if is_leaf:
                feature.append(TREE_UNDEFINED)
                threshold.append(float(TREE_UNDEFINED))
                continue
            f, thr, p, part = split
            feature.append(f)
            threshold.append(thr)
            stack.append((part[p:], depth + 1, node, False, imp_r, n_const))
            stack.append((part[:p], depth + 1, node, True, imp_l, n_const))
        return Tree(np.asarray(left, np.int64), np.asarray(right, np.int64),
                    np.asarray(feature, np.int64),
                    np.asarray(threshold, np.float64),
                    np.asarray(value, np.float64))


# --------------------------------------------------------------------------
# The forest
# --------------------------------------------------------------------------


def fit_forest(x: np.ndarray, y: np.ndarray, n_trees: int = 100,
               max_depth: Optional[int] = None, seed: int = 0
               ) -> List[Tree]:
    """The trees of ``RandomForestRegressor(n_estimators=n_trees,
    max_depth=max_depth, random_state=seed).fit(x, y)``."""
    x = np.asarray(x)
    y = np.asarray(y, np.float64).reshape(-1)
    if x.ndim != 2 or x.shape[0] != len(y) or len(y) == 0:
        raise ValueError(f"x {x.shape} and y {y.shape} do not pair up")
    if n_trees < 1 or (max_depth is not None and max_depth < 1):
        raise ValueError(f"n_trees {n_trees} and max_depth {max_depth} "
                         "must be >= 1")
    x32 = np.ascontiguousarray(x, dtype=np.float32)
    if not (np.isfinite(x32).all() and np.isfinite(y).all()):
        raise ValueError("x and y must be finite")
    n = len(y)
    forest_rng = np.random.RandomState(seed)
    tree_seeds = [int(forest_rng.randint(_SEED_MAX)) for _ in range(n_trees)]
    trees = []
    for tree_seed in tree_seeds:
        rows = np.random.RandomState(tree_seed).randint(0, n, n)
        weight = np.bincount(rows.astype(np.int32),
                             minlength=n).astype(np.float64)
        trees.append(_TreeGrower(x32, y, weight, tree_seed,
                                  max_depth).build())
    return trees


def forest_arrays(trees: Sequence[Tree], prefix: str
                  ) -> Dict[str, np.ndarray]:
    """The trees as ``MaModel`` npz arrays: ``{prefix}_children_left /
    _right / _feature`` int32, ``_threshold / _value`` float32 (each
    tree's node ids local to it) and ``_tree_offsets`` int32."""
    offsets = np.cumsum([0] + [t.node_count for t in trees])

    def cat(name: str, dtype) -> np.ndarray:
        return np.concatenate([getattr(t, name) for t in trees]).astype(dtype)

    return {
        f"{prefix}_children_left": cat("children_left", np.int32),
        f"{prefix}_children_right": cat("children_right", np.int32),
        f"{prefix}_feature": cat("feature", np.int32),
        f"{prefix}_threshold": cat("threshold", np.float32),
        f"{prefix}_value": cat("value", np.float32),
        f"{prefix}_tree_offsets": offsets.astype(np.int32),
    }
