"""SHAP feature contributions for tree ensembles (PyTorch port of
``lightgbm_tpu/shap.py``).

Equivalent of the reference's TreeSHAP implementation
(reference: src/io/tree.cpp TreeSHAP / PredictContrib, based on Lundberg &
Lee's exact tree SHAP with EXPECTED-value path attribution). It runs on
the host, as in the JAX package, in float64. The JAX package recurses once
per row (``lightgbm_tpu/shap.py`` ``_tree_shap_row`` and its
``_extend_path`` / ``_unwind_path`` / ``_unwound_sum``); the port
recurses once per tree for all rows together (``_tree_shap_rows``: the
same operations in the same order, on arrays, each row on its own
branch) and adds every row's leaf contributions in the order its own
recursion would visit them, so the results are equal bit for bit
(``tests/test_torch_api.py``).
"""
from __future__ import annotations

import numpy as np

from .tree import Tree


def _node_weight(tree: Tree, node: int) -> float:
    if node < 0:
        return max(float(tree.leaf_count[~node]), 1e-10)
    return max(float(tree.internal_count[node]), 1e-10)


def _child_weight(tree: Tree, child: int) -> float:
    return _node_weight(tree, child)


def _expected_value(tree: Tree, node: int = 0) -> float:
    if tree.num_leaves == 1:
        return float(tree.leaf_value[0])
    if node < 0:
        return float(tree.leaf_value[~node])
    wl = _node_weight(tree, tree.left_child[node])
    wr = _node_weight(tree, tree.right_child[node])
    tot = wl + wr
    return (wl * _expected_value(tree, tree.left_child[node]) +
            wr * _expected_value(tree, tree.right_child[node])) / tot


def _extend_path_rows(path: list, zero_fraction: float, one_fraction,
                      feature_index: int) -> None:
    """The JAX package's ``_extend_path`` for all rows at once: ``path`` holds
    ``[feature_index, zero_fraction, one_fraction (rows,), pweight
    (rows,)]`` entries, ``one_fraction`` is a (rows,) array; the
    arithmetic is ``_extend_path``'s, term by term, on arrays."""
    path.append([feature_index, zero_fraction, one_fraction,
                 np.full(len(one_fraction), 1.0 if len(path) == 0
                         else 0.0)])
    n = len(path) - 1
    for i in range(n - 1, -1, -1):
        path[i + 1][3] = path[i + 1][3] + \
            one_fraction * path[i][3] * (i + 1) / (n + 1)
        path[i][3] = zero_fraction * path[i][3] * (n - i) / (n + 1)


def _unwind_path_rows(path: list, path_index: int) -> None:
    """The JAX package's ``_unwind_path`` for all rows: each row takes its own branch
    of the ``one_fraction != 0`` test."""
    n = len(path) - 1
    one_fraction = path[path_index][2]
    zero_fraction = path[path_index][1]
    hot = one_fraction != 0
    next_one_portion = path[n][3]
    for i in range(n - 1, -1, -1):
        tmp = path[i][3]
        pw_hot = next_one_portion * (n + 1) / ((i + 1) * one_fraction)
        nop_hot = tmp - pw_hot * zero_fraction * (n - i) / (n + 1)
        pw_cold = path[i][3] * (n + 1) / (zero_fraction * (n - i))
        path[i][3] = np.where(hot, pw_hot, pw_cold)
        next_one_portion = np.where(hot, nop_hot, next_one_portion)
    for i in range(path_index, n):
        path[i][0] = path[i + 1][0]
        path[i][1] = path[i + 1][1]
        path[i][2] = path[i + 1][2]
    path.pop()


def _unwound_sum_rows(path: list, path_index: int) -> np.ndarray:
    """The JAX package's ``_unwound_sum`` for all rows, each on its own branch."""
    n = len(path) - 1
    one_fraction = path[path_index][2]
    zero_fraction = path[path_index][1]
    hot = one_fraction != 0
    next_one_portion = path[n][3]
    total = np.zeros(len(next_one_portion))
    for i in range(n - 1, -1, -1):
        tmp = next_one_portion * (n + 1) / ((i + 1) * one_fraction)
        nop_hot = path[i][3] - tmp * zero_fraction * (n - i) / (n + 1)
        cold = path[i][3] / (zero_fraction * (n - i) / (n + 1))
        total = total + np.where(hot, tmp, cold)
        next_one_portion = np.where(hot, nop_hot, next_one_portion)
    return total


def _tree_shap_rows(tree: Tree, X: np.ndarray, node: int, path: list,
                    parent_zero: float, parent_one, parent_feature: int,
                    base: np.ndarray, leaves: list) -> None:
    """The JAX package's ``_tree_shap_row`` for all rows of ``X`` at
    once. The recursion visits both children of every node for every
    row, so only the one fractions (hot or cold) and the weights differ
    per row. Each leaf appends ``(leaf, features, contributions (D, rows), position
    (rows,))``: the row's visit order of the leaf (hot child first, as the
    per-row recursion goes), which :func:`tree_shap_contribs` sums in."""
    path = [list(p) for p in path]
    _extend_path_rows(path, parent_zero, parent_one, parent_feature)
    if node < 0:  # leaf
        leaf = ~node
        feats, vals = [], []
        for i in range(1, len(path)):
            w = _unwound_sum_rows(path, i)
            feats.append(path[i][0])
            vals.append(w * (path[i][2] - path[i][1])
                        * tree.leaf_value[leaf])
        leaves.append((leaf, feats, vals, base))
        return
    f = int(tree.split_feature[node])
    go_left = tree._decide(node, X[:, f])
    left, right = int(tree.left_child[node]), int(tree.right_child[node])
    w_node = _node_weight(tree, node)
    incoming_zero, incoming_one = 1.0, np.ones(X.shape[0])
    path_index = -1
    for i in range(1, len(path)):
        if path[i][0] == f:
            path_index = i
            break
    if path_index >= 0:
        incoming_zero = path[path_index][1]
        incoming_one = path[path_index][2]
        _unwind_path_rows(path, path_index)
    n_left, n_right = _num_leaves_under(tree, left), \
        _num_leaves_under(tree, right)
    zero = 0.0 * incoming_one
    _tree_shap_rows(tree, X, left, path,
                    _child_weight(tree, left) / w_node * incoming_zero,
                    np.where(go_left, incoming_one, zero), f,
                    np.where(go_left, base, base + n_right), leaves)
    _tree_shap_rows(tree, X, right, path,
                    _child_weight(tree, right) / w_node * incoming_zero,
                    np.where(go_left, zero, incoming_one), f,
                    np.where(go_left, base + n_left, base), leaves)


def _num_leaves_under(tree: Tree, node: int) -> int:
    if node < 0:
        return 1
    return _num_leaves_under(tree, int(tree.left_child[node])) + \
        _num_leaves_under(tree, int(tree.right_child[node]))


#: rows a TreeSHAP pass holds at once (its leaf table is leaves x depth x
#: rows float64)
SHAP_ROW_CHUNK = 2048


def _tree_phi(tree: Tree, X: np.ndarray, num_feat: int) -> np.ndarray:
    """(rows, num_feat + 1) per-row ``phi`` of one tree: every leaf's
    contributions added in each row's own leaf order and, within a leaf,
    in path order, as the JAX package's ``_tree_shap_row`` adds them."""
    n = X.shape[0]
    leaves: list = []
    with np.errstate(divide="ignore", invalid="ignore"):
        _tree_shap_rows(tree, X, 0, [], 1.0, np.ones(n), -1,
                        np.zeros(n, np.int64), leaves)
    L = len(leaves)
    depth = max(len(f) for _, f, _, _ in leaves)
    dummy = num_feat + 1        # padding column, dropped below
    feats = np.full((L, depth), dummy, np.int64)
    vals = np.zeros((L, depth, n))
    order = np.empty((n, L), np.int64)
    rows = np.arange(n)
    for j, (_, f, v, pos) in enumerate(leaves):
        feats[j, :len(f)] = f
        if v:
            vals[j, :len(v)] = v
        order[rows, pos] = j
    phi = np.zeros((n, num_feat + 2))
    for p in range(L):
        j = order[:, p]
        for i in range(depth):
            phi[rows, feats[j, i]] += vals[j, i, rows]
    return phi[:, :num_feat + 1]


def tree_shap_contribs(gbdt, X: np.ndarray, num_iteration=-1) -> np.ndarray:
    """(n, F+1) contributions per class, concatenated over classes like the
    reference's PredictContrib layout (c_api PredictForMat contrib)."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    num_feat = gbdt.train_set.num_total_features if gbdt.train_set else X.shape[1]
    K = gbdt.num_tree_per_iteration
    total_iters = len(gbdt.models) // max(K, 1)
    if num_iteration is None or num_iteration <= 0:
        num_iteration = total_iters
    end = min(total_iters, num_iteration) * K
    out = np.zeros((n, K, num_feat + 1), dtype=np.float64)
    for i, tree in enumerate(gbdt.models[:end]):
        k = i % K
        base = _expected_value(tree)
        out[:, k, -1] += base
        if tree.num_leaves <= 1:
            continue
        for r0 in range(0, n, SHAP_ROW_CHUNK):
            phi = _tree_phi(tree, X[r0:r0 + SHAP_ROW_CHUNK], num_feat)
            out[r0:r0 + SHAP_ROW_CHUNK, k, :num_feat] += phi[:, :num_feat]
    out[:, :, -1] += gbdt.init_scores[None, :K]
    if K == 1:
        return out[:, 0, :]
    return out.reshape(n, K * (num_feat + 1))
