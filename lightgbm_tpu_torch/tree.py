"""Leaf-wise decision tree model: fixed-capacity arrays + prediction.

TPU-native equivalent of the reference ``Tree`` (reference:
include/LightGBM/tree.h:25, src/io/tree.cpp). Differences by design:

- Trees are *built on device* by the jitted learner as a flat "split log"
  (one record per split round); this class reconstructs the standard
  internal-node/leaf structure on host for prediction and serialization.
- Prediction over a batch of rows is vectorized (numpy on host, and the
  learner routes binned rows on device with per-split bin tables), instead
  of the reference's per-row pointer walk (tree.h:133 NumericalDecision).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# decision_type bit layout (reference: include/LightGBM/tree.h:149-166)
K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
# missing type stored in bits 2-3 (values 0=None,1=Zero,2=NaN)


class Tree:
    """A fitted decision tree with ``num_leaves`` leaves.

    Internal node ``i`` (0-based, creation order) holds a split; children are
    node indices where negative values encode leaves: leaf ``j`` is stored as
    ``~j`` (reference: tree.h left_child_/right_child_ convention).
    """

    def __init__(self, num_leaves: int, has_categorical: bool = False) -> None:
        n = max(num_leaves - 1, 1)
        self.num_leaves = num_leaves
        self.split_feature: np.ndarray = np.zeros(n, dtype=np.int32)  # real feature idx
        self.split_bin: np.ndarray = np.zeros(n, dtype=np.int32)
        self.threshold: np.ndarray = np.zeros(n, dtype=np.float64)
        self.decision_type: np.ndarray = np.zeros(n, dtype=np.int8)
        self.left_child: np.ndarray = np.full(n, -1, dtype=np.int32)
        self.right_child: np.ndarray = np.full(n, -1, dtype=np.int32)
        self.split_gain: np.ndarray = np.zeros(n, dtype=np.float32)
        self.internal_value: np.ndarray = np.zeros(n, dtype=np.float64)
        self.internal_weight: np.ndarray = np.zeros(n, dtype=np.float64)
        self.internal_count: np.ndarray = np.zeros(n, dtype=np.int64)
        self.leaf_value: np.ndarray = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_weight: np.ndarray = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_count: np.ndarray = np.zeros(num_leaves, dtype=np.int64)
        self.leaf_parent: np.ndarray = np.full(num_leaves, -1, dtype=np.int32)
        # categorical split i -> sorted array of category values going LEFT
        self.cat_threshold: Dict[int, np.ndarray] = {}
        self.shrinkage: float = 1.0
        self.num_cat: int = 0
        # linear leaves (reference: tree.h leaf_const_/leaf_coeff_/
        # leaf_features_, fit by LinearTreeLearner::CalculateLinear)
        self.is_linear: bool = False
        self.leaf_const: np.ndarray = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_coeff: Dict[int, np.ndarray] = {}
        self.leaf_features: Dict[int, np.ndarray] = {}  # real feature idx

    # ------------------------------------------------------------------ build
    @classmethod
    def from_split_log(
        cls,
        num_splits: int,
        split_leaf: np.ndarray,      # (R,) leaf index split at round r
        split_feature: np.ndarray,   # (R,) inner feature index
        split_bin: np.ndarray,       # (R,) threshold bin
        default_left: np.ndarray,    # (R,) bool
        split_gain: np.ndarray,      # (R,)
        left_sum: np.ndarray,        # (R, 3) g,h,cnt of left child at split time
        right_sum: np.ndarray,       # (R, 3)
        leaf_value: np.ndarray,      # (num_leaves,) final leaf outputs
        *,
        bin_mappers: Sequence[Any],
        real_feature_index: Sequence[int],
        go_left_table: Optional[np.ndarray] = None,  # (R, B) bool, categorical splits
        is_categorical: Optional[np.ndarray] = None,  # (R,) bool
    ) -> "Tree":
        """Rebuild the node structure from the learner's split log.

        Round ``r`` splits leaf ``l``: internal node ``r`` is created, the left
        child keeps leaf index ``l`` and the right child becomes leaf ``r+1``
        (reference: Tree::Split semantics, tree.h:62 — same leaf-index reuse).
        """
        num_leaves = num_splits + 1
        t = cls(num_leaves)
        # leaf -> node currently representing it (-1 while it is the root)
        leaf_slot: Dict[int, tuple] = {0: (-1, 0)}  # leaf -> (parent node, side 0=L 1=R)
        for r in range(num_splits):
            l = int(split_leaf[r])
            inner_f = int(split_feature[r])
            mapper = bin_mappers[inner_f]
            t.split_feature[r] = int(real_feature_index[inner_f])
            t.split_bin[r] = int(split_bin[r])
            dtyp = 0
            if is_categorical is not None and bool(is_categorical[r]):
                dtyp |= K_CATEGORICAL_MASK
                t.num_cat += 1
                # table row -> real category values going left
                tbl = go_left_table[r, : mapper.num_bins]
                bins_left = np.flatnonzero(tbl)
                cats = [mapper.bin_to_value(int(b)) for b in bins_left
                        if b < len(mapper.categories)]
                t.cat_threshold[r] = np.asarray(sorted(int(c) for c in cats), dtype=np.int64)
                t.threshold[r] = float(len(t.cat_threshold))  # placeholder index-ish
            else:
                if bool(default_left[r]):
                    dtyp |= K_DEFAULT_LEFT_MASK
                dtyp |= (mapper.missing_type & 3) << 2
                t.threshold[r] = mapper.bin_to_value(int(split_bin[r]))
            t.decision_type[r] = dtyp
            t.split_gain[r] = float(split_gain[r])
            gl, hl, cl = (float(left_sum[r, 0]), float(left_sum[r, 1]), float(left_sum[r, 2]))
            gr, hr, cr = (float(right_sum[r, 0]), float(right_sum[r, 1]), float(right_sum[r, 2]))
            t.internal_weight[r] = hl + hr
            t.internal_count[r] = int(round(cl + cr))
            tot_h = hl + hr
            t.internal_value[r] = -(gl + gr) / tot_h if tot_h > 0 else 0.0
            # hook up parent pointer
            parent, side = leaf_slot.pop(l)
            if parent >= 0:
                if side == 0:
                    t.left_child[parent] = r
                else:
                    t.right_child[parent] = r
            new_leaf = r + 1
            t.left_child[r] = ~l
            t.right_child[r] = ~new_leaf
            t.leaf_parent[l] = r
            t.leaf_parent[new_leaf] = r
            t.leaf_weight[l], t.leaf_count[l] = hl, int(round(cl))
            t.leaf_weight[new_leaf], t.leaf_count[new_leaf] = hr, int(round(cr))
            leaf_slot[l] = (r, 0)
            leaf_slot[new_leaf] = (r, 1)
        if num_splits == 0:
            # no usable split: the tree contributes nothing (reference:
            # gbdt.cpp keeps the stump but never applies its output)
            return t
        t.leaf_value[:num_leaves] = np.asarray(leaf_value[:num_leaves], dtype=np.float64)
        return t

    # ---------------------------------------------------------------- predict
    def _decide(self, node: int, values: np.ndarray) -> np.ndarray:
        """Vectorized left/right decision for internal node over raw values.

        Mirrors reference NumericalDecision / CategoricalDecision
        (tree.h:133-166): missing handling None (NaN->0), Zero (NaN->0 and
        |x|<=kZeroThreshold routed to the default direction), NaN (default
        dir). Returns bool array: True -> go left.
        """
        dt = int(self.decision_type[node])
        if dt & K_CATEGORICAL_MASK:
            cats = self.cat_threshold.get(node, np.array([], dtype=np.int64))
            iv = np.where(np.isfinite(values), values, -1).astype(np.int64)
            return np.isin(iv, cats)
        thr = self.threshold[node]
        missing_type = (dt >> 2) & 3
        default_left = bool(dt & K_DEFAULT_LEFT_MASK)
        nan_mask = np.isnan(values)
        if missing_type == 2:  # NaN-aware
            base = values <= thr
            return np.where(nan_mask, default_left, base)
        # None/Zero: NaN behaves as 0 (reference tree.h NumericalDecision)
        v = np.where(nan_mask, 0.0, values)
        base = v <= thr
        if missing_type == 1:  # zero as missing: zeros take the default dir
            return np.where(np.abs(v) <= 1e-35, default_left, base)
        return base

    def to_if_else(self, index: int) -> str:
        """Emit this tree as a standalone C++ if-else function
        (reference: gbdt_model_text.cpp:258 GBDT::ModelToIfElse — the
        reference also uses the generated code as a prediction regression
        harness; tests/test_codegen.py does the same here).

        Decision semantics mirror _decide: None/Zero missing treats NaN as
        0.0 (Zero additionally routes |x|<=1e-35 to the default side);
        NaN-aware splits route NaN to the default side. Linear leaves emit
        their const + coeffs . x model guarded by the NaN fallback to the
        plain leaf value (linear_predict semantics).
        """
        lines = ["double PredictTree%d(const double* arr) {" % index]
        if self.num_leaves <= 1:
            const0 = self.leaf_const[0] if self.is_linear \
                else self.leaf_value[0]
            lines.append("  return %.17g;" % float(const0))
            lines.append("}")
            return "\n".join(lines)

        def emit_leaf(leaf: int, ind: str, out):
            if not self.is_linear:
                out.append("%sreturn %.17g;"
                           % (ind, float(self.leaf_value[leaf])))
                return
            feats = self.leaf_features.get(leaf)
            if feats is None or len(feats) == 0:
                out.append("%sreturn %.17g;"
                           % (ind, float(self.leaf_const[leaf])))
                return
            # any NaN among the leaf's features -> plain leaf value
            nan_check = " || ".join("std::isnan(arr[%d])" % int(f)
                                    for f in feats)
            terms = " + ".join(
                "%.17g * arr[%d]" % (float(c), int(f))
                for f, c in zip(feats, self.leaf_coeff[leaf]))
            out.append("%sif (%s) return %.17g;"
                       % (ind, nan_check, float(self.leaf_value[leaf])))
            out.append("%sreturn %.17g + %s;"
                       % (ind, float(self.leaf_const[leaf]), terms))

        def emit(node: int, ind: str, out):
            if node < 0:
                emit_leaf(~node, ind, out)
                return
            f = int(self.split_feature[node])
            dt = int(self.decision_type[node])
            if dt & K_CATEGORICAL_MASK:
                cats = self.cat_threshold.get(
                    node, np.array([], dtype=np.int64))
                cond = ("!std::isnan(arr[%d]) && cat_in((int64_t)arr[%d], "
                        "kCats%d_%d, %d)" % (f, f, index, node, len(cats)))
                out.append("%sif (%s) {" % (ind, cond))
            else:
                thr = float(self.threshold[node])
                missing_type = (dt >> 2) & 3
                default_left = bool(dt & K_DEFAULT_LEFT_MASK)
                if missing_type == 2:
                    cond = "std::isnan(arr[%d]) ? %s : (arr[%d] <= %.17g)" \
                        % (f, "true" if default_left else "false", f, thr)
                elif missing_type == 1:
                    cond = ("[&]{ double v = std::isnan(arr[%d]) ? 0.0 : "
                            "arr[%d]; return std::fabs(v) <= 1e-35 ? %s : "
                            "(v <= %.17g); }()"
                            % (f, f, "true" if default_left else "false",
                               thr))
                else:
                    cond = ("(std::isnan(arr[%d]) ? 0.0 : arr[%d]) <= %.17g"
                            % (f, f, thr))
                out.append("%sif (%s) {" % (ind, cond))
            emit(int(self.left_child[node]), ind + "  ", out)
            out.append("%s} else {" % ind)
            emit(int(self.right_child[node]), ind + "  ", out)
            out.append("%s}" % ind)

        # category tables for this tree
        pre = []
        for node, cats in sorted(self.cat_threshold.items()):
            pre.append("static const int64_t kCats%d_%d[%d] = {%s};"
                       % (index, node, max(len(cats), 1),
                          ", ".join(str(int(c)) for c in cats) or "0"))
        body: list = []
        emit(0, "  ", body)
        return "\n".join(pre + lines + body + ["}"])

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Batch prediction of leaf outputs for raw feature rows."""
        X = np.asarray(X, dtype=np.float64)
        n = X.shape[0]
        if self.num_leaves <= 1:
            if self.is_linear:
                return np.full(n, self.leaf_const[0], dtype=np.float64)
            return np.full(n, self.leaf_value[0], dtype=np.float64)
        if self.is_linear:
            return self.linear_predict(X, self.predict_leaf_index(X))
        node = np.zeros(n, dtype=np.int64)  # >=0 internal, <0 leaf (~leaf)
        active = node >= 0
        while np.any(active):
            for nd in np.unique(node[active]):
                sel = active & (node == nd)
                go_left = self._decide(int(nd), X[sel, self.split_feature[nd]])
                nxt = np.where(go_left, self.left_child[nd], self.right_child[nd])
                node[sel] = nxt
            active = node >= 0
        return self.leaf_value[~node]

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int64)
        active = node >= 0
        while np.any(active):
            for nd in np.unique(node[active]):
                sel = active & (node == nd)
                go_left = self._decide(int(nd), X[sel, self.split_feature[nd]])
                node[sel] = np.where(go_left, self.left_child[nd], self.right_child[nd])
            active = node >= 0
        return (~node).astype(np.int32)

    def to_split_arrays(self) -> Dict[str, np.ndarray]:
        """Flatten the node structure into leaf-slot split order.

        Returns per-split arrays usable by the device routers: processing
        split r, rows on slot ``slot[r]`` move to slot ``r+1`` unless the
        decision sends them left (the same slot-reuse convention as the
        learner's TreeLog; from_split_log's inverse). Works for any tree —
        including models loaded from reference-format text.
        """
        R = self.num_internal if self.num_leaves > 1 else 0
        slot = np.zeros(R, np.int32)
        feature = np.zeros(R, np.int32)
        threshold = np.zeros(R, np.float64)
        kind = np.zeros(R, np.int32)          # 0 numerical, 1 categorical
        default_left = np.zeros(R, bool)
        missing_type = np.zeros(R, np.int32)
        cat_values: Dict[int, np.ndarray] = {}
        leaf_of_slot = np.zeros(max(self.num_leaves, 1), np.int32)
        if R == 0:
            leaf_of_slot[0] = 0
            return dict(slot=slot, feature=feature, threshold=threshold,
                        kind=kind, default_left=default_left,
                        missing_type=missing_type, cat_values=cat_values,
                        leaf_of_slot=leaf_of_slot)
        # BFS from the root; order = our split order r; slots assigned on
        # the fly (left keeps the parent's slot, right takes slot r+1)
        order: List[int] = []
        node_slot = {0: 0}
        queue = [0]
        while queue:
            nd = queue.pop(0)
            r = len(order)
            order.append(nd)
            s = node_slot.pop(nd)
            slot[r] = s
            feature[r] = self.split_feature[nd]
            threshold[r] = self.threshold[nd]
            dt = int(self.decision_type[nd])
            kind[r] = 1 if dt & K_CATEGORICAL_MASK else 0
            default_left[r] = bool(dt & K_DEFAULT_LEFT_MASK)
            missing_type[r] = (dt >> 2) & 3
            if kind[r]:
                cat_values[r] = self.cat_threshold.get(
                    nd, np.array([], dtype=np.int64))
            for child, child_slot in ((self.left_child[nd], s),
                                      (self.right_child[nd], r + 1)):
                if child >= 0:
                    node_slot[int(child)] = child_slot
                    queue.append(int(child))
                else:
                    leaf_of_slot[child_slot] = ~child
        # BFS guarantees parents precede children, but the right-child slot
        # r+1 refers to THIS split's position — valid since rows can only
        # reach a child's test after the parent's test ran
        return dict(slot=slot, feature=feature, threshold=threshold,
                    kind=kind, default_left=default_left,
                    missing_type=missing_type, cat_values=cat_values,
                    leaf_of_slot=leaf_of_slot)

    def branch_features(self, leaf: int) -> np.ndarray:
        """Real feature indices on the path from the root to ``leaf``
        (reference: tree.h branch_features with track_branch_features)."""
        feats = []
        nd = int(self.leaf_parent[leaf])
        seen = set()
        while nd >= 0:
            f = int(self.split_feature[nd])
            if f not in seen:
                seen.add(f)
                feats.append(f)
            # walk up: find the parent of nd
            up = np.flatnonzero((self.left_child == nd) | (self.right_child == nd))
            nd = int(up[0]) if len(up) else -1
        return np.asarray(sorted(feats), dtype=np.int64)

    def linear_predict(self, X: np.ndarray, leaf: np.ndarray) -> np.ndarray:
        """Linear-leaf outputs for rows routed to ``leaf`` (reference:
        tree.h:127 — const + coeffs . x; rows with NaN in any used feature
        fall back to the plain leaf value)."""
        out = self.leaf_const[leaf].copy()
        for l in range(self.num_leaves):
            m = leaf == l
            if not np.any(m):
                continue
            feats = self.leaf_features.get(l)
            if feats is None or len(feats) == 0:
                continue
            Z = X[np.ix_(m, feats)]
            nan_rows = np.isnan(Z).any(axis=1)
            vals = self.leaf_const[l] + Z @ self.leaf_coeff[l]
            vals = np.where(nan_rows, self.leaf_value[l], vals)
            out[m] = vals
        return out

    def apply_shrinkage(self, rate: float) -> None:
        """(reference: tree.h:187 Shrinkage — scales linear leaves too)"""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate
        if self.is_linear:
            self.leaf_const *= rate
            for l in self.leaf_coeff:
                self.leaf_coeff[l] = self.leaf_coeff[l] * rate

    def add_bias(self, val: float) -> None:
        self.leaf_value += val
        self.internal_value += val

    @property
    def num_internal(self) -> int:
        return self.num_leaves - 1

    def leaf_depths(self) -> np.ndarray:
        depth = np.zeros(self.num_leaves, dtype=np.int32)
        if self.num_leaves <= 1:
            return depth
        node_depth = np.zeros(self.num_internal, dtype=np.int32)
        for r in range(self.num_internal):
            for child in (self.left_child[r], self.right_child[r]):
                if child >= 0:
                    node_depth[child] = node_depth[r] + 1
                else:
                    depth[~child] = node_depth[r] + 1
        return depth

    # -------------------------------------------------------------- serialize
    def to_dict(self) -> Dict[str, Any]:
        d = {
            "num_leaves": int(self.num_leaves),
            "num_cat": int(self.num_cat),
            "shrinkage": float(self.shrinkage),
            "leaf_value": self.leaf_value.tolist(),
            "leaf_weight": self.leaf_weight.tolist(),
            "leaf_count": self.leaf_count.tolist(),
        }
        if self.num_leaves > 1:
            d.update({
                "split_feature": self.split_feature.tolist(),
                "split_gain": self.split_gain.tolist(),
                "threshold": self.threshold.tolist(),
                "decision_type": self.decision_type.tolist(),
                "left_child": self.left_child.tolist(),
                "right_child": self.right_child.tolist(),
                "internal_value": self.internal_value.tolist(),
                "internal_weight": self.internal_weight.tolist(),
                "internal_count": self.internal_count.tolist(),
                "cat_threshold": {str(k): v.tolist() for k, v in self.cat_threshold.items()},
            })
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Tree":
        t = cls(int(d["num_leaves"]))
        t.shrinkage = float(d.get("shrinkage", 1.0))
        t.num_cat = int(d.get("num_cat", 0))
        t.leaf_value = np.asarray(d["leaf_value"], dtype=np.float64)
        t.leaf_weight = np.asarray(d.get("leaf_weight", np.zeros(t.num_leaves)), dtype=np.float64)
        t.leaf_count = np.asarray(d.get("leaf_count", np.zeros(t.num_leaves)), dtype=np.int64)
        if t.num_leaves > 1:
            t.split_feature = np.asarray(d["split_feature"], dtype=np.int32)
            t.split_gain = np.asarray(d["split_gain"], dtype=np.float32)
            t.threshold = np.asarray(d["threshold"], dtype=np.float64)
            t.decision_type = np.asarray(d["decision_type"], dtype=np.int8)
            t.left_child = np.asarray(d["left_child"], dtype=np.int32)
            t.right_child = np.asarray(d["right_child"], dtype=np.int32)
            t.internal_value = np.asarray(d["internal_value"], dtype=np.float64)
            t.internal_weight = np.asarray(d["internal_weight"], dtype=np.float64)
            t.internal_count = np.asarray(d["internal_count"], dtype=np.int64)
            t.cat_threshold = {int(k): np.asarray(v, dtype=np.int64)
                               for k, v in d.get("cat_threshold", {}).items()}
        return t

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def to_text(self) -> str:
        """Text block in the spirit of the reference model format
        (reference: src/boosting/gbdt_model_text.cpp:311 ``Tree=N`` blocks)."""
        lines = [
            "num_leaves=%d" % self.num_leaves,
            "num_cat=%d" % self.num_cat,
            "shrinkage=%g" % self.shrinkage,
            "leaf_value=" + " ".join("%.17g" % v for v in self.leaf_value),
            "leaf_weight=" + " ".join("%g" % v for v in self.leaf_weight),
            "leaf_count=" + " ".join(str(int(v)) for v in self.leaf_count),
        ]
        if self.num_leaves > 1:
            lines += [
                "split_feature=" + " ".join(str(v) for v in self.split_feature),
                "split_gain=" + " ".join("%g" % v for v in self.split_gain),
                "threshold=" + " ".join("%.17g" % v for v in self.threshold),
                "decision_type=" + " ".join(str(int(v)) for v in self.decision_type),
                "left_child=" + " ".join(str(v) for v in self.left_child),
                "right_child=" + " ".join(str(v) for v in self.right_child),
                "internal_value=" + " ".join("%g" % v for v in self.internal_value),
                "internal_weight=" + " ".join("%g" % v for v in self.internal_weight),
                "internal_count=" + " ".join(str(int(v)) for v in self.internal_count),
            ]
            if self.cat_threshold:
                cat_items = ["%d:%s" % (k, ",".join(str(c) for c in v))
                             for k, v in sorted(self.cat_threshold.items())]
                lines.append("cat_threshold=" + ";".join(cat_items))
        if self.is_linear:
            nf = [len(self.leaf_features.get(l, ())) for l in range(self.num_leaves)]
            feats, coefs = [], []
            for l in range(self.num_leaves):
                feats.extend(int(f) for f in self.leaf_features.get(l, ()))
                coefs.extend(float(c) for c in self.leaf_coeff.get(l, ()))
            lines += [
                "is_linear=1",
                "leaf_const=" + " ".join("%.17g" % v for v in self.leaf_const),
                "num_features=" + " ".join(str(v) for v in nf),
                "leaf_features=" + " ".join(str(v) for v in feats),
                "leaf_coeff=" + " ".join("%.17g" % v for v in coefs),
            ]
        return "\n".join(lines)

    @classmethod
    def from_text(cls, block: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in block.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        t = cls(int(kv["num_leaves"]))
        t.num_cat = int(kv.get("num_cat", "0"))
        t.shrinkage = float(kv.get("shrinkage", "1"))

        def arr(key: str, dtype, size: int) -> np.ndarray:
            if key not in kv or kv[key] == "":
                return np.zeros(size, dtype=dtype)
            return np.asarray([float(x) for x in kv[key].split()], dtype=dtype)

        L = t.num_leaves
        t.leaf_value = arr("leaf_value", np.float64, L)
        t.leaf_weight = arr("leaf_weight", np.float64, L)
        t.leaf_count = arr("leaf_count", np.int64, L)
        if L > 1:
            n = L - 1
            t.split_feature = arr("split_feature", np.int32, n)
            t.split_gain = arr("split_gain", np.float32, n)
            t.threshold = arr("threshold", np.float64, n)
            t.decision_type = arr("decision_type", np.int8, n)
            t.left_child = arr("left_child", np.int32, n)
            t.right_child = arr("right_child", np.int32, n)
            t.internal_value = arr("internal_value", np.float64, n)
            t.internal_weight = arr("internal_weight", np.float64, n)
            t.internal_count = arr("internal_count", np.int64, n)
            if kv.get("cat_threshold"):
                for item in kv["cat_threshold"].split(";"):
                    k, cats = item.split(":")
                    t.cat_threshold[int(k)] = np.asarray(
                        [int(c) for c in cats.split(",") if c], dtype=np.int64)
        if kv.get("is_linear", "0").strip() == "1":
            t.is_linear = True
            t.leaf_const = arr("leaf_const", np.float64, L)
            nf = arr("num_features", np.int64, L).astype(int)
            feats = arr("leaf_features", np.int64, int(nf.sum()))
            coefs = arr("leaf_coeff", np.float64, int(nf.sum()))
            pos = 0
            for l in range(L):
                k = int(nf[l])
                if k:
                    t.leaf_features[l] = feats[pos:pos + k].astype(np.int64)
                    t.leaf_coeff[l] = coefs[pos:pos + k]
                pos += k
        return t
