"""Device-resident prediction session with a shape-bucket ladder (PyTorch
port of ``lightgbm_tpu/serve/session.py``).

- The ensemble's device tables come from the booster's version-keyed
  caches (``_packed_model`` for the plain raw-threshold predict,
  ``_forest_model`` for the forest kernel) and are refreshed only when
  the model-version token moves.
- Row counts round UP to a fixed bucket ladder; a batch is padded to its
  bucket and the result sliced back, and requests past the top rung
  dispatch in top-rung chunks. Row routing is row-independent, so padding
  never changes real rows' scores; fixed shapes are what a later CUDA
  graph per rung will capture.
- With ``tpu_forest_kernel`` on (the ``auto`` default), rows are binned on
  the host with the training set's bin mappers and the whole ensemble runs
  as ONE forest kernel launch per dispatch (``ops/forest.py``).

:meth:`predict_binned` routes a constructed ``Dataset`` in BIN space
through ``tree_to_bin_log`` + ``assign_leaves`` (the row-router kernel,
one launch per tree) — no raw thresholds at all.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import telemetry, tracer
from ..ops.forest import forest_predict_impl
from ..ops.predict import predict_raw_impl
from ..utils.log import LightGBMError, Log

#: Default bucket ladder. Rungs are ~4x apart: at most ~25% of a dispatch
#: is padding in the worst case.
DEFAULT_BUCKETS = (256, 1024, 4096, 16384, 65536)


class PredictSession:
    """Serving handle over a trained booster (``Booster`` or inner
    ``GBDT``): device-resident tables + bucketed dispatch.

    Thread-safe for concurrent ``predict``/``raw_scores`` calls; pair with
    :class:`~lightgbm_tpu_torch.serve.batcher.MicroBatcher` to coalesce
    many small requests into one dispatch.
    """

    def __init__(self, model, *, start_iteration: int = 0,
                 num_iteration: int = -1,
                 buckets: Optional[Sequence[int]] = None,
                 forest: Optional[str] = None) -> None:
        self._gbdt = getattr(model, "inner", model)
        if start_iteration < 0:
            raise LightGBMError("start_iteration must be >= 0")
        if forest not in (None, "on", "off"):
            raise LightGBMError(
                "forest must be None (follow tpu_forest_kernel), 'on' or "
                "'off', got %r" % (forest,))
        self._start = int(start_iteration)
        self._num = int(num_iteration)
        rungs = tuple(sorted({int(b) for b in (buckets or DEFAULT_BUCKETS)}))
        if not rungs or rungs[0] < 1:
            raise LightGBMError("serve buckets must be positive ints")
        self.buckets = rungs
        self._lock = threading.Lock()
        self._pack = None
        self._has_cat = False
        self._has_linear = False
        self._K = max(1, int(self._gbdt.num_tree_per_iteration))
        self._version = -1
        self._range = (0, 0)
        self._warm: set = set()
        # forest state: explicit override (None = follow the booster's
        # resolved knob), version-keyed entry, inner->total column map
        # for host binning, warn-once latch
        self._forest_cfg = forest
        self._fentry = None
        self._fver = -1
        self._frange = (0, 0)
        self._f_cols: Optional[np.ndarray] = None
        self._forest_warned = False

    @property
    def device(self) -> torch.device:
        return self._gbdt.device

    # ------------------------------------------------------------ resolution
    def num_features(self) -> int:
        """Feature count for warmup batches."""
        g = self._gbdt
        if g.train_set is not None:
            return int(g.train_set.num_total_features)
        names = getattr(g, "_feature_names", None)
        if names:
            return len(names)
        mx = -1
        for t in g.models:
            if t.num_leaves > 1:
                mx = max(mx, int(t.split_feature[:t.num_internal].max()))
        return mx + 1

    def bucket_for(self, rows: int) -> int:
        """Smallest ladder rung covering ``rows`` (the top rung beyond
        the ladder)."""
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def _resolve_range(self) -> Tuple[int, int]:
        g = self._gbdt
        total = len(g.models) // self._K
        end = total if self._num <= 0 else min(total, self._start + self._num)
        return self._start, max(self._start, end)

    def _ensure_pack(self):
        """Refresh the plain-path pack iff the model version (or the
        resolved iteration range) moved; returns (pack, has_cat,
        has_linear). Lock order is session -> booster."""
        g = self._gbdt
        with self._lock, g._cache_lock:
            ver = g.model_version
            rng = self._resolve_range()
            if self._pack is None or ver != self._version \
                    or rng != self._range:
                self._pack, self._has_cat, self._has_linear = \
                    g._packed_model(*rng)
                self._version, self._range = ver, rng
                self._warm.clear()
            return self._pack, self._has_cat, self._has_linear

    def _forest_mode(self) -> str:
        if self._forest_cfg is not None:
            return self._forest_cfg
        return self._gbdt._forest_knob()

    def _ensure_forest(self):
        """Version-keyed ``(ForestPack, has_cat, has_linear, ForestWalk)``
        or None when the model is structurally ineligible."""
        g = self._gbdt
        with self._lock, g._cache_lock:
            ver = g.model_version
            rng = self._resolve_range()
            if self._fver != ver or self._frange != rng:
                self._fentry = g._forest_model(*rng)
                self._fver, self._frange = ver, rng
                self._f_cols = None
                if g.train_set is not None:
                    self._f_cols = np.asarray(
                        g.train_set.used_feature_indices, np.int64)
                self._warm.clear()
            return self._fentry

    def _bin_rows(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host binning for the forest path: (n, F_total) float32 raw rows
        -> ((n, Fi) int32 bins, (n, Fi) float32 raw values), both in INNER
        feature order (the order the forest tables were packed in)."""
        ds = self._gbdt.train_set
        with self._lock:
            cols = self._f_cols
        if cols is not None and len(cols) and X.shape[1] <= int(cols.max()):
            raise LightGBMError(
                "predict rows have %d features but the model was trained "
                "on %d" % (X.shape[1], int(cols.max()) + 1))
        Xr = np.ascontiguousarray(X[:, cols]) if cols is not None else X
        bins = np.empty(Xr.shape, np.int32)
        for j in range(Xr.shape[1]):
            bins[:, j] = ds.bin_mappers[j].value_to_bin(Xr[:, j])
        return bins, Xr

    def pack_fingerprint(self) -> str:
        """sha256 over every tensor of the resident plain-path pack: after
        a REJECTED online candidate the serving pack must be
        byte-identical, after a promotion it must differ. Reads the pack
        back to the host: not for the hot path."""
        import hashlib

        pack, _, _ = self._ensure_pack()
        h = hashlib.sha256()
        for t in pack:
            arr = t.cpu().numpy()
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        return h.hexdigest()

    # -------------------------------------------------------------- dispatch
    def dispatch(self, X) -> List[Tuple[torch.Tensor, int]]:
        """Bucketed device dispatch; returns [(device scores, real rows)].

        Nothing here waits for the device — :meth:`collect` (called by
        raw_scores and the MicroBatcher) is the one host sync."""
        forest = None
        if self._forest_mode() == "on":
            forest = self._ensure_forest()
            explicit = self._forest_cfg == "on" \
                or self._gbdt.config.tpu_forest_kernel == "on"
            if forest is None and explicit:
                with self._lock:
                    warn = not self._forest_warned
                    self._forest_warned = True
                if warn:
                    Log.warning(
                        "tpu_forest_kernel=on but this model is ineligible "
                        "for the forest path; serving stays on the plain "
                        "predict")
        if forest is None:
            pack, has_cat, has_linear = self._ensure_pack()
        X = np.ascontiguousarray(np.asarray(X), dtype=np.float32)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2:
            raise LightGBMError("predict expects a 2-D (rows, features) "
                                "array, got ndim=%d" % X.ndim)
        n = X.shape[0]
        pieces: List[Tuple[torch.Tensor, int]] = []
        if n == 0:
            return pieces
        if forest is not None:
            X, Xraw = self._bin_rows(X)
            telemetry.count("serve/forest_dispatches")
        nf = X.shape[1]
        top = self.buckets[-1]
        dev = self.device
        telemetry.count("serve/dispatches")
        with tracer.span("serve/session_dispatch", domain="serve", rows=n):
            for lo in range(0, n, top):
                chunk = X[lo:lo + top]
                rows = chunk.shape[0]
                b = self.bucket_for(rows)
                with self._lock:
                    warm = b in self._warm
                    self._warm.add(b)
                telemetry.count(
                    "serve/bucket_hit" if warm else "serve/bucket_miss")
                if b > rows:
                    telemetry.count("serve/pad_rows", b - rows)
                    chunk = np.concatenate(
                        [chunk, np.zeros((b - rows, nf), chunk.dtype)])
                if forest is not None:
                    fp, f_cat, f_lin, walk = forest
                    xdev = None
                    if f_lin:
                        xchunk = Xraw[lo:lo + top]
                        if b > rows:
                            xchunk = np.concatenate(
                                [xchunk,
                                 np.zeros((b - rows, nf), np.float32)])
                        xdev = torch.from_numpy(xchunk).to(dev)
                    score = forest_predict_impl(
                        torch.from_numpy(chunk).to(dev), xdev, fp,
                        walk=walk, num_class=self._K, has_cat=f_cat,
                        has_linear=f_lin)
                else:
                    score = predict_raw_impl(
                        torch.from_numpy(chunk).to(dev), pack,
                        num_class=self._K, has_cat=has_cat,
                        has_linear=has_linear)
                pieces.append((score, rows))
        return pieces

    def collect(self, pieces) -> np.ndarray:
        """Pull dispatched pieces to the host: (n, K) float64 raw sums."""
        if not pieces:
            return np.zeros((0, self._K), np.float64)
        outs = [s[:r].to("cpu", torch.float64).numpy() for s, r in pieces]
        raw = outs[0] if len(outs) == 1 else np.concatenate(outs)
        return raw.reshape(len(raw), -1)

    def warmup(self, buckets: Optional[Sequence[int]] = None
               ) -> "PredictSession":
        """Build the device tables and touch every rung once (the full
        ladder by default)."""
        nf = max(1, self.num_features())
        for b in sorted({self.bucket_for(int(v))
                         for v in (buckets or self.buckets)}):
            self.collect(self.dispatch(np.zeros((b, nf), np.float32)))
        return self

    # --------------------------------------------------------------- results
    def raw_scores(self, X) -> np.ndarray:
        """(n, F) raw rows -> (n, K) float64 raw ensemble sums (no init
        score, no output transform)."""
        return self.collect(self.dispatch(X))

    def finalize(self, raw: np.ndarray, *,
                 raw_score: bool = False) -> np.ndarray:
        """Raw ensemble sums -> final predictions: RF averaging, init
        scores, objective output transform, (n,) squeeze for K == 1."""
        g = self._gbdt
        score = np.asarray(raw, np.float64)
        score = score.reshape(len(score), -1)
        start, end = self._range if self._pack is not None \
            else self._resolve_range()
        score = g._average(score, start, end)
        score = score + g.init_scores[None, :self._K]
        if not raw_score and g.objective is not None:
            score = g.objective.convert_output(score).numpy()
        return score.ravel() if self._K == 1 else score

    def predict(self, X, *, raw_score: bool = False) -> np.ndarray:
        """Full prediction for raw feature rows (parity with
        ``Booster.predict``)."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        telemetry.count("serve/requests")
        telemetry.count("serve/rows", X.shape[0])
        return self.finalize(self.raw_scores(X), raw_score=raw_score)

    def predict_binned(self, dataset, *, raw_score: bool = False
                       ) -> np.ndarray:
        """Pre-binned fast path: route a constructed ``Dataset`` in BIN
        space via ``tree_to_bin_log`` + ``assign_leaves``; per-tree bin
        logs are cached per (tree, dataset)."""
        from ..boosting import ScoreTracker

        g = self._gbdt
        binned = dataset.construct() if hasattr(dataset, "construct") \
            else dataset
        start, end = self._resolve_range()
        K = self._K
        n = binned.num_data
        telemetry.count("serve/requests")
        telemetry.count("serve/rows", n)
        telemetry.count("serve/binned_requests")
        ts = ScoreTracker(n, K, np.zeros(K, np.float64), self.device)
        linear_extra = None
        for i, tree in enumerate(g.models[start * K:end * K]):
            vals, leaf = g._route_tree_device(tree, binned)
            if getattr(tree, "is_linear", False) \
                    and binned.raw_numeric is not None:
                # linear leaves need raw feature values; the router
                # returns SLOTS — map to LEAF ids for the coefficients
                leaf_of_slot = tree.to_split_arrays()["leaf_of_slot"]
                rv = tree.linear_predict(
                    binned.raw_numeric.astype(np.float64),
                    leaf_of_slot[leaf.cpu().numpy()])
                if linear_extra is None:
                    linear_extra = np.zeros((n, K), np.float64)
                linear_extra[:, i % K] += rv
                continue
            ts.add(vals, leaf, i % K, K)
        raw = np.asarray(ts.np(), np.float64).reshape(n, -1)
        if linear_extra is not None:
            raw = raw + linear_extra
        return self.finalize(raw, raw_score=raw_score)
