"""Boosting drivers (PyTorch port of ``lightgbm_tpu/boosting.py``).

A :class:`GBDT` trains an ensemble and serves it. Training (plain GBDT,
reference: gbdt.cpp:369 TrainOneIter) runs the objective's gradients, one
:class:`~lightgbm_tpu_torch.learner.SerialTreeLearner` tree per class and
device-side score updates for the training set and every valid set, one
iteration at a time, or, with no valid set and no per-iteration
observation, K iterations per fused block (``fused.FusedTrainer``,
``train_block`` / ``finish_fused``; every reader of the model finalizes
the block in flight first). Bagging,
balanced bagging, GOSS and ``feature_fraction < 1`` draw their masks from
the port's threefry (``fused.py``, ``prng.py``) exactly as the JAX package
draws them. :class:`DART` (dropout boosting) and :class:`RF` (random
forest) train per iteration, as in the JAX package, and so do linear
trees (``linear_tree``): after each tree every leaf's ridge model is fit
in one batched pass (``linear/fit.py``: the Gram kernel
``csrc/linear_gram.cu`` on the card) or, on a host learner, by the
f64 oracle (``linear_device``), and the scores are updated on the host
from the raw features.

Serving: the model text format (``model_to_string`` /
``model_from_string``, byte-compatible with the JAX package), raw-score
and final prediction with prediction early stopping, the version-keyed
device packs behind :class:`~lightgbm_tpu_torch.serve.session.PredictSession`,
binned routing of a dataset's rows (``_route_tree_device``) and the online
hot-swap hooks ``adopt`` / ``restore``. DART and RF models load and serve
(RF averages its trees). ``dump_json``, ``to_if_else_cpp`` (standalone C++
of the ensemble, ``task=convert_model``) and ``feature_importance`` read
the host trees, as the JAX package's do.

Everything device-side lives on ``self.device``, resolved from
``config.device_type`` (see device.py).
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import BinnedDataset
from .device import resolve_device
from .fused import make_balanced_sampler, make_feature_mask_fn, make_sampler
from .learner import (SerialTreeLearner, TreeLog, assign_leaves,
                      device_bins, launches_per_split, leaf_values_by_row,
                      note_used_features, route_layout)
from .metric import Metric, create_metrics
from .objective import ObjectiveFunction, create_objective
from .obs import telemetry
from .prng import PRNGKey, fold_in
from .tree import Tree
from .utils.log import LightGBMError


class ScoreTracker:
    """Running f32 raw scores for one dataset on a torch device
    (reference: score_updater.hpp:21)."""

    def __init__(self, num_data: int, num_class: int, init: np.ndarray,
                 device: torch.device = torch.device("cpu")) -> None:
        shape = (num_data, num_class) if num_class > 1 else (num_data,)
        s = np.zeros(shape, dtype=np.float32)
        s += init if num_class > 1 else init[0]
        self.score = torch.as_tensor(s).to(device)

    def add(self, leaf_values, leaf_assign: torch.Tensor, class_id: int,
            num_class: int, scale: float = 1.0) -> None:
        """score[:, class_id] += leaf_values[leaf_assign] * scale, on the
        device (``leaf_values`` a device tensor or host array)."""
        if isinstance(leaf_values, torch.Tensor):
            lv = leaf_values.to(leaf_assign.device)
        else:
            lv = torch.as_tensor(np.asarray(leaf_values, np.float32)).to(
                leaf_assign.device)
        vals = leaf_values_by_row(lv, leaf_assign) * np.float32(scale)
        if self.score.dim() > 1:
            self.score[:, class_id] += vals
        else:
            self.score += vals

    def np(self) -> np.ndarray:
        return self.score.cpu().numpy()


class GBDT:
    """Gradient boosting model (reference: src/boosting/gbdt.cpp)."""

    name = "gbdt"
    #: below this many rows, predict walks the host trees
    DEVICE_PREDICT_MIN_ROWS = 512

    def __init__(self, config: Config,
                 train_set: Optional[BinnedDataset] = None) -> None:
        self.config = config
        self.device = resolve_device(config.device_type)
        self.train_set = train_set
        self.models: List[Tree] = []
        self.iter_ = 0
        self.num_class = max(1, int(config.num_class))
        self.objective: Optional[ObjectiveFunction] = None
        self.num_tree_per_iteration = self.num_class
        self.init_scores = np.zeros(self.num_class, dtype=np.float64)
        self.best_iteration = -1
        # monotonic token bumped whenever self.models changes content;
        # the device packs key on it
        self._model_version = 0
        # guards models, the version token and the serving caches: a
        # PredictSession worker thread must never pack a half-committed
        # model
        self._cache_lock = threading.RLock()
        self._pack_cache: Dict = {}
        self._forest_cache: Dict = {}
        self._serve_sessions: Dict = {}
        self._tree_log_cache: Dict = {}
        self.metrics: List[Metric] = []
        self.valid_sets: List[Tuple[str, BinnedDataset, ScoreTracker]] = []
        self.learner: Optional[SerialTreeLearner] = None
        self.train_score: Optional[ScoreTracker] = None
        if train_set is not None:
            self._setup(train_set)

    # ------------------------------------------------------------------ setup
    def check_device_config(self, cfg: Config) -> None:
        """Refuse settings that would run this booster's work on another
        device than its own: a new ``device_type`` (the trees, scores and
        learner live on :attr:`device`), and ``linear_device=off`` on a
        CUDA device (the card fits every leaf with the Gram kernel; the
        f64 host oracle is the host learner's fit, not a fallback of the
        card). :meth:`_setup` and ``Booster.reset_parameter`` call it
        before they touch anything."""
        if resolve_device(cfg.device_type) != self.device:
            raise LightGBMError(
                "device_type=%s moves a booster that lives on %s; train a "
                "new booster instead" % (cfg.device_type, self.device))
        if cfg.linear_tree and cfg.linear_device == "off" \
                and self.device.type == "cuda":
            raise LightGBMError(
                "linear_device=off fits the linear leaves on the host and "
                "needs device_type=cpu; on a CUDA device use "
                "linear_device=auto or on (the Gram kernel)")

    def _setup(self, train_set: BinnedDataset) -> None:
        cfg = self.config
        self.check_device_config(cfg)
        self.objective = create_objective(cfg)
        self.objective.init(train_set.metadata, self.device)
        self.num_tree_per_iteration = self.objective.num_model_per_iteration
        self.metrics = create_metrics(cfg, self.objective.name)
        from .parallel.distributed import current_group
        from .parallel.mesh import create_tree_learner
        # tree_learner=data|feature|voting builds its distributed learner
        # over the process group (serial without one, as the JAX package
        # does on one device)
        group = current_group() if cfg.tree_learner != "serial" else None
        self.learner = create_tree_learner(
            cfg, train_set, group, self.device,
            bins=self._valid_bins(train_set),
            bins_t=self._valid_bins_t(train_set))
        if cfg.boost_from_average and self.objective.name != "none":
            for k in range(self.num_tree_per_iteration):
                self.init_scores[k] = self.objective.boost_from_score(k)
        self.train_score = self._fresh_tracker(train_set)
        self._inbag = torch.ones(train_set.num_data, dtype=torch.float32,
                                 device=self.device)
        self._amp: Optional[torch.Tensor] = None
        self._fmask = torch.ones(train_set.num_features, dtype=torch.bool,
                                 device=self.device)
        #: the features the model's trees split on, on the device (CEGB's
        #: coupled penalties apply until a feature's first use)
        self._cegb_used = torch.zeros(train_set.num_features,
                                      dtype=torch.bool, device=self.device)
        self._key = PRNGKey(cfg.seed if cfg.seed is not None else 0)
        self._sampler = self._make_sampler()
        self._fmask_fn = make_feature_mask_fn(cfg, train_set.num_features,
                                              self.device)

    def _fresh_tracker(self, ds: BinnedDataset) -> "ScoreTracker":
        """Scores at the init scores plus the dataset's own init_score."""
        ts = ScoreTracker(ds.num_data, self.num_tree_per_iteration,
                          self.init_scores, self.device)
        if ds.metadata.init_score is not None:
            base = ds.metadata.init_score
            base = base.reshape(ds.num_data, -1) if self.num_class > 1 \
                else base.ravel()
            ts.score = ts.score + torch.as_tensor(
                np.asarray(base, np.float32)).to(self.device)
        return ts

    def add_valid(self, name: str, valid_set: BinnedDataset) -> None:
        self.finish_fused("add_valid")
        vs = self._fresh_tracker(valid_set)
        # replay already-trained trees (continued training)
        for i, tree in enumerate(self.models):
            vals, leaf = self._route_tree_device(tree, valid_set)
            vs.add(vals, leaf, i % self.num_tree_per_iteration,
                   self.num_tree_per_iteration)
        self.valid_sets.append((name, valid_set, vs))

    # --------------------------------------------------------------- sampling
    def _make_sampler(self):
        """The row sampler of this config, or None (the JAX package's
        choice: GOSS first, then balanced bagging when a positive or
        negative fraction is set and labels exist, else plain bagging)."""
        cfg = self.config
        lab = self.objective.label if self.objective is not None else None
        if lab is None and self.train_set.metadata.label is not None:
            # custom objectives (objective=none) still bag by label
            lab = torch.as_tensor(np.asarray(self.train_set.metadata.label,
                                             np.float32)).to(self.device)
        if cfg.data_sample_strategy != "goss" \
                and (cfg.pos_bagging_fraction < 1.0
                     or cfg.neg_bagging_fraction < 1.0) \
                and cfg.bagging_freq > 0 and lab is not None:
            return make_balanced_sampler(cfg, lab)
        return make_sampler(cfg, self.train_set.num_data)

    def _bagging(self, it: int, grad: torch.Tensor,
                 hess: torch.Tensor) -> None:
        """Refresh the in-bag mask (reference: gbdt.cpp:228 Bagging,
        goss.hpp:103 for data_sample_strategy=goss); GOSS also keeps its
        amplification of the sampled small-gradient rows."""
        if self._sampler is None:
            return
        g = grad if grad.dim() == 1 else torch.sum(torch.abs(grad), dim=1)
        h = hess if hess.dim() == 1 else torch.sum(torch.abs(hess), dim=1)
        self._inbag, amp = self._sampler(it, g, h)
        if self.config.data_sample_strategy == "goss":
            self._amp = amp

    def _tree_channels(self, grad: torch.Tensor, hess: torch.Tensor,
                       k: int) -> torch.Tensor:
        """(N, 3) channels ``(g * m, h * m, m)`` of class ``k`` for the
        in-bag mask m, with GOSS's amplification folded into g and h."""
        g = grad if grad.dim() == 1 else grad[:, k]
        h = hess if hess.dim() == 1 else hess[:, k]
        if self._amp is not None:
            g, h = g * self._amp, h * self._amp
        m = self._inbag
        return torch.stack([g * m, h * m, m], dim=1)

    def _feature_mask(self, it: int) -> torch.Tensor:
        """Per-tree column sample (all features without feature_fraction)."""
        if self._fmask_fn is None:
            return self._fmask
        return self._fmask_fn(it)

    # ---------------------------------------------------------- fused blocks
    def supports_fused(self) -> bool:
        """True when K iterations can run as one fused block (no
        per-iteration host observation needed): plain GBDT, a built-in
        objective without leaf renewal, no valid sets, a one-device learner
        (the JAX package's conditions: a distributed learner's trees join
        the ranks per split)."""
        from .parallel.mesh import _MeshTreeLearner
        return (type(self) is GBDT
                and not self.config.linear_tree
                and self.objective is not None
                and self.objective.name != "none"
                and not self.objective.need_renew
                and not self.valid_sets
                and self.train_set is not None
                and not isinstance(self.learner, _MeshTreeLearner))

    def train_block(self, k: int) -> bool:
        """Train k iterations as one fused block (see fused.py). Returns
        True when training should stop."""
        if getattr(self, "_fused", None) is None:
            from .fused import FusedTrainer
            self._fused = FusedTrainer(self)
        return self._fused.run(k)

    def finish_fused(self, reason: str = "unspecified") -> bool:
        """Finalize any in-flight fused block (its host trees). ``reason``
        names the calling reader for the ``fused/flush/<reason>``
        counters."""
        if getattr(self, "_fused", None) is None:
            return False
        return self._fused.flush(reason)

    # --------------------------------------------------------------- training
    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration (reference: gbdt.cpp:369 TrainOneIter).
        Returns True when no tree could be grown (all-stop signal)."""
        self.finish_fused("train_one_iter")
        it = self.iter_
        K = self.num_tree_per_iteration
        if grad is None:
            g, h = self.gradients(it)
        else:
            n = self.train_set.num_data
            g = torch.as_tensor(np.asarray(grad, np.float32)).to(self.device)
            h = torch.as_tensor(np.asarray(hess, np.float32)).to(self.device)
            if K > 1:
                g, h = g.reshape(n, K), h.reshape(n, K)
        self._bagging(it, g, h)
        fmask = self._feature_mask(it)
        any_nonconstant = False
        for k in range(K):
            key = fold_in(self._key, it * 131 + k)
            ghc = self._tree_channels(g, h, k)
            # the channels the tree grew on: the linear fit's weights
            self._last_ghc = ghc
            log = self.learner.train(ghc, fmask, key, self._cegb_used)
            if self.learner.hp.use_cegb:
                note_used_features(self._cegb_used, log)
            tree = self._finalize_tree(log, k)
            with self._cache_lock:
                self.models.append(tree)
            self._count_tree(tree, self.learner.train_on_loop)
            if tree.num_leaves > 1:
                any_nonconstant = True
        with self._cache_lock:
            self.iter_ += 1
            self._bump_model_version()
        return not any_nonconstant

    def gradients(self, it: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The objective's gradients at the training scores; an objective
        that draws per-iteration randomness (``needs_iter``) gets the
        iteration index."""
        obj = self.objective
        if obj.needs_iter:
            return obj.get_gradients(self.train_score.score, it)
        return obj.get_gradients(self.train_score.score)

    def _count_tree(self, tree: Tree, device_loop: bool = False) -> None:
        """Growth and launch counters of one finished tree; the
        ``learner/launches_per_split`` gauge is the count of the loop that
        grew it (the device tree loop on the card's fused path and for
        the card's dense builder, else the per-split host loop)."""
        splits = tree.num_leaves - 1
        telemetry.count("tree/trees")
        telemetry.count("tree/splits", splits)
        telemetry.count("tree/leaves", tree.num_leaves)
        # launches: one partition and one smaller-child histogram per
        # split, plus one root histogram per tree on either layout (the
        # JAX planes pack folds its root into the pack pass; the port's
        # pack is a torch copy and the root its own launch). The one-kernel
        # split is one launch per split, counted as a partition launch as
        # the JAX package counts it. The resident layout's three-launch
        # path gathers the route plane before each partition: one
        # route-gather launch more per split.
        kw = self.learner._kw
        one = kw["split_kernel"] == "on"
        telemetry.count("learner/partition_launches", splits)
        telemetry.count("learner/hist_launches", 1 if one else splits + 1)
        telemetry.count("learner/scan_launches", 0 if one else splits)
        if kw["work_layout"] == "resident" and not one:
            telemetry.count("learner/route_gather_launches", splits)
        if kw["goss_compact"]:
            # grown over the in-bag rows alone (GOSS compaction)
            telemetry.count("learner/goss_compact_trees")
        telemetry.gauge("learner/launches_per_split",
                        launches_per_split(kw["work_layout"], one,
                                           device_loop,
                                           self.learner.opts.active,
                                           self.learner.hp.mono_advanced))

    def _shrinkage_rate(self, log: TreeLog) -> float:
        return float(self.config.learning_rate)

    def _finalize_tree(self, log: TreeLog, class_id: int) -> Tree:
        """Host tree from the log, plus the device score updates: the
        training set through the learner's row_leaf, valid sets through
        the router. Constant (1-leaf) trees contribute nothing. An
        objective with leaf renewal (``need_renew``) refits the leaves on
        the host from every row's leaf and the scores before the tree
        (reference: serial_tree_learner.cpp:684 RenewTreeOutput): one read
        of both per tree, on the per-iteration path only
        (:meth:`supports_fused` excludes it). Linear trees (without leaf
        renewal) fit their leaves' models and update the scores from the
        raw features instead (:meth:`_fit_linear_tree`,
        :meth:`_linear_score_updates`)."""
        rate = self._shrinkage_rate(log)
        tree = self.learner.log_to_tree(log)
        if self.objective.need_renew:
            if tree.num_leaves > 1:
                renewed = self.objective.renew_leaf_values(
                    log.row_leaf.cpu().numpy(), tree.num_leaves,
                    self.train_score.np())
                if renewed is not None:
                    tree.leaf_value = renewed.astype(np.float64)
            tree.apply_shrinkage(rate)
            leaf_vals_dev = torch.as_tensor(
                np.asarray(tree.leaf_value, np.float32)).to(self.device)
        else:
            leaf_vals_dev = log.leaf_value * np.float32(rate)
            tree.apply_shrinkage(rate)
        if self.config.linear_tree and not self.objective.need_renew:
            self._fit_linear_tree(tree, log, rate)
            if self.train_set.raw_numeric is not None:
                if tree.num_leaves > 1:
                    self._linear_score_updates(tree, log, class_id)
                return tree
            # no raw features (a binary-cache training set): the leaves
            # stay constant, and so do the score updates
        if tree.num_leaves > 1:
            K = self.num_tree_per_iteration
            self.train_score.add(leaf_vals_dev, log.row_leaf, class_id, K)
            for _, vset, vscore in self.valid_sets:
                vleaf = assign_leaves(
                    self._valid_bins(vset), log,
                    has_categorical=self.learner.hp.has_categorical,
                    bundle=self.learner.bundle,
                    bins_t=self._valid_bins_t(vset))
                vscore.add(leaf_vals_dev, vleaf, class_id, K)
        return tree

    def _fit_linear_tree(self, tree: Tree, log: TreeLog,
                         rate: float) -> None:
        """Fit ridge linear models in the leaves (reference:
        LinearTreeLearner::CalculateLinear, linear_tree_learner.cpp:7):
        solve -(Z^T H Z + lambda I') beta = Z^T g per leaf over the leaf's
        branch numerical features; rows with NaN in those features are
        excluded; under-determined leaves keep the plain output. The first
        iteration only copies constants (the reference skips the fit).
        With :meth:`_linear_fit_on_device` every leaf is fit in one batched
        pass (``linear/fit.fit_linear_leaves``: the Gram kernel on the
        card); else this host f64 loop, the oracle, fits them."""
        from .ops.binning import BIN_CATEGORICAL

        ds = self.train_set
        tree.is_linear = True
        # leaf_value is already shrunk; solved coefficients get the same
        # shrinkage below (the reference applies Tree::Shrinkage to both)
        tree.leaf_const = tree.leaf_value.copy()
        if len(self.models) <= self.num_tree_per_iteration - 1 \
                or tree.num_leaves <= 1 or ds.raw_numeric is None:
            return
        lam = float(self.config.linear_lambda)
        if self._linear_fit_on_device():
            from .linear import fit_linear_leaves
            fit_linear_leaves(tree, ds, log.row_leaf, self._last_ghc,
                              lam=lam, rate=rate,
                              num_leaves_cap=int(self.config.num_leaves))
            return
        leaf = log.row_leaf.cpu().numpy()
        # the bagged and amplified channels the tree grew on (the
        # reference fits over the bagged partition only; out-of-bag rows
        # carry h = 0 here, which drops them from the normal equations)
        ghc = self._last_ghc.cpu().numpy().astype(np.float64)
        gk, hk = ghc[:, 0], ghc[:, 1]
        X = ds.raw_numeric
        for l in range(tree.num_leaves):
            feats = [int(f) for f in tree.branch_features(l)
                     if ds.inner_feature_index(int(f)) >= 0
                     and ds.bin_mappers[ds.inner_feature_index(int(f))]
                     .bin_type != BIN_CATEGORICAL]
            rows = np.flatnonzero(leaf == l)
            if not feats or len(rows) < len(feats) + 1:
                continue
            Z = X[np.ix_(rows, feats)].astype(np.float64)
            ok = ~np.isnan(Z).any(axis=1)
            if int(ok.sum()) < len(feats) + 1:
                continue
            Zk = np.concatenate([Z[ok], np.ones((int(ok.sum()), 1))], axis=1)
            hr = hk[rows][ok]
            A = Zk.T @ (Zk * hr[:, None])
            A[np.arange(len(feats)), np.arange(len(feats))] += lam
            b = Zk.T @ gk[rows][ok]
            try:
                beta = -np.linalg.solve(A, b)
            except np.linalg.LinAlgError:
                continue
            keep = np.abs(beta[:-1]) > 1e-35
            tree.leaf_features[l] = np.asarray(feats, np.int64)[keep]
            tree.leaf_coeff[l] = beta[:-1][keep] * rate
            tree.leaf_const[l] = float(beta[-1]) * rate

    def _linear_fit_on_device(self) -> bool:
        """``linear_device``: off -> the host oracle (a host learner only:
        :meth:`_setup` refuses it on the card), on -> the batched fit on
        the learner's device, auto -> the batched fit on a CUDA device and
        the oracle on the host (the JAX package's rule: the batched fit
        only on an accelerator)."""
        mode = self.config.linear_device
        if mode == "off":
            return False
        if mode == "on":
            return True
        return self.device.type == "cuda"

    def _add_class_scores(self, tracker: "ScoreTracker", vals: np.ndarray,
                          class_id: int) -> None:
        """tracker += f32(vals) in column ``class_id`` (f64 host values)."""
        v = torch.as_tensor(np.asarray(vals, np.float32)).to(self.device)
        if self.num_tree_per_iteration == 1:
            tracker.score = tracker.score + v
        else:
            tracker.score[:, class_id] += v

    def _linear_score_updates(self, tree: Tree, log: TreeLog,
                              class_id: int) -> None:
        """Score updates of a linear tree need the raw feature values, so
        they run on the host, as in the JAX package (reference:
        Tree::AddPredictionToScore with PredictionFunLinear,
        tree.cpp:246): the training rows by their leaves, the valid rows
        routed on the device (a leaf slot per row, mapped to its leaf)."""
        from .utils.log import Log

        leaf = log.row_leaf.cpu().numpy()
        vals = tree.linear_predict(
            self.train_set.raw_numeric.astype(np.float64), leaf)
        self._add_class_scores(self.train_score, vals, class_id)
        for _, vset, vscore in self.valid_sets:
            slot_vals, vleaf = self._route_tree_device(tree, vset)
            if vset.raw_numeric is None:
                # no raw features (a binary-cache valid set): its scores
                # take the plain leaf outputs, so its metrics stay meaningful
                Log.warning("valid set lacks raw features for linear trees; "
                            "using plain leaf outputs for its scores")
                vscore.add(slot_vals, vleaf, class_id,
                           self.num_tree_per_iteration)
                continue
            # the router returns to_split_arrays SLOTS (BFS order); the
            # linear tables are keyed by LEAF id
            leaf_of_slot = tree.to_split_arrays()["leaf_of_slot"]
            vvals = tree.linear_predict(
                vset.raw_numeric.astype(np.float64),
                leaf_of_slot[vleaf.cpu().numpy()])
            self._add_class_scores(vscore, vvals, class_id)

    def rollback_one_iter(self) -> None:
        """(reference: gbdt.cpp:454 RollbackOneIter)"""
        self.finish_fused("rollback_one_iter")
        if self.iter_ <= 0:
            return
        with self._cache_lock:
            for _ in range(self.num_tree_per_iteration):
                self.models.pop()
            self.iter_ -= 1
            self._bump_model_version()
        self._rebuild_scores()

    def _rebuild_scores(self) -> None:
        """Scores replayed from the trees (after rollback or when training
        continues from a loaded model)."""
        self._bump_model_version()
        K = self.num_tree_per_iteration
        ts = self._fresh_tracker(self.train_set)
        for i, tree in enumerate(self.models):
            vals, leaf = self._route_tree_device(tree, self.train_set)
            ts.add(vals, leaf, i % K, K)
        self.train_score = ts
        rebuilt = []
        for name, vset, _ in self.valid_sets:
            vs = self._fresh_tracker(vset)
            for i, tree in enumerate(self.models):
                vals, leaf = self._route_tree_device(tree, vset)
                vs.add(vals, leaf, i % K, K)
            rebuilt.append((name, vset, vs))
        self.valid_sets = rebuilt

    # ------------------------------------------------------------------- eval
    def eval_set(self, name: str, ds: BinnedDataset, tracker: ScoreTracker,
                 feval=None) -> List[Tuple[str, str, float, bool]]:
        out = []
        conv = self.objective.convert_output(tracker.score).cpu().numpy()
        md = ds.metadata
        for m in self.metrics:
            for mname, val in m.eval(conv, md.label, md.weight,
                                     md.query_boundaries):
                out.append((name, mname, float(val), m.greater_is_better))
        if feval is not None:
            res = feval(tracker.np(), ds)
            if res:
                if isinstance(res[0], (list, tuple)):
                    for mname, val, gib in res:
                        out.append((name, mname, float(val), bool(gib)))
                else:
                    mname, val, gib = res
                    out.append((name, mname, float(val), bool(gib)))
        return out

    def eval_train(self, feval=None):
        return self.eval_set("training", self.train_set, self.train_score,
                             feval)

    def eval_valid(self, feval=None):
        out = []
        for name, ds, tracker in self.valid_sets:
            out.extend(self.eval_set(name, ds, tracker, feval))
        return out

    @property
    def current_iteration(self) -> int:
        self.finish_fused("current_iteration")
        return self.iter_

    def num_trees(self) -> int:
        self.finish_fused("num_trees")
        return len(self.models)

    def save_model(self, filename: str, num_iteration: int = -1) -> None:
        self.finish_fused("save_model")
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration))

    # ---------------------------------------------------------- binned route
    def _valid_bins(self, ds: BinnedDataset) -> torch.Tensor:
        """Device copy of a dataset's binned matrix, cached on the
        dataset per device."""
        cache = ds.__dict__.setdefault("_device_bins", {})
        if self.device not in cache:
            cache[self.device] = device_bins(ds.binned, self.device)
        return cache[self.device]

    def _valid_bins_t(self, ds: BinnedDataset) -> torch.Tensor:
        """The router's transposed block form of the device matrix,
        cached like :meth:`_valid_bins` (one transpose per dataset, not
        one per tree)."""
        cache = ds.__dict__.setdefault("_device_bins_t", {})
        if self.device not in cache:
            cache[self.device] = route_layout(self._valid_bins(ds))
        return cache[self.device]

    def _route_tree_device(self, tree: Tree, ds: BinnedDataset):
        """Route a dataset's binned rows through a host Tree on the
        device. Returns (slot-ordered leaf values (L,) numpy, per-row
        slots (N,) device tensor)."""
        from .ops.binning import BIN_CATEGORICAL
        from .ops.predict import tree_to_bin_log

        # content key (not id()): a collected tree's address can be
        # reused by a new tree after a model swap
        key = (tree.num_leaves, tree.split_feature.tobytes(),
               tree.threshold.tobytes(), tree.decision_type.tobytes(),
               tree.leaf_value.tobytes(), id(ds))
        with self._cache_lock:
            log = self._tree_log_cache.get(key)
        if log is None:
            log = tree_to_bin_log(tree, ds, self.device)
            with self._cache_lock:
                if len(self._tree_log_cache) > 4096:
                    self._tree_log_cache.clear()
                self._tree_log_cache[key] = log
        bins = self._valid_bins(ds)
        bundle = None
        if ds.has_bundles:
            bundle = {k: torch.as_tensor(v).to(self.device)
                      for k, v in ds.bundle_maps().items()}
        hc = any(m.bin_type == BIN_CATEGORICAL for m in ds.bin_mappers)
        leaf = assign_leaves(bins, log, has_categorical=hc, bundle=bundle,
                             bins_t=self._valid_bins_t(ds))
        return log.leaf_value.cpu().numpy(), leaf

    # ------------------------------------------------------------- versions
    @property
    def model_version(self) -> int:
        return self._model_version

    def _bump_model_version(self) -> None:
        with self._cache_lock:
            self._model_version += 1

    def adopt(self, other: "GBDT") -> tuple:
        """Atomically swap this booster's served model for ``other``'s
        with a single version bump, so every concurrent PredictSession
        sees the old ensemble or the new one whole. Returns a rollback
        token for :meth:`restore`."""
        self.finish_fused("adopt")
        with self._cache_lock:
            snap = (list(self.models), self.init_scores.copy(), self.iter_,
                    self.best_iteration)
            self.models = list(other.models)
            self.init_scores = np.asarray(other.init_scores,
                                          np.float64).copy()
            self.iter_ = int(other.iter_)
            self.best_iteration = int(getattr(other, "best_iteration", -1))
            self._bump_model_version()
        return snap

    def restore(self, snapshot: tuple) -> None:
        """Roll back to a model captured by :meth:`adopt`."""
        models, init_scores, it, best_it = snapshot
        with self._cache_lock:
            self.models = list(models)
            self.init_scores = np.asarray(init_scores, np.float64).copy()
            self.iter_ = int(it)
            self.best_iteration = int(best_it)
            self._bump_model_version()

    # ---------------------------------------------------------------- packs
    def _packed_model(self, start: int, end: int):
        """Device ``(PackedSplits, has_cat, has_linear, RawWalk)`` for
        iterations [start, end), cached behind the model-version token
        (``serve/pack_build`` / ``serve/pack_hit``). The raw-threshold
        walk's tables (``ops/forest.raw_walk``) are derived once per pack
        on a CUDA device, None on the host (the twin needs none)."""
        from .ops.forest import raw_walk
        from .ops.predict import pack_splits

        self.finish_fused("packed_model")
        with self._cache_lock:
            key = (start, end, self._model_version)
            hit = self._pack_cache.get(key)
            if hit is not None:
                telemetry.count("serve/pack_hit")
                return hit
            if len(self._pack_cache) > 16:
                self._pack_cache.clear()
            telemetry.count("serve/pack_build")
            K = self.num_tree_per_iteration
            pk, has_cat, has_linear = pack_splits(
                self.models[start * K:end * K], num_class=K,
                device=self.device)
            walk = raw_walk(pk) if self.device.type == "cuda" else None
            hit = self._pack_cache[key] = (pk, has_cat, has_linear, walk)
            return hit

    def _forest_knob(self) -> str:
        """Resolved ``tpu_forest_kernel`` for serving sessions. ``auto``
        resolves ``on``: the CUDA forest kernel is the port's serving
        path wherever the model is eligible (``_forest_model`` sends an
        ineligible model to the raw-threshold walk)."""
        cfg = getattr(self.config, "tpu_forest_kernel", "auto")
        if cfg != "auto":
            return cfg
        reason = ("hand-written CUDA forest kernel is the serving path; "
                  "ineligible models (no bin mappers, tables past "
                  "FOREST_VMEM_BUDGET) take the raw-threshold walk")
        telemetry.record("auto_resolution",
                         dedupe_key=("tpu_forest_kernel", "on", reason),
                         knob="tpu_forest_kernel", configured="auto",
                         value="on", reason=reason)
        return "on"

    def _forest_model(self, start: int, end: int):
        """Device BIN-space ``(ForestPack, has_cat, has_linear,
        ForestWalk)`` for [start, end) (the walk tables derived once per
        pack, beside it), or ``None`` when the forest path is structurally
        ineligible (no constructed train_set to supply bin mappers, a
        threshold inside one of its bins, splits on unmapped features,
        tables over the budget). Cached behind the
        model-version token like ``_packed_model``, ineligibility
        included."""
        from .ops.forest import (FOREST_VMEM_BUDGET, forest_pack,
                                 forest_table_bytes, forest_walk)

        self.finish_fused("forest_model")
        with self._cache_lock:
            key = (start, end, self._model_version)
            hit = self._forest_cache.get(key)
            if hit is not None:
                telemetry.count("serve/forest_hit")
                return None if hit[0] == "ineligible" else hit[1]
            if len(self._forest_cache) > 16:
                self._forest_cache.clear()
            ds = self.train_set
            why = None
            entry = None
            K = self.num_tree_per_iteration
            if ds is None:
                why = "no constructed train_set (bin mappers unavailable)"
            else:
                try:
                    telemetry.count("serve/forest_build")
                    fp, has_cat, has_linear = forest_pack(
                        self.models[start * K:end * K], ds, num_class=K,
                        device=self.device)
                    tbytes = forest_table_bytes(fp)
                    if tbytes > FOREST_VMEM_BUDGET:
                        why = ("node tables %d B exceed the %d B budget"
                               % (tbytes, FOREST_VMEM_BUDGET))
                    else:
                        entry = (fp, has_cat, has_linear,
                                 forest_walk(fp))
                except ValueError as exc:
                    why = str(exc)
            if entry is None:
                self._forest_cache[key] = ("ineligible", why)
                telemetry.record("forest_ineligible", dedupe_key=why,
                                 reason=why)
                return None
            self._forest_cache[key] = ("ok", entry)
            return entry

    def _predict_session(self, start: int, end: int):
        """Lazily created serving session per iteration range."""
        from .serve.session import PredictSession

        self.finish_fused("predict_session")
        with self._cache_lock:
            sess = self._serve_sessions.get((start, end))
            if sess is None:
                if len(self._serve_sessions) > 32:
                    self._serve_sessions.clear()
                sess = self._serve_sessions[(start, end)] = PredictSession(
                    self, start_iteration=start, num_iteration=end - start)
            return sess

    # -------------------------------------------------------------- predict
    def _raw_scores(self, X: np.ndarray, start: int, end: int) -> np.ndarray:
        """Ensemble raw scores with optional prediction early stopping
        (reference: src/boosting/prediction_early_stop.cpp)."""
        cfg = self.config
        K = self.num_tree_per_iteration
        es = bool(cfg.pred_early_stop) and self.objective is not None \
            and (self.objective.name in ("binary",)
                 or (K > 1 and "multiclass" in self.objective.name))
        if not es:
            return self._raw_scores_range(X, start, end)
        freq = max(1, int(cfg.pred_early_stop_freq))
        margin_thr = float(cfg.pred_early_stop_margin)
        n = X.shape[0]
        score = np.zeros((n, K), dtype=np.float64)
        active = np.ones(n, dtype=bool)
        init = self.init_scores[None, :K]
        for b0 in range(start, end, freq):
            if not active.any():
                break
            b1 = min(end, b0 + freq)
            score[active] += self._raw_scores_range(X[active], b0, b1)
            full = score[active] + init
            if K == 1:
                margin = 2.0 * np.abs(full[:, 0])
            else:
                top2 = np.partition(full, K - 2, axis=1)[:, K - 2:]
                margin = np.max(top2, axis=1) - np.min(top2, axis=1)
            idx = np.flatnonzero(active)
            active[idx[margin > margin_thr]] = False
        return score

    def _raw_scores_range(self, X: np.ndarray, start: int,
                          end: int) -> np.ndarray:
        """Ensemble raw scores (N, K) over model range [start*K, end*K):
        large batches on the device through a PredictSession, small
        ones by walking the host trees."""
        K = self.num_tree_per_iteration
        n = X.shape[0]
        with self._cache_lock:
            models = self.models[start * K:end * K]
        if n >= self.DEVICE_PREDICT_MIN_ROWS and models:
            return self._predict_session(start, end).raw_scores(X)
        score = np.zeros((n, K), dtype=np.float64)
        for i, t in enumerate(models):
            score[:, (start * K + i) % K] += t.predict(X)
        return score

    def _iteration_range(self, start_iteration: int,
                         num_iteration: int) -> int:
        K = self.num_tree_per_iteration
        total_iters = len(self.models) // max(K, 1)
        if num_iteration is None or num_iteration <= 0:
            num_iteration = total_iters - start_iteration
        return min(total_iters, start_iteration + num_iteration)

    def predict(self, X: np.ndarray, *, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1,
                pred_leaf: bool = False) -> np.ndarray:
        self.finish_fused("predict")
        X = np.asarray(X, dtype=np.float64)
        n = X.shape[0]
        K = self.num_tree_per_iteration
        with self._cache_lock:
            end = self._iteration_range(start_iteration, num_iteration)
            leaf_models = self.models[start_iteration * K:end * K] \
                if pred_leaf else None
        if pred_leaf:
            out = np.zeros((n, (end - start_iteration) * K), dtype=np.int32)
            for i, t in enumerate(leaf_models):
                out[:, i] = t.predict_leaf_index(X)
            return out
        score = self._average(self._raw_scores(X, start_iteration, end),
                              start_iteration, end)
        score = score + self.init_scores[None, :K]
        if not raw_score and self.objective is not None:
            score = self.objective.convert_output(score).numpy()
        return score.ravel() if K == 1 else score

    def _average(self, raw: np.ndarray, start: int, end: int) -> np.ndarray:
        """Raw sums -> model output before init scores (RF averages)."""
        return raw

    # ------------------------------------------------------------- model IO
    def model_to_string(self, num_iteration: int = -1) -> str:
        """(reference: gbdt_model_text.cpp:400 SaveModelToString)"""
        self.finish_fused("model_to_string")
        cfg = self.config
        K = self.num_tree_per_iteration
        with self._cache_lock:
            models = list(self.models)
            init_scores = self.init_scores.copy()
        total_iters = len(models) // max(K, 1)
        if num_iteration is None or num_iteration <= 0:
            num_iteration = total_iters
        end = min(total_iters, num_iteration) * K
        ts = self.train_set
        names = ts.feature_names if ts else getattr(self, "_feature_names",
                                                    [])
        lines = [
            "tree",
            "version=v3",
            "boosting=%s" % self.name,
            "objective=%s" % self._objective_string(),
            "num_class=%d" % self.num_class,
            "num_tree_per_iteration=%d" % K,
            "init_score=%s" % " ".join("%.17g" % v for v in init_scores),
            "max_feature_idx=%d" % (ts.num_total_features - 1 if ts
                                    else len(names) - 1),
            "feature_names=%s" % " ".join(names),
            "best_iteration=%d" % self.best_iteration,
            "",
        ]
        for i, tree in enumerate(models[:end]):
            lines.append("Tree=%d" % i)
            lines.append(tree.to_text())
            lines.append("")
        lines.append("end of trees")
        itype = "gain" if int(cfg.saved_feature_importance_type) == 1 \
            else "split"
        imps = self.feature_importance(itype, num_iteration)
        pairs = [(float(v), names[i] if i < len(names) else
                  "Column_%d" % i) for i, v in enumerate(imps) if v > 0]
        pairs.sort(key=lambda p: -p[0])
        lines.append("")
        lines.append("feature_importances:")
        for v, name in pairs:
            lines.append("%s=%.17g" % (name, v)
                         if itype == "gain" else "%s=%d" % (name, int(v)))
        return "\n".join(lines)

    def to_if_else_cpp(self, num_iteration: int = -1) -> str:
        """Standalone C++ prediction source for the whole ensemble
        (reference: gbdt_model_text.cpp:258 ModelToIfElse; also its model-
        correctness regression harness). Emits per-tree if-else functions,
        a PredictRaw accumulator (init scores included) and extern-C
        single-row entry points so the file both drops into user code and
        compiles into a test harness."""
        self.finish_fused("to_if_else_cpp")
        K = self.num_tree_per_iteration
        total_iters = len(self.models) // max(K, 1)
        if num_iteration is None or num_iteration <= 0:
            num_iteration = total_iters
        end = min(total_iters, num_iteration) * K
        parts = [
            "// generated by lightgbm_tpu task=convert_model",
            "#include <cmath>",
            "#include <cstdint>",
            "#include <algorithm>",
            "",
            "static inline bool cat_in(int64_t v, const int64_t* arr, "
            "int n) {",
            "  return std::binary_search(arr, arr + n, v);",
            "}",
            "",
        ]
        for i, tree in enumerate(self.models[:end]):
            parts.append(tree.to_if_else(i))
            parts.append("")
        init = ", ".join("%.17g" % v for v in self.init_scores[:max(K, 1)])
        parts += [
            "static const int kNumClass = %d;" % max(K, 1),
            "static const int kNumTrees = %d;" % end,
            "static const double kInitScore[%d] = {%s};" % (max(K, 1), init),
            "",
            "typedef double (*TreeFn)(const double*);",
            "static const TreeFn kTrees[%d] = {%s};" % (
                max(end, 1),
                ", ".join("PredictTree%d" % i for i in range(end)) or "0"),
            "",
            "extern \"C\" void PredictRaw(const double* arr, double* out) {",
            "  for (int k = 0; k < kNumClass; ++k) out[k] = kInitScore[k];",
            "  for (int i = 0; i < kNumTrees; ++i) {",
            "    out[i % kNumClass] += kTrees[i](arr);",
            "  }",
            "}",
            "",
        ]
        obj = self.objective.name if self.objective else ""
        if obj == "binary":
            sig = self.config.sigmoid
            transform = ("  out[0] = 1.0 / (1.0 + std::exp(-%.17g * "
                         "out[0]));" % sig)
        elif obj in ("multiclassova", "ova"):
            sig = self.config.sigmoid
            transform = ("  for (int k = 0; k < kNumClass; ++k) out[k] = "
                         "1.0 / (1.0 + std::exp(-%.17g * out[k]));" % sig)
        elif obj in ("multiclass", "softmax"):
            transform = (
                "  double m = out[0];\n"
                "  for (int k = 1; k < kNumClass; ++k) m = std::max(m, "
                "out[k]);\n"
                "  double s = 0;\n"
                "  for (int k = 0; k < kNumClass; ++k) { out[k] = "
                "std::exp(out[k] - m); s += out[k]; }\n"
                "  for (int k = 0; k < kNumClass; ++k) out[k] /= s;")
        else:
            transform = "  // identity output transform"
        parts += [
            "extern \"C\" void Predict(const double* arr, double* out) {",
            "  PredictRaw(arr, out);",
            transform,
            "}",
            "",
        ]
        return "\n".join(parts)

    def dump_json(self, num_iteration: int = -1) -> str:
        self.finish_fused("dump_json")
        K = self.num_tree_per_iteration
        total_iters = len(self.models) // max(K, 1)
        if num_iteration is None or num_iteration <= 0:
            num_iteration = total_iters
        end = min(total_iters, num_iteration) * K
        d = {
            "name": "tree",
            "version": "v3",
            "objective": self._objective_string(),
            "num_class": self.num_class,
            "num_tree_per_iteration": K,
            "init_score": self.init_scores.tolist(),
            "tree_info": [t.to_dict() for t in self.models[:end]],
        }
        return json.dumps(d)

    def _objective_string(self) -> str:
        obj = self.objective.name if self.objective else self.config.objective
        if obj in ("multiclass", "multiclassova"):
            return "%s num_class:%d" % (obj, self.num_class)
        return obj

    @classmethod
    def model_from_string(cls, s: str,
                          config: Optional[Config] = None) -> "GBDT":
        config = config or Config()
        header, _, rest = s.partition("Tree=")
        kv: Dict[str, str] = {}
        for line in header.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        obj_str = kv.get("objective", "regression").split()
        config.objective = obj_str[0]
        for tok in obj_str[1:]:
            if tok.startswith("num_class:"):
                config.num_class = int(tok.split(":")[1])
        booster_cls = {"gbdt": cls, "dart": DART, "rf": RF}.get(
            kv.get("boosting", "gbdt"), cls)
        model = booster_cls(config, None)
        model.num_tree_per_iteration = int(kv.get("num_tree_per_iteration", 1))
        model.num_class = int(kv.get("num_class", 1))
        init = kv.get("init_score", "0").split()
        model.init_scores = np.asarray([float(v) for v in init],
                                       dtype=np.float64)
        model.best_iteration = int(kv.get("best_iteration", -1))
        model.objective = create_objective(config)
        model._feature_names = kv.get("feature_names", "").split()
        for block in ("Tree=" + rest).split("Tree=")[1:]:
            block = block.split("end of trees")[0]
            lines = block.strip().splitlines()[1:]  # drop the index line
            model.models.append(Tree.from_text("\n".join(lines)))
        model.iter_ = len(model.models) // max(model.num_tree_per_iteration, 1)
        return model

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        """(reference: GBDT::FeatureImportance, gbdt.cpp)"""
        self.finish_fused("feature_importance")
        with self._cache_lock:
            models = list(self.models)
        nf = self.train_set.num_total_features if self.train_set else (
            max((int(t.split_feature.max()) for t in models
                 if t.num_leaves > 1), default=-1) + 1)
        imp = np.zeros(nf, dtype=np.float64)
        K = self.num_tree_per_iteration
        end = len(models) if iteration <= 0 else min(
            len(models), iteration * K)
        for t in models[:end]:
            if t.num_leaves <= 1:
                continue
            for r in range(t.num_internal):
                if importance_type == "split":
                    imp[t.split_feature[r]] += 1
                else:
                    imp[t.split_feature[r]] += max(0.0, float(t.split_gain[r]))
        return imp


class DART(GBDT):
    """Dropout boosting (reference: src/boosting/dart.hpp), per iteration:
    each iteration drops a random set of earlier iterations' trees from
    the scores, trains on the rest, then normalises the new tree and the
    dropped ones. Its trees carry their normalised leaf values, so serving
    is plain GBDT."""

    name = "dart"

    def __init__(self, config: Config,
                 train_set: Optional[BinnedDataset] = None) -> None:
        super().__init__(config, train_set)
        self._drop_rng = np.random.RandomState(config.drop_seed)

    def _drop_set(self) -> List[int]:
        """The iterations to drop (dart.hpp:97 DroppingTrees), drawn as the
        JAX package draws them: ``skip_drop`` and the set from the
        ``drop_seed`` stream; without ``uniform_drop`` the set's size from
        ``RandomState(drop_seed + iter).binomial``, at most ``max_drop``."""
        cfg = self.config
        if not (self._drop_rng.rand() >= cfg.skip_drop and self.iter_ > 0):
            return []
        n_iters = self.iter_
        if cfg.uniform_drop:
            sel = self._drop_rng.rand(n_iters) < cfg.drop_rate
            return [int(i) for i in np.flatnonzero(sel)]
        p = min(1.0, cfg.drop_rate)
        k_drop = min(cfg.max_drop, np.random.RandomState(
            cfg.drop_seed + self.iter_).binomial(n_iters, p))
        if k_drop <= 0:
            return []
        return [int(i) for i in self._drop_rng.choice(n_iters, size=k_drop,
                                                      replace=False)]

    def train_one_iter(self, grad=None, hess=None) -> bool:
        cfg = self.config
        K = self.num_tree_per_iteration
        drop = self._drop_set()
        for it_idx in drop:
            for k in range(K):
                self._apply_tree_delta(self.models[it_idx * K + k], k, -1.0)
        k_cnt = len(drop)
        stop = super().train_one_iter(grad, hess)
        if stop:
            # no tree grew: the dropped trees go back untouched
            for it_idx in drop:
                for k in range(K):
                    self._apply_tree_delta(self.models[it_idx * K + k], k,
                                           1.0)
            return stop
        # ---- normalise (dart.hpp:65 Normalize) ----
        norm = 1.0 / (k_cnt + 1.0)
        if cfg.xgboost_dart_mode:
            norm = cfg.learning_rate / (k_cnt + cfg.learning_rate)
        # the committed trees change in place: under the model lock, so
        # that no serving pack sees half of them rescaled, then a version
        # bump
        with self._cache_lock:
            for k in range(K):
                tree = self.models[-K + k]
                self._apply_tree_delta(tree, k, norm - 1.0)
                tree.apply_shrinkage(norm)
            if k_cnt > 0:
                factor = k_cnt / (k_cnt + 1.0)
                if cfg.xgboost_dart_mode:
                    factor = k_cnt / (k_cnt + cfg.learning_rate)
                for it_idx in drop:
                    for k in range(K):
                        tree = self.models[it_idx * K + k]
                        self._apply_tree_delta(tree, k, factor)
                        tree.apply_shrinkage(factor)
            self._bump_model_version()
        return stop

    def _apply_tree_delta(self, tree: Tree, class_id: int,
                          scale: float) -> None:
        """Add ``scale`` x the tree's outputs to the training and valid
        scores, routed on the device (the router kernel on the card)."""
        K = self.num_tree_per_iteration
        vals, leaf = self._route_tree_device(tree, self.train_set)
        self.train_score.add(vals, leaf, class_id, K, scale=scale)
        for _, vset, vscore in self.valid_sets:
            vvals, vleaf = self._route_tree_device(tree, vset)
            vscore.add(vvals, vleaf, class_id, K, scale=scale)


class RF(GBDT):
    """Random forest (reference: src/boosting/rf.hpp), per iteration:
    bagging, gradients always at the constant init scores, trees without
    shrinkage, and scores that are the running average of the trees'
    outputs; the output is the average of the trees' outputs."""

    name = "rf"

    def __init__(self, config: Config,
                 train_set: Optional[BinnedDataset] = None) -> None:
        super().__init__(config, train_set)
        self._init_score_dev: Optional[torch.Tensor] = None
        if train_set is not None:
            # a copy: ScoreTracker.add updates the training scores in
            # place, and the gradients must stay at the init scores
            self._init_score_dev = self.train_score.score.clone()

    def train_one_iter(self, grad=None, hess=None) -> bool:
        it = self.iter_
        K = self.num_tree_per_iteration
        if grad is None:
            obj = self.objective
            g, h = (obj.get_gradients(self._init_score_dev, it)
                    if obj.needs_iter
                    else obj.get_gradients(self._init_score_dev))
        else:
            n = self.train_set.num_data
            g = torch.as_tensor(np.asarray(grad, np.float32)).to(self.device)
            h = torch.as_tensor(np.asarray(hess, np.float32)).to(self.device)
            if K > 1:
                g, h = g.reshape(n, K), h.reshape(n, K)
        self._bagging(it, g, h)
        fmask = self._feature_mask(it)
        any_ok = False
        for k in range(K):
            key = fold_in(self._key, it * 131 + k)
            log = self.learner.train(self._tree_channels(g, h, k), fmask,
                                     key, self._cegb_used)
            if self.learner.hp.use_cegb:
                note_used_features(self._cegb_used, log)
            tree = self.learner.log_to_tree(log)
            with self._cache_lock:
                self.models.append(tree)
            self._count_tree(tree, self.learner.train_on_loop)
            self._accumulate_avg(tree, log, k)
            if tree.num_leaves > 1:
                any_ok = True
        with self._cache_lock:
            self.iter_ += 1
            self._bump_model_version()
        return not any_ok

    def _accumulate_avg(self, tree: Tree, log: TreeLog,
                        class_id: int) -> None:
        """The running average over iterations, new = (old * it + tree) /
        (it + 1), of the training and valid scores less the init score."""
        it = self.iter_
        lv = torch.as_tensor(np.asarray(tree.leaf_value, np.float32)).to(
            self.device)
        init = self.init_scores[class_id if self.num_class > 1 else 0]

        def average(tracker, vals):
            col = tracker.score[:, class_id] if self.num_class > 1 \
                else tracker.score
            new = ((col - init) * it + vals) / (it + 1) + init
            if self.num_class > 1:
                tracker.score[:, class_id] = new
            else:
                tracker.score = new

        average(self.train_score, leaf_values_by_row(lv, log.row_leaf))
        for _, vset, vscore in self.valid_sets:
            vleaf = assign_leaves(
                self._valid_bins(vset), log,
                has_categorical=self.learner.hp.has_categorical,
                bundle=self.learner.bundle, bins_t=self._valid_bins_t(vset))
            average(vscore, leaf_values_by_row(lv, vleaf))

    def _average(self, raw: np.ndarray, start: int, end: int) -> np.ndarray:
        return raw / max(1, end - start)


def create_boosting(config: Config,
                    train_set: Optional[BinnedDataset] = None) -> GBDT:
    """Factory (reference: src/boosting/boosting.cpp:35 CreateBoosting)."""
    kind = config.boosting
    if kind in ("gbdt", "gbrt", "goss"):
        return GBDT(config, train_set)
    if kind == "dart":
        return DART(config, train_set)
    if kind in ("rf", "random_forest"):
        return RF(config, train_set)
    raise LightGBMError("Unknown boosting type: %s" % kind)
