"""Fused K-iteration blocks and the row and column samplers (PyTorch port
of ``lightgbm_tpu/fused.py``).

When no per-iteration host observation is needed (no valid set, no
callback, no custom objective), :class:`FusedTrainer` runs K boosting
iterations as one block: gradients, sampling, one tree per class and the
score update, all queued on the device; the block's split logs are stacked
on the device and copied to the host once, into pinned memory behind an
event; the host trees are built one block behind, while the next block
runs. The JAX package runs the block as one jitted ``lax.scan``; here each
tree of the one-kernel split on data without categorical features is one
replay of the learner's CUDA graph (``learner.DeviceTreeLoop``), and every
other configuration, and every configuration on host tensors, grows its
trees with the per-split host loop (``learner.build_tree_partitioned``)
inside the block. Both give the trees of the per-iteration path byte for
byte.

Bagging, balanced bagging, GOSS and ``feature_fraction`` draw their masks
from the port's threefry (``prng.py``), keyed by ``bagging_seed`` and
``feature_fraction_seed`` alone, exactly as the JAX package keys them: the
same config gives the same masks in both packages, bit for bit. The draws
are torch operations on the device of the tensors they are given, with
no host round trip.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .obs import telemetry
from .prng import Key, PRNGKey, fold_in, uniform
from .utils.log import LightGBMError, Log

#: a sampler maps (iteration, |grad|, |hess|) to (inbag, amplification),
#: both (N,) f32 on the device of the gradients
Sampler = Callable[[int, torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor]]


def _seed_key(seed: int) -> Key:
    return PRNGKey(int(seed) & 0x7FFFFFFF)


def make_sampler(config, num_data: int) -> Optional[Sampler]:
    """(inbag, amplification) masks per iteration; None when sampling is
    off (reference: gbdt.cpp:228 Bagging, goss.hpp:103)."""
    cfg = config
    if cfg.data_sample_strategy == "goss":
        warmup = int(1.0 / max(cfg.learning_rate, 1e-12))
        top_rate, other_rate = cfg.top_rate, cfg.other_rate
        if top_rate + other_rate >= 1.0:
            return None
        base = _seed_key(cfg.bagging_seed)
        top_k = max(1, int(num_data * top_rate))
        rest_rate = other_rate / max(1e-12, 1.0 - top_rate)
        amp = (1.0 - top_rate) / max(other_rate, 1e-12)

        def goss(it, g, h):
            ones = torch.ones(num_data, dtype=torch.float32, device=g.device)
            if it < warmup:
                return ones, ones
            s = torch.abs(g * h)
            # the k-th largest score: the value of top_k(s)[k-1], ties
            # included, as jax.lax.top_k gives it
            thr = torch.topk(s, top_k, sorted=True).values[top_k - 1]
            is_top = s >= thr
            u = uniform(fold_in(base, 7000 + it), (num_data,), device=g.device)
            sampled = (u < rest_rate) & ~is_top
            inbag = (is_top | sampled).to(torch.float32)
            ampv = torch.where(sampled, torch.full_like(ones, amp), ones)
            return inbag, ampv

        return goss
    need = cfg.bagging_freq > 0 and (
        cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0
        or cfg.neg_bagging_fraction < 1.0)
    if not need:
        return None
    freq = max(1, cfg.bagging_freq)
    base = _seed_key(cfg.bagging_seed)

    def bagging(it, g, h):
        u = uniform(fold_in(base, 9000 + it // freq), (num_data,),
                    device=g.device)
        mask = (u < cfg.bagging_fraction).to(torch.float32)
        return mask, torch.ones_like(mask)

    return bagging


def make_balanced_sampler(config, label: torch.Tensor) -> Sampler:
    """Bagging with separate fractions for positive and negative labels
    (``pos_bagging_fraction`` / ``neg_bagging_fraction``)."""
    cfg = config
    freq = max(1, cfg.bagging_freq)
    pos = label > 0
    base = _seed_key(cfg.bagging_seed)

    def bagging(it, g, h):
        u = uniform(fold_in(base, 9000 + it // freq), tuple(label.shape),
                    device=label.device)
        mask = torch.where(pos, u < cfg.pos_bagging_fraction,
                           u < cfg.neg_bagging_fraction).to(torch.float32)
        return mask, torch.ones_like(mask)

    return bagging


def make_feature_mask_fn(config, num_feat: int,
                         device: Optional[torch.device] = None):
    """Per-iteration by-tree column mask, (F,) bool; None when
    ``feature_fraction >= 1``."""
    cfg = config
    if cfg.feature_fraction >= 1.0:
        return None
    kk = max(1, int(np.ceil(cfg.feature_fraction * num_feat)))
    base = _seed_key(cfg.feature_fraction_seed)

    def fmask(it: int) -> torch.Tensor:
        u = uniform(fold_in(base, 555 + it), (num_feat,), device=device)
        rank = torch.argsort(torch.argsort(u, stable=True), stable=True)
        return rank < kk

    return fmask


# ---------------------------------------------------------------------------
# Fused blocks
# ---------------------------------------------------------------------------

class BlockLogs(NamedTuple):
    """The per-tree split-log fields a fused block copies to the host
    (``learner.TreeLog`` less what only the device needs)."""
    num_splits: torch.Tensor
    split_leaf: torch.Tensor
    feature: torch.Tensor
    bin: torch.Tensor
    kind: torch.Tensor
    default_left: torch.Tensor
    gain: torch.Tensor
    left_sum: torch.Tensor
    right_sum: torch.Tensor
    go_left: torch.Tensor
    leaf_value: torch.Tensor


def _small(log, has_categorical: bool) -> BlockLogs:
    # go_left is only consumed for categorical splits (numerical routing
    # rebuilds from feature/bin/default_left); dropping the (R, B) table
    # from the block's device->host copy saves its payload entirely on
    # categorical-free datasets
    return BlockLogs(
        num_splits=log.num_splits, split_leaf=log.split_leaf,
        feature=log.feature, bin=log.bin, kind=log.kind,
        default_left=log.default_left, gain=log.gain,
        left_sum=log.left_sum, right_sum=log.right_sum,
        go_left=log.go_left if has_categorical else log.go_left[:0],
        leaf_value=log.leaf_value)


class _Pending(NamedTuple):
    """A dispatched block: its logs' bytes on the host (valid once
    ``event`` completed), their layout, its length and the scores before
    it (for the rollback)."""
    host: torch.Tensor
    event: Optional[object]
    layout: List[Tuple[str, np.dtype, tuple, int]]
    k: int
    pre_score: torch.Tensor


def _pack(logs: List[BlockLogs]) -> Tuple[torch.Tensor, list]:
    """Stack the trees' logs field by field and lay them out as one byte
    buffer on their device: (buffer, [(field, dtype, shape, offset)])."""
    parts, layout, off = [], [], 0
    for name in BlockLogs._fields:
        t = torch.stack([getattr(lg, name) for lg in logs]).contiguous()
        b = t.view(torch.uint8).reshape(-1) if t.numel() else \
            torch.zeros(0, dtype=torch.uint8, device=t.device)
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        layout.append((name, dtype, tuple(t.shape), off))
        parts.append(b)
        off += b.numel()
    return torch.cat(parts), layout


def _unpack(host: np.ndarray, layout) -> BlockLogs:
    out = {}
    for name, dtype, shape, off in layout:
        n = int(np.prod(shape)) * dtype.itemsize
        out[name] = np.frombuffer(host[off:off + n].tobytes(),
                                  dtype=dtype).reshape(shape)
    return BlockLogs(**out)


def check_finite(kind: str, t: torch.Tensor, mode: str) -> int:
    """Count the non-finite elements of ``t`` into ``obs/nonfinite_<kind>``
    and warn or raise per ``mode`` (``obs_check_finite``; the JAX
    package's ``obs_device.check_finite``). The count is read back: an
    intentional wait for the block it checks."""
    if mode == "off":
        return 0
    n = int(torch.count_nonzero(~torch.isfinite(t)))
    telemetry.count("obs/finite_checks")
    if n:
        telemetry.count("obs/nonfinite_" + kind, n)
        msg = ("non-finite values in %s: %d elements (objective blow-up "
               "or bad input; see obs/nonfinite_%s)" % (kind, n, kind))
        if mode == "raise":
            raise LightGBMError(msg)
        Log.warning(msg)
    return n


class FusedTrainer:
    """K boosting iterations per block for a :class:`~lightgbm_tpu_torch.
    boosting.GBDT` (the JAX package's ``FusedTrainer``): :meth:`run`
    queues a block and builds the previous block's host trees while it
    runs; :meth:`flush` finalizes the block in flight."""

    def __init__(self, gbdt) -> None:
        self.gbdt = gbdt
        self.learner = gbdt.learner
        self.config = gbdt.config
        #: the block dispatched but not finalized
        self._pending: Optional[_Pending] = None
        #: trees through the device tree loop (and its CUDA graph) on the
        #: card, in every configuration the learner accepts; on host
        #: tensors the per-split host loop grows the same tree faster (no
        #: device to keep busy, and the loop's twins work on whole planes:
        #: O(N) a split)
        self.device_loop = self.learner.device_loop_eligible() \
            and self.learner.device.type == "cuda"

    def _tree(self, ghc: torch.Tensor, fmask: torch.Tensor, key):
        if self.device_loop:
            return self.learner.train_device(ghc, fmask, key)
        return self.learner.train(ghc, fmask, key)

    def run(self, k: int) -> bool:
        """Run k fused iterations. Returns True when training should stop.

        Pipelined: the block is queued on the device and the PREVIOUS
        block's host work (waiting for its logs, building its trees)
        happens while the new block runs. The returned stop signal
        therefore refers to the previous block; when it fires, the
        in-flight block is rolled back, so training stops at the block
        whose last iteration was all-constant, as the JAX package stops
        (reference: gbdt.cpp:379 "no more leaves"). Callers must invoke
        :meth:`flush` when the training loop ends. Every tree a kept
        block computed is kept (constant trees added nothing to the
        scores), so model and scores stay consistent."""
        gbdt = self.gbdt
        prev = self._pending
        K = gbdt.num_tree_per_iteration
        lr = np.float32(self.config.learning_rate)
        has_cat = self.learner.hp.has_categorical
        # iter_ only advances when a block is finalized; schedule from it
        # plus the not-yet-finalized block's length
        it0 = gbdt.iter_ + (prev.k if prev is not None else 0)
        pre_score = gbdt.train_score.score.clone()
        telemetry.count("fused/blocks_dispatched")
        telemetry.count("fused/iters_dispatched", k)
        logs = []
        for it in range(it0, it0 + k):
            g, h = gbdt.gradients(it)
            gbdt._bagging(it, g, h)
            fmask = gbdt._feature_mask(it)
            for c in range(K):
                log = self._tree(gbdt._tree_channels(g, h, c), fmask,
                                 fold_in(gbdt._key, it * 131 + c))
                # a constant tree adds nothing (the num_splits mask)
                gbdt.train_score.add(
                    log.leaf_value * lr * (log.num_splits > 0),
                    log.row_leaf, c, K)
                logs.append(_small(log, has_cat))
        buf, layout = _pack(logs)
        event = None
        if buf.device.type == "cuda":
            host = torch.empty(buf.numel(), dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = buf
        self._pending = _Pending(host, event, layout, k, pre_score)
        if self.config.obs_check_finite != "off":
            # opt-in watchdog: waits for THIS block, trading the pipeline
            # overlap for catching a NaN blow-up at the block it happened
            check_finite("scores", gbdt.train_score.score,
                         self.config.obs_check_finite)
        stopped = self._finalize(prev)
        if stopped:
            # the previous block ended all-constant: drop the one in
            # flight
            self._rollback(pre_score)
        return stopped

    def _rollback(self, pre_score: torch.Tensor) -> None:
        """Drop the in-flight block and restore the scores before it."""
        self.gbdt.train_score.score = pre_score
        self._pending = None

    def flush(self, reason: str = "unspecified") -> bool:
        """Finalize the in-flight block, if any. Returns True when it
        ended all-constant. ``reason`` names the reader that forced the
        flush (predict, model_to_string, train_end, ...): counted under
        ``fused/flush/<reason>`` when a block was in flight."""
        pending = self._pending
        self._pending = None
        if pending is not None:
            telemetry.count("fused/flush/" + reason)
        return self._finalize(pending)

    def _finalize(self, pending: Optional[_Pending]) -> bool:
        """Append a dispatched block's trees and advance ``iter_``. On a
        failure (device error, interrupt) the booster rolls back to its
        last finalized state: the scores revert to the block's inputs, no
        partial trees are kept and a block in flight is dropped."""
        if pending is None:
            return False
        gbdt = self.gbdt
        K = gbdt.num_tree_per_iteration
        lr = float(self.config.learning_rate)
        trees = []
        last_iter_constant = False
        try:
            if pending.event is not None:
                pending.event.synchronize()
            host = _unpack(pending.host.numpy(), pending.layout)
            for i in range(pending.k):
                all_constant = True
                for c in range(K):
                    tree = self._host_tree(host, i * K + c)
                    tree.apply_shrinkage(lr)
                    trees.append(tree)
                    if tree.num_leaves > 1:
                        all_constant = False
                last_iter_constant = all_constant
        except BaseException:
            self._rollback(pending.pre_score)
            raise
        # atomic commit: models, iter_ and the version move together, under
        # the model lock so serving never packs mid-commit
        with gbdt._cache_lock:
            gbdt.models.extend(trees)
            gbdt.iter_ += pending.k
            gbdt._bump_model_version()
        self._count_trees(trees)
        return last_iter_constant

    def _count_trees(self, trees) -> None:
        """The ``tree/*`` and ``learner/*`` counts of the finalized trees,
        as the per-iteration path counts them."""
        for tree in trees:
            self.gbdt._count_tree(tree, device_loop=self.device_loop)

    def _host_tree(self, host: BlockLogs, i: int):
        from .tree import Tree
        ds = self.learner.dataset
        has_tbl = host.go_left.shape[-2] > 0
        return Tree.from_split_log(
            int(host.num_splits[i].reshape(-1)[0]), host.split_leaf[i],
            host.feature[i], host.bin[i], host.default_left[i],
            host.gain[i], host.left_sum[i], host.right_sum[i],
            host.leaf_value[i], bin_mappers=ds.bin_mappers,
            real_feature_index=ds.used_feature_indices,
            go_left_table=host.go_left[i] if has_tbl else None,
            is_categorical=host.kind[i] > 0)
