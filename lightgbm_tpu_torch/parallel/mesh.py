"""Distributed tree learners (data / feature / voting) over a
``torch.distributed`` process group (PyTorch port of
``lightgbm_tpu/parallel/mesh.py``; reference:
src/treelearner/data_parallel_tree_learner.cpp,
feature_parallel_tree_learner.cpp, voting_parallel_tree_learner.cpp).

The JAX package's mesh becomes a process group with one process a rank:
the mesh's device count is the group's world size D, a shard's index the
rank. Every rank runs the same per-split host loop
(``learner.build_tree_partitioned``, or ``build_tree`` for the dense
builder in data mode) over its own rows through the port's kernels on its
card, and ``learner.Comm`` joins the ranks:

- data-parallel: rows sharded, each split's smaller-child histogram
  reduced (reduce-scattered by bundle-group blocks with
  ``tpu_hist_scatter``, each rank then searching its block and the winner
  synced);
- feature-parallel: every row on every rank, the split search sharded by
  feature ownership and the winning SplitInfo synced;
- voting-parallel: rows sharded, histograms local; the ranks vote their
  local top-k features and the global top-2k features' rows are merged.

With a replicated ``Dataset`` rank r takes rows ``[r * P / D, (r + 1) * P
/ D)`` of ``P = round_up(N, D)``; the pad rows are zero bins with zero
g, h and count. A sharded dataset (``io.load_dataset_sharded``,
``shard_info``) holds the rank's own rows, padded to ``round_up(n_total,
D) / world``. Gradients are the booster's (all rows of a replicated
dataset, sliced here; the local rows of a sharded one), and ``row_leaf``
comes back as the booster's rows: gathered from every rank, or the local
rows. Distributed trees take the per-split host loop (the booster's fused
blocks exclude these learners) and the chain's kernels: the one-kernel
split and GOSS compaction are ineligible under a comm, with the JAX
package's warnings.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..learner import Comm, SerialTreeLearner, TreeLog, device_bins
from ..utils.log import Log


def round_up(n: int, d: int) -> int:
    return ((n + d - 1) // d) * d


def group_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def group_rank(group) -> int:
    import torch.distributed as dist
    return dist.get_rank(group)


class _MeshTreeLearner(SerialTreeLearner):
    """The shared wiring of the distributed learners: the rank's rows, its
    comm, and the gradients and ``row_leaf`` to and from the booster's
    rows."""

    comm_mode = "data"
    rows_sharded = True

    def __init__(self, config, dataset, group,
                 device: Optional[torch.device] = None,
                 bins: Optional[torch.Tensor] = None,
                 bins_t: Optional[torch.Tensor] = None) -> None:
        from ..device import resolve_device

        self.group = group
        self.world = group_size(group)
        self.rank = group_rank(group)
        dev = device if device is not None \
            else resolve_device(config.device_type)
        n = dataset.num_data
        d = self.world
        shard = getattr(dataset, "shard_info", None)
        #: (rank, world, n_total) of a sharded dataset in use, else None
        self.shard = shard if shard is not None and shard[1] > 1 else None
        if self.rows_sharded:
            if self.shard is not None:
                # the dataset holds only this rank's rows (the reference's
                # per-rank partitions, dataset_loader.cpp:951)
                _, world, n_total = self.shard
                if world != d:
                    Log.fatal("dataset was sharded for %d processes but %d "
                              "are running", world, d)
                self.padded_n = round_up(n_total, d)
                per = self.padded_n // world
                if n > per:
                    Log.fatal("shard %d has %d rows > %d per-process "
                              "capacity", self.shard[0], n, per)
                lo, hi = 0, n
            else:
                self.padded_n = round_up(n, d)
                per = self.padded_n // d
                lo = min(self.rank * per, n)
                hi = min(lo + per, n)
            #: this rank's rows of the booster's, and its block's length
            self.block = (lo, hi, per)
            local = np.asarray(dataset.binned[lo:hi])
            if hi - lo < per:
                local = np.concatenate(
                    [local, np.zeros((per - (hi - lo), local.shape[1]),
                                     dtype=local.dtype)])
            bins, bins_t = device_bins(local, dev), None
        else:
            if self.shard is not None:
                Log.fatal("tree_learner=%s keeps every row on every rank; "
                          "a sharded dataset holds one rank's rows",
                          self.comm_mode)
            self.padded_n = n
            self.block = (0, n, n)
        super().__init__(config, dataset, dev, bins=bins, bins_t=bins_t)
        if self.comm_mode != "data" and not self.use_partition():
            Log.fatal("tree_learner=%s requires the partitioned builder "
                      "(max_bin <= 256)", self.comm_mode)

    def _make_comm(self) -> Comm:
        return Comm(self.group, mode=self.comm_mode,
                    top_k=int(self.config.top_k), num_machines=self.world,
                    hist_scatter=bool(self.config.tpu_hist_scatter))

    def train(self, ghc: torch.Tensor,
              feature_mask: Optional[torch.Tensor] = None,
              key=None, cegb_used: Optional[torch.Tensor] = None) -> TreeLog:
        """One tree from the booster's (N, 3) channels, through the
        per-split host loop on this rank's rows; the log's ``row_leaf``
        holds the booster's rows."""
        lo, hi, per = self.block
        blk = ghc[lo:hi]
        if hi - lo < per:
            blk = torch.cat([blk, torch.zeros((per - (hi - lo), 3),
                                              dtype=ghc.dtype,
                                              device=ghc.device)])
        log = self.train_host_loop(blk, feature_mask, key, cegb_used)
        row_leaf = log.row_leaf
        if self.rows_sharded:
            n = self.dataset.num_data
            if self.shard is None:
                row_leaf = self.comm.all_gather(row_leaf).reshape(-1)[:n]
            else:
                row_leaf = row_leaf[:n]
            self.last_stats["row_leaf"] = row_leaf
        return log._replace(row_leaf=row_leaf)


class DataParallelTreeLearner(_MeshTreeLearner):
    """tree_learner=data: rows sharded, histograms globally reduced
    (reference: DataParallelTreeLearner)."""

    comm_mode = "data"
    rows_sharded = True


class FeatureParallelTreeLearner(_MeshTreeLearner):
    """tree_learner=feature: every row on every rank, the split search
    sharded over features, the winner synced: one SplitInfo a node
    (reference: FeatureParallelTreeLearner)."""

    comm_mode = "feature"
    rows_sharded = False


class VotingParallelTreeLearner(_MeshTreeLearner):
    """tree_learner=voting: data-parallel with top-k feature voting, the
    merged rows bounded as features grow (reference:
    VotingParallelTreeLearner / PV-Tree)."""

    comm_mode = "voting"
    rows_sharded = True


def create_tree_learner(config, dataset, group=None,
                        device: Optional[torch.device] = None,
                        bins: Optional[torch.Tensor] = None,
                        bins_t: Optional[torch.Tensor] = None
                        ) -> SerialTreeLearner:
    """Factory (reference: tree_learner.cpp:15 CreateTreeLearner): the
    serial learner for ``tree_learner=serial``, without a process group or
    at world size 1, else the mode's distributed learner over ``group``.
    ``bins`` / ``bins_t`` are the booster's device copies of every row."""
    kind = config.tree_learner
    if kind == "serial" or group is None or group_size(group) <= 1:
        return SerialTreeLearner(config, dataset, device, bins=bins,
                                 bins_t=bins_t)
    cls = {"data": DataParallelTreeLearner,
           "feature": FeatureParallelTreeLearner,
           "voting": VotingParallelTreeLearner}.get(kind)
    if cls is None:
        Log.fatal("Unknown tree_learner: %s", kind)
    return cls(config, dataset, group, device, bins=bins, bins_t=bins_t)
