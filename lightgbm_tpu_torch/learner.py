"""Leaf-wise tree growth and binned-row routing (PyTorch port of
``lightgbm_tpu/learner.py``).

:func:`build_tree_partitioned` grows one tree on the planes, resident or
rows work layout (the JAX package's ``tpu_work_layout`` and
``tpu_resident_state``): per split, a stable
partition of the parent's rows (``ops/partition.partition_segment`` /
``partition_segment_rows``, CUDA kernels on the card), a histogram of the
smaller child's contiguous segment (``ops/histogram.segment_histogram`` /
``segment_histogram_rows``, or ``segment_histogram_q`` for int8 quantized
gradients, which train on the rows layout only) with the sibling as parent
minus child, and the split scan over both children
(``ops/split.find_best_split``). With ``split_kernel="on"`` (the JAX
package's ``tpu_split_kernel=on``, planes or resident layout) the three
run as ONE launch per split, ``ops/partition.one_kernel_split_planes``.
The resident layout (``tpu_resident_state=on``) keeps the bins once in
the router's planes and partitions a slim payload: a route gather
(``ops/partition.write_route_plane``) before each partition, and a gather
histogram (``ops/histogram.segment_histogram_resident``). After the
tree, :func:`assign_leaves` routes every row to its leaf (the
``route_rows`` kernel).

The JAX ``while_loop`` becomes a Python loop whose state stays on the
device. What the host needs to issue a split (the chosen leaf, whether its
gain is positive, the parent segment, the split column, which child is
smaller) comes back in ONE device->host transfer per split; the kernels
read their segment arguments from device tensors and the host sizes their
grids from the parent's row count. :class:`DeviceTreeLoop` grows the same
tree with no transfer at all, in every configuration: a fixed sequence of
(split commit, split) launches that read their scalars on the card -- the
one-kernel split, or the three-launch chain with the split scan kernel
(``ops/chain.ChainSplit``) -- one CUDA graph per tree (the fused blocks of
``fused.py`` use it on the card).

:func:`build_tree` is the dense builder (past 256 bins, or
``tree_builder=dense``): rows stay in place with their leaf ids, and a
split updates them and histograms the smaller child by a mask over all
rows (``ops/histogram.DenseHistogram``): on the card through the device
tree loop (``ops/chain.DenseSplit``), per iteration too, and on the host
through the per-split host loop.

The distributed learners (``parallel/mesh.py``) grow the same trees
through :class:`Comm`, the collective seam over a ``torch.distributed``
process group (the identity for one device): the per-split host loop of
each rank runs its own rows through the kernels, and the collectives join
the ranks' histograms, sums, votes and winning splits.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .utils.log import LightGBMError


class TreeLog(NamedTuple):
    """Device-side record of one tree in leaf-slot split order."""
    num_splits: torch.Tensor     # (1,) i32, stays on the device
    split_leaf: torch.Tensor     # (L-1,) i32
    feature: torch.Tensor        # (L-1,) i32
    bin: torch.Tensor            # (L-1,) i32
    kind: torch.Tensor           # (L-1,) i32
    default_left: torch.Tensor   # (L-1,) bool
    gain: torch.Tensor           # (L-1,) f32
    left_sum: torch.Tensor       # (L-1, 3) f32
    right_sum: torch.Tensor      # (L-1, 3) f32
    go_left: torch.Tensor        # (L-1, B) bool
    miss_bin: torch.Tensor       # (L-1,) i32 movable-missing bin
    movable: torch.Tensor        # (L-1,) bool feature has missing-directed bin
    leaf_value: torch.Tensor     # (L,) f32 raw outputs
    leaf_sum: torch.Tensor       # (L, 3) f32
    row_leaf: torch.Tensor       # (N,) i32 final leaf of every training row


def device_bins(binned: np.ndarray, device) -> torch.Tensor:
    """A dataset's (N, G) binned matrix on ``device``: u8, or u16 as an
    int16 view of the same bits (torch has few u16 ops; bins stay below
    2^15)."""
    if binned.dtype == np.uint16:
        binned = binned.view(np.int16)
    return torch.as_tensor(binned).to(device)


def route_layout(bins: torch.Tensor) -> torch.Tensor:
    """(N, G) u8 binned matrix -> the router's (G, Npad/128, 128) u8
    transposed block form, rows zero-padded to a multiple of 128. Its
    (G, Npad) view is the resident layout's bin planes
    (``ops/partition.resident_bin_planes``)."""
    from .ops.partition import resident_bin_planes
    from .ops.route import ROUTE_ROW_ALIGN

    return resident_bin_planes(bins).reshape(bins.shape[1], -1,
                                             ROUTE_ROW_ALIGN)


def assign_leaves(bins: torch.Tensor, log: TreeLog,
                  has_categorical: bool = True,
                  bundle: Optional[dict] = None,
                  bins_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Route binned rows through a tree's split log -> (N,) i32 leaf slots
    (device analog of Tree::PredictLeafIndex over pre-binned data).

    A u8 matrix goes through the row router ``ops.route.route_rows`` --
    its CUDA kernel on the card, its plain twin on the host -- with no
    read back to the host: numerical(-or-bundled) trees as the JAX package
    routes them with its Pallas router, and categorical trees with the
    router's categorical table (``ops.route.build_cat_table``), where the
    JAX package runs its round-by-round ``fori_loop``; u16 matrices (an
    int16 view, :func:`device_bins`: the dense builder's past 256 bins) the
    same way, through the router's u16 entry point. ``bins_t`` is the
    router's block form (:func:`route_layout`) when the caller caches it.
    """
    from .ops.route import build_cat_table, build_route_table, route_rows

    n = bins.shape[0]
    btr = bins_t if bins_t is not None else route_layout(bins)
    table = build_route_table(log, bundle)
    cat = build_cat_table(log) if has_categorical else None
    return route_rows(btr, table, log.num_splits, cat,
                      num_values=max(256, log.go_left.shape[1]))[:n]


def assign_leaves_plain(bins: torch.Tensor, log: TreeLog,
                        has_categorical: bool = True,
                        bundle: Optional[dict] = None) -> torch.Tensor:
    """The round-by-round plain router (u8 or u16 bins), the twin that
    :func:`assign_leaves` is held to: one pass over every row per split,
    the split count read on the host; categorical rounds look the bin up
    in the (B,) routing table."""
    n = bins.shape[0]
    max_splits = log.split_leaf.shape[0]
    ns = min(int(log.num_splits.reshape(-1)[0]), max_splits)
    row_leaf = torch.zeros(n, dtype=torch.int32, device=bins.device)
    bt = bins.t()
    for r in range(ns):
        fid = int(log.feature[r])
        col_idx = int(bundle["group"][fid]) if bundle is not None else fid
        col = bt[col_idx].to(torch.int32)
        if has_categorical and int(log.kind[r]) > 0:
            go = log.go_left[r][col.long()]
        elif bundle is not None:
            off = int(bundle["offset"][fid])
            d = int(bundle["dpos"][fid])
            rest_dir = bool(log.go_left[r][d])
            has_rest = bool(bundle["has_rest"][fid])
            rank = col - off
            fb = rank + (rank >= d).to(torch.int32)
            in_range = has_rest & (col >= off) \
                & (col < off + int(bundle["nbm1"][fid]))
            eff = fb if has_rest else col
            go = eff <= log.bin[r]
            go = torch.where(log.movable[r] & (eff == log.miss_bin[r]),
                             log.default_left[r], go)
            if has_rest:
                go = torch.where(in_range, go, rest_dir)
        else:
            go = col <= log.bin[r]
            go = torch.where(log.movable[r] & (col == log.miss_bin[r]),
                             log.default_left[r], go)
        row_leaf = torch.where((row_leaf == log.split_leaf[r]) & ~go,
                               r + 1, row_leaf)
    return row_leaf


def leaf_values_by_row(leaf_value: torch.Tensor,
                       row_leaf: torch.Tensor) -> torch.Tensor:
    """(L,) leaf outputs + (N,) leaf ids -> (N,) per-row f32 values."""
    return leaf_value.to(torch.float32)[row_leaf.long()]


# ---------------------------------------------------------------------------
# Tree builder
# ---------------------------------------------------------------------------

class Comm:
    """Collective seam of the tree builders (the JAX package's ``Comm``;
    reference analog: static class Network, network.h:89, and the hooks of
    the Data/Feature/Voting-parallel tree learners). ``axis`` is a
    ``torch.distributed`` process group of ``num_machines`` ranks, one
    process a rank; ``axis=None`` is one device and every method the
    identity.

    Modes (reference: tree_learner.cpp:15 factory):
    - ``serial``/``data``: rows sharded; histograms are globally reduced
      and every rank computes the same best split. With ``hist_scatter``
      (``tpu_hist_scatter``, data mode) a histogram is reduce-scattered by
      blocks of ``ceil(G / D)`` bundle groups, each rank searches the
      features of its block and :meth:`sync_split` carries the winner
      (data_parallel_tree_learner.cpp:155-251).
    - ``feature``: rows replicated, the split search sharded by feature
      ownership (``f % D == rank``), the winner synced
      (feature_parallel_tree_learner.cpp:40).
    - ``voting``: rows sharded, histograms stay local; ranks vote their
      local top-k features and the global top-2k features' rows are merged
      (voting_parallel_tree_learner.cpp:151 GlobalVoting).

    Every collective gives each rank the same bits. A gloo group moves a
    card tensor through pinned host memory, explicitly (gloo stages card
    tensors through the host itself); ``stats`` counts the collectives,
    their payload bytes and the bytes staged."""

    def __init__(self, axis=None, mode: Optional[str] = None, top_k: int = 20,
                 num_machines: int = 1, hist_scatter: bool = True) -> None:
        self.axis = axis
        self.mode = mode or ("data" if axis is not None else "serial")
        self.top_k = int(top_k)
        self.num_machines = int(num_machines)
        self.hist_scatter = bool(hist_scatter) and self.mode == "data" \
            and axis is not None and self.num_machines > 1
        self.rank = 0
        self.staged = False
        if axis is not None:
            import torch.distributed as dist
            self.rank = dist.get_rank(axis)
            self.staged = dist.get_backend(axis) == "gloo"
        self.stats = {"collectives": 0, "bytes": 0, "staged_bytes": 0}

    # ---- the collectives: fresh tensors on the input's device ----
    def _buffer(self, x: torch.Tensor) -> torch.Tensor:
        """A fresh buffer holding ``x`` for an in-place collective: pinned
        host memory for a gloo group's card tensor."""
        x = x.contiguous()
        self.stats["collectives"] += 1
        self.stats["bytes"] += x.numel() * x.element_size()
        if self.staged and x.is_cuda:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x)
            self.stats["staged_bytes"] += x.numel() * x.element_size()
            return buf
        return x.clone()

    def _back(self, buf: torch.Tensor, device) -> torch.Tensor:
        if buf.device != device:
            self.stats["staged_bytes"] += buf.numel() * buf.element_size()
            return buf.to(device)
        return buf

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        buf = self._buffer(x)
        dist.all_reduce(buf, group=self.axis)
        return self._back(buf, x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(D, *x.shape): every rank's ``x`` in rank order."""
        import torch.distributed as dist
        buf = self._buffer(x)
        parts = [torch.empty_like(buf) for _ in range(self.num_machines)]
        dist.all_gather(parts, buf, group=self.axis)
        return self._back(torch.stack(parts), x.device)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x``'s block ``rank`` along dim 0 (its
        length a multiple of D)."""
        import torch.distributed as dist
        buf = self._buffer(x)
        out = torch.empty((buf.shape[0] // self.num_machines,)
                          + tuple(buf.shape[1:]), dtype=buf.dtype,
                          device=buf.device)
        fn = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        fn(out, buf, group=self.axis)
        return self._back(out, x.device)

    # ---- the builders' seam (JAX learner.py:48-168) ----
    def psum(self, x):
        if self.axis is None:
            return x
        return self.all_reduce(x)

    def _gpad(self, g: int) -> int:
        d = self.num_machines
        return -(-g // d) * d

    def hist(self, h):
        """Leaf-histogram reduction: a reduce-scatter by group blocks in
        scatter mode (this rank's block re-embedded into zeros), else an
        all-reduce; the identity where rows are replicated (feature) or
        histograms stay local (voting)."""
        if self.axis is None or self.mode in ("feature", "voting"):
            return h
        if self.hist_scatter:
            g = h.shape[0]
            gpad = self._gpad(g)
            blk = gpad // self.num_machines
            hp = torch.zeros((gpad,) + tuple(h.shape[1:]), dtype=h.dtype,
                             device=h.device)
            hp[:g] = h
            out = torch.zeros_like(hp)
            out[self.rank * blk:(self.rank + 1) * blk] = \
                self.reduce_scatter(hp)
            return out[:g]
        return self.all_reduce(h)

    def owned_group_mask(self, feat_group: torch.Tensor, num_groups: int):
        """(F,) bool: this rank owns feature f's histogram block (scatter
        mode); None otherwise. ``num_groups`` is the bundled column count,
        so the block size matches :meth:`hist`."""
        if not self.hist_scatter:
            return None
        blk = self._gpad(num_groups) // self.num_machines
        return (feat_group >= self.rank * blk) \
            & (feat_group < (self.rank + 1) * blk)

    def root(self, x):
        """Root gradient-sum reduction (replicated rows: identity)."""
        if self.axis is None or self.mode == "feature":
            return x
        return self.all_reduce(x)

    def owned_mask(self, num_feat: int, device):
        """Feature-parallel search ownership, ``f % D == rank``; None in
        the other modes."""
        if self.mode != "feature" or self.axis is None:
            return None
        return (torch.arange(num_feat, device=device) % self.num_machines) \
            == self.rank

    def sync_split(self, info):
        """The globally best SplitInfo of each node (SyncUpGlobalBestSplit,
        parallel_tree_learner.h:191), in feature mode and scatter mode:
        gather every rank's gain (NaN read as -inf), take the argmax (ties
        to the lowest rank), then a masked sum carries every field over,
        -inf gains restored; as the JAX package's masked psum, a field is
        carried in f32 and non-finite values but -inf become 0. ``info``
        holds P nodes (fields with a leading P).

        One all-gather of every rank's gain and fields, then the masked sum
        on each rank: a sum of one value and zeros does not depend on its
        order (a zero's sign included), so it has the psum's bits."""
        if self.axis is None or not (self.mode == "feature"
                                     or self.hist_scatter):
            return info
        f32 = torch.float32
        p = info.gain.shape[0]
        cols, spans = [info.gain.to(f32).reshape(p, 1)], []
        for x in info:
            v = x.reshape(p, -1)
            if v.dtype == f32:
                cols.append(torch.where(torch.isfinite(v), v,
                                        torch.zeros_like(v)))
                cols.append(torch.isneginf(v).to(f32))
            else:
                cols.append(v.to(f32))
            spans.append(v.shape[1])
        every = self.all_gather(torch.cat(cols, dim=1))          # (D, P, C)
        gains = every[:, :, 0]
        win = torch.argmax(torch.where(torch.isnan(gains),
                                       torch.full_like(gains, float("-inf")),
                                       gains), dim=0)             # (P,)
        mine = (win[None, :] == torch.arange(
            self.num_machines, device=win.device)[:, None]).to(f32)
        out = every[0, :, 1:] * mine[0][:, None]
        for r in range(1, self.num_machines):
            out = out + every[r, :, 1:] * mine[r][:, None]
        fields, at = [], 0
        for x, w in zip(info, spans):
            v = out[:, at:at + w]
            at += w
            if x.dtype == f32:
                neg = out[:, at:at + w] > 0.5
                at += w
                v = torch.where(neg, torch.full_like(v, float("-inf")), v)
            fields.append(v.to(x.dtype).reshape(x.shape))
        return type(info)(*fields)


def _empty_best(num_leaves: int, num_bin: int, device) -> "SplitInfo":
    from .ops.split import SplitInfo

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SplitInfo(
        gain=torch.full((num_leaves,), float("-inf"), device=device),
        feature=z(num_leaves, dtype=torch.int64),
        bin=z(num_leaves, dtype=torch.int64),
        kind=z(num_leaves, dtype=torch.int64),
        default_left=z(num_leaves, dtype=torch.bool),
        go_left=z(num_leaves, num_bin, dtype=torch.bool),
        left_sum=z(num_leaves, 3), right_sum=z(num_leaves, 3),
        left_output=z(num_leaves), right_output=z(num_leaves))


def _set_best(best, idx, info) -> None:
    """best[idx] = info, field by field, in place."""
    for b, v in zip(best, info):
        b[idx] = v


def _make_best_for(meta, hp, feature_mask, opts=None, keys=None,
                   node=None):
    """Per-node split evaluation (the JAX package's ``_make_best_for``):
    the node inputs of ``opts`` (an ``ops/node.NodeOptions``: by-node
    column sampling, extra-trees thresholds, interaction constraints, CEGB
    penalties; ``ops/node.node_inputs`` writes them into the
    ``ops/node.NodeBuf`` ``node``, from the tree's (4,) ``keys``), then
    the (F, B) scan of a batch of nodes. A node of round ``r`` draws with
    that ``r`` and its leaf: the root at ``r = 0``, leaf 0; both children
    of round ``r`` at ``r``, the split leaf and the new one. Under the
    advanced monotone method ``adv_bounds`` is the nodes' per-candidate
    ``(lo_l, up_l, lo_r, up_r)``, (P, F, B) each. The voting learner's
    scans add ``extra_mask`` (the voted features), ``want_feature_gains``
    and ``use_hp`` (its local constraints), and its local vote drops the
    CEGB penalties (``use_delta``)."""
    from .ops.node import node_inputs
    from .ops.split import find_best_split

    active = opts is not None and opts.active

    def best_for(hist, parent_sum, parent_out, lower, upper, depth, *,
                 r=0, leaf=0, leaf1=0, used=None, tree_used=None,
                 adv_bounds=None, extra_mask=None, want_feature_gains=False,
                 use_hp=None, use_delta=True):
        mask, thr, delta = feature_mask, None, None
        if active:
            p = hist.shape[0]
            node_inputs(node, keys, r, leaf, leaf1, p, opts=opts,
                        fmask=feature_mask, num_bins=meta.num_bins,
                        coupled=meta.cegb_coupled, hp=hp,
                        sums=parent_sum.contiguous(), used=used,
                        tree_used=tree_used)
            mask, thr, delta = node.rows(p)
        if extra_mask is not None:
            mask = mask & extra_mask
        return find_best_split(hist, parent_sum, meta, mask,
                               use_hp if use_hp is not None else hp,
                               parent_output=parent_out, leaf_lower=lower,
                               leaf_upper=upper, node_depth=depth,
                               rand_threshold=thr,
                               cegb_delta=delta if use_delta else None,
                               adv_bounds=adv_bounds,
                               want_feature_gains=want_feature_gains)

    return best_for


def split_kernel_ineligible(*, work_layout: str, hist_mode: str, bundle,
                            num_bin_hist: int, num_bin: int, comm, hp,
                            hist_chunk: int = 0, opts=None) -> list:
    """Why ``split_kernel="on"`` (one launch per split) cannot run here;
    empty when it can. The JAX package's gate (learner.py, the
    ``one_kernel`` premises): the kernel inlines a plain
    ``find_best_split`` over the planes or resident layout, so it needs
    serial comm, no feature bundles, no CEGB, no by-node sampling or
    extra-trees, no interaction constraint sets (``opts``, an
    ``ops/node.NodeOptions``) and scalar (basic) monotone bounds;
    ``hist_chunk`` keeps the reference's 128-row alignment rule so both
    packages resolve the knob alike. Forced splits stay eligible: the
    split commit picks them and the kernel partitions by the split its
    header names. The port's host twin is eligible wherever the kernel
    is."""
    bad = []
    if work_layout not in ("planes", "resident"):
        bad.append("needs the planes work layout (or the resident one)")
    if hist_mode == "int8":
        bad.append("int8 histograms unsupported")
    if bundle is not None or num_bin_hist != num_bin:
        bad.append("EFB feature bundling unsupported")
    if comm.axis is not None:
        bad.append("multi-device comm unsupported")
    if hp.use_cegb:
        bad.append("CEGB penalties unsupported")
    if hp.has_monotone and (hp.mono_intermediate or hp.mono_advanced):
        bad.append("intermediate/advanced monotone unsupported")
    if opts is not None and (opts.kth or opts.extra_trees):
        bad.append("by-node sampling / extra-trees unsupported")
    if opts is not None and opts.sets is not None:
        bad.append("interaction constraint sets unsupported")
    if hist_chunk % 128:
        bad.append("hist_chunk must be a multiple of 128")
    return bad


def forced_tables(forced, num_feat: int, device):
    """BFS forced splits ``(leaves, features, bins)`` -> (leaves as host
    ints, (n, F) bool one-feature masks, (n, F) i32 threshold bins): the
    inputs of each forced round's one-leaf scan (``pick_forced`` of the
    JAX package's tree loop: the forced feature alone, at the forced
    bin)."""
    leaves, feats, bins_ = (list(map(int, x)) for x in forced)
    n = len(leaves)
    feat_t = torch.tensor(feats, dtype=torch.int64).to(device)
    mask = torch.arange(num_feat, device=device)[None, :] == feat_t[:, None]
    thr = torch.tensor(bins_, dtype=torch.int32).to(device)[:, None] \
        .expand(n, num_feat).contiguous()
    return leaves, mask, thr


def note_used_features(used: torch.Tensor, log: "TreeLog") -> None:
    """Add the features a tree split on to the model's (F,) bool ``used``
    set, in place on the device (the JAX package's
    ``_note_used_features``, CEGB's coupled penalties; no host read)."""
    F = used.shape[0]
    valid = torch.arange(log.feature.shape[0], device=used.device) \
        < log.num_splits.reshape(-1)[0]
    idx = torch.where(valid, log.feature.long(),
                      torch.full_like(log.feature.long(), F))
    ext = torch.cat([used, torch.zeros(1, dtype=torch.bool,
                                       device=used.device)])
    ext.index_fill_(0, idx, True)
    used.copy_(ext[:F])


def feature_view(hg: torch.Tensor, total_sum: torch.Tensor, bundle: dict,
                 num_feat: int, num_bin: int) -> torch.Tensor:
    """(P, G, Bm, 3) bundled histograms -> (P, F, B, 3) per-feature views;
    a bundled feature's shared default bin is recovered as total -
    sum(own slots) (dataset.h:503 FixHistogram). ``total_sum`` is the
    (P, 3) nodes' sums. Torch ops on device tensors: no host read."""
    p, num_grp, bm = hg.shape[0], hg.shape[1], hg.shape[2]
    flat = hg.reshape(p, num_grp * bm, 3)
    fh = flat[:, bundle["proj"].reshape(-1).long()] \
        .reshape(p, num_feat, num_bin, 3)
    fh = fh * bundle["valid"][None, :, :, None]
    rest = total_sum[:, None, :] - torch.sum(fh, dim=2)     # (P, F, 3)
    put = bundle["dpos_oh"] & bundle["has_rest"][:, None]
    return torch.where(put[None, :, :, None], rest[:, :, None, :], fh)


def build_tree_partitioned(
    bins: torch.Tensor,          # (N, G) uint8 bundle columns
    ghc: torch.Tensor,           # (N, 3) f32 (grad, hess, inbag)
    meta,                        # ops.split.FeatureMeta
    feature_mask: torch.Tensor,  # (F,) bool
    hp,                          # ops.split.SplitHyper
    *,
    num_leaves: int,
    num_bin: int,
    max_depth: int = -1,
    num_bin_hist: Optional[int] = None,
    bundle: Optional[Dict[str, torch.Tensor]] = None,
    hist_mode: str = "hilo",
    work_layout: str = "planes",
    split_kernel: str = "off",
    key=None,
    dither_offset: int = 0,
    comm: Comm = Comm(),
    bins_t: Optional[torch.Tensor] = None,
    work: Optional[torch.Tensor] = None,
    stats: Optional[dict] = None,
    opts=None,
    cegb_used: Optional[torch.Tensor] = None,
    forced=None,
    inbag_first: bool = False,
    goss_compact: bool = False,
) -> TreeLog:
    """Grow one leaf-wise tree with a physical row partition (reference
    contract: serial_tree_learner.cpp:324 FindBestSplits over the smaller
    leaf + histogram subtraction, data_partition.hpp:101 Split).

    ``work_layout`` is ``planes``, ``resident`` or ``rows``; ``resident``
    partitions the slim pair and gathers bins from the resident planes,
    the (G, Npad) view of ``bins_t`` (the router's block form,
    :func:`route_layout`, built here when None), and grows the trees of
    ``planes`` bit for bit. ``split_kernel`` ``on`` runs each split as one
    launch (``ops/partition.one_kernel_split_planes``, planes and resident
    only: :func:`split_kernel_ineligible` says where it cannot run, and a
    ``ValueError`` names it "not eligible"); ``hist_mode`` ``hilo``,
    ``bf16`` or ``int8`` (rows only: gradients packed as int8 with
    per-tree scales and a stochastic-rounding dither drawn from
    ``fold_in(key, 987123)`` at row offset ``dither_offset``, as the JAX
    builder draws it). ``work`` is a carried ping-pong buffer of the
    layout's shape (``ops/partition.work_buffer``; allocated when None);
    ``stats``, when given, receives the final per-leaf segment counts
    (``leaf_cnt``) and the count channel of each leaf's histogram
    (``hist_cnt``, the in-bag rows), both (num_leaves,) device tensors, the
    split count and the routed ``row_leaf``.

    ``opts`` (an ``ops/node.NodeOptions``) adds the per-node options, as
    the JAX package has them: by-node column sampling, extra-trees
    thresholds (both drawn from ``key``), interaction constraints (each
    leaf's used features), CEGB penalties (``cegb_used``, the (F,) bool
    features the model has used, seeds the tree's used set). ``forced``,
    BFS ``(leaf, feature, bin)`` lists (:meth:`SerialTreeLearner.
    _forced_splits`), forces the tree's first splits while each forced
    leaf has a valid split at its bin; the loop then runs up to
    ``num_leaves - 1 + len(forced)`` rounds, and a round that finds no
    valid split commits nothing. Under the intermediate and advanced
    monotone methods (``hp.mono_intermediate`` / ``mono_advanced``) the
    picked split's outputs are re-clamped to its leaf's current bounds
    before it is recorded, and every commit refreshes the other leaves'
    bounds (``ops/monotone.py``). ``inbag_first`` (GOSS) grows the tree
    over the rows in ``ops/partition.inbag_order``'s order, the in-bag
    ones first: the partition is stable, so every leaf's segment then
    holds its in-bag rows first, in the same positions whether the
    out-of-bag ones (zero channels) follow or not, and the card's
    histograms, which sum a segment's rows in an order fixed by their
    positions, give the same bits either way. ``goss_compact`` (GOSS
    compaction, ``tpu_goss_compact=on``) then drops the out-of-bag rows:
    the root segment holds the in-bag ones alone. Either way the root sums
    come from ``ghc`` as given and every row is routed in its own order.

    ``comm`` (:class:`Comm`) joins the ranks of a distributed learner,
    each growing the tree over its own rows (``bins``, ``ghc``): the root
    sums and every histogram reduced (or reduce-scattered) before the
    scan, the scan masked to the rank's owned features and its winner
    synced (feature and scatter modes), or the voting branch; a forced
    leaf's histogram made global where the pool is not. The int8
    histograms are dequantized by the rank's own scales first, and each
    rank draws the dither at its local row positions, as the JAX package's
    shards do.

    Kept exactly as the JAX builder has them: the leaf to split is the
    first argmax of the best gains; the smaller child is the one with the
    smaller in-bag count (``left_sum[2] <= right_sum[2]``); the larger
    child's histogram is parent minus smaller; the root sum comes from the
    unquantized channels.
    """
    from .ops.histogram import (dequant_scale, segment_histogram,
                                segment_histogram_q,
                                segment_histogram_resident,
                                segment_histogram_rows)
    from .ops.partition import (OneKernelSplit, inbag_order,
                                on_route_plane, pack_planes_fold_root,
                                pack_resident_fold_root, pack_rows,
                                pack_rows_quantized, partition_segment,
                                partition_segment_rows, quantize_scales,
                                split_out, split_pair, work_buffer,
                                work_spec, write_route_plane)
    from .ops.monotone import (adv_boxes_init, adv_child_boxes, adv_init,
                               intermediate_refresh, method_code,
                               mono_bounds, mono_commit, reclamp)
    from .ops.node import NodeOptions, node_buf, node_keys
    from .ops.scan import scan_leaf_info
    from .ops.split import calc_leaf_output
    from .prng import fold_in

    dev = bins.device
    f32, i32 = torch.float32, torch.int32
    n, num_grp = bins.shape
    num_feat = int(meta.num_bins.shape[0])
    max_splits = num_leaves - 1
    # the root sums from the channels as given (a row reduction over the
    # gathered rows would group the f32 additions otherwise); the router
    # routes every row in its own order
    root_sum = torch.sum(ghc, dim=0)
    route_bins, route_bins_t = bins, bins_t
    nr = n
    if goss_compact and not inbag_first:
        raise ValueError("goss_compact needs inbag_first")
    if inbag_first:
        order, c_in = inbag_order(ghc)
        bins, ghc = bins.index_select(0, order), ghc.index_select(0, order)
        bins_t = None
        if goss_compact:
            # the host loop reads a header per split anyway
            nr = int(c_in)
    bm = num_bin_hist if num_bin_hist is not None else num_bin
    exact = hist_mode != "bf16"
    quantized = hist_mode == "int8"
    rows_layout = work_layout == "rows"
    resident = None
    if work_layout == "resident":
        bt = bins_t if bins_t is not None else route_layout(bins)
        resident = bt.reshape(num_grp, -1)      # (G, Npad) bin planes
    if quantized and not rows_layout:
        raise ValueError("int8 quantized histograms need the rows work "
                         "layout (the planes layout has no quantized pack)")
    if quantized and key is None:
        raise ValueError("int8 quantized histograms need a key for the "
                         "stochastic-rounding dither")
    one_kernel = split_kernel == "on"
    if one_kernel:
        bad = split_kernel_ineligible(work_layout=work_layout,
                                      hist_mode=hist_mode, bundle=bundle,
                                      num_bin_hist=bm, num_bin=num_bin,
                                      comm=comm, hp=hp, opts=opts)
        if bad:
            raise ValueError("tpu_split_kernel=on is not eligible here: "
                             + "; ".join(bad))
    guard, _ = work_spec(num_grp, quantized, work_layout)
    if work is None:
        work = work_buffer(n, num_grp, work_layout, quantized, dev)
    # the root segment: every row, or the in-bag ones (compaction)
    root_seg = None if nr == n else torch.tensor([0, guard, nr], dtype=i32,
                                                 device=dev)

    # ---- pack plane 0, root histogram (one launch) ----
    if rows_layout:
        part_fn = partition_segment_rows
        if quantized:
            # per-tree local scales, dequantized inside the histogram
            scales = quantize_scales(ghc)
            scale = dequant_scale(scales)
            work[0, guard:guard + n] = pack_rows_quantized(
                bins, ghc, fold_in(key, 987123), scales,
                offset=dither_offset)

            def hist_fn(seg, cnt_bound):
                return segment_histogram_q(work, seg, scale, num_bins=bm,
                                           num_feat=num_grp,
                                           cnt_bound=cnt_bound)
        else:
            work[0, guard:guard + n] = pack_rows(bins, ghc)

            def hist_fn(seg, cnt_bound):
                return segment_histogram_rows(work, seg, num_bins=bm,
                                              num_feat=num_grp, exact=exact,
                                              cnt_bound=cnt_bound)
        root_hist = hist_fn(torch.tensor([0, guard, nr], dtype=i32,
                                         device=dev), n)
    elif resident is not None:
        def part_fn(work, seg, table, cnt_bound):
            # the split column's bins into the route plane, then the
            # planes partition of the slim rows on that plane
            write_route_plane(work, resident, seg, cnt_bound)
            return partition_segment(work, on_route_plane(seg), table,
                                     cnt_bound)

        def hist_fn(seg, cnt_bound):
            return segment_histogram_resident(work, resident, seg,
                                              num_bins=bm, num_feat=num_grp,
                                              exact=exact,
                                              cnt_bound=cnt_bound)
        root_hist = pack_resident_fold_root(work, resident, ghc, guard,
                                            num_bins=bm, num_feat=num_grp,
                                            exact=exact, seg=root_seg)
    else:
        part_fn = partition_segment

        def hist_fn(seg, cnt_bound):
            return segment_histogram(work, seg, num_bins=bm,
                                     num_feat=num_grp, exact=exact,
                                     cnt_bound=cnt_bound)
        root_hist = pack_planes_fold_root(work, bins, ghc, guard,
                                          num_bins=bm, exact=exact,
                                          seg=root_seg)
    if one_kernel:
        # checked and set up once per tree; each split fills in its own
        one_kernel_split = OneKernelSplit(work, meta, feature_mask, hp,
                                          num_bins=bm, num_feat=num_grp,
                                          exact=exact, cnt_max=n,
                                          resident=resident)
        split_bufs = split_out(num_grp, bm, dev)
        one = torch.ones(1, dtype=i32, device=dev)
        # the split's header ONE_KERNEL_HDR from hdr[:6] below + [depth,
        # live]
        hdr_cols = torch.tensor([2, 0, 1, 3, 5, 6, 7, 4], device=dev)

    def feat_view(hg, total_sum):
        if bundle is None:
            return hg
        return feature_view(hg, total_sum, bundle, num_feat, num_bin)

    def route_table(go_left, feature):
        """Feature-space (B,) table -> bundle-column (Bm,) table (alien
        sub-features' slots follow the feature's default-bin direction)."""
        if bundle is None:
            return go_left
        return go_left[bundle["map_fb"][feature].long()]

    opts = opts if opts is not None else NodeOptions()
    n_forced = 0 if forced is None else len(forced[0])
    keys = node = None
    if opts.active:
        if key is None:
            raise ValueError("by-node sampling, extra-trees, interaction "
                             "constraints and CEGB need the tree's key")
        keys = node_keys(key, opts.extra_seed,
                         torch.zeros(4, dtype=torch.int64, device=dev))
        node = node_buf(opts, num_feat, dev)
    # the search mask under the comm (JAX learner.py:1009-1076): the owned
    # features in feature mode, the owned group blocks in scatter mode
    fmask_search = feature_mask
    owned = comm.owned_mask(num_feat, dev)
    if owned is not None:
        fmask_search = fmask_search & owned
    owned_g = comm.owned_group_mask(
        bundle["group"] if bundle is not None
        else torch.arange(num_feat, device=dev), num_grp)
    if owned_g is not None:
        fmask_search = fmask_search & owned_g
    best_raw = _make_best_for(meta, hp, fmask_search, opts, keys, node)
    voting = comm.mode == "voting"
    if voting:
        # local vote constraints scaled by 1 / num_machines
        # (voting_parallel_tree_learner.cpp:62-64)
        d_m = float(max(comm.num_machines, 1))
        hp_loc = hp._replace(
            min_data_in_leaf=hp.min_data_in_leaf / d_m,
            min_sum_hessian_in_leaf=hp.min_sum_hessian_in_leaf / d_m)

    def best_for(hg, tot_g, tot_l, parent_out, lower, upper, depth, **kw):
        """Best splits of a batch of nodes under the comm: ``hg`` their
        (P, G, Bm, 3) histograms (global, or local under voting),
        ``tot_g`` / ``tot_l`` their global / local (g, h, cnt) sums."""
        if not voting:
            return comm.sync_split(best_raw(feat_view(hg, tot_g), tot_g,
                                            parent_out, lower, upper, depth,
                                            **kw))
        # voting (GlobalVoting, voting_parallel_tree_learner.cpp:151,322):
        # each rank's local top-k, the votes summed, the global top-2k
        # (ties to the lowest feature) merged by a sum and searched
        fv_loc = feat_view(hg, tot_l)
        p = fv_loc.shape[0]
        fg = best_raw(fv_loc, tot_l, parent_out, lower, upper, depth,
                      want_feature_gains=True, use_hp=hp_loc,
                      use_delta=False, **dict(kw, adv_bounds=None))
        k = min(comm.top_k, num_feat)
        k2 = min(2 * comm.top_k, num_feat)
        top = torch.sort(fg, dim=1, descending=True, stable=True).indices
        votes = torch.zeros((p, num_feat), dtype=f32, device=dev)
        votes.scatter_add_(1, top[:, :k], torch.ones((p, k), dtype=f32,
                                                     device=dev))
        votes = comm.psum(votes)
        bias = -torch.arange(num_feat, dtype=f32, device=dev) * 1e-6
        sel = torch.sort(votes + bias[None], dim=1, descending=True,
                         stable=True).indices[:, :k2]            # (P, k2)
        flat = fv_loc.reshape(p, num_feat, -1)
        at = sel[:, :, None].expand(p, k2, flat.shape[2])
        merged = comm.psum(torch.gather(flat, 1, at))
        full = torch.zeros_like(flat).scatter_(1, at, merged) \
            .reshape(fv_loc.shape)
        selmask = torch.zeros((p, num_feat), dtype=torch.bool,
                              device=dev).scatter_(1, sel, True)
        return best_raw(full, tot_g, parent_out, lower, upper, depth,
                        extra_mask=selmask, **kw)

    # the intermediate and advanced monotone methods: the leaves' bin
    # boxes, the advanced per-bin bounds and the nodes' per-candidate
    # bounds (ops/monotone.py; mono_bounds and mono_commit launch their
    # kernels on the card)
    method = method_code(hp)
    cons_lo = cons_hi = bounds = None
    if method == 2:
        cons_lo, cons_hi, rng_lo, rng_hi = adv_init(
            num_leaves, num_feat, num_bin, meta.num_bins)
        bounds = torch.zeros((2, 4, num_feat, num_bin), dtype=f32,
                             device=dev)
    elif method == 1:
        rng_lo, rng_hi = adv_boxes_init(num_leaves, num_feat, meta.num_bins)

    def leaf_bounds(leaf, leaf1=0, nodes=1):
        """(nodes, F, B) views of the advanced per-candidate bounds of
        ``leaf`` (and ``leaf1``)."""
        word = torch.full((1,), leaf, dtype=i32, device=dev)
        mono_bounds(cons_lo, cons_hi, rng_lo, rng_hi, word, leaf1, nodes,
                    bounds)
        return tuple(bounds[:nodes, k] for k in range(4))

    # ---- root ----
    root_hist = comm.hist(root_hist)
    root_sum_loc = root_sum
    root_sum = comm.root(root_sum)
    hist_pool = torch.zeros((num_leaves, num_grp, bm, 3), dtype=f32,
                            device=dev)
    hist_pool[0] = root_hist
    leaf_sum = torch.zeros((num_leaves, 3), dtype=f32, device=dev)
    leaf_sum[0] = root_sum
    # each leaf's local (g, h, cnt) sums: the voting ranks vote with them
    leaf_sum_loc = torch.zeros_like(leaf_sum) if voting else None
    if voting:
        leaf_sum_loc[0] = root_sum_loc
    leaf_out = torch.zeros(num_leaves, dtype=f32, device=dev)
    leaf_out[0] = calc_leaf_output(root_sum[0], root_sum[1], hp)
    leaf_lower = torch.full((num_leaves,), float("-inf"), device=dev)
    leaf_upper = torch.full((num_leaves,), float("inf"), device=dev)
    # features used on each leaf's path (interaction constraints) and by
    # the tree and the model (CEGB), kept only where an option reads them
    leaf_used = torch.zeros((num_leaves, num_feat), dtype=torch.bool,
                            device=dev) if opts.needs_used else None
    tree_used = None
    if hp.use_cegb:
        tree_used = cegb_used.to(torch.bool).clone() \
            if cegb_used is not None \
            else torch.zeros(num_feat, dtype=torch.bool, device=dev)
    # segment table: (start, cnt, parity) per leaf, on the device
    seg_tab = torch.zeros((num_leaves, 3), dtype=i32, device=dev)
    seg_tab[0, 0] = guard
    seg_tab[0, 1] = nr
    depth = [0] * num_leaves
    best = _empty_best(num_leaves, num_bin, dev)
    root_info = best_for(root_hist[None], root_sum[None],
                         root_sum_loc[None], leaf_out[:1], leaf_lower[:1],
                         leaf_upper[:1], 0, used=leaf_used,
                         tree_used=tree_used,
                         adv_bounds=leaf_bounds(0) if method == 2 else None)
    _set_best(best, slice(0, 1), root_info)
    if n_forced:
        f_leaf, f_mask, f_thr = forced_tables(forced, num_feat, dev)

    log_leaf = []
    log_feat = torch.zeros(max_splits, dtype=torch.int64, device=dev)
    log_bin = torch.zeros_like(log_feat)
    log_kind = torch.zeros_like(log_feat)
    log_dl = torch.zeros(max_splits, dtype=torch.bool, device=dev)
    log_gain = torch.zeros(max_splits, dtype=f32, device=dev)
    log_ls = torch.zeros((max_splits, 3), dtype=f32, device=dev)
    log_rs = torch.zeros_like(log_ls)
    log_go = torch.zeros((max_splits, num_bin), dtype=torch.bool, device=dev)
    group = bundle["group"].long() if bundle is not None else None
    seg_cols = torch.tensor([2, 0, 1, 3], device=dev)   # parity,start,cnt,col
    no = torch.zeros((), dtype=torch.bool, device=dev)

    # rounds r (the draws' index) and splits s: a round that finds no
    # valid split (a forced one, whose leaf cannot split there, when no
    # leaf has a split either) commits nothing but still counts
    r = s = 0
    force_live = n_forced > 0
    while s < max_splits and r < max_splits + n_forced:
        forcing = force_live and r < n_forced
        # ---- the round's one device->host transfer ----
        leaf_d = torch.argmax(best.gain)
        info = [x[leaf_d] for x in best]
        ok_d = no
        if forcing:
            fl = f_leaf[r]
            # the forced leaf's histogram made global where the pool holds
            # local rows (voting) or one rank's blocks (scatter), so every
            # rank scans the same
            hg_forced = comm.psum(hist_pool[fl]) \
                if voting or comm.hist_scatter else hist_pool[fl]
            fi = scan_leaf_info(
                feat_view(hg_forced[None], leaf_sum[fl][None])[0],
                leaf_sum[fl], leaf_out[fl], leaf_lower[fl], leaf_upper[fl],
                depth[fl], f_mask[r], f_thr[r], meta, hp,
                tuple(b[0] for b in leaf_bounds(fl)) if method == 2
                else None)
            ok_d = fi.gain > float("-inf")
            leaf_d = torch.where(ok_d, torch.full_like(leaf_d, fl), leaf_d)
            info = [torch.where(ok_d, a.to(b.dtype), b)
                    for a, b in zip(fi, info)]
        feat_d = info[1]
        col_d = group[feat_d] if group is not None else feat_d
        hdr = torch.cat([
            seg_tab[leaf_d], col_d.to(i32).reshape(1),
            leaf_d.to(i32).reshape(1),
            (info[6][2] <= info[7][2]).to(i32).reshape(1),
            (torch.max(best.gain) > 0).to(i32).reshape(1),
            (info[0] > float("-inf")).to(i32).reshape(1),
            ok_d.to(i32).reshape(1)])
        (start, cnt, parity, _, leaf, left_smaller, positive, valid,
         ok) = hdr.tolist()
        if not (positive or forcing):
            break
        if forcing and not ok:
            force_live = False
        if not valid:
            r += 1
            continue
        new = s + 1
        (i_gain, i_feat, i_bin, i_kind, i_dl, i_go, i_ls, i_rs, i_lo,
         i_ro) = info
        if method:
            # the stored split was scanned under the bounds of its leaf's
            # last scan; neighbours' commits may have tightened them since:
            # re-clamp its outputs and re-enforce the sibling order
            mono_f = meta.monotone[i_feat]
            if method == 2:
                at = i_feat * num_bin + i_bin
                lo_l, up_l, lo_r, up_r = (b[0].reshape(-1)[at]
                                          for b in leaf_bounds(leaf))
            else:
                lo_l = lo_r = leaf_lower[leaf]
                up_l = up_r = leaf_upper[leaf]
            i_lo, i_ro = reclamp(i_lo, i_ro, mono_f, lo_l, up_l, lo_r, up_r)

        # ---- record ----
        log_leaf.append(leaf)
        log_feat[s] = i_feat
        log_bin[s] = i_bin
        log_kind[s] = i_kind
        log_dl[s] = i_dl
        log_gain[s] = i_gain
        log_ls[s] = i_ls
        log_rs[s] = i_rs
        log_go[s] = i_go

        # ---- stats bookkeeping ----
        leaf_sum[leaf] = i_ls
        leaf_sum[new] = i_rs
        leaf_out[leaf] = i_lo
        leaf_out[new] = i_ro
        d = depth[leaf] + 1
        depth[leaf] = depth[new] = d
        if method:
            # the intermediate method's new child inherits the parent's
            # scalar bounds; a numerical winner cuts the boxes
            if method == 1:
                leaf_lower[new] = leaf_lower[leaf]
                leaf_upper[new] = leaf_upper[leaf]
            rng_lo, rng_hi, box_l, box_r = adv_child_boxes(
                rng_lo, rng_hi, lambda a, b: a, leaf, new,
                SimpleNamespace(kind=i_kind, feature=i_feat, bin=i_bin))
            if method == 1:
                # both children bound every box-overlapping leaf wholly
                # below or above them (the neighbour refresh)
                leaf_lower, leaf_upper = intermediate_refresh(
                    leaf_lower, leaf_upper, rng_lo, rng_hi, meta.monotone,
                    ((box_l, i_lo), (box_r, i_ro)), True)
            else:
                # both children's outputs into every overlapping leaf's
                # per-bin bounds (the new leaf inherits the parent's)
                words = torch.full((2,), leaf, dtype=i32, device=dev)
                words[0:1].fill_(1)
                mono_commit(cons_lo, cons_hi, rng_lo, rng_hi, meta.monotone,
                            words, torch.stack([i_lo, i_ro]).to(f32), new)
        elif hp.has_monotone:
            # basic method: both children bounded by the split midpoint
            # (monotone_constraints.hpp:327 BasicLeafConstraints)
            mono = meta.monotone[i_feat]
            mid = (i_lo + i_ro) * 0.5
            lo_p, up_p = leaf_lower[leaf].clone(), leaf_upper[leaf].clone()
            leaf_lower[leaf] = torch.where(mono < 0, torch.maximum(lo_p, mid),
                                           lo_p)
            leaf_upper[leaf] = torch.where(mono > 0, torch.minimum(up_p, mid),
                                           up_p)
            leaf_lower[new] = torch.where(mono > 0, torch.maximum(lo_p, mid),
                                          lo_p)
            leaf_upper[new] = torch.where(mono < 0, torch.minimum(up_p, mid),
                                          up_p)
        if opts.needs_used:
            used = leaf_used[leaf] | (torch.arange(num_feat, device=dev)
                                      == i_feat)
            leaf_used[leaf] = used
            leaf_used[new] = used
        if tree_used is not None:
            tree_used.index_fill_(0, i_feat.reshape(1), True)
        pair_sum = torch.stack([i_ls, i_rs])
        pair = slice(leaf, leaf + 1), slice(new, new + 1)
        pair_out = torch.cat([leaf_out[pair[0]], leaf_out[pair[1]]])
        pair_lo = torch.cat([leaf_lower[pair[0]], leaf_lower[pair[1]]])
        pair_up = torch.cat([leaf_upper[pair[0]], leaf_upper[pair[1]]])
        new_parity = 1 - parity
        seg = hdr.index_select(0, seg_cols)     # [src, start, cnt, col]

        if one_kernel:
            # ---- ONE launch: partition + smaller-child histogram + the
            # split scan of both children (bounds and outputs set above),
            # its scalars read on the card from a header built there
            k_hdr = torch.cat([hdr[:6], torch.full((1,), d, dtype=i32,
                                                   device=dev), one]) \
                .index_select(0, hdr_cols)
            one_kernel_split.split(k_hdr, i_go, hist_pool,
                                   split_pair(pair_sum, pair_out, pair_lo,
                                              pair_up), split_bufs,
                                   lanes=(start, start + cnt))
            lt = split_bufs.lt
            hist_left, hist_right = split_bufs.hists[0], split_bufs.hists[1]
            infos = split_bufs.infos()
        else:
            # ---- physical partition of the parent's segment ----
            lt = part_fn(work, seg, route_table(i_go, i_feat), cnt)
            # ---- histograms: smaller child's segment, sibling by
            # subtraction
            hseg = torch.empty(3, dtype=i32, device=dev)
            hseg[0] = new_parity
            if left_smaller:
                hseg[1] = start
                hseg[2:3] = lt
            else:
                hseg[1:2] = lt + start
                hseg[2:3] = cnt - lt
            hist_small = comm.hist(hist_fn(hseg, cnt))
            hist_large = hist_pool[leaf] - hist_small
            hist_left, hist_right = (hist_small, hist_large) \
                if left_smaller else (hist_large, hist_small)
            # ---- refresh best splits for both children in one batched
            # scan, drawn at this round with both children's leaves; the
            # voting ranks' local child sums (group 0's bins hold every
            # row of a leaf)
            pair_loc = None
            if voting:
                loc_left = torch.sum(hist_left[0], dim=0)
                pair_loc = torch.stack([loc_left,
                                        leaf_sum_loc[leaf] - loc_left])
                leaf_sum_loc[leaf] = pair_loc[0]
                leaf_sum_loc[new] = pair_loc[1]
            infos = best_for(torch.stack([hist_left, hist_right]), pair_sum,
                             pair_loc, pair_out, pair_lo, pair_up, d,
                             r=r, leaf=leaf, leaf1=new, used=leaf_used,
                             tree_used=tree_used,
                             adv_bounds=leaf_bounds(leaf, new, 2)
                             if method == 2 else None)
        seg_tab[new, 0:1] = lt + start
        seg_tab[new, 1:2] = cnt - lt
        seg_tab[leaf, 1:2] = lt
        seg_tab[leaf, 2] = new_parity
        seg_tab[new, 2] = new_parity
        hist_pool[leaf] = hist_left
        hist_pool[new] = hist_right
        if max_depth > 0 and d >= max_depth:
            infos = infos._replace(gain=torch.full_like(infos.gain,
                                                        float("-inf")))
        _set_best(best, leaf, [x[0] for x in infos])
        _set_best(best, new, [x[1] for x in infos])
        s += 1
        r += 1

    ns = len(log_leaf)
    split_leaf = torch.tensor(log_leaf + [0] * (max_splits - ns),
                              dtype=i32).to(dev)
    log = TreeLog(
        num_splits=torch.full((1,), ns, dtype=i32, device=dev),
        split_leaf=split_leaf, feature=log_feat.to(i32),
        bin=log_bin.to(i32), kind=log_kind.to(i32), default_left=log_dl,
        gain=log_gain, left_sum=log_ls, right_sum=log_rs, go_left=log_go,
        miss_bin=meta.missing_bin[log_feat].to(i32),
        movable=meta.movable_missing[log_feat],
        leaf_value=leaf_out, leaf_sum=leaf_sum,
        row_leaf=torch.zeros(0, dtype=i32, device=dev))
    row_leaf = assign_leaves(route_bins, log,
                             has_categorical=hp.has_categorical,
                             bundle=bundle, bins_t=route_bins_t)
    if stats is not None:
        stats["leaf_cnt"] = seg_tab[:, 1]
        stats["hist_cnt"] = hist_pool[:, 0, :, 2].sum(dim=1)
        stats["num_splits"] = ns
        stats["row_leaf"] = row_leaf
    return log._replace(row_leaf=row_leaf)


def build_tree(
    bins: torch.Tensor,          # (N, F) u8 or u16 (int16 view) bins
    ghc: torch.Tensor,           # (N, 3) f32 (grad, hess, inbag)
    meta,                        # ops.split.FeatureMeta
    feature_mask: torch.Tensor,  # (F,) bool
    hp,                          # ops.split.SplitHyper
    *,
    num_leaves: int,
    num_bin: int,
    max_depth: int = -1,
    key=None,
    comm: Comm = Comm(),
    opts=None,
    forced=None,
    hist_chunk: int = 4096,
    stats: Optional[dict] = None,
) -> TreeLog:
    """Grow one leaf-wise tree with the dense builder (the JAX package's
    ``build_tree``, the only builder past 256 bins and the one
    ``tree_builder=dense`` asks for): every row stays in place and carries
    its leaf id. Per split, one read of the round's header to the host,
    then on the device:

    - the row update: the parent's rows whose bin goes right move to the
      new leaf (``ops/histogram.dense_row_update``);
    - the histogram of the smaller child (``ops/histogram.DenseHistogram``:
      the rows on it selected from all rows by their leaf id; the kernel
      ``csrc/dense_histogram.cu`` on the card), the sibling as parent minus
      child;
    - the split scan of both children (``ops/split.find_best_split``).

    Kept as the JAX builder has them: the root's (r = 0, leaf 0) and each
    round's children's (r, leaf) node draws of ``opts`` (by-node sampling,
    extra-trees, interaction constraints; CEGB needs the partitioned
    builder), forced splits (``forced``, BFS ``(leaf, feature, bin)``; the
    loop runs up to ``num_leaves - 1 + len(forced)`` rounds and a round
    without a valid split commits nothing), ``max_depth`` and the basic
    monotone method's midpoint bounds (the learner hands the dense builder
    no other method). ``hist_chunk`` is the twin's summation chunk (the
    JAX builder's). ``stats``, when given, receives the split count and
    ``row_leaf``. The leaf ids of ``row_leaf`` are the log's leaf slots.
    """
    from .ops.histogram import DenseHistogram, dense_row_update
    from .ops.node import NodeOptions, node_buf, node_keys
    from .ops.scan import scan_leaf_info
    from .ops.split import calc_leaf_output

    dev = bins.device
    f32, i32 = torch.float32, torch.int32
    n, num_feat = bins.shape
    max_splits = num_leaves - 1
    row_leaf = torch.zeros(n, dtype=i32, device=dev)
    dense = DenseHistogram(bins, ghc, row_leaf, num_bin, chunk=hist_chunk)
    opts = opts if opts is not None else NodeOptions()
    if opts.active and key is None:
        raise ValueError("by-node sampling, extra-trees and interaction "
                         "constraints need the tree's key")
    keys = node = None
    if opts.active:
        keys = node_keys(key, opts.extra_seed,
                         torch.zeros(4, dtype=torch.int64, device=dev))
        node = node_buf(opts, num_feat, dev)
    best_for = _make_best_for(meta, hp, feature_mask, opts, keys, node)
    n_forced = 0 if forced is None else len(forced[0])

    # ---- root ----
    # the JAX dense builder sums every histogram over the ranks (data
    # mode only: the learners refuse the other modes here)
    root_sum = comm.psum(torch.sum(ghc, dim=0))
    root_hist = comm.psum(dense(-1).clone())
    hist_pool = torch.zeros((num_leaves, num_feat, num_bin, 3), dtype=f32,
                            device=dev)
    hist_pool[0] = root_hist
    leaf_sum = torch.zeros((num_leaves, 3), dtype=f32, device=dev)
    leaf_sum[0] = root_sum
    leaf_out = torch.zeros(num_leaves, dtype=f32, device=dev)
    leaf_out[0] = calc_leaf_output(root_sum[0], root_sum[1], hp)
    leaf_lower = torch.full((num_leaves,), float("-inf"), device=dev)
    leaf_upper = torch.full((num_leaves,), float("inf"), device=dev)
    leaf_used = torch.zeros((num_leaves, num_feat), dtype=torch.bool,
                            device=dev) if opts.needs_used else None
    depth = [0] * num_leaves
    best = _empty_best(num_leaves, num_bin, dev)
    _set_best(best, slice(0, 1),
              best_for(root_hist[None], root_sum[None], leaf_out[:1],
                       leaf_lower[:1], leaf_upper[:1], 0, used=leaf_used))
    if n_forced:
        f_leaf, f_mask, f_thr = forced_tables(forced, num_feat, dev)

    log_leaf = []
    log_feat = torch.zeros(max_splits, dtype=torch.int64, device=dev)
    log_bin = torch.zeros_like(log_feat)
    log_kind = torch.zeros_like(log_feat)
    log_dl = torch.zeros(max_splits, dtype=torch.bool, device=dev)
    log_gain = torch.zeros(max_splits, dtype=f32, device=dev)
    log_ls = torch.zeros((max_splits, 3), dtype=f32, device=dev)
    log_rs = torch.zeros_like(log_ls)
    log_go = torch.zeros((max_splits, num_bin), dtype=torch.bool, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    r = s = 0
    force_live = n_forced > 0
    while s < max_splits and r < max_splits + n_forced:
        forcing = force_live and r < n_forced
        # ---- the round's one device->host transfer ----
        leaf_d = torch.argmax(best.gain)
        info = [x[leaf_d] for x in best]
        ok_d = no
        if forcing:
            fl = f_leaf[r]
            fi = scan_leaf_info(hist_pool[fl], leaf_sum[fl], leaf_out[fl],
                                leaf_lower[fl], leaf_upper[fl], depth[fl],
                                f_mask[r], f_thr[r], meta, hp)
            ok_d = fi.gain > float("-inf")
            leaf_d = torch.where(ok_d, torch.full_like(leaf_d, fl), leaf_d)
            info = [torch.where(ok_d, a.to(b.dtype), b)
                    for a, b in zip(fi, info)]
        hdr = torch.cat([
            leaf_d.to(i32).reshape(1), info[1].to(i32).reshape(1),
            (info[6][2] <= info[7][2]).to(i32).reshape(1),
            (torch.max(best.gain) > 0).to(i32).reshape(1),
            (info[0] > float("-inf")).to(i32).reshape(1),
            ok_d.to(i32).reshape(1)])
        leaf, feat, left_smaller, positive, valid, ok = hdr.tolist()
        if not (positive or forcing):
            break
        if forcing and not ok:
            force_live = False
        if not valid:
            r += 1
            continue
        new = s + 1
        (i_gain, i_feat, i_bin, i_kind, i_dl, i_go, i_ls, i_rs, i_lo,
         i_ro) = info

        # ---- the row update (DataPartition::Split's analog) ----
        d = depth[leaf] + 1
        split_hdr = torch.tensor([0, 0, 0, feat, left_smaller, d, 1, leaf],
                                 dtype=i32).to(dev)
        dense_row_update(bins, row_leaf, i_go.contiguous(), split_hdr, new)

        # ---- record ----
        log_leaf.append(leaf)
        log_feat[s] = i_feat
        log_bin[s] = i_bin
        log_kind[s] = i_kind
        log_dl[s] = i_dl
        log_gain[s] = i_gain
        log_ls[s] = i_ls
        log_rs[s] = i_rs
        log_go[s] = i_go

        # ---- stats bookkeeping ----
        leaf_sum[leaf] = i_ls
        leaf_sum[new] = i_rs
        leaf_out[leaf] = i_lo
        leaf_out[new] = i_ro
        depth[leaf] = depth[new] = d
        if hp.has_monotone:
            # basic method: both children bounded by the split midpoint
            mono = meta.monotone[i_feat]
            mid = (i_lo + i_ro) * 0.5
            lo_p, up_p = leaf_lower[leaf].clone(), leaf_upper[leaf].clone()
            leaf_lower[leaf] = torch.where(mono < 0, torch.maximum(lo_p, mid),
                                           lo_p)
            leaf_upper[leaf] = torch.where(mono > 0, torch.minimum(up_p, mid),
                                           up_p)
            leaf_lower[new] = torch.where(mono > 0, torch.maximum(lo_p, mid),
                                          lo_p)
            leaf_upper[new] = torch.where(mono < 0, torch.minimum(up_p, mid),
                                          up_p)
        if opts.needs_used:
            used = leaf_used[leaf] | (torch.arange(num_feat, device=dev)
                                      == i_feat)
            leaf_used[leaf] = used
            leaf_used[new] = used

        # ---- histograms: the smaller child's rows by mask, the sibling by
        # subtraction (serial_tree_learner.cpp:418) ----
        hist_small = comm.psum(dense(leaf if left_smaller else new).clone())
        hist_large = hist_pool[leaf] - hist_small
        hist_left, hist_right = (hist_small, hist_large) if left_smaller \
            else (hist_large, hist_small)
        hist_pool[leaf] = hist_left
        hist_pool[new] = hist_right
        pair_sum = torch.stack([i_ls, i_rs])
        idx = torch.tensor([leaf, new], device=dev)
        infos = best_for(torch.stack([hist_left, hist_right]), pair_sum,
                         leaf_out[idx], leaf_lower[idx], leaf_upper[idx], d,
                         r=r, leaf=leaf, leaf1=new, used=leaf_used)
        if max_depth > 0 and d >= max_depth:
            infos = infos._replace(gain=torch.full_like(infos.gain,
                                                        float("-inf")))
        _set_best(best, leaf, [x[0] for x in infos])
        _set_best(best, new, [x[1] for x in infos])
        s += 1
        r += 1

    ns = len(log_leaf)
    split_leaf = torch.tensor(log_leaf + [0] * (max_splits - ns),
                              dtype=i32).to(dev)
    if stats is not None:
        stats["num_splits"] = ns
        stats["row_leaf"] = row_leaf
    return TreeLog(
        num_splits=torch.full((1,), ns, dtype=i32, device=dev),
        split_leaf=split_leaf, feature=log_feat.to(i32),
        bin=log_bin.to(i32), kind=log_kind.to(i32), default_left=log_dl,
        gain=log_gain, left_sum=log_ls, right_sum=log_rs, go_left=log_go,
        miss_bin=meta.missing_bin[log_feat].to(i32),
        movable=meta.movable_missing[log_feat],
        leaf_value=leaf_out, leaf_sum=leaf_sum, row_leaf=row_leaf)


class DeviceTreeLoop:
    """The device tree loop: one leaf-wise tree with no read back to the
    host between its root and its log (the JAX builder's
    ``lax.while_loop``, ``lightgbm_tpu/learner.py``), in every
    configuration of the partitioned builder: the planes, resident and
    rows layouts, f32 (hi/lo, bf16) and int8 histograms, EFB bundles and
    categorical features, and the per-node options (``opts``, an
    ``ops/node.NodeOptions``) and forced splits, and every monotone method.

    A tree is a fixed sequence: the root (the pack and its histogram, the
    root's split scan), then ``num_leaves - 1`` pairs of a split commit
    (``ops/commit.split_commit``: apply the last split, pick the next one,
    write its header) and a split that reads that header on the card, a
    final commit, and the row router (``ops/route.route_rows``, categorical
    rounds included) with the device ``num_splits``. The split is the
    one-kernel split (``split_kernel="on"``, planes or resident, no EFB or
    int8: ``ops/partition.OneKernelSplit``) or the three-launch chain
    (``ops/chain.ChainSplit``: K3, K4 or K5, the split scan). With bundles
    the commit writes the split feature's bundle column into the header
    and the chain partitions by the routing table in bundle codes
    (``go_left[map_fb[feature]]``, built per slot on the card). With node
    options each slot launches ``ops/node.node_inputs`` between the commit
    and the split: the children's masks, threshold bins and CEGB penalties,
    drawn at the slot's round from the header's leaf, which the chain's
    scan reads. With forced splits the first ``len(forced)`` slots start
    with the forced leaf's one-leaf scan (``ops/scan.SplitScan.
    scan_leaf``), which the commit takes while the forced splits hold; the
    JAX loop's extra rounds need no slot: a round that finds no valid split
    is always its last. The intermediate monotone method's state (the
    boxes and scalar bounds) is the commit's; under the advanced method
    each slot also launches ``ops/monotone.mono_commit`` after the commit
    (the per-bin bounds of every leaf) and ``ops/monotone.mono_bounds``
    before the split (the children's per-candidate bounds, which the
    chain's scan reads), and a forced slot the forced leaf's bounds before
    its scan. A tree that stops early runs its remaining splits
    as ``live = 0`` no-ops. The trees and logs equal
    :func:`build_tree_partitioned`'s with the same arguments, field by
    field. With ``work_layout="dense"`` they equal :func:`build_tree`'s
    (the dense builder, u8 or u16 bins): every row keeps its leaf id, the
    split is ``ops/chain.DenseSplit`` (the row update, the smaller child's
    histogram by leaf id over all rows, the split scan), and the rows'
    leaves are the log's ``row_leaf``, with no router.

    The inputs are static buffers (``ghc``, ``fmask``, the tree key's
    words, the model's used features ``cegb0``): :meth:`run` copies a
    tree's into them. With ``inbag_first`` (GOSS) the root first puts the
    rows in ``ops/partition.inbag_order``'s order (the in-bag ones first)
    into buffers of its own, and with ``goss_compact`` (GOSS compaction)
    sets the root segment's count to the in-bag count, on the card: the
    tree grows over the in-bag rows alone, and its histograms are the
    ``inbag_first`` dense tree's bit for bit (as in
    :func:`build_tree_partitioned`). The root sums come from the channels
    as given, and the router routes every row in its own order. On the
    card the sequence is captured once as one CUDA graph (after one eager
    tree, which sets up every launch's lazy state) and replayed per tree;
    the kernels' launch counts are counted at capture and added per replay
    (``ops/kernels.capture_launches``). A failed capture or launch raises.
    On host tensors the sequence runs eagerly through the kernels' plain
    twins, which read nothing back either. The returned log aliases the
    loop's buffers: the next tree overwrites it.
    """

    def __init__(self, bins: torch.Tensor, meta, hp, *, num_leaves: int,
                 num_bin: int, max_depth: int = -1,
                 num_bin_hist: Optional[int] = None,
                 hist_mode: str = "hilo", work_layout: str = "planes",
                 split_kernel: str = "on",
                 bundle: Optional[Dict[str, torch.Tensor]] = None,
                 dither_offset: int = 0,
                 bins_t: Optional[torch.Tensor] = None,
                 work: Optional[torch.Tensor] = None, opts=None,
                 forced=None, inbag_first: bool = False,
                 goss_compact: bool = False) -> None:
        from .ops.chain import ChainSplit, DenseSplit
        from .ops.commit import SplitCommit, tree_state
        from .ops.monotone import method_code
        from .ops.node import NodeOptions, node_buf
        from .ops.partition import (OneKernelSplit, root_segment, split_out,
                                    work_buffer, work_spec)
        from .ops.scan import SplitScan

        dev = bins.device
        n, num_grp = bins.shape
        num_feat = int(meta.num_bins.shape[0])
        bm = num_bin_hist if num_bin_hist is not None else num_bin
        quantized = hist_mode == "int8"
        opts = opts if opts is not None else NodeOptions()
        if quantized and work_layout != "rows":
            raise ValueError("int8 quantized histograms need the rows work "
                             "layout (the planes layout has no quantized "
                             "pack)")
        self.one_kernel = split_kernel == "on"
        self.dense = work_layout == "dense"
        if self.dense and (self.one_kernel or quantized or inbag_first
                           or bundle is not None):
            raise ValueError("the dense builder's loop takes no one-kernel "
                             "split, int8 histograms, GOSS ordering or EFB "
                             "bundles")
        if self.one_kernel:
            bad = split_kernel_ineligible(work_layout=work_layout,
                                          hist_mode=hist_mode, bundle=bundle,
                                          num_bin_hist=bm, num_bin=num_bin,
                                          comm=Comm(), hp=hp, opts=opts)
            if bad:
                raise ValueError("tpu_split_kernel=on is not eligible here: "
                                 + "; ".join(bad))
        self.bins, self.meta, self.hp, self.bundle = bins, meta, hp, bundle
        self.n, self.num_grp, self.bm = n, num_grp, bm
        self.num_feat, self.num_bin = num_feat, num_bin
        self.num_leaves = num_leaves
        self.layout, self.quantized = work_layout, quantized
        self.exact = hist_mode != "bf16"
        self.dither_offset = int(dither_offset)
        if goss_compact and not inbag_first:
            raise ValueError("goss_compact needs inbag_first")
        self.opts, self.inbag_first = opts, bool(inbag_first)
        self.compact = bool(goss_compact)
        #: the router's block form of the rows in their own order
        self.route_bins_t = None if self.dense else bins_t \
            if bins_t is not None else route_layout(bins)
        self.bins_t = self.route_bins_t
        if self.inbag_first:
            # the tree's rows in the in-bag-first order, refreshed per tree
            self.bins_src = bins
            self.bins = torch.empty_like(bins)
            if work_layout == "resident":
                self.bins_t = torch.empty_like(self.route_bins_t)
        self.resident = self.bins_t.reshape(num_grp, -1) \
            if work_layout == "resident" else None
        self.guard, _ = (0, 0) if self.dense \
            else work_spec(num_grp, quantized, work_layout)
        self.work = work if work is not None or self.dense else work_buffer(
            n, num_grp, work_layout, quantized, dev)
        #: every row's leaf (the dense builder)
        self.row_leaf = torch.zeros(n, dtype=torch.int32, device=dev) \
            if self.dense else None
        self.ghc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        #: the tree's channels as given (gathered into ``ghc`` in the
        #: in-bag-first order)
        self.ghc_in = torch.zeros_like(self.ghc) if self.inbag_first \
            else self.ghc
        self.fmask = torch.ones(num_feat, dtype=torch.bool, device=dev)
        #: int8: the dither key's words and the tree's dequantization
        self.key = torch.zeros(2, dtype=torch.int64, device=dev)
        self.scale = torch.ones(3, dtype=torch.float32, device=dev)
        #: the node draws' key words (ops/node.node_keys), the model's used
        #: features
        self.keys = torch.zeros(4, dtype=torch.int64, device=dev)
        self.cegb0 = torch.zeros(num_feat, dtype=torch.bool, device=dev)
        hist = (num_grp, bm)
        #: the monotone method (ops/monotone.method_code) and, for the
        #: advanced one, the nodes' (2, 4, F, B) per-candidate bounds that
        #: the split scans read (node 0 the left child or the forced leaf)
        self.mono_method = method_code(hp)
        self.state = tree_state(num_leaves, num_feat, num_bin, dev, hist,
                                mono_method=self.mono_method)
        self.bounds = torch.zeros((2, 4, num_feat, num_bin),
                                  dtype=torch.float32, device=dev) \
            if self.mono_method == 2 else None
        self.zero_word = torch.zeros(1, dtype=torch.int32, device=dev)
        self.out = split_out(num_feat, num_bin, dev, hist)
        self.node = node_buf(opts, num_feat, dev) if opts.active else None
        self.map_fb = None
        col_map = None
        if bundle is not None:
            self.map_fb = bundle["map_fb"].long()
            col_map = bundle["group"].to(torch.int32)
        if self.dense:
            self.split = DenseSplit(bins, self.ghc, self.row_leaf, meta,
                                    self.fmask, hp, num_bins=num_bin,
                                    node=self.node)
        elif self.one_kernel:
            self.split = OneKernelSplit(self.work, meta, self.fmask, hp,
                                        num_bins=bm, num_feat=num_grp,
                                        exact=self.exact, cnt_max=n,
                                        resident=self.resident)
        else:
            self.split = ChainSplit(
                self.work, meta, self.fmask, hp, layout=work_layout,
                hist_mode=hist_mode, num_feat=num_grp, num_bins=bm,
                scan_feat=num_feat, scan_bins=num_bin, cnt_max=n,
                resident=self.resident, scale=self.scale,
                feat_view=None if bundle is None else self.feature_view,
                node=self.node, bounds=self.bounds)
        self.n_forced = 0 if forced is None else len(forced[0])
        self.forced_out = None
        if self.n_forced:
            self.f_leaf, self.f_mask, self.f_thr = forced_tables(
                forced, num_feat, dev)
            self.forced_out = split_out(num_feat, num_bin, dev, hist)
            self.forced_scan = SplitScan(meta, self.fmask, hp,
                                         num_feat=num_feat,
                                         num_bins=num_bin, device=dev,
                                         node=self.node, bounds=self.bounds)
            #: the forced leaves as device words (their bounds' leaf)
            self.f_leaf_words = torch.tensor(
                self.f_leaf, dtype=torch.int32).to(dev)
            self.fview = torch.zeros((1, num_feat, num_bin, 3),
                                     dtype=torch.float32, device=dev)
        #: the split writes both children into the pool (the scan's fold
        #: mode: the chain without bundles, the dense builder)
        self.pooled = bool(getattr(self.split, "pooled", False))
        self.commit = SplitCommit(self.state, self.out, max_depth=max_depth,
                                  monotone=meta.monotone,
                                  has_monotone=hp.has_monotone,
                                  col_map=col_map, forced=self.forced_out,
                                  n_forced=self.n_forced,
                                  track_used=opts.needs_used,
                                  mono_method=self.mono_method,
                                  pooled=self.pooled)
        self.cuda = dev.type == "cuda"
        self.root_seg = root_segment(self.guard, n, dev) if self.cuda \
            else None
        self.graph = None
        self._warm = False
        self._graph_log: Optional[TreeLog] = None
        #: launches of one replay, per kernel (the capture's tally)
        self.replay_launches: Dict[str, int] = {}
        #: wall ms of the capture, once it ran
        self.capture_ms: Optional[float] = None

    def feature_view(self, hg: torch.Tensor,
                     total_sum: torch.Tensor) -> torch.Tensor:
        """:func:`feature_view` of this loop's bundles."""
        return feature_view(hg, total_sum, self.bundle, self.num_feat,
                            self.num_bin)

    def node_inputs(self, r: int, leaf, leaf1: int, p: int, sums,
                    live=None) -> None:
        """``ops/node.node_inputs`` of this loop's tree into its node
        buffer."""
        from .ops.node import node_inputs

        st = self.state
        node_inputs(self.node, self.keys, r, leaf, leaf1, p, opts=self.opts,
                    fmask=self.fmask, num_bins=self.meta.num_bins,
                    coupled=self.meta.cegb_coupled, hp=self.hp, sums=sums,
                    used=st.leaf_used, tree_used=st.tree_used, live=live)

    def root(self) -> None:
        """The state of a tree after its root, from the static inputs: the
        pack and the root histogram, the root's sums, output and best
        split."""
        from .ops.commit import reset_tree_state
        from .ops.histogram import dequant_scale
        from .ops.partition import (inbag_order, pack_planes_fold_root,
                                    pack_resident_fold_root,
                                    pack_rows_fold_root, quantize_scales)
        from .ops.split import calc_leaf_output, find_best_split

        st, hp, meta = self.state, self.hp, self.meta
        ghc = self.ghc
        reset_tree_state(st, self.guard, self.n, forced=self.n_forced > 0,
                         tree_used=self.cegb0,
                         num_bins=meta.num_bins if self.mono_method else None)
        # the root sums come from the channels as given (a row reduction
        # over the gathered rows would group the f32 additions otherwise)
        root_sum = torch.sum(self.ghc_in, dim=0)
        if self.inbag_first:
            order, c_in = inbag_order(self.ghc_in)
            ghc.copy_(self.ghc_in.index_select(0, order))
            self.bins.copy_(self.bins_src.index_select(0, order))
            if self.resident is not None:
                self.bins_t.copy_(route_layout(self.bins))
        if self.compact:
            c_in = c_in.to(torch.int32)
            st.seg_tab[0, 1:2].copy_(c_in)
            if self.root_seg is not None:
                self.root_seg[2:3].copy_(c_in)
        kw = dict(num_bins=self.bm, seg=self.root_seg)
        if self.dense:
            self.row_leaf.zero_()
            root_hist = self.split.hist(-1)
        elif self.resident is not None:
            root_hist = pack_resident_fold_root(
                self.work, self.resident, ghc, self.guard,
                num_feat=self.num_grp, exact=self.exact, **kw)
        elif self.layout == "rows":
            if self.quantized:
                scales = quantize_scales(ghc)
                self.scale.copy_(dequant_scale(scales))
                kw.update(key=self.key, scales=scales, scale=self.scale,
                          offset=self.dither_offset)
            root_hist = pack_rows_fold_root(self.work, self.bins, ghc,
                                            self.guard, exact=self.exact,
                                            **kw)
        else:
            root_hist = pack_planes_fold_root(
                self.work, self.bins, ghc, self.guard, exact=self.exact, **kw)
        st.hist_pool[0] = root_hist
        st.leaf_sum[0] = root_sum
        st.leaf_out[0] = calc_leaf_output(root_sum[0], root_sum[1], hp)
        view = root_hist[None] if self.bundle is None \
            else self.feature_view(root_hist[None], root_sum[None])
        mask, thr, delta = self.fmask, None, None
        if self.node is not None:
            self.node_inputs(0, 0, 0, 1, st.leaf_sum[0:1])
            mask, thr, delta = self.node.rows(1)
        adv = None
        if self.mono_method == 2:
            self.mono_bounds(self.zero_word, 0, 1)
            adv = tuple(self.bounds[:1, k] for k in range(4))
        root_info = find_best_split(
            view, root_sum[None], meta, mask, hp,
            parent_output=st.leaf_out[:1], leaf_lower=st.leaf_lower[:1],
            leaf_upper=st.leaf_upper[:1], node_depth=0,
            rand_threshold=thr, cegb_delta=delta, adv_bounds=adv)
        _set_best(st.best, slice(0, 1), root_info)

    def mono_bounds(self, leaf0: torch.Tensor, leaf1: int, nodes: int,
                    live=None) -> None:
        """``ops/monotone.mono_bounds`` of this tree's state into the
        loop's bounds buffer."""
        from .ops.monotone import mono_bounds

        st = self.state
        mono_bounds(st.cons_lo, st.cons_hi, st.rng_lo, st.rng_hi, leaf0,
                    leaf1, nodes, self.bounds, live)

    def table(self, s: int) -> torch.Tensor:
        """Split slot ``s``'s routing table over its column's codes: the
        logged (B,) go-left row, through the bundle's code map with EFB."""
        go = self.state.log_go[s]
        if self.map_fb is None:
            return go
        feat = self.state.log_feat[s:s + 1]
        return go.index_select(0, self.map_fb.index_select(0, feat)[0])

    def forced_leaf_scan(self, s: int) -> None:
        """The one-leaf scan of forced slot ``s``, before its commit: the
        forced leaf's histogram is a child of split ``s - 1`` (in the split
        outputs, which the commit has yet to pool: while the forced splits
        hold, split ``s - 1`` was forced split ``s - 1``; in the pool
        already where the split pools the children) or already in the
        pool; its sums, output, bounds and depth are in the state."""
        st = self.state
        fl = self.f_leaf[s]
        if self.pooled:
            hist = st.hist_pool[fl:fl + 1]
        elif s > 0 and fl == self.f_leaf[s - 1]:
            hist = self.out.hists[0:1]
        elif s > 0 and fl == s:
            hist = self.out.hists[1:2]
        else:
            hist = st.hist_pool[fl:fl + 1]
        if self.bundle is not None:
            self.fview.copy_(self.feature_view(hist,
                                               st.leaf_sum[fl:fl + 1]))
            hist = self.fview
        if self.mono_method == 2:
            self.mono_bounds(self.f_leaf_words[s:s + 1], 0, 1,
                             live=st.force_live)
        self.forced_scan.scan_leaf(
            hist, st.leaf_sum[fl], st.leaf_out[fl:fl + 1],
            st.leaf_lower[fl:fl + 1], st.leaf_upper[fl:fl + 1],
            st.depth[fl:fl + 1], st.force_live, self.f_mask[s],
            self.f_thr[s], self.forced_out)

    def children(self, s: int) -> torch.Tensor:
        """The (2, F, B, 3) children that split slot ``s``'s scan read,
        after that split ran: the pool rows of its parent and of leaf ``s +
        1`` where the split pools them, else the split outputs' (the
        per-feature view with bundles)."""
        if self.pooled:
            st = self.state
            return torch.stack([st.hist_pool[int(st.hdr[s, 7])],
                                st.hist_pool[s + 1]])
        fhist = getattr(self.split, "fhist", None)
        return fhist if fhist is not None else self.out.hists

    def splits(self, stop: int) -> None:
        """Split slots ``[0, stop)``: a commit, then the split that reads
        the header it wrote (with the forced leaf's scan before the commit;
        after it, under the advanced monotone method, the commit's per-bin
        bound writes; the children's node inputs; and, advanced, the
        children's per-candidate bounds)."""
        st = self.state
        for s in range(stop):
            self.pre_split(s)
            self.split.split(st.hdr[s], self.table(s), st.hist_pool,
                             st.pair[s], self.out,
                             *(() if self.one_kernel else (s + 1,)))

    def pre_split(self, s: int) -> None:
        """Split slot ``s`` up to its split: the forced leaf's scan, the
        commit, and the launches between the commit and the split (the
        advanced method's per-bin bounds and the children's, the node
        inputs)."""
        from .ops.monotone import mono_commit

        st = self.state
        advanced = self.mono_method == 2
        forced = s < self.n_forced
        if forced:
            self.forced_leaf_scan(s)
        self.commit(s, self.f_leaf[s] if forced else 0)
        if advanced:
            mono_commit(st.cons_lo, st.cons_hi, st.rng_lo, st.rng_hi,
                        self.meta.monotone, st.hdr[s, 6:8],
                        st.pair[s, 6:8], s + 1)
        if self.node is not None:
            self.node_inputs(s, st.hdr[s, 7:8], s + 1, 2,
                             st.pair[s, 0:6].view(2, 3),
                             live=st.hdr[s, 6:7])
        if advanced:
            self.mono_bounds(st.hdr[s, 7:8], s + 1, 2,
                             live=st.hdr[s, 6:7])

    def grow(self) -> TreeLog:
        """One tree from the static inputs, every launch queued without a
        read back to the host."""
        from .ops.route import build_cat_table, build_route_table, route_rows

        st, meta = self.state, self.meta
        self.root()
        self.splits(self.num_leaves - 1)
        self.commit(self.num_leaves - 1)
        feat = st.log_feat.long()
        log = TreeLog(
            num_splits=st.num_splits, split_leaf=st.log_leaf,
            feature=st.log_feat, bin=st.log_bin, kind=st.log_kind,
            default_left=st.log_dl, gain=st.log_gain, left_sum=st.log_ls,
            right_sum=st.log_rs, go_left=st.log_go,
            miss_bin=meta.missing_bin[feat].to(torch.int32),
            movable=meta.movable_missing[feat], leaf_value=st.leaf_out,
            leaf_sum=st.leaf_sum, row_leaf=st.num_splits[:0])
        if self.dense:
            return log._replace(row_leaf=self.row_leaf)
        cat = build_cat_table(log) if self.hp.has_categorical else None
        row_leaf = route_rows(self.route_bins_t,
                              build_route_table(log, self.bundle),
                              st.num_splits, cat)[:self.n]
        return log._replace(row_leaf=row_leaf)

    def run(self, ghc: torch.Tensor, fmask: torch.Tensor, key=None,
            cegb_used: Optional[torch.Tensor] = None) -> TreeLog:
        """One tree from ``ghc`` (N, 3), ``fmask`` (F,) and the ``prng``
        ``key`` of the tree (for int8 its dither is drawn from
        ``fold_in(key, 987123)`` at row offset ``dither_offset``, as
        :func:`build_tree_partitioned` draws it; the node options draw from
        it too) and the model's used features ``cegb_used`` ((F,) bool,
        none when None): copied into the static inputs (the keys' words by
        fills, so the host does not wait), then the graph's replay on the
        card (the first tree runs eagerly and the second captures), the
        eager sequence on the host."""
        from .ops import kernels
        from .ops.node import node_keys
        from .prng import fold_in, key_words

        self.ghc_in.copy_(ghc)
        self.fmask.copy_(fmask)
        if self.quantized or self.node is not None:
            if key is None:
                raise ValueError("int8 quantized histograms and the "
                                 "per-node options need the tree's key")
            if self.quantized:
                key_words(fold_in(key, 987123), self.key)
            if self.node is not None:
                node_keys(key, self.opts.extra_seed, self.keys)
        if cegb_used is not None:
            self.cegb0.copy_(cegb_used)
        else:
            self.cegb0.zero_()
        if not self.cuda:
            return self.grow()
        if not self._warm:
            self._warm = True
            return self.grow()      # sets up every launch's lazy state
        if self.graph is None:
            import time
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with kernels.capture_launches() as cap:
                # relaxed: the kernels' entry points set function
                # attributes (not stream work) while they are recorded
                with torch.cuda.graph(graph, capture_error_mode="relaxed"):
                    self._graph_log = self.grow()
            self.capture_ms = (time.perf_counter() - t0) * 1e3
            self.graph, self.replay_launches = graph, dict(cap.counts)
        self.graph.replay()
        kernels.add_launches(self.replay_launches)
        return self._graph_log

    def stats(self) -> dict:
        """The last tree's per-leaf segment and histogram counts, split
        count and routed rows (``build_tree_partitioned``'s ``stats``)."""
        st = self.state
        return {"leaf_cnt": st.seg_tab[:, 1].clone(),
                "hist_cnt": st.hist_pool[:, 0, :, 2].sum(dim=1),
                "num_splits": st.num_splits.clone()}


def launches_per_split(work_layout: str, one_kernel: bool,
                       device_loop: bool = True,
                       node_inputs: bool = False,
                       advanced: bool = False) -> int:
    """Device launches per split slot. The device tree loop (the card's
    fused path): the one-kernel split and the split commit; or the chain's
    partition, histogram and split scan and the commit, plus the route
    gather on the resident layout. The per-split host loop: the one-kernel
    split; or partition, histogram and the torch scan, plus the route
    gather on the resident layout. With the per-node options
    (``node_inputs``; the chain only) either loop launches the node inputs
    kernel once more a split. Under the advanced monotone method (the
    chain only) the device loop launches ``mono_commit`` and
    ``mono_bounds`` (the children's bounds) once more each a split, the
    host loop those two and ``mono_bounds`` of the picked leaf (its
    re-clamp). A tree's forced slots add one launch each (the forced
    leaf's scan, and its bounds under the advanced method), not counted
    here."""
    gather = 1 if work_layout == "resident" else 0
    if one_kernel:
        return 2 if device_loop else 1
    mono = (2 if device_loop else 3) if advanced else 0
    return 3 + gather + (1 if device_loop else 0) + (1 if node_inputs
                                                     else 0) + mono


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

def kernel_sources(layout: str, quantized: bool):
    """(partition, histogram): the sources and entry points of the
    hand-written kernels that a resolved work layout runs, as the
    ``auto_resolution`` records name them."""
    hist = ("csrc/segment_histogram_q.cu" if quantized else
            "csrc/segment_histogram.cu (%s)"
            % {"rows": "segment_histogram_rows",
               "resident": "segment_histogram_resident"}.get(
                   layout, "segment_histogram"))
    part = ("csrc/partition_rows.cu (partition_segment_rows)"
            if layout == "rows" else
            "csrc/partition_segment.cu (partition_segment)")
    if layout == "resident":
        part = "csrc/resident_route.cu, then " + part
    return part, hist


def _refuse(what: str, item: str) -> None:
    raise LightGBMError("%s is not ported to the PyTorch/CUDA package yet "
                        "(ROADMAP %s)" % (what, item))


class SerialTreeLearner:
    """Host orchestration around :func:`build_tree_partitioned`, or
    :func:`build_tree` (the dense builder) past 256 bins and for
    ``tree_builder=dense`` (:meth:`use_partition`; reference analog:
    SerialTreeLearner + the factory at tree_learner.cpp:15).

    Settings the port cannot honour raise :class:`LightGBMError` naming
    their ROADMAP item. The exceptions are the reference's own:
    ``tpu_split_kernel=on`` where the one-kernel split is ineligible warns
    and trains the three-launch path, ``tpu_goss_compact=on`` where GOSS
    compaction cannot run warns and trains the dense-mask path, and
    ``cegb_penalty_feature_lazy`` warns and is ignored, as the JAX package
    does."""

    def __init__(self, config, dataset, device: Optional[torch.device] = None,
                 bins: Optional[torch.Tensor] = None,
                 bins_t: Optional[torch.Tensor] = None) -> None:
        from .device import resolve_device
        from .ops.binning import BIN_CATEGORICAL, MISSING_NAN, MISSING_ZERO
        from .ops.node import node_options
        from .ops.split import FeatureMeta, SplitHyper
        from .utils.log import Log

        self.config = config
        self.dataset = dataset
        self.device = device if device is not None \
            else resolve_device(config.device_type)
        dev = self.device
        self.num_leaves = max(2, int(config.num_leaves))
        nb = dataset.feature_num_bins()
        self.num_bin = int(max(2, nb.max() if len(nb) else 2))
        self.bins = bins if bins is not None \
            else device_bins(dataset.binned, dev)
        self.num_bin_hist = int(max(2, dataset.group_num_bins().max()
                                    if dataset.num_groups else 2))
        self.bins_t = bins_t if bins_t is not None else route_layout(self.bins)
        mono = np.zeros(dataset.num_features, dtype=np.int8)
        if dataset.monotone_constraints is not None:
            mono = dataset.monotone_constraints.astype(np.int8)
        pen = np.ones(dataset.num_features, dtype=np.float32)
        if dataset.feature_penalty is not None:
            pen = dataset.feature_penalty.astype(np.float32)
        cegb_coupled = np.zeros(dataset.num_features, dtype=np.float32)
        if config.cegb_penalty_feature_coupled:
            for i, f in enumerate(dataset.used_feature_indices):
                if f < len(config.cegb_penalty_feature_coupled):
                    cegb_coupled[i] = config.cegb_penalty_feature_coupled[f]
        if config.cegb_penalty_feature_lazy:
            Log.warning("cegb_penalty_feature_lazy is not supported; "
                        "use cegb_penalty_feature_coupled")
        mappers = dataset.bin_mappers

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(dtype).to(dev)

        self.meta = FeatureMeta(
            num_bins=t(nb, torch.int32),
            movable_missing=t([m.missing_type in (MISSING_NAN, MISSING_ZERO)
                               and m.bin_type != BIN_CATEGORICAL
                               for m in mappers], torch.bool),
            missing_bin=t([m.missing_bin for m in mappers], torch.int32),
            is_categorical=t([m.bin_type == BIN_CATEGORICAL for m in mappers],
                             torch.bool),
            monotone=t(mono, torch.int8),
            penalty=t(pen, torch.float32),
            cegb_coupled=t(cegb_coupled, torch.float32))
        self.hp = SplitHyper(
            lambda_l1=float(config.lambda_l1),
            lambda_l2=float(config.lambda_l2),
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
            min_gain_to_split=float(config.min_gain_to_split),
            max_delta_step=float(config.max_delta_step),
            cat_smooth=float(config.cat_smooth),
            cat_l2=float(config.cat_l2),
            max_cat_threshold=int(config.max_cat_threshold),
            max_cat_to_onehot=int(config.max_cat_to_onehot),
            min_data_per_group=float(config.min_data_per_group),
            path_smooth=float(config.path_smooth),
            has_categorical=any(m.bin_type == BIN_CATEGORICAL
                                for m in mappers),
            has_monotone=dataset.monotone_constraints is not None,
            mono_intermediate=config.monotone_constraints_method
            in ("intermediate", "advanced"),
            mono_advanced=(config.monotone_constraints_method == "advanced"
                           and dataset.monotone_constraints is not None),
            monotone_penalty=float(config.monotone_penalty),
            cegb_tradeoff=float(config.cegb_tradeoff),
            cegb_penalty_split=float(config.cegb_penalty_split),
            # gated on a non-zero penalty, as the JAX package gates it:
            # the tradeoff alone multiplies nothing
            use_cegb=bool(config.cegb_penalty_split > 0
                          or config.cegb_penalty_feature_coupled))
        self.opts = node_options(config, dataset.num_features,
                                 self._constraint_sets(), self.hp.use_cegb)
        self.forced = self._forced_splits()
        self.bundle = None
        if dataset.has_bundles:
            self.bundle = {k: torch.as_tensor(v).to(dev)
                           for k, v in dataset.bundle_maps().items()}
            self.bundle["dpos_oh"] = (
                torch.arange(self.num_bin, device=dev)[None, :]
                == self.bundle["dpos"].long()[:, None])
        self.dense = not self.use_partition()
        if self.dense:
            self._dense_gates()
        self.comm = self._make_comm()
        #: whether :meth:`train` grows its trees through the device tree
        #: loop: the dense builder on the card, so that its per-iteration
        #: trees (valid sets, DART, RF) run the split scan kernel and the
        #: dense histogram's kernels; elsewhere, and under a distributed
        #: learner's comm (collectives per split), the per-split host loop
        self.train_on_loop = self.dense and dev.type == "cuda" \
            and self.comm.axis is None
        self._kw = self.build_kwargs()
        self._work = None
        self._loop: Optional[DeviceTreeLoop] = None
        #: the last tree's per-leaf segment and histogram counts
        self.last_stats: dict = {}

    def _make_comm(self) -> Comm:
        """The builders' collective seam: the identity for one device
        (the distributed learners give their process group's)."""
        return Comm()

    def _dense_gates(self) -> None:
        """What the dense builder cannot honour, as the JAX package gates
        it: the advanced monotone method falls back to the basic one with
        a warning (the dense builder keeps only midpoint bounds, as it does
        for the intermediate method); CEGB penalties and quantized
        histograms are fatal."""
        from .utils.log import Log

        cfg = self.config
        if self.hp.mono_advanced:
            Log.warning("monotone_constraints_method=advanced needs the "
                        "partitioned builder (max_bin <= 256); the dense "
                        "builder applies the basic (midpoint) method")
        self.hp = self.hp._replace(mono_intermediate=False,
                                   mono_advanced=False)
        if self.hp.use_cegb:
            Log.fatal("CEGB penalties require the partitioned builder "
                      "(max_bin <= 256, tree_builder != dense)")
        if cfg.use_quantized_grad or cfg.tpu_hist_precision == "int8":
            Log.fatal("use_quantized_grad requires the partitioned builder "
                      "(max_bin <= 256, tree_builder != dense)")

    def _constraint_sets(self) -> Optional[torch.Tensor]:
        """``interaction_constraints`` ``"[0,1],[2,3]"`` -> (S, F) bool
        over inner features, on the learner's device; None when unset
        (the JAX package's parser; col_sampler.hpp:27). Features the
        dataset dropped are skipped."""
        import re

        spec = self.config.interaction_constraints
        if not spec:
            return None
        groups = re.findall(r"\[([^\]]*)\]", str(spec))
        if not groups:
            return None
        F = self.dataset.num_features
        sets = np.zeros((len(groups), F), dtype=bool)
        for s, grp in enumerate(groups):
            for tok in grp.split(","):
                tok = tok.strip()
                if tok == "":
                    continue
                inner = self.dataset.inner_feature_index(int(tok))
                if inner >= 0:
                    sets[s, inner] = True
        return torch.as_tensor(sets).to(self.device)

    def _forced_splits(self):
        """``forcedsplits_filename``'s JSON tree -> BFS ``(leaves,
        features, bins)`` lists of host ints, or None (the JAX package's
        loader; serial_tree_learner.cpp:450 ForceSplits): each node's
        threshold through its feature's ``value_to_bin``, at most bin
        ``num_bins - 2``; a node on a feature the dataset dropped is
        skipped, at most ``num_leaves - 1`` splits. A missing file warns
        and forces nothing."""
        import json
        import os

        from .utils.log import Log

        fname = self.config.forcedsplits_filename
        if not fname:
            return None
        if not os.path.exists(fname):
            Log.warning("forced splits file %s not found", fname)
            return None
        with open(fname) as f:
            root = json.load(f)
        leaves, feats, bins_ = [], [], []
        queue = [(root, 0)]
        n_created = 0
        while queue and n_created < self.num_leaves - 1:
            node, leaf = queue.pop(0)
            if not node or "feature" not in node:
                continue
            inner = self.dataset.inner_feature_index(int(node["feature"]))
            if inner < 0:
                continue
            mapper = self.dataset.bin_mappers[inner]
            tbin = int(mapper.value_to_bin(
                np.asarray([float(node["threshold"])]))[0])
            tbin = min(tbin, mapper.num_bins - 2) \
                if mapper.num_bins > 1 else 0
            leaves.append(leaf)
            feats.append(inner)
            bins_.append(tbin)
            n_created += 1
            if "left" in node and node["left"]:
                queue.append((node["left"], leaf))
            if "right" in node and node["right"]:
                queue.append((node["right"], n_created))
        if not leaves:
            return None
        return leaves, feats, bins_

    def use_partition(self) -> bool:
        """The partitioned (leaf-contiguous) builder unless
        ``tree_builder=dense`` asks for the dense one or the bins exceed
        the u8 layout (max_bin > 256: u16 bins); the JAX package's rule
        and fatals (EFB bundles need the partitioned builder)."""
        from .utils.log import Log

        mode = self.config.tree_builder
        if mode == "dense":
            if self.bundle is not None:
                Log.fatal("tree_builder=dense does not support EFB bundles; "
                          "set enable_bundle=false or use the partitioned "
                          "builder")
            return False
        ok = self.num_bin <= 256 and self.num_bin_hist <= 256 \
            and self.bins.dtype == torch.uint8
        if mode == "partition" and not ok:
            Log.fatal("tree_builder=partition requires max_bin <= 256 (uint8 "
                      "bins); got %d bins. Use tree_builder=dense or lower "
                      "max_bin.", self.num_bin)
        if not ok and self.bundle is not None:
            Log.fatal("EFB bundles require the partitioned builder "
                      "(max_bin <= 256)")
        return ok

    def build_kwargs(self) -> dict:
        """Resolve the ``tpu_*`` knobs for the card; each ``auto``
        resolution is recorded with its reason. The work layout: int8
        quantized gradients (``use_quantized_grad`` or
        ``tpu_hist_precision=int8``) and ``tpu_hist_mxu=on`` train on the
        rows layout, everything else on planes; an explicit layout is
        honoured. ``tpu_resident_state=on`` turns planes into the
        ``resident`` layout and raises with the rows layout or int8
        histograms, with the JAX package's words; ``auto`` stays off
        (:meth:`_resolve_resident`). The kernels: the hand-written ones
        (knob value ``pallas``) on a CUDA device, their plain twins
        (``xla``) on the host. Settings the port cannot honour raise. The
        dense builder (:func:`build_tree`) takes none of these knobs: its
        ``work_layout`` is ``dense``."""
        from .obs import telemetry
        from .ops.partition import dither_offset

        cfg = self.config
        cuda = self.device.type == "cuda"
        if self.dense:
            # the dense builder (build_tree): no work layout, no knobs of
            # the partitioned kernels; its histogram chunk is the JAX
            # builder's
            return dict(hp=self.hp, num_leaves=self.num_leaves,
                        num_bin=self.num_bin, max_depth=int(cfg.max_depth),
                        num_bin_hist=self.num_bin_hist, bundle=None,
                        hist_mode="hilo", comm=self.comm,
                        work_layout="dense", split_kernel="off",
                        dither_offset=0, opts=self.opts, forced=self.forced,
                        inbag_first=False, goss_compact=False,
                        hist_chunk=min(int(cfg.tpu_rows_per_chunk), 8192))

        def rec(knob, value, reason):
            telemetry.record("auto_resolution",
                             dedupe_key=(knob, value, reason), knob=knob,
                             configured="auto", value=value, reason=reason)

        mode = "int8" if cfg.use_quantized_grad else cfg.tpu_hist_precision
        quantized = mode == "int8"
        mxu = cfg.tpu_hist_mxu
        layout = cfg.tpu_work_layout
        if cfg.tpu_resident_state == "on":
            if cfg.tpu_work_layout == "rows":
                raise LightGBMError(
                    "tpu_resident_state=on requires the planes work layout "
                    "(got tpu_work_layout=rows)")
            if quantized:
                raise LightGBMError(
                    "tpu_resident_state=on does not support int8 quantized "
                    "training (plane-family layouts are hilo/bf16 only)")
            if mxu == "on":
                raise LightGBMError(
                    "tpu_hist_mxu=on needs the rows work layout, not "
                    "tpu_resident_state=on (ROADMAP B)")
        if layout == "planes" and quantized:
            raise LightGBMError(
                "tpu_work_layout=planes cannot train int8 quantized "
                "histograms: the planes layout has no quantized pack, in "
                "the JAX package as here (use rows or auto; ROADMAP B)")
        if layout == "planes" and mxu == "on":
            raise LightGBMError(
                "tpu_hist_mxu=on needs the rows work layout, not "
                "tpu_work_layout=planes (ROADMAP B)")
        if layout == "auto":
            if quantized:
                layout = "rows"
                why = "int8 mode has no quantized planes pack"
            elif mxu == "on":
                layout = "rows"
                why = "tpu_hist_mxu=on histograms the rows layout"
            else:
                layout = "planes"
                why = ("f32 histograms: the planes layout, rows on request "
                       "(tpu_work_layout=rows or tpu_hist_mxu=on)")
            rec("tpu_work_layout", layout, why)
        layout = self._resolve_resident(layout, cuda, rec)
        if mxu == "auto":
            rec("tpu_hist_mxu", "off", "the layout decides the histogram "
                "kernel; on only asks for the rows layout")
        part_src, hist_src = kernel_sources(layout, quantized)
        kernels = {}
        for knob, src in (("tpu_partition_kernel", part_src),
                          ("tpu_hist_kernel", hist_src)):
            v = getattr(cfg, knob)
            if v == "xla" and cuda:
                _refuse("%s=xla on a CUDA device (the plain twins run only "
                        "on host tensors)" % knob, "B")
            if v == "auto":
                v = "pallas" if cuda else "xla"
                rec(knob, v, "hand-written CUDA kernel %s" % src if cuda
                    else "host tensors: the kernel's plain torch twin")
            kernels[knob] = v
        inbag_first, compact = self._resolve_goss_compact(mode, cuda, rec)
        split_kernel = self._resolve_split_kernel(layout, mode, cuda, rec)
        return dict(hp=self.hp, num_leaves=self.num_leaves,
                    num_bin=self.num_bin, max_depth=int(cfg.max_depth),
                    num_bin_hist=self.num_bin_hist, bundle=self.bundle,
                    hist_mode=mode, comm=self.comm,
                    part_kernel=kernels["tpu_partition_kernel"],
                    hist_kernel=kernels["tpu_hist_kernel"],
                    work_layout=layout, split_kernel=split_kernel,
                    dither_offset=dither_offset(
                        int(self.bins.shape[1]), int(cfg.tpu_part_chunk),
                        int(cfg.tpu_hist_chunk)),
                    opts=self.opts, forced=self.forced,
                    inbag_first=inbag_first, goss_compact=compact)

    def _resolve_goss_compact(self, mode: str, cuda: bool, rec):
        """``tpu_goss_compact`` -> ``(inbag_first, compact)``. Where GOSS
        samples and the histograms are f32, every tree grows over the rows
        in the in-bag-first order (:func:`build_tree_partitioned`), so that
        the card's histograms, which sum a segment's rows in an order fixed
        by their positions, give a compacted tree the dense one's bits.
        ``on`` compacts there; elsewhere it warns and keeps the dense-mask
        path, the JAX package's downgrade. ``auto`` is off, recorded with
        its reason: the compacted trees equal the dense ones bit for bit,
        but the gain is unmeasured."""
        from .utils.log import Log

        cfg = self.config
        goss = cfg.data_sample_strategy == "goss" \
            and float(cfg.top_rate) + float(cfg.other_rate) < 1.0
        # int8: the stochastic-rounding draws are seeded by row position
        inbag_first = goss and mode != "int8"
        gc = cfg.tpu_goss_compact
        if gc == "auto":
            if not goss:
                why = ("no GOSS sampling in this config "
                       "(data_sample_strategy=%s)" % cfg.data_sample_strategy)
            else:
                why = ("the compacted trees equal the dense path's bit for "
                       "bit, but the gain is unmeasured %s"
                       % ("on the card (no benchmark yet, ROADMAP A1)"
                          if cuda else "on host tensors"))
            rec("tpu_goss_compact", "off", why)
            return inbag_first, False
        if gc != "on":
            return inbag_first, False
        bad = []
        if not goss:
            bad.append("no GOSS sampling in this config")
        if mode == "int8":
            bad.append("int8 stochastic-rounding draws are row-position "
                       "seeded (compaction would change the quantization "
                       "stream)")
        if self.comm.axis is not None:
            bad.append("multi-device comm unsupported (per-shard "
                       "compact/dense cond would diverge)")
        if bad:
            Log.warning("tpu_goss_compact=on is not eligible here (%s); "
                        "using the dense-mask path", "; ".join(bad))
            return inbag_first, False
        return True, True

    def _resolve_resident(self, layout: str, cuda: bool, rec) -> str:
        """``tpu_resident_state``: ``on`` (checked by the caller) turns the
        planes layout into ``resident``. ``auto`` stays off everywhere (the
        JAX package takes it only on a TPU): the resident trees equal
        planes' bit for bit, so only speed could decide. On the card fused
        resident training was 5.1% and 8.8% faster a tree than planes in
        two calls' profiled blocks (PERF.md, PR 10), too few to change a
        default until a benchmark holds it over more runs (ROADMAP A1).
        Recorded with its reason."""
        rs = self.config.tpu_resident_state
        if rs == "on":
            return "resident"
        if rs == "auto":
            if layout != "planes":
                why = "layout %s: the resident state is a planes layout" \
                    % layout
            elif cuda:
                why = ("measured on the card: byte-equal trees, fused 5.1% "
                       "and 8.8% faster a tree than planes in two calls; "
                       "off until a benchmark holds it over more runs "
                       "(ROADMAP A1; PERF.md)")
            else:
                why = ("host tensors: the gather has no payoff without "
                       "device memory bandwidth pressure")
            rec("tpu_resident_state", "off", why)
        return layout

    def _resolve_split_kernel(self, layout: str, mode: str, cuda: bool,
                              rec) -> str:
        """``tpu_split_kernel``. ``auto`` is on where the one-kernel split
        can run on the card (:func:`split_kernel_ineligible` is empty):
        one launch per split there trains the same trees up to near ties,
        several times faster than three launches and the torch scan
        (PERF.md). The JAX package resolves ``auto`` to off only until its
        kernel is measured on hardware. On the host ``auto`` is off: the
        twin is the three-launch chain itself. ``on`` is on wherever it is
        eligible, on the card (``csrc/one_kernel_split.cu``) and on the
        host (the twin); ``on`` where ineligible warns and trains the
        three-launch path, the reference's own downgrade. Each ``auto``
        resolution is recorded with its reason."""
        from .utils.log import Log

        cfg = self.config
        sk = cfg.tpu_split_kernel
        if sk == "off":
            return "off"
        bad = split_kernel_ineligible(
            work_layout=layout, hist_mode=mode, bundle=self.bundle,
            num_bin_hist=self.num_bin_hist, num_bin=self.num_bin,
            comm=self.comm, hp=self.hp, hist_chunk=int(cfg.tpu_hist_chunk),
            opts=self.opts)
        if sk == "auto":
            if not cuda:
                why = ("host tensors: the plain twin of "
                       "csrc/one_kernel_split.cu is the three-launch chain")
            elif bad:
                why = "structurally ineligible: " + "; ".join(bad)
            else:
                rec("tpu_split_kernel", "on", "eligible on the card: "
                    "csrc/one_kernel_split.cu runs each split as one launch")
                return "on"
            rec("tpu_split_kernel", "off", why)
            return "off"
        if bad:
            Log.warning("tpu_split_kernel=on is not eligible here (%s); "
                        "using the three-launch path", "; ".join(bad))
            return "off"
        return "on"

    def resident_spec(self):
        """(guard, npad) of the resident bin planes, or None when the
        resolved layout is not resident. The port's resident planes are
        the router's block form of the binned matrix (``self.bins_t``):
        row i at lane i (no guard), lanes in whole 128-lane tiles."""
        if self.build_kwargs()["work_layout"] != "resident":
            return None
        return 0, int(self.bins_t.shape[1] * self.bins_t.shape[2])

    def traffic_spec(self) -> dict:
        """Bytes-moved accounting of the per-split hot loop for the
        resolved config (the JAX package's ``traffic_spec``): per parent
        row per split the partition reads and writes the work row (W bytes
        each way) and the smaller-child histogram reads it once. The
        resident layout moves the slim row (W = RST_WIDTH), plus the route
        gather's 4 ridx bytes read, 1 gathered byte and 1 route byte
        written per parent row; its histogram reads the slim row and the F
        gathered bins. ``launches_per_split`` is the port's true count on
        the device tree loop, which grows the fused path's trees on the
        card: 2 on the one-kernel split (it and the split commit), else 4
        (partition, histogram, split scan, commit) and 5 on the resident
        layout, whose route gather is a launch of its own;
        ``launches_per_split_host_loop`` the per-split host loop's (1; 3 or
        4 with the torch scan); the per-node options add the node inputs
        kernel to both, and the advanced monotone method its bound kernels
        (``mono_commit`` and ``mono_bounds``: 2 a split on the device loop,
        3 on the host loop). ``effective_rows`` is N, or under GOSS compaction
        M (``ops/partition.goss_compact_rows``, the JAX package's figure):
        a 4-sigma bound on the in-bag rows that a compacted tree scans
        after the warmup trees, expected, not measured (the warmup trees
        scan all N)."""
        from .ops.partition import (GH_BYTES, RST_GH_OFF, goss_compact_rows,
                                    work_spec)

        kw = self.build_kwargs()
        layout = kw["work_layout"]
        f = int(self.bins.shape[1])
        if layout == "dense":
            # the row update reads and writes a row's leaf id (and reads
            # the split column's bin of a row on the parent); the
            # histogram reads every row's leaf id, and a selected row's
            # bins and channels
            w = f * self.bins.element_size() + GH_BYTES
            part, hist = 8, 4 + w
        else:
            _, w = work_spec(f, kw["hist_mode"] == "int8", layout)
            part, hist = 2 * w, w
        if layout == "resident":
            part += RST_GH_OFF + 1
            hist += f
        one_kernel = kw["split_kernel"] == "on"
        n = int(self.bins.shape[0])
        cfg = self.config
        m = goss_compact_rows(n, float(cfg.top_rate), float(cfg.other_rate)) \
            if kw["goss_compact"] else n
        return {"work_layout": layout, "work_width": int(w),
                "partition_bytes_per_row": int(part),
                "hist_bytes_per_row": int(hist),
                "split_kernel": kw["split_kernel"],
                "hist_mxu": "on" if self.config.tpu_hist_mxu == "on"
                else "off",
                # rows a pass of a tree is expected to scan at most
                "effective_rows": int(m),
                "goss_compact": "on" if kw["goss_compact"] else "off",
                "launches_per_split": launches_per_split(
                    layout, one_kernel, node_inputs=self.opts.active,
                    advanced=self.hp.mono_advanced),
                "launches_per_split_host_loop": launches_per_split(
                    layout, one_kernel, device_loop=False,
                    node_inputs=self.opts.active,
                    advanced=self.hp.mono_advanced)}

    def _work_buffer(self, kw: dict) -> torch.Tensor:
        """The carried work buffer of the resolved layout."""
        from .ops.partition import work_buffer

        if self._work is None:
            self._work = work_buffer(self.bins.shape[0], self.bins.shape[1],
                                     kw["work_layout"],
                                     kw["hist_mode"] == "int8", self.device)
        return self._work

    def _used(self, cegb_used: Optional[torch.Tensor]) -> torch.Tensor:
        if cegb_used is None:
            return torch.zeros(self.dataset.num_features, dtype=torch.bool,
                               device=self.device)
        return cegb_used

    def train(self, ghc: torch.Tensor,
              feature_mask: Optional[torch.Tensor] = None,
              key=None, cegb_used: Optional[torch.Tensor] = None) -> TreeLog:
        """One tree from (grad, hess, inbag) channels; the log stays on
        the device. ``key`` (a ``prng`` key, ``PRNGKey(0)`` when None)
        seeds the int8 quantization dither and the per-node draws;
        ``cegb_used`` is the (F,) bool set of features the model has used
        (CEGB; none when None). Through :meth:`train_device` where
        ``train_on_loop`` (the dense builder on the card), else through
        :meth:`train_host_loop`; both give the same log."""
        if self.train_on_loop:
            return self.train_device(ghc, feature_mask, key, cegb_used)
        return self.train_host_loop(ghc, feature_mask, key, cegb_used)

    def train_host_loop(self, ghc: torch.Tensor,
                        feature_mask: Optional[torch.Tensor] = None,
                        key=None,
                        cegb_used: Optional[torch.Tensor] = None) -> TreeLog:
        """One tree through the per-split host loop
        (:func:`build_tree_partitioned`, or :func:`build_tree` for the
        dense builder), on any device; arguments as in :meth:`train`."""
        from .prng import PRNGKey

        if feature_mask is None:
            feature_mask = torch.ones(self.dataset.num_features,
                                      dtype=torch.bool, device=self.device)
        stats: dict = {}
        if self.dense:
            kw = self._kw
            log = build_tree(self.bins, ghc, self.meta, feature_mask,
                             self.hp, num_leaves=self.num_leaves,
                             num_bin=self.num_bin, max_depth=kw["max_depth"],
                             key=key if key is not None else PRNGKey(0),
                             comm=self.comm, opts=self.opts,
                             forced=self.forced,
                             hist_chunk=kw["hist_chunk"], stats=stats)
            self.last_stats = stats
            return log
        kw = {k: v for k, v in self._kw.items()
              if k not in ("part_kernel", "hist_kernel")}
        log = build_tree_partitioned(self.bins, ghc, self.meta, feature_mask,
                                     key=key if key is not None
                                     else PRNGKey(0),
                                     bins_t=self.bins_t,
                                     work=self._work_buffer(kw),
                                     cegb_used=self._used(cegb_used),
                                     stats=stats, **kw)
        self.last_stats = stats
        return log

    def device_loop_eligible(self) -> bool:
        """Whether :meth:`train_device` can grow this learner's trees: in
        every configuration the learner accepts: the dense builder, or the
        partitioned one with the one-kernel split or the three-launch
        chain, any layout and histogram mode, EFB bundles, categorical
        features, the per-node options, forced splits and GOSS
        compaction."""
        return True

    def train_device(self, ghc: torch.Tensor,
                     feature_mask: Optional[torch.Tensor] = None,
                     key=None,
                     cegb_used: Optional[torch.Tensor] = None) -> TreeLog:
        """One tree through the :class:`DeviceTreeLoop` (built once per
        learner, a CUDA graph on the card): no read back to the host from
        the root to the log, which lives on the device (a copy: the next
        tree reuses the loop's buffers). ``key`` (``PRNGKey(0)`` when None)
        seeds the int8 dither and the per-node draws and ``cegb_used`` is
        the model's used features, as in :meth:`train`. Its log equals
        :meth:`train`'s."""
        from .prng import PRNGKey

        if feature_mask is None:
            feature_mask = torch.ones(self.dataset.num_features,
                                      dtype=torch.bool, device=self.device)
        kw = self._kw
        if self._loop is None:
            self._loop = DeviceTreeLoop(
                self.bins, self.meta, self.hp, num_leaves=self.num_leaves,
                num_bin=self.num_bin, max_depth=kw["max_depth"],
                num_bin_hist=self.num_bin_hist, hist_mode=kw["hist_mode"],
                work_layout=kw["work_layout"],
                split_kernel=kw["split_kernel"], bundle=self.bundle,
                dither_offset=kw["dither_offset"], bins_t=self.bins_t,
                work=None if self.dense else self._work_buffer(kw),
                opts=self.opts,
                forced=self.forced, inbag_first=kw["inbag_first"],
                goss_compact=kw["goss_compact"])
        log = self._loop.run(ghc, feature_mask,
                             key if key is not None else PRNGKey(0),
                             self._used(cegb_used))
        log = TreeLog(*(t.clone() for t in log))
        self.last_stats = dict(self._loop.stats(), row_leaf=log.row_leaf)
        return log

    def log_to_tree(self, log: TreeLog):
        """Pull the split log to the host and rebuild the Tree model
        (O(leaves) data; ``row_leaf`` stays on the device)."""
        from .tree import Tree

        h = {k: getattr(log, k).cpu().numpy() for k in (
            "num_splits", "split_leaf", "feature", "bin", "default_left",
            "gain", "left_sum", "right_sum", "leaf_value", "kind",
            "go_left")}
        return Tree.from_split_log(
            int(h["num_splits"].reshape(-1)[0]), h["split_leaf"],
            h["feature"], h["bin"], h["default_left"], h["gain"],
            h["left_sum"], h["right_sum"], h["leaf_value"],
            bin_mappers=self.dataset.bin_mappers,
            real_feature_index=self.dataset.used_feature_indices,
            go_left_table=h["go_left"], is_categorical=h["kind"] > 0)
