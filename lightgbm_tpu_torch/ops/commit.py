"""The split commit: the bookkeeping between two one-kernel splits of the
device tree loop (``learner.DeviceTreeLoop``).

The JAX builder keeps a tree's state in the carry of one
``lax.while_loop`` (``lightgbm_tpu/learner.py``, the split loop of
``build_tree_partitioned``); the per-split host loop of this package keeps
it in device tensors and updates it with torch ops between reads of one
header. The device tree loop keeps the same state in a :class:`TreeState`
and updates it with one launch per split, :func:`split_commit`: on a CUDA
tensor the hand-written kernel ``csrc/split_commit.cu``, on a CPU tensor
its plain twin :func:`split_commit_plain` (the host loop's torch code,
written over device indices, with no read back to the host). Commit ``s``
applies split ``s - 1``'s one-kernel outputs (``ops/partition.SplitOut``),
picks split ``s`` (the first argmax of the best gains; live while the
previous split ran and the gain is positive; or, while a tree's forced
splits hold, forced split ``s`` from the forced-split scan of its leaf),
records its log entry, the features used on the children's path and by
the tree, the monotone state (``mono_method``: the basic method's midpoint
bounds; the intermediate and advanced methods' re-clamp of the picked
split to its leaf's current bounds and the sibling-order swap, then the
intermediate method's scalar bounds and neighbour refresh, or the
advanced method's box cut, whose per-bin bounds ``ops/monotone.
mono_commit`` writes after the commit), and writes header and pair row
``s`` that the split reads (the one-kernel
split, or the three-launch chain of ``ops/chain.ChainSplit``). The header's
``col`` word is the split feature's column of the work rows through an
(F,) column map: the feature itself, or its bundle with EFB (the pool and
the split outputs' histograms are then in bundle space, (HF, HB), and the
best-split tables and the log in feature space). The kernel and its twin
leave the state bit-equal.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import torch

from .kernels import CudaKernel, register, stream_of
from .partition import HDR_WORDS, PAIR_WORDS, check_on_card

_P = ctypes.c_void_p
#: the midpoint and bounds follow torch's arithmetic op by op
COMMIT_KERNEL = register(CudaKernel(
    "split_commit", "split_commit.cu", [_P, ctypes.c_int, _P],
    flags=("-fmad=false",)))
#: blocks of a commit launch: block 0 does the scalar work, all of them
#: copy the two child histograms into the pool
COMMIT_BLOCKS = 32


class TreeState(NamedTuple):
    """A tree's state on the device, for ``num_leaves`` = L leaves, F
    features and B bins (HF columns of HB bins in the work rows): the
    per-leaf tables, the best split of each leaf, the split log and the
    split's header and pair rows."""
    seg_tab: torch.Tensor      # (L, 3) i32 start, cnt, parity
    hist_pool: torch.Tensor    # (L, HF, HB, 3) f32
    best_gain: torch.Tensor    # (L,) f32
    best_feature: torch.Tensor  # (L,) i64
    best_bin: torch.Tensor     # (L,) i64
    best_kind: torch.Tensor    # (L,) i64
    best_dl: torch.Tensor      # (L,) bool
    best_go: torch.Tensor      # (L, B) bool
    best_ls: torch.Tensor      # (L, 3) f32
    best_rs: torch.Tensor      # (L, 3) f32
    best_lo: torch.Tensor      # (L,) f32
    best_ro: torch.Tensor      # (L,) f32
    leaf_sum: torch.Tensor     # (L, 3) f32
    leaf_out: torch.Tensor     # (L,) f32
    leaf_lower: torch.Tensor   # (L,) f32
    leaf_upper: torch.Tensor   # (L,) f32
    depth: torch.Tensor        # (L,) i32
    log_leaf: torch.Tensor     # (L-1,) i32
    log_feat: torch.Tensor     # (L-1,) i32
    log_bin: torch.Tensor      # (L-1,) i32
    log_kind: torch.Tensor     # (L-1,) i32
    log_dl: torch.Tensor       # (L-1,) bool
    log_gain: torch.Tensor     # (L-1,) f32
    log_ls: torch.Tensor       # (L-1, 3) f32
    log_rs: torch.Tensor       # (L-1, 3) f32
    log_go: torch.Tensor       # (L-1, B) bool
    num_splits: torch.Tensor   # (1,) i32
    hdr: torch.Tensor          # (L, HDR_WORDS) i32
    pair: torch.Tensor         # (L, PAIR_WORDS) f32
    leaf_used: torch.Tensor    # (L, F) bool features used on each path
    tree_used: torch.Tensor    # (F,) bool features the model has used
    force_live: torch.Tensor   # (1,) i32 the forced splits still hold
    rng_lo: torch.Tensor       # (L, F) i32 each leaf's bin box [lo, hi)
    rng_hi: torch.Tensor       # (L, F) i32
    cons_lo: torch.Tensor      # (L, F, B) f32 advanced bounds, else (0,)
    cons_hi: torch.Tensor      # (L, F, B) f32

    @property
    def best(self):
        """The best-split table as an ``ops.split.SplitInfo`` of views."""
        from .split import SplitInfo
        return SplitInfo(self.best_gain, self.best_feature, self.best_bin,
                         self.best_kind, self.best_dl, self.best_go,
                         self.best_ls, self.best_rs, self.best_lo,
                         self.best_ro)


def tree_state(num_leaves: int, num_feat: int, num_bins: int,
               device, hist=None, mono_method: int = 0) -> TreeState:
    """A :class:`TreeState`, allocated once and reset per tree
    (:func:`reset_tree_state`). ``hist`` (HF, HB) is the histograms'
    shape when it differs from (F, B) (EFB bundles); ``mono_method`` 2
    (advanced monotone) allocates the per-bin bounds."""
    L, F, B = num_leaves, num_feat, num_bins
    HF, HB = hist if hist is not None else (F, B)
    f32, i32, i64, b = torch.float32, torch.int32, torch.int64, torch.bool

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TreeState(
        seg_tab=z(L, 3, dtype=i32), hist_pool=z(L, HF, HB, 3),
        best_gain=z(L), best_feature=z(L, dtype=i64), best_bin=z(L, dtype=i64),
        best_kind=z(L, dtype=i64), best_dl=z(L, dtype=b),
        best_go=z(L, B, dtype=b), best_ls=z(L, 3), best_rs=z(L, 3),
        best_lo=z(L), best_ro=z(L), leaf_sum=z(L, 3), leaf_out=z(L),
        leaf_lower=z(L), leaf_upper=z(L), depth=z(L, dtype=i32),
        log_leaf=z(L - 1, dtype=i32), log_feat=z(L - 1, dtype=i32),
        log_bin=z(L - 1, dtype=i32), log_kind=z(L - 1, dtype=i32),
        log_dl=z(L - 1, dtype=b), log_gain=z(L - 1), log_ls=z(L - 1, 3),
        log_rs=z(L - 1, 3), log_go=z(L - 1, B, dtype=b),
        num_splits=z(1, dtype=i32), hdr=z(L, HDR_WORDS, dtype=i32),
        pair=z(L, PAIR_WORDS), leaf_used=z(L, F, dtype=b),
        tree_used=z(F, dtype=b), force_live=z(1, dtype=i32),
        rng_lo=z(L, F, dtype=i32), rng_hi=z(L, F, dtype=i32),
        cons_lo=z(L, F, B) if mono_method == 2 else z(0),
        cons_hi=z(L, F, B) if mono_method == 2 else z(0))


def reset_tree_state(st: TreeState, guard: int, n: int, *,
                     forced: bool = False, tree_used=None,
                     num_bins=None) -> None:
    """The state of a tree before its root: every table at the host
    loop's initial values, the root's segment ``(guard, n, 0)``, the
    forcing word 1 when the tree has ``forced`` splits, the model's
    used features from the device tensor ``tree_used`` (none when None)
    and, with the (F,) ``num_bins``, every leaf's box the whole range and
    its per-bin bounds unbounded (``ops/monotone.adv_init``). Fills and
    device copies only (no host->device copy), so a CUDA graph holds
    it."""
    for t in st:
        t.zero_()
    st.best_gain.fill_(float("-inf"))
    st.leaf_lower.fill_(float("-inf"))
    st.leaf_upper.fill_(float("inf"))
    st.seg_tab[0, 0:1].fill_(guard)
    st.seg_tab[0, 1:2].fill_(n)
    if forced:
        st.force_live.fill_(1)
    if tree_used is not None:
        st.tree_used.copy_(tree_used)
    if num_bins is not None:
        st.rng_hi.copy_(num_bins.to(torch.int32)[None, :].expand_as(
            st.rng_hi))
        st.cons_lo.fill_(float("-inf"))
        st.cons_hi.fill_(float("inf"))


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, idx)


def _put(t: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
         live: torch.Tensor) -> None:
    """t[idx] = val where ``live`` (a 0-d bool), else unchanged; ``idx``
    a (1,) i64 device index."""
    cur = t.index_select(0, idx)
    t.index_copy_(0, idx, torch.where(live, val.to(t.dtype).reshape(
        cur.shape), cur))


def forced_info(fo: "SplitOut"):
    """Child 0 of a forced-split scan's outputs as an unbatched
    ``ops.split.SplitInfo`` of views (the fields the commit reads)."""
    from .split import SplitInfo
    B = (fo.bout.shape[0] - 2) // 2
    return SplitInfo(
        gain=fo.fout[0:1], feature=fo.iout[0:1], bin=fo.iout[2:3],
        kind=fo.iout[4:5], default_left=fo.bout[0:1],
        go_left=fo.bout[2:2 + B][None], left_sum=fo.fout[2:5][None],
        right_sum=fo.fout[8:11][None], left_output=fo.fout[14:15],
        right_output=fo.fout[16:17])


def split_commit_plain(st: TreeState, out, s: int, *, max_depth: int,
                       monotone: torch.Tensor, has_monotone: bool,
                       col_map=None, forced=None, n_forced: int = 0,
                       f_leaf: int = 0, track_used: bool = False,
                       mono_method: int = 0) -> None:
    """Plain torch twin of ``csrc/split_commit.cu``: commit ``s`` of the
    tree in ``st`` from the split outputs ``out`` (the host loop's
    bookkeeping, ``learner.build_tree_partitioned``, with every index and
    condition kept on the device); ``col_map`` the (F,) i32 column of each
    feature, or None (the feature itself); ``forced`` the forced-split
    scan's outputs (a ``SplitOut``, child 0) of slot ``s < n_forced``,
    whose leaf is ``f_leaf``; ``track_used`` keeps each leaf's used
    features; ``mono_method`` the monotone method (``ops/monotone.
    method_code``: 0 basic, 1 intermediate, 2 advanced)."""
    from .monotone import (adv_bounds_of, adv_child_boxes,
                           intermediate_refresh, reclamp)

    dev = st.best_gain.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    L = st.best_gain.shape[0]
    if s > 0:
        ph = st.hdr[s - 1].to(i64)
        p_live = ph[6] != 0
        leaf = ph[7].reshape(1)
        new = torch.full((1,), s, dtype=i64, device=dev)
        lt = out.lt.to(i64)[0]
        start, cnt, npar = ph[1], ph[2], 1 - ph[0]
        _put(st.seg_tab, new, torch.stack([start + lt, cnt - lt, npar]),
             p_live)
        old = _rows(st.seg_tab, leaf)[0].to(i64)
        _put(st.seg_tab, leaf, torch.stack([old[0], lt, npar]), p_live)
        _put(st.hist_pool, leaf, out.hists[0:1], p_live)
        _put(st.hist_pool, new, out.hists[1:2], p_live)
        infos = out.infos()
        gain = infos.gain
        if max_depth > 0:
            gain = torch.where(ph[5] >= max_depth,
                               torch.full_like(gain, float("-inf")), gain)
        for c, slot in ((0, leaf), (1, new)):
            for table, val in zip(st.best, infos._replace(gain=gain)):
                _put(table, slot, val[c:c + 1], p_live)
        live_in = p_live
    else:
        live_in = torch.ones((), dtype=torch.bool, device=dev)
    if s >= L - 1:
        return
    leaf_b = torch.argmax(st.best_gain).reshape(1)
    new = torch.full((1,), s + 1, dtype=i64, device=dev)
    at = torch.full((1,), s, dtype=i64, device=dev)
    picked = [_rows(t, leaf_b) for t in st.best]
    g_best = picked[0][0]
    false = torch.zeros((), dtype=torch.bool, device=dev)
    forcing = fok = false
    leaf = leaf_b
    if s < n_forced and forced is not None:
        forcing = live_in & (st.force_live[0] != 0)
        finfo = forced_info(forced)
        fok = forcing & (finfo.gain[0] > float("-inf"))
        leaf = torch.where(fok, torch.full_like(leaf_b, f_leaf), leaf_b)
        picked = [torch.where(fok, f.to(p.dtype), p)
                  for f, p in zip(finfo, picked)]
    (i_gain, i_feat, i_bin, i_kind, i_dl, i_go, i_ls, i_rs, i_lo,
     i_ro) = picked
    cond = live_in & ((g_best > 0) | forcing)
    live = cond & (i_gain[0] > float("-inf"))
    method = mono_method if has_monotone else 0
    if method:
        # the picked split was scanned under the bounds of its leaf's last
        # scan; neighbours' commits may have tightened them since
        mono_f = monotone.index_select(0, i_feat)
        if method == 2:
            B = st.cons_lo.shape[2]
            at_fb = i_feat * B + i_bin
            lo_l, up_l, lo_r, up_r = (
                a.reshape(-1).index_select(0, at_fb) for a in adv_bounds_of(
                    (st.cons_lo, st.cons_hi, st.rng_lo, st.rng_hi), leaf))
        else:
            lo_l = lo_r = _rows(st.leaf_lower, leaf)
            up_l = up_r = _rows(st.leaf_upper, leaf)
        i_lo, i_ro = reclamp(i_lo, i_ro, mono_f, lo_l, up_l, lo_r, up_r)
    if n_forced:
        keep = live & ~(forcing & ~fok)
        st.force_live.copy_(torch.where(keep, st.force_live,
                                        torch.zeros_like(st.force_live)))
    for table, val in ((st.log_leaf, leaf), (st.log_feat, i_feat),
                       (st.log_bin, i_bin), (st.log_kind, i_kind),
                       (st.log_dl, i_dl), (st.log_gain, i_gain),
                       (st.log_ls, i_ls), (st.log_rs, i_rs),
                       (st.log_go, i_go)):
        _put(table, at, val, live)
    _put(st.leaf_sum, leaf, i_ls, live)
    _put(st.leaf_sum, new, i_rs, live)
    _put(st.leaf_out, leaf, i_lo, live)
    _put(st.leaf_out, new, i_ro, live)
    d = _rows(st.depth, leaf) + 1
    _put(st.depth, leaf, d, live)
    _put(st.depth, new, d, live)
    if method:
        # the intermediate method's children inherit the parent's scalar
        # bounds; both methods cut the boxes (numerical winners)
        if method == 1:
            _put(st.leaf_lower, new, _rows(st.leaf_lower, leaf), live)
            _put(st.leaf_upper, new, _rows(st.leaf_upper, leaf), live)

        def sel(a, b):
            return torch.where(live, a, b)

        info = SimpleNamespace(kind=i_kind, feature=i_feat, bin=i_bin)
        rng_lo, rng_hi, box_l, box_r = adv_child_boxes(
            st.rng_lo, st.rng_hi, sel, leaf, new, info)
        st.rng_lo.copy_(rng_lo)
        st.rng_hi.copy_(rng_hi)
        if method == 1:
            # both children bound every box-overlapping leaf wholly below
            # or above them (the neighbour refresh)
            lower, upper = intermediate_refresh(
                st.leaf_lower, st.leaf_upper, st.rng_lo, st.rng_hi,
                monotone, ((box_l, i_lo), (box_r, i_ro)), live)
            st.leaf_lower.copy_(lower)
            st.leaf_upper.copy_(upper)
    elif has_monotone:
        # basic method: both children bounded by the split midpoint
        # (monotone_constraints.hpp:327 BasicLeafConstraints)
        mono = monotone.index_select(0, i_feat)
        mid = (i_lo + i_ro) * 0.5
        lo_p, up_p = _rows(st.leaf_lower, leaf), _rows(st.leaf_upper, leaf)
        _put(st.leaf_lower, leaf,
             torch.where(mono < 0, torch.maximum(lo_p, mid), lo_p), live)
        _put(st.leaf_upper, leaf,
             torch.where(mono > 0, torch.minimum(up_p, mid), up_p), live)
        _put(st.leaf_lower, new,
             torch.where(mono > 0, torch.maximum(lo_p, mid), lo_p), live)
        _put(st.leaf_upper, new,
             torch.where(mono < 0, torch.minimum(up_p, mid), up_p), live)
    if track_used:
        F = st.tree_used.shape[0]
        hot = torch.arange(F, device=dev) == i_feat
        used = _rows(st.leaf_used, leaf) | hot[None]
        _put(st.leaf_used, leaf, used, live)
        _put(st.leaf_used, new, used, live)
    _put(st.tree_used, i_feat, torch.ones(1, dtype=torch.bool, device=dev),
         live)
    st.num_splits.add_(live.to(i32))
    pair = torch.cat([i_ls[0], i_rs[0], i_lo, i_ro,
                      _rows(st.leaf_lower, leaf), _rows(st.leaf_lower, new),
                      _rows(st.leaf_upper, leaf), _rows(st.leaf_upper, new)])
    _put(st.pair, at, pair.to(f32), live)
    seg = _rows(st.seg_tab, leaf)[0]
    col = i_feat if col_map is None else col_map.index_select(0, i_feat)
    hdr = torch.cat([seg[2:3], seg[0:2], col.to(i32),
                     (i_ls[:, 2] <= i_rs[:, 2]).to(i32), d.to(i32),
                     torch.ones(1, dtype=i32, device=dev), leaf.to(i32)])
    cur = _rows(st.hdr, at)[0]
    st.hdr.index_copy_(0, at, torch.where(
        live, hdr, torch.cat([cur[:6], cur[6:7] * 0, cur[7:]]))[None])


class CommitArgs(ctypes.Structure):
    """The C struct ``CommitArgs`` of ``csrc/split_commit.cu`` (same
    fields, same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lt", "hists", "fout", "iout", "bout", "seg_tab", "hist_pool",
        "best_gain", "best_feature", "best_bin", "best_kind", "best_dl",
        "best_go", "best_ls", "best_rs", "best_lo", "best_ro", "leaf_sum",
        "leaf_out", "leaf_lower", "leaf_upper", "depth", "log_leaf",
        "log_feat", "log_bin", "log_kind", "log_dl", "log_gain", "log_ls",
        "log_rs", "log_go", "num_splits", "hdr", "pair", "monotone",
        "col_map", "leaf_used", "tree_used", "force_live", "ffout", "fiout",
        "fbout", "rng_lo", "rng_hi", "cons_lo", "cons_hi")] \
        + [(name, ctypes.c_int32) for name in (
            "s", "L", "F", "B", "HF", "HB", "max_depth", "has_monotone",
            "n_forced", "f_leaf", "track_used", "mono_method")]


class SplitCommit:
    """:func:`split_commit` over one :class:`TreeState` and one set of
    split outputs: the pointers are packed once, each call sets ``s`` (and
    the forced leaf of slot ``s``) and launches. ``forced`` (a
    ``SplitOut``) holds the forced-split scan of slots ``s < n_forced``;
    ``track_used`` keeps each leaf's used features (interaction
    constraints); ``mono_method`` is the monotone method
    (``ops/monotone.method_code``)."""

    def __init__(self, st: TreeState, out, *, max_depth: int,
                 monotone: torch.Tensor, has_monotone: bool,
                 col_map=None, forced=None, n_forced: int = 0,
                 track_used: bool = False, mono_method: int = 0) -> None:
        _check_commit(st, out, monotone, col_map, mono_method)
        if n_forced and forced is None:
            raise ValueError("split_commit: forced splits need the "
                             "forced-split scan's outputs")
        self.st, self.out = st, out
        self.max_depth, self.has_monotone = int(max_depth), bool(has_monotone)
        self.monotone, self.col_map = monotone, col_map
        self.forced, self.n_forced = forced, int(n_forced)
        self.track_used = bool(track_used)
        self.mono_method = int(mono_method) if has_monotone else 0
        self._args = None
        if st.best_gain.device.type == "cpu":
            return
        extra = () if col_map is None else (col_map,)
        if forced is not None:
            extra += tuple(forced)
        check_on_card("split_commit", st.hdr, *st, *out, monotone, *extra)
        L, HF, HB = (st.best_gain.shape[0], st.hist_pool.shape[1],
                     st.hist_pool.shape[2])
        F, B = monotone.shape[0], st.best_go.shape[1]
        ptrs = {f: getattr(st, f).data_ptr() for f in TreeState._fields}
        ptrs.update({f: getattr(out, f).data_ptr() for f in out._fields})
        if forced is not None:
            ptrs.update(ffout=forced.fout.data_ptr(),
                        fiout=forced.iout.data_ptr(),
                        fbout=forced.bout.data_ptr())
        self._args = CommitArgs(monotone=monotone.data_ptr(),
                                col_map=0 if col_map is None
                                else col_map.data_ptr(),
                                L=L, F=F, B=B, HF=HF, HB=HB,
                                max_depth=self.max_depth,
                                has_monotone=int(self.has_monotone),
                                n_forced=self.n_forced,
                                track_used=int(self.track_used),
                                mono_method=self.mono_method,
                                **{f: ptrs[f] for f, _ in CommitArgs._fields_
                                   if f in ptrs})

    def __call__(self, s: int, f_leaf: int = 0) -> None:
        L = self.st.best_gain.shape[0]
        if not 0 <= s < L:
            raise ValueError("split_commit: s = %d outside [0, %d)" % (s, L))
        if self._args is None:
            split_commit_plain(self.st, self.out, s, max_depth=self.max_depth,
                               monotone=self.monotone,
                               has_monotone=self.has_monotone,
                               col_map=self.col_map, forced=self.forced,
                               n_forced=self.n_forced, f_leaf=f_leaf,
                               track_used=self.track_used,
                               mono_method=self.mono_method)
            return
        self._args.s = s
        self._args.f_leaf = int(f_leaf)
        COMMIT_KERNEL.launch(ctypes.addressof(self._args), COMMIT_BLOCKS,
                             stream_of(self.st.hdr))


def split_commit(st: TreeState, out, s: int, *, max_depth: int,
                 monotone: torch.Tensor, has_monotone: bool,
                 col_map=None, forced=None, n_forced: int = 0,
                 f_leaf: int = 0, track_used: bool = False,
                 mono_method: int = 0) -> None:
    """Commit ``s`` of the tree in ``st`` (in place) from the split
    outputs ``out`` (``ops/partition.SplitOut``): apply split ``s - 1``,
    pick split ``s`` (forced split ``s`` from ``forced``, the forced-split
    scan of leaf ``f_leaf``, while the tree's forced splits hold and ``s <
    n_forced``), record it and write its header and pair rows.
    ``monotone`` is the (F,) i8 constraint of each feature, ``col_map``
    the (F,) i32 work-row column of each feature (None: the feature),
    ``mono_method`` the monotone method (``ops/monotone.method_code``). On
    a CUDA tensor one launch of ``csrc/split_commit.cu``; on a CPU tensor
    :func:`split_commit_plain`. Nothing is read back to the host."""
    SplitCommit(st, out, max_depth=max_depth, monotone=monotone,
                has_monotone=has_monotone, col_map=col_map, forced=forced,
                n_forced=n_forced, track_used=track_used,
                mono_method=mono_method)(s, f_leaf)


def _check_commit(st: TreeState, out, monotone: torch.Tensor,
                  col_map=None, mono_method: int = 0) -> None:
    L, HF, HB = (st.best_gain.shape[0], st.hist_pool.shape[1],
                 st.hist_pool.shape[2])
    B = st.best_go.shape[1]
    if L < 2 or st.hist_pool.shape != (L, HF, HB, 3):
        raise ValueError("split_commit: a tree state of %d leaves" % L)
    if st.hdr.shape != (L, HDR_WORDS) or st.pair.shape != (L, PAIR_WORDS):
        raise ValueError("split_commit: header rows must be (L, %d), pair "
                         "rows (L, %d)" % (HDR_WORDS, PAIR_WORDS))
    if out.hists.shape != (2, HF, HB, 3) or out.bout.shape != (2 + 2 * B,):
        raise ValueError("split_commit: outputs of another shape than the "
                         "state's (HF = %d, HB = %d, B = %d)" % (HF, HB, B))
    F = monotone.shape[0]
    if monotone.dtype != torch.int8 or monotone.dim() != 1:
        raise ValueError("split_commit: monotone must be (F,) int8")
    if col_map is not None and (col_map.dtype != torch.int32
                                or col_map.shape != (F,)):
        raise ValueError("split_commit: col_map must be (%d,) int32" % F)
    if st.rng_lo.shape != (L, F) or st.rng_hi.shape != (L, F):
        raise ValueError("split_commit: boxes must be (L, F)")
    if mono_method == 2 and st.cons_lo.shape != (L, F, B):
        raise ValueError("split_commit: the advanced method needs (L, F, B) "
                         "bounds (tree_state(mono_method=2))")
    if not all(t.is_contiguous() for t in (*st, *out)):
        raise ValueError("split_commit: state and outputs must be "
                         "contiguous")
