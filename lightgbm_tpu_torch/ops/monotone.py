"""The intermediate and advanced monotone constraint state (PyTorch port
of the ``_adv_*`` helpers of ``lightgbm_tpu/learner.py``).

Both methods keep each leaf's bin-range box (``rng_lo``, ``rng_hi``: (L,
F) i32, the bins ``[lo, hi)`` of feature f that reach the leaf). The
intermediate method (``monotone_constraints_method=intermediate``) bounds
each leaf by two scalars, which every committed split refreshes for every
box-overlapping leaf wholly below or above a child (the split commit,
``ops/commit.py``). The advanced method adds per-leaf per-feature per-bin
bounds (``cons_lo``, ``cons_hi``: (L, F, B) f32): every commit writes both
children's outputs into the rows of every box-overlapping leaf
(:func:`adv_commit`), and the split scan reads each candidate's child
bounds (:func:`adv_bounds_of`: prefix and suffix extrema over the in-range
bins, and the extremum over every other feature).

The functional helpers (:func:`adv_boxes_init`, :func:`adv_init`,
:func:`adv_bounds_of`, :func:`adv_child_boxes`,
:func:`adv_overlap_except`, :func:`adv_commit`) are the JAX functions line
for line, on torch tensors: min, max, clip, compare and copy only, so
they equal them exactly. Leaves are host ints or (1,) device indices, so
the tree loops read nothing back to the host.

Two kernels of ``csrc/monotone.cu`` run the advanced method's state work
on the card, each with its plain twin here (which runs only for host
tensors; both agree bit for bit):

- :func:`mono_bounds`: :func:`adv_bounds_of` of one or two leaves (a
  split's children, or a forced split's leaf) into the (nodes, 4, F, B)
  bounds the split scan reads (``ops/scan.SplitScan``);
- :func:`mono_commit`: :func:`adv_commit`'s (L, F, B) writes of both
  children of a committed split, gated by its live word, after the split
  commit has cut the boxes.

Neither replaces a Pallas kernel: the JAX package runs this state as XLA
inside its ``lax.while_loop``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .kernels import CudaKernel, register, stream_of

_P = ctypes.c_void_p
MONO_BOUNDS_KERNEL = register(CudaKernel("mono_bounds", "monotone.cu",
                                         [_P, _P]))
MONO_COMMIT_KERNEL = register(CudaKernel("mono_commit", "monotone.cu",
                                         [_P, _P]))


def method_code(hp) -> int:
    """The commit's monotone method of a ``SplitHyper``: 0 basic (or no
    constraints), 1 intermediate, 2 advanced."""
    if not hp.has_monotone:
        return 0
    if hp.mono_advanced:
        return 2
    return 1 if hp.mono_intermediate else 0


def _index(leaf, device) -> torch.Tensor:
    """A leaf (host int, 0-d or (1,) tensor) as a (1,) int64 index."""
    if isinstance(leaf, torch.Tensor):
        return leaf.reshape(1).to(torch.int64)
    return torch.full((1,), int(leaf), dtype=torch.int64, device=device)


def _row(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, idx)[0]


def _set_row(t: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``t.at[idx].set(val)``: a new tensor."""
    return t.index_copy(0, idx, val.to(t.dtype).reshape((1,) + t.shape[1:]))


# ------------------------------------------------------------------ helpers

def adv_boxes_init(num_leaves: int, num_feat: int, num_bins: torch.Tensor):
    """(L, F) bin-range boxes, all that the intermediate method needs."""
    rng_lo = torch.zeros((num_leaves, num_feat), dtype=torch.int32,
                         device=num_bins.device)
    rng_hi = num_bins.to(torch.int32)[None, :].expand(
        num_leaves, num_feat).contiguous()
    return (rng_lo, rng_hi)


def adv_init(num_leaves: int, num_feat: int, num_bin: int,
             num_bins: torch.Tensor):
    """The advanced state ``(cons_lo, cons_hi, rng_lo, rng_hi)``."""
    dev = num_bins.device
    cons_lo = torch.full((num_leaves, num_feat, num_bin), float("-inf"),
                         dtype=torch.float32, device=dev)
    cons_hi = torch.full((num_leaves, num_feat, num_bin), float("inf"),
                         dtype=torch.float32, device=dev)
    return (cons_lo, cons_hi) + adv_boxes_init(num_leaves, num_feat,
                                               num_bins)


def adv_bounds_of(adv, leaf):
    """Per-candidate child bounds ``(lo_l, up_l, lo_r, up_r)``, each (F,
    B): entry [f, t] bounds the child of a split on feature f at threshold
    t (left = bins <= t). The whole-range extrema over every feature but f
    come from the two smallest (largest) in ``torch.sort``'s stable order,
    as ``jnp.sort`` gives them, so ties and the one-feature case (a
    +/-inf sentinel) behave as in the JAX package."""
    cons_lo, cons_hi, rng_lo, rng_hi = adv
    dev = cons_lo.device
    idx = _index(leaf, dev)
    lo = _row(cons_lo, idx)
    hi = _row(cons_hi, idx)                           # (F, B)
    rlo = _row(rng_lo, idx)
    rhi = _row(rng_hi, idx)                           # (F,)
    num_bin = lo.shape[1]
    b = torch.arange(num_bin, dtype=torch.int32, device=dev)[None, :]
    inr = (b >= rlo[:, None]) & (b < rhi[:, None])
    inf = torch.full((1,), float("inf"), dtype=torch.float32, device=dev)
    hi_m = torch.where(inr, hi, inf)
    lo_m = torch.where(inr, lo, -inf)
    hi_f = torch.amin(hi_m, dim=1)                    # (F,) whole-range
    lo_f = torch.amax(lo_m, dim=1)
    hi_s = torch.sort(torch.cat([hi_f, inf]), stable=True).values
    hi1, hi2 = hi_s[0], hi_s[1]
    hi_exc = torch.where((hi_f == hi1) & (torch.sum(hi_f == hi1) == 1),
                         hi2, hi1)
    lo_s = torch.sort(torch.cat([lo_f, -inf]), stable=True).values
    lo1, lo2 = lo_s[-1], lo_s[-2]
    lo_exc = torch.where((lo_f == lo1) & (torch.sum(lo_f == lo1) == 1),
                         lo2, lo1)
    # prefix extrema cover the left child's bins [0, t]; suffix (shifted
    # one left) the right child's bins (t, B)
    pre_hi = torch.cummin(hi_m, dim=1).values
    pre_lo = torch.cummax(lo_m, dim=1).values
    suf_hi = torch.flip(torch.cummin(torch.flip(hi_m, [1]), dim=1).values,
                        [1])
    suf_lo = torch.flip(torch.cummax(torch.flip(lo_m, [1]), dim=1).values,
                        [1])
    inf_c = inf.expand(hi_m.shape[0], 1)
    suf_hi = torch.cat([suf_hi[:, 1:], inf_c], dim=1)
    suf_lo = torch.cat([suf_lo[:, 1:], -inf_c], dim=1)
    up_l = torch.minimum(hi_exc[:, None], pre_hi)
    lo_l = torch.maximum(lo_exc[:, None], pre_lo)
    up_r = torch.minimum(hi_exc[:, None], suf_hi)
    lo_r = torch.maximum(lo_exc[:, None], suf_lo)
    return lo_l, up_l, lo_r, up_r


def adv_child_boxes(rng_lo, rng_hi, sel, leaf, new_leaf, info):
    """Split the parent's bin box along a numerical winner's feature and
    commit the children's boxes (the left child keeps the parent's slot).
    ``info`` carries the winner's ``kind``, ``feature`` and ``bin`` (0-d or
    (1,) tensors); ``sel(a, b)`` picks ``a`` when the round commits.
    Returns the updated ``(rng_lo, rng_hi)`` and the two child boxes."""
    dev = rng_lo.device
    leaf, new_leaf = _index(leaf, dev), _index(new_leaf, dev)
    is_num = info.kind.reshape(()) == 0
    fs = info.feature.reshape(()).to(torch.int64)
    t1 = (info.bin.reshape(()) + 1).to(torch.int32)
    p_rlo = _row(rng_lo, leaf)
    p_rhi = _row(rng_hi, leaf)
    cut = (torch.arange(rng_lo.shape[1], device=dev) == fs) & is_num
    rhi_l = torch.where(cut, t1, p_rhi)
    rlo_r = torch.where(cut, t1, p_rlo)
    rng_lo = _set_row(rng_lo, new_leaf, sel(rlo_r, _row(rng_lo, new_leaf)))
    rng_hi = _set_row(rng_hi, leaf, sel(rhi_l, p_rhi))
    rng_hi = _set_row(rng_hi, new_leaf, sel(p_rhi, _row(rng_hi, new_leaf)))
    return rng_lo, rng_hi, (p_rlo, rhi_l), (rlo_r, p_rhi)


def adv_overlap_except(rng_lo, rng_hi, c_rlo, c_rhi):
    """(L, F) mask: leaf boxes overlapping child box C in every feature
    but the column's own (the dimension a bound would apply along)."""
    ov = (rng_lo < c_rhi[None, :]) & (c_rlo[None, :] < rng_hi)
    nfalse = torch.sum(~ov, dim=1)
    return (nfalse == 0)[:, None] | ((nfalse == 1)[:, None] & ~ov)


def adv_writes(cons_lo, cons_hi, rng_lo, rng_hi, monotone, children,
               valid_b):
    """The writes of :func:`adv_commit` after the boxes are cut: for each
    child ``(c_rlo, c_rhi), out`` of ``children`` in order, its output as
    a bound along each monotone dimension beyond its range (gated by
    ``cov_exc``), and along each other dimension inside its range for
    leaves wholly ordered against it (``free_gate``). Returns ``(cons_lo,
    cons_hi)``."""
    num_bin = cons_lo.shape[2]
    dev = cons_lo.device
    b = torch.arange(num_bin, dtype=torch.int32, device=dev)[None, None, :]
    mono = monotone[None, :]
    inc = (mono > 0)[:, :, None]
    dec = (mono < 0)[:, :, None]
    incv = mono > 0
    decv = mono < 0
    for (c_rlo, c_rhi), out in children:
        out = out.reshape(()).to(torch.float32)
        cover = (c_rlo[None, :] <= rng_lo) & (rng_hi <= c_rhi[None, :])
        ncov = torch.sum(~cover, dim=1)                            # (L,)
        cov_exc = (ncov == 0)[:, None] | ((ncov == 1)[:, None] & ~cover)
        below = b < c_rlo[None, :, None]
        above = b >= c_rhi[None, :, None]
        hi_upd = (inc & below) | (dec & above)
        lo_upd = (inc & above) | (dec & below)
        gate = cov_exc[:, :, None] & valid_b
        cons_hi = torch.where(gate & hi_upd, torch.minimum(cons_hi, out),
                              cons_hi)
        cons_lo = torch.where(gate & lo_upd, torch.maximum(cons_lo, out),
                              cons_lo)

        # ---- free-dimension writes (restricted to C's own bin range) ----
        ov = (rng_lo < c_rhi[None, :]) & (c_rlo[None, :] < rng_hi)  # (L, F)
        nonov = (~ov).to(torch.int32)
        nov = torch.sum(nonov, dim=1)                              # (L,)
        ub_ord = (incv & (rng_hi <= c_rlo[None, :])) \
            | (decv & (rng_lo >= c_rhi[None, :]))                  # (L, F)
        lb_ord = (incv & (rng_lo >= c_rhi[None, :])) \
            | (decv & (rng_hi <= c_rlo[None, :]))
        ub_any = (torch.sum(ub_ord, dim=1)[:, None]
                  - ub_ord.to(torch.int32)) > 0                    # (L, F)
        lb_any = (torch.sum(lb_ord, dim=1)[:, None]
                  - lb_ord.to(torch.int32)) > 0
        free_gate = (nov[:, None] - nonov) == 1                    # (L, F)
        in_rng = (b >= c_rlo[None, :, None]) & (b < c_rhi[None, :, None])
        g_ub = (ub_any & free_gate)[:, :, None] & in_rng & valid_b
        g_lb = (lb_any & free_gate)[:, :, None] & in_rng & valid_b
        cons_hi = torch.where(g_ub, torch.minimum(cons_hi, out), cons_hi)
        cons_lo = torch.where(g_lb, torch.maximum(cons_lo, out), cons_lo)
    return cons_lo, cons_hi


def adv_commit(adv, monotone, sel, leaf, new_leaf, info, num_bin: int):
    """Split commit of the advanced state: the new child inherits the
    parent's bound rows, the split feature's box tightens (numerical
    winners), and both children write their outputs (``info.left_output``,
    ``info.right_output``) as bounds into every box-overlapping leaf
    (:func:`adv_writes`). ``monotone`` is the (F,) i8 constraint of each
    feature. Returns the new ``adv``."""
    cons_lo, cons_hi, rng_lo, rng_hi = adv
    dev = cons_lo.device
    li, ni = _index(leaf, dev), _index(new_leaf, dev)
    cons_lo = _set_row(cons_lo, ni, sel(_row(cons_lo, li), _row(cons_lo, ni)))
    cons_hi = _set_row(cons_hi, ni, sel(_row(cons_hi, li), _row(cons_hi, ni)))
    rng_lo, rng_hi, box_l, box_r = adv_child_boxes(
        rng_lo, rng_hi, sel, li, ni, info)
    valid_b = sel(torch.ones((), dtype=torch.bool, device=dev),
                  torch.zeros((), dtype=torch.bool, device=dev))
    cons_lo, cons_hi = adv_writes(
        cons_lo, cons_hi, rng_lo, rng_hi, monotone,
        ((box_l, info.left_output), (box_r, info.right_output)), valid_b)
    return (cons_lo, cons_hi, rng_lo, rng_hi)


def intermediate_refresh(leaf_lower, leaf_upper, rng_lo, rng_hi, monotone,
                         children, valid_b):
    """The intermediate method's neighbour refresh: each child ``(c_rlo,
    c_rhi), out`` of ``children`` in order bounds every box-overlapping
    leaf wholly below (above) it in a monotone dimension from above
    (below). Returns ``(leaf_lower, leaf_upper)``."""
    monov = monotone[None, :]
    inc = monov > 0
    dec = monov < 0
    for (c_rlo, c_rhi), out in children:
        out = out.reshape(()).to(torch.float32)
        ov_exc = adv_overlap_except(rng_lo, rng_hi, c_rlo, c_rhi)
        below = rng_hi <= c_rlo[None, :]
        above = rng_lo >= c_rhi[None, :]
        hi_m = torch.any(ov_exc & ((inc & below) | (dec & above)),
                         dim=1) & valid_b
        lo_m = torch.any(ov_exc & ((inc & above) | (dec & below)),
                         dim=1) & valid_b
        leaf_upper = torch.where(hi_m, torch.minimum(leaf_upper, out),
                                 leaf_upper)
        leaf_lower = torch.where(lo_m, torch.maximum(leaf_lower, out),
                                 leaf_lower)
    return leaf_lower, leaf_upper


def reclamp(wl, wr, mono_f, lo_l, up_l, lo_r, up_r):
    """The picked split's outputs against its leaf's current bounds, then
    the sibling order re-enforced (a swap), as the JAX tree loop does
    before it records a split under the intermediate and advanced
    methods."""
    wl = torch.minimum(torch.maximum(wl, lo_l), up_l)
    wr = torch.minimum(torch.maximum(wr, lo_r), up_r)
    swap = ((mono_f > 0) & (wl > wr)) | ((mono_f < 0) & (wl < wr))
    return torch.where(swap, wr, wl), torch.where(swap, wl, wr)


# ------------------------------------------------------------------ kernels

class MonoBoundsArgs(ctypes.Structure):
    """The C struct ``MonoBoundsArgs`` of ``csrc/monotone.cu``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cons_lo", "cons_hi", "rng_lo", "rng_hi", "leaf0", "live", "out")] \
        + [(name, ctypes.c_int32) for name in (
            "leaf1", "nodes", "L", "F", "B")]


class MonoCommitArgs(ctypes.Structure):
    """The C struct ``MonoCommitArgs`` of ``csrc/monotone.cu``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cons_lo", "cons_hi", "rng_lo", "rng_hi", "monotone", "words",
        "outs")] \
        + [(name, ctypes.c_int32) for name in ("new_leaf", "L", "F", "B")]


def _check_state(name, cons_lo, cons_hi, rng_lo, rng_hi):
    L, F, B = cons_lo.shape
    if cons_hi.shape != (L, F, B) or rng_lo.shape != (L, F) \
            or rng_hi.shape != (L, F):
        raise ValueError("%s: the state must be (L, F, B) bounds and (L, F) "
                         "boxes" % name)
    if cons_lo.dtype != torch.float32 or cons_hi.dtype != torch.float32 \
            or rng_lo.dtype != torch.int32 or rng_hi.dtype != torch.int32:
        raise ValueError("%s: bounds f32, boxes i32" % name)
    if not 0 < B <= 256:
        raise ValueError("%s: needs 0 < B <= 256, got %d" % (name, B))
    if not all(t.is_contiguous() for t in (cons_lo, cons_hi, rng_lo,
                                           rng_hi)):
        raise ValueError("%s: the state must be contiguous" % name)
    return L, F, B


def _on_card(name, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("%s: every tensor on %s, got one on %s"
                             % (name, dev, t.device))


def mono_bounds_plain(cons_lo, cons_hi, rng_lo, rng_hi, leaf0, leaf1: int,
                      nodes: int, out, live=None) -> None:
    """Plain twin of :func:`mono_bounds`."""
    adv = (cons_lo, cons_hi, rng_lo, rng_hi)
    leaves = [leaf0] + ([leaf1] if nodes == 2 else [])
    vals = torch.stack([torch.stack(adv_bounds_of(adv, lf))
                        for lf in leaves])              # (nodes, 4, F, B)
    if live is None:
        out[:nodes].copy_(vals)
    else:
        out[:nodes].copy_(torch.where(live.reshape(()) != 0, vals,
                                      out[:nodes]))


def mono_bounds(cons_lo, cons_hi, rng_lo, rng_hi, leaf0: torch.Tensor,
                leaf1: int, nodes: int, out: torch.Tensor,
                live: Optional[torch.Tensor] = None) -> None:
    """:func:`adv_bounds_of` of ``nodes`` (1 or 2) leaves into ``out``
    (nodes, 4, F, B) f32 ([lo_l, up_l, lo_r, up_r] a node): node 0 at the
    leaf in the (1,) i32 device word ``leaf0`` (a split header's leaf
    word), node 1 at ``leaf1``. With the (1,) i32 ``live`` word 0 nothing
    is written. On a CUDA tensor one launch of ``csrc/monotone.cu``
    (``mono_bounds``); on a CPU tensor :func:`mono_bounds_plain`. Nothing
    is read back to the host."""
    L, F, B = _check_state("mono_bounds", cons_lo, cons_hi, rng_lo, rng_hi)
    if nodes not in (1, 2):
        raise ValueError("mono_bounds: nodes must be 1 or 2")
    if out.dtype != torch.float32 or out.dim() != 4 \
            or out.shape[0] < nodes or out.shape[1:] != (4, F, B) \
            or not out.is_contiguous():
        raise ValueError("mono_bounds: out must be contiguous (>= %d, 4, "
                         "%d, %d) f32" % (nodes, F, B))
    if leaf0.dtype != torch.int32 or leaf0.numel() != 1 or (
            live is not None and (live.dtype != torch.int32
                                  or live.numel() != 1)):
        raise ValueError("mono_bounds: leaf0 and live must be (1,) int32")
    if cons_lo.device.type == "cpu":
        mono_bounds_plain(cons_lo, cons_hi, rng_lo, rng_hi, leaf0, leaf1,
                          nodes, out, live)
        return
    _on_card("mono_bounds", cons_lo, cons_hi, rng_lo, rng_hi, leaf0, out,
             *(() if live is None else (live,)))
    a = MonoBoundsArgs(
        cons_lo=cons_lo.data_ptr(), cons_hi=cons_hi.data_ptr(),
        rng_lo=rng_lo.data_ptr(), rng_hi=rng_hi.data_ptr(),
        leaf0=leaf0.data_ptr(), live=0 if live is None else live.data_ptr(),
        out=out.data_ptr(), leaf1=int(leaf1), nodes=int(nodes), L=L, F=F,
        B=B)
    MONO_BOUNDS_KERNEL.launch(ctypes.addressof(a), stream_of(cons_lo))


def mono_commit_plain(cons_lo, cons_hi, rng_lo, rng_hi, monotone, words,
                      outs, new_leaf: int) -> None:
    """Plain twin of :func:`mono_commit`, in place."""
    dev = cons_lo.device
    live = words[0].reshape(()) != 0
    li = words[1:2].to(torch.int64)
    ni = _index(new_leaf, dev)

    def sel(a, b):
        return torch.where(live, a, b)

    lo = _set_row(cons_lo, ni, sel(_row(cons_lo, li), _row(cons_lo, ni)))
    hi = _set_row(cons_hi, ni, sel(_row(cons_hi, li), _row(cons_hi, ni)))
    children = (((_row(rng_lo, li), _row(rng_hi, li)), outs[0]),
                ((_row(rng_lo, ni), _row(rng_hi, ni)), outs[1]))
    lo, hi = adv_writes(lo, hi, rng_lo, rng_hi, monotone, children, live)
    cons_lo.copy_(lo)
    cons_hi.copy_(hi)


def mono_commit(cons_lo, cons_hi, rng_lo, rng_hi, monotone: torch.Tensor,
                words: torch.Tensor, outs: torch.Tensor,
                new_leaf: int) -> None:
    """:func:`adv_commit`'s bound writes, in place, for the split whose
    (2,) i32 device ``words`` are [live, leaf] (a split header's words 6
    and 7) and whose (2,) f32 ``outs`` are the children's committed
    outputs (the pair row's words 6 and 7), the new leaf ``new_leaf``. The
    boxes must already be cut (the split commit cuts them): the children's
    boxes are then rows ``leaf`` and ``new_leaf``. The new leaf's rows
    inherit the parent's first. With live 0 nothing is written. On a CUDA
    tensor one launch of ``csrc/monotone.cu`` (``mono_commit``); on a CPU
    tensor :func:`mono_commit_plain`."""
    L, F, B = _check_state("mono_commit", cons_lo, cons_hi, rng_lo, rng_hi)
    if monotone.dtype != torch.int8 or monotone.shape != (F,):
        raise ValueError("mono_commit: monotone must be (%d,) int8" % F)
    if words.dtype != torch.int32 or words.shape != (2,) \
            or outs.dtype != torch.float32 or outs.shape != (2,):
        raise ValueError("mono_commit: words (2,) int32, outs (2,) f32")
    if not 0 < new_leaf < L:
        raise ValueError("mono_commit: new leaf %d outside (0, %d)"
                         % (new_leaf, L))
    if cons_lo.device.type == "cpu":
        mono_commit_plain(cons_lo, cons_hi, rng_lo, rng_hi, monotone, words,
                          outs, new_leaf)
        return
    _on_card("mono_commit", cons_lo, cons_hi, rng_lo, rng_hi, monotone,
             words, outs)
    a = MonoCommitArgs(
        cons_lo=cons_lo.data_ptr(), cons_hi=cons_hi.data_ptr(),
        rng_lo=rng_lo.data_ptr(), rng_hi=rng_hi.data_ptr(),
        monotone=monotone.data_ptr(), words=words.data_ptr(),
        outs=outs.data_ptr(), new_leaf=int(new_leaf), L=L, F=F, B=B)
    MONO_COMMIT_KERNEL.launch(ctypes.addressof(a), stream_of(cons_lo))
