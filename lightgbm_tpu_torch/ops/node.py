"""The per-node inputs of the split scan: by-node feature sampling,
extra-trees thresholds, interaction constraints and CEGB penalties
(PyTorch port of ``_make_best_for`` and ``cegb_penalty`` in
``lightgbm_tpu/learner.py``).

A node of round ``r`` (the root at ``r = 0``; both children of the split
of round ``r`` with that same ``r``) searches its split under

- a feature mask: the tree's mask, AND the by-node sample (the ``kth``
  features of smallest rank of ``uniform(fold_in(key, 2r + 1000 + leaf),
  (F,))``, the stable double argsort), AND the features that a constraint
  set compatible with the features used on the node's path allows;
- extra-trees threshold bins: ``int(uniform(fold_in(fold_in(key, 2000 +
  extra_seed), 2r + 1 + leaf), (F,)) * max(num_bins - 1, 1))``, the one
  numerical threshold each feature may take;
- CEGB gain penalties: ``tradeoff * (penalty_split * cnt + coupled *
  !tree_used)``, subtracted from every candidate's gain.

:func:`node_inputs` writes them for one or two nodes into a
:class:`NodeBuf`: on a CUDA tensor one launch of ``csrc/node_draws.cu``
(which reads the leaf and the live word from the split's device header,
so a CUDA graph holds it), on a CPU tensor its plain twin
:func:`node_inputs_plain`, torch ops over ``prng.py``'s threefry. The two
agree bit for bit. Nothing is read back to the host.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from .kernels import CudaKernel, register, stream_of

_P = ctypes.c_void_p
#: torch's op-by-op rounding: no contracted multiply-adds
NODE_KERNEL = register(CudaKernel(
    "node_inputs", "node_draws.cu", [_P, _P], flags=("-fmad=false",)))


class NodeOptions(NamedTuple):
    """The per-node options of a learner, fixed for its trees: the by-node
    fraction (``kth`` features kept of F, 0 when off), extra-trees and its
    seed, the (S, F) bool constraint sets (or None) and CEGB."""
    kth: int = 0
    extra_trees: bool = False
    extra_seed: int = 6
    sets: Optional[torch.Tensor] = None
    cegb: bool = False

    @property
    def active(self) -> bool:
        """Whether any node input differs from the tree's plain mask."""
        return bool(self.kth or self.extra_trees or self.sets is not None
                    or self.cegb)

    @property
    def needs_used(self) -> bool:
        """Whether the learner keeps each leaf's used features."""
        return self.sets is not None


def node_options(config, num_feat: int, sets=None,
                 cegb: bool = False) -> NodeOptions:
    """The :class:`NodeOptions` of a config (``feature_fraction_bynode``,
    ``extra_trees``, ``extra_seed``) for F features, with the parsed
    constraint ``sets`` and whether CEGB is on."""
    frac = float(config.feature_fraction_bynode)
    kth = max(1, int(math.ceil(frac * num_feat))) if frac < 1.0 else 0
    return NodeOptions(kth=kth, extra_trees=bool(config.extra_trees),
                       extra_seed=int(config.extra_seed), sets=sets,
                       cegb=bool(cegb))


class NodeBuf(NamedTuple):
    """The inputs of a split's two children (or one node), on the device:
    ``mask`` (2, F) bool, ``thr`` (2, F) i32 (None without extra-trees),
    ``delta`` (2, F) f32 (None without CEGB); ``compat`` (2, S) u8 is the
    kernel's scratch of the constraint sets compatible with each node's
    path (None without interaction constraints)."""
    mask: torch.Tensor
    thr: Optional[torch.Tensor]
    delta: Optional[torch.Tensor]
    compat: Optional[torch.Tensor] = None

    def rows(self, p: int):
        """(mask, thr, delta) of the first ``p`` nodes, as the scan takes
        them."""
        return (self.mask[:p],
                None if self.thr is None else self.thr[:p],
                None if self.delta is None else self.delta[:p])


def node_buf(opts: NodeOptions, num_feat: int, device) -> NodeBuf:
    """A zeroed :class:`NodeBuf` for ``opts``."""
    z = torch.zeros
    return NodeBuf(
        mask=z((2, num_feat), dtype=torch.bool, device=device),
        thr=z((2, num_feat), dtype=torch.int32, device=device)
        if opts.extra_trees else None,
        delta=z((2, num_feat), dtype=torch.float32, device=device)
        if opts.cegb else None,
        compat=z((2, opts.sets.shape[0]), dtype=torch.uint8, device=device)
        if opts.sets is not None else None)


def node_keys(key, extra_seed: int, out: torch.Tensor) -> torch.Tensor:
    """The (4,) int64 words of a tree's node keys, ``key`` (a ``prng``
    key) and ``fold_in(key, 2000 + extra_seed)``, written into ``out`` by
    fills (the host does not wait for the card)."""
    from ..prng import fold_in, key_words

    key_words(key, out[0:2])
    key_words(fold_in(key, 2000 + extra_seed), out[2:4])
    return out


def allowed_mask(used_row: torch.Tensor, sets: torch.Tensor) -> torch.Tensor:
    """(F,) bool: the features that a constraint set compatible with the
    path's ``used_row`` allows (col_sampler.hpp:94 GetByNode;
    ``allowed_mask`` of the JAX package's ``_make_best_for``)."""
    compat = torch.all(~used_row[None, :] | sets, dim=1)       # (S,)
    return torch.any(sets & compat[:, None], dim=0)


def _fold(key4: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in`` of the (2,) int64 key words ``key4`` by the (1,) int64
    device ``data``: (2,) int64 words."""
    from ..prng import MASK32, threefry2x32

    a, b = threefry2x32(key4, 0, data & MASK32)
    return torch.cat([a, b])


def node_inputs_plain(out: NodeBuf, keys: torch.Tensor, r: int, leaf,
                      leaf1: int, p: int, *, opts: NodeOptions,
                      fmask: torch.Tensor, num_bins: torch.Tensor,
                      coupled: torch.Tensor, hp, sums=None, used=None,
                      tree_used=None, live=None) -> None:
    """Plain twin of :func:`node_inputs`: torch ops, no host read."""
    from ..prng import uniform

    dev = fmask.device
    F = fmask.shape[0]
    i64 = torch.int64
    lf0 = leaf.to(i64).reshape(1) if isinstance(leaf, torch.Tensor) \
        else torch.full((1,), int(leaf), dtype=i64, device=dev)
    lf = [lf0, torch.full((1,), int(leaf1), dtype=i64, device=dev)]
    allowed = None
    if opts.sets is not None:
        row = used.index_select(0, lf0)[0]
        allowed = allowed_mask(row, opts.sets)
    go = torch.ones((), dtype=torch.bool, device=dev) if live is None \
        else live.reshape(-1)[0] != 0
    for c in range(p):
        m = fmask.clone()
        if opts.kth:
            u = uniform(_fold(keys[0:2], r * 2 + 1000 + lf[c]), (F,),
                        device=dev)
            rank = torch.argsort(torch.argsort(u, stable=True), stable=True)
            m = m & (rank < opts.kth)
        if allowed is not None:
            m = m & allowed
        out.mask[c].copy_(torch.where(go, m, out.mask[c]))
        if out.thr is not None:
            u = uniform(_fold(keys[2:4], r * 2 + 1 + lf[c]), (F,),
                        device=dev)
            nb1 = torch.clamp(num_bins.to(torch.int32) - 1, min=1)
            thr = (u * nb1.to(torch.float32)).to(torch.int32)
            out.thr[c].copy_(torch.where(go, thr, out.thr[c]))
        if out.delta is not None:
            d = hp.cegb_tradeoff * (hp.cegb_penalty_split * sums[c, 2]
                                    + coupled * (~tree_used)
                                    .to(torch.float32))
            out.delta[c].copy_(torch.where(go, d, out.delta[c]))


class NodeArgs(ctypes.Structure):
    """The C struct ``NodeArgs`` of ``csrc/node_draws.cu`` (same fields,
    same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "keys", "live", "leaf_ptr", "sums", "used", "tree_used", "fmask",
        "num_bins", "sets", "coupled", "mask", "thr", "delta", "compat")] \
        + [(name, ctypes.c_int32) for name in (
            "F", "P", "r", "leaf0", "leaf1", "S", "kth", "bynode")] \
        + [(name, ctypes.c_float) for name in (
            "tradeoff", "penalty_split")]


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def node_inputs(out: NodeBuf, keys: torch.Tensor, r: int, leaf, leaf1: int,
                p: int, *, opts: NodeOptions, fmask: torch.Tensor,
                num_bins: torch.Tensor, coupled: torch.Tensor, hp,
                sums: Optional[torch.Tensor] = None,
                used: Optional[torch.Tensor] = None,
                tree_used: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None) -> None:
    """The inputs of ``p`` (1 or 2) nodes of round ``r`` into ``out``:
    node 0 at ``leaf`` (a host int, or a (1,) i32 device tensor such as
    the split header's leaf word), node 1 at ``leaf1``. ``keys`` is the
    (4,) int64 :func:`node_keys` buffer; ``sums`` the nodes' (p, 3) g, h,
    cnt (CEGB); ``used`` the (L, F) bool table whose row ``leaf`` holds the
    features used on the path (interaction constraints); ``tree_used`` the
    (F,) bool features the model has used (CEGB); ``live`` a (1,) i32 word
    that, when 0, leaves ``out`` as it is. On a CUDA tensor one launch of
    ``csrc/node_draws.cu``; on a CPU tensor :func:`node_inputs_plain`."""
    if not 1 <= p <= 2:
        raise ValueError("node_inputs: p must be 1 or 2, got %d" % p)
    F = fmask.shape[0]
    if keys.dtype != torch.int64 or keys.shape != (4,):
        raise ValueError("node_inputs: keys must be (4,) int64")
    if out.mask.shape != (2, F):
        raise ValueError("node_inputs: a NodeBuf of %d features" % F)
    if (opts.sets is not None and (used is None or out.compat is None)) or (
            out.delta is not None and (sums is None or tree_used is None)):
        raise ValueError("node_inputs: constraint sets need `used`, CEGB "
                         "needs `sums` and `tree_used`")
    if fmask.device.type == "cpu":
        node_inputs_plain(out, keys, r, leaf, leaf1, p, opts=opts,
                          fmask=fmask, num_bins=num_bins, coupled=coupled,
                          hp=hp, sums=sums, used=used, tree_used=tree_used,
                          live=live)
        return
    leaf_t = leaf if isinstance(leaf, torch.Tensor) else None
    sets = opts.sets
    a = NodeArgs(
        keys=keys.data_ptr(), live=_ptr(live), leaf_ptr=_ptr(leaf_t),
        sums=_ptr(sums), used=_ptr(used), tree_used=_ptr(tree_used),
        fmask=fmask.data_ptr(), num_bins=num_bins.data_ptr(),
        sets=_ptr(sets), coupled=coupled.data_ptr(),
        mask=out.mask.data_ptr(), thr=_ptr(out.thr), delta=_ptr(out.delta),
        compat=_ptr(out.compat),
        F=F, P=p, r=int(r), leaf0=0 if leaf_t is not None else int(leaf),
        leaf1=int(leaf1), S=0 if sets is None else int(sets.shape[0]),
        kth=int(opts.kth), bynode=int(bool(opts.kth)),
        tradeoff=float(hp.cegb_tradeoff),
        penalty_split=float(hp.cegb_penalty_split))
    NODE_KERNEL.launch(ctypes.addressof(a), stream_of(fmask))
