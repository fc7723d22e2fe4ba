"""Row and column samplers (PyTorch port of the samplers of
``lightgbm_tpu/fused.py``).

Bagging, balanced bagging, GOSS and ``feature_fraction`` draw their masks
from the port's threefry (``prng.py``), keyed by ``bagging_seed`` and
``feature_fraction_seed`` alone, exactly as the JAX package keys them: the
same config gives the same masks in both packages, bit for bit. The draws
are torch operations on the device of the tensors they are given, with
no host round trip. The fused K-iteration block that the JAX module also
holds is later work (ROADMAP A9).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .prng import Key, PRNGKey, fold_in, uniform

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
