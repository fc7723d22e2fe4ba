#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``lightgbm_tpu_torch``).

    python3 chip_smoke.py [--seed 0] [--trees 40] [--leaves 255]

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
the checkout it sits in. Seven phases, each fatal on failure:

1. build     -- compile the hand-written kernels (``csrc/*.cu``: five
                sources, seven entry points), one nvcc per source, started
                together.
2. kernels   -- hold each kernel against its plain torch twin on the card:
                the forest kernel on small seeded packs covering every
                branch (numerical, NaN-missing, categorical, multiclass
                K=3, linear, linear + NaN); the row router with and without
                EFB bundle columns; the segment partition on both layouts
                (bytes and left counts equal: unaligned starts, empty
                sides, a segment under one block, one row, an EFB bundle
                column; rows of W = F + 12 and F + 3 bytes, F = 27 and 28);
                the segment histogram on both layouts (counts equal; g/h
                within the f32 summation bound ``ops.histogram.
                sum_error_bound`` of the twin's float64 sum of the same
                per-row values; hi/lo and bf16 modes; 0 rows to 9000;
                bit-equal run to run; the rows kernel bit-equal to the
                planes kernel on the same rows); the int8 histogram
                (byte-equal to its twin and run to run). Again at 2M rows
                after phases 3 and 4, on their data and first root splits.
                Leaf ids must be equal, scores within SCORE_ATOL +
                SCORE_RTOL * |b|.
3. planes    -- the slice-2 training path: 2,000,000 Higgs-shaped rows x
                28 features (max_bin=255), ``objective=binary``,
                ``num_leaves=255``, ``--trees`` iterations through
                ``lightgbm_tpu_torch.train`` with a 100,000-row valid set.
                Launch counts are zeroed just before and read just after:
                the partition, histogram and router kernels must have run.
                Every tree's leaf segment counts must equal the router's
                per-leaf row counts and sum to N, and the histogram count
                channel the in-bag rows. Two 3-iteration runs must give
                byte-equal model strings; 3 iterations on 200,000 rows on
                the card and on the host (the plain twins) must agree in
                train logloss within LOGLOSS_TOL.
4. quantized -- the slice-3 path, the same data and trees with
                QUANT_PARAMS (int8 quantized gradients, bagging 0.8, column
                sampling 0.8) on the rows layout: the rows partition, the
                int8 histogram and the router must have run; the same
                per-tree checks (the int8 count channel = the in-bag rows);
                byte-equal determinism; card vs host on 200,000 rows with
                every split of the first tree equal; valid AUC within
                AUC_TOL of phase 3's at the same number of trees.
5. short runs -- unquantized rows layout vs planes, 200,000 rows x 3
                trees on the card: byte-equal model strings (the rows
                histogram kernel must have run); GOSS on the card vs the
                host.
6. serve     -- the quantized model through every serving entry point:
                PredictSession requests of 1, 256, 4096 and 65536 rows, 64
                concurrent MicroBatcher submits, loopback ``POST /predict``
                and ``predict_binned`` over 2,000,000 binned rows, counts
                zeroed just before and read just after (forest and router
                must have run); every answer against the plain path and, on
                a small input, the host tree walk.
7. timings   -- each kernel's ms (CUDA events), its plain twin's ms, one
                library call's ms where torch has one, and its bound at the
                main path's shapes, beside the card's name and power limit.

The second-to-last line of output is the ``kernels`` JSON object; the last
is ``{"ok": true, "device": {...}}``. Without a card, or outside the
checkout, the script exits non-zero and prints no result.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

#: score tolerance kernel vs plain twin: f32 sums of up to 100 leaf
#: values, in one order in the kernel and possibly another in torch's
#: reductions, plus FMA contraction in the linear-leaf dot products
SCORE_RTOL = 1e-5
SCORE_ATOL = 1e-5

#: train logloss after 3 iterations, card vs host: the histogram sums run
#: in another order, so near-tie splits may flip between the two
LOGLOSS_TOL = 1e-3

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores (the routing work is scalar)
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12

HIGGS_FEATURES = 28
TRAIN_ROWS = 2_000_000
VALID_ROWS = 100_000
BINNED_ROWS = 2_000_000
REQUEST_ROWS = (1, 256, 4096, 65536)
TRAIN_PARAMS = {"objective": "binary", "max_bin": 255, "num_leaves": 255,
                "verbosity": -1}
#: the slice-3 configuration: int8 quantized gradients, bagging and column
#: sampling on top of TRAIN_PARAMS (trains on the rows work layout)
QUANT_PARAMS = {"use_quantized_grad": True, "bagging_fraction": 0.8,
                "bagging_freq": 1, "feature_fraction": 0.8}
#: GOSS samples from iteration 1 / learning_rate on: 2 here
GOSS_PARAMS = {"data_sample_strategy": "goss", "learning_rate": 0.5}
#: valid AUC, quantized and sampled model vs the unquantized planes model
#: at the same number of trees
AUC_TOL = 0.01


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------- data

def higgs_like(rng, n):
    """(n, 28) rows shaped like UCI HIGGS: 21 low-level features (lepton
    and 4 jets: pT, eta, phi, jet b-tags on 3 levels; missing energy
    magnitude and phi) and 7 high-level masses. Quantised to 1/1024 so
    every value and bin midpoint is float32-exact (raw-threshold and BIN
    routing then agree on every row)."""
    import numpy as np
    cols = []

    def pt():
        return rng.lognormal(-0.1, 0.45, n)

    def eta():
        return rng.normal(0.0, 1.0, n)

    def phi():
        return rng.uniform(-1.74, 1.74, n)

    cols += [pt(), eta(), phi(), pt(), phi()]        # lepton, missing E
    for _ in range(4):                               # jets
        btag = rng.choice([0.0, 1.087, 2.173], size=n, p=[0.55, 0.25, 0.2])
        cols += [pt(), eta(), phi(), btag]
    for _ in range(7):                               # m_jj ... m_wwbb
        cols.append(rng.lognormal(0.0, 0.3, n))
    X = np.stack(cols, axis=1)
    return np.round(X * 1024.0) / 1024.0


def construct(X, params, reference=None):
    from lightgbm_tpu_torch import Dataset
    return Dataset(X, params=params, reference=reference).construct()


def bin_rows(ds, X):
    """Raw rows -> ((n, Fi) i32 bins, (n, Fi) f32 raw) in inner order."""
    import numpy as np
    Xr = np.ascontiguousarray(
        np.asarray(X, np.float32)[:, ds.used_feature_indices])
    bins = np.empty(Xr.shape, np.int32)
    for j in range(Xr.shape[1]):
        bins[:, j] = ds.bin_mappers[j].value_to_bin(Xr[:, j])
    return bins, Xr


def random_trees(ds, rng, num_trees, num_leaves, *, categorical=False,
                 linear=False, leaf_scale=0.05):
    """Seeded trees grown leaf-wise like the trainer's split logs: round
    r splits a uniformly drawn existing leaf on a random feature at one of
    its bin bounds (categorical features on a random subset of bins)."""
    import numpy as np
    from lightgbm_tpu_torch.ops.binning import BIN_CATEGORICAL
    from lightgbm_tpu_torch.tree import Tree

    B = int(ds.feature_num_bins().max())
    F = ds.num_features
    trees = []
    for _ in range(num_trees):
        R = num_leaves - 1
        split_leaf = np.array([rng.randint(0, r + 1) for r in range(R)])
        feat = rng.randint(0, F, R)
        sbin = np.zeros(R, np.int64)
        is_cat = np.zeros(R, bool)
        go_left = np.zeros((R, B), bool)
        for r in range(R):
            m = ds.bin_mappers[feat[r]]
            if m.bin_type == BIN_CATEGORICAL:
                if not categorical:
                    feat[r] = (feat[r] + 1) % F
                    m = ds.bin_mappers[feat[r]]
                else:
                    is_cat[r] = True
                    go_left[r, :m.num_bins] = rng.rand(m.num_bins) < 0.5
                    continue
            sbin[r] = rng.randint(0, max(1, m.num_bins - 1))
        ones = np.ones((R, 3))
        t = Tree.from_split_log(
            R, split_leaf, feat, sbin, rng.rand(R) < 0.5, np.ones(R),
            ones, ones, rng.normal(0.0, leaf_scale, num_leaves),
            bin_mappers=ds.bin_mappers,
            real_feature_index=ds.used_feature_indices,
            go_left_table=go_left, is_categorical=is_cat)
        if linear:
            num = [ds.used_feature_indices[j] for j in range(F)
                   if ds.bin_mappers[j].bin_type != BIN_CATEGORICAL]
            t.is_linear = True
            t.leaf_const = rng.normal(0.0, leaf_scale, num_leaves)
            for leaf in range(num_leaves):
                if rng.rand() < 0.2:
                    continue          # a leaf without a linear model
                k = rng.randint(1, 4)
                t.leaf_features[leaf] = np.sort(
                    rng.choice(num, size=k, replace=False)).astype(np.int64)
                t.leaf_coeff[leaf] = rng.normal(0.0, leaf_scale, k)
        trees.append(t)
    return trees


def check_scores(name, got, want):
    """max |got - want|; raises when beyond SCORE_ATOL + SCORE_RTOL|want|."""
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError("%s: shape %s != %s"
                             % (name, got.shape, want.shape))
    if not np.isfinite(got).all():
        raise AssertionError("%s: non-finite output" % name)
    err = np.abs(got - want)
    bad = err > SCORE_ATOL + SCORE_RTOL * np.abs(want)
    if bad.any():
        raise AssertionError("%s: %d/%d values off, max |diff| = %.3g"
                             % (name, int(bad.sum()), bad.size, err.max()))
    return float(err.max()) if err.size else 0.0


def id_diff(name, got, want):
    """max |got - want| over leaf ids; raises unless they are all equal."""
    import torch
    if got.shape != want.shape:
        raise AssertionError("%s: shape %s != %s"
                             % (name, tuple(got.shape), tuple(want.shape)))
    diff = (got.long() - want.long()).abs()
    if torch.count_nonzero(diff):
        raise AssertionError("%s: %d leaf ids differ"
                             % (name, int(torch.count_nonzero(diff))))
    return int(diff.max()) if diff.numel() else 0


def sync(dev):
    """Wait for the card (a fault in a kernel surfaces here)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, iters=20, warmup=2):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phases

def phase_kernels(dev, seed):
    """Every forest branch and both router layouts, kernel vs plain."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.learner import route_layout
    from lightgbm_tpu_torch.ops.forest import (forest_pack,
                                               forest_predict_impl,
                                               forest_predict_plain)
    from lightgbm_tpu_torch.ops.predict import tree_to_bin_log
    from lightgbm_tpu_torch.ops.route import (build_route_table, route_rows,
                                              route_rows_plain)

    rng = np.random.RandomState(seed + 1)
    n = 3000
    X = np.round(rng.randn(n, 10) * 16) / 64.0
    Xnan = X.copy()
    Xnan[rng.rand(n, 10) < 0.15] = np.nan
    Xcat = X.copy()
    Xcat[:, 0] = rng.randint(0, 12, n)
    Xcat[:, 3] = rng.randint(0, 5, n)
    cases = {
        "numerical": (X, {}, {}),
        "nan_missing": (Xnan, {}, {}),
        "categorical": (Xcat, {"categorical_feature": "0,3"},
                        {"categorical": True}),
        "multiclass3": (X, {}, {"num_class": 3}),
        "linear": (X, {}, {"linear": True}),
        "linear_nan": (Xnan, {}, {"linear": True}),
    }
    errs = {}
    for name, (Xc, params, opt) in cases.items():
        ds = construct(Xc, dict(params, verbosity=-1))
        K = opt.get("num_class", 1)
        trees = random_trees(ds, rng, 8 * K + 3, 31,
                             categorical=opt.get("categorical", False),
                             linear=opt.get("linear", False))
        fp, has_cat, has_lin = forest_pack(trees, ds, num_class=K,
                                           device=dev)
        if has_cat != (name == "categorical") \
                or has_lin != name.startswith("linear"):
            raise AssertionError("%s: pack flags cat=%s linear=%s"
                                 % (name, has_cat, has_lin))
        b, xr = bin_rows(ds, Xc[:1000])
        bins = torch.from_numpy(b).to(dev)
        xd = torch.from_numpy(xr).to(dev)
        kw = dict(num_class=K, has_cat=has_cat, has_linear=has_lin)
        got = forest_predict_impl(bins, xd, fp, **kw)
        want = forest_predict_plain(bins, xd, fp, **kw)
        sync(dev)
        errs["forest/" + name] = check_scores(
            "forest/" + name, got.cpu().numpy(), want.cpu().numpy())

    # router without bundles (dense) and with EFB bundle columns
    ids = rng.randint(0, 12, (n, 3))
    Xs = np.zeros((n, 36))
    for blk in range(3):
        Xs[np.arange(n), blk * 12 + ids[:, blk]] = rng.rand(n) + 0.5
    Xefb = np.concatenate([Xs, np.round(rng.randn(n, 2) * 16) / 64.0], 1)
    for name, Xc in (("dense", Xnan), ("efb_bundles", Xefb)):
        ds = construct(Xc, {"verbosity": -1})
        if (name == "efb_bundles") != ds.has_bundles:
            raise AssertionError("router/%s: has_bundles=%s"
                                 % (name, ds.has_bundles))
        bundle = None
        if ds.has_bundles:
            bundle = {k: torch.as_tensor(v).to(dev)
                      for k, v in ds.bundle_maps().items()}
        bt = route_layout(torch.as_tensor(ds.binned).to(dev))
        err = 0
        for tree in random_trees(ds, rng, 4, 63):
            lg = tree_to_bin_log(tree, ds, dev)
            table = build_route_table(lg, bundle)
            got = route_rows(bt, table, lg.num_splits)
            want = route_rows_plain(bt, table, lg.num_splits)
            sync(dev)
            err = max(err, id_diff("router/" + name, got, want))
        errs["router/" + name] = float(err)
        if name == "efb_bundles":
            # the partition on a bundle column of the EFB matrix
            bt_rows = torch.as_tensor(ds.binned)
            g = int(np.argmax([len(gr.feature_indices) for gr in ds.groups]))
            table = torch.as_tensor(
                rng.rand(int(ds.group_num_bins().max())) < 0.4)
            work = seeded_work(rng, bt_rows, dev)
            errs["partition/bundle_column"] = check_partition(
                "partition/bundle_column", work, [0, 128 + 7, n - 9, g],
                table.to(dev))
    errs.update(phase_segment_kernels(dev, rng))
    errs.update(phase_rows_kernels(dev, rng))
    return errs


def seeded_work(rng, bins, dev, guard=128):
    """(2, W, Npad) work pair: plane 0 packs ``bins`` (N, G) u8 with seeded
    g/h/cnt at lane guard + i, plane 1 is junk."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.partition import pack_planes, planes_npad

    n, gcols = bins.shape
    ghc = np.stack([rng.randn(n) * 2, np.abs(rng.randn(n)) + 0.01,
                    np.ones(n)], axis=1).astype(np.float32)
    npad = planes_npad(n, guard)
    work = torch.as_tensor(rng.randint(0, 256, (2, gcols + 12, npad))
                           .astype(np.uint8))
    work[0, :, guard:guard + n] = pack_planes(bins, torch.as_tensor(ghc))
    return work.to(dev)


def check_partition(name, work, seg, table, rows=False):
    """Kernel (on a CUDA tensor) vs plain twin, planes or rows layout: the
    whole buffer and the left count must be equal. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P

    kernel, plain = (P.partition_segment_rows, P.partition_segment_rows_plain) \
        if rows else (P.partition_segment, P.partition_segment_plain)
    a, b = work.clone(), work.clone()
    sg = torch.tensor(seg, dtype=torch.int32, device=work.device)
    lt_a = kernel(a, sg, table, max(seg[2], 1))
    lt_b = plain(b, sg, table)
    sync(work.device)
    if int(lt_a) != int(lt_b):
        raise AssertionError("%s: lt %d != %d" % (name, int(lt_a), int(lt_b)))
    if not torch.equal(a, b):
        raise AssertionError("%s: %d bytes differ" % (
            name, int(torch.count_nonzero(a != b))))
    return 0.0


def abs_work(work, num_feat, rows=False):
    """The work pair with |g| and |h| in place of g and h (for the per-bin
    sum of |x| that scales the histogram tolerance)."""
    from lightgbm_tpu_torch.ops.partition import (pack_planes, pack_rows,
                                                  unpack_ghc,
                                                  unpack_ghc_planes)

    w = work.clone()
    for p in (0, 1):
        if rows:
            ghc = unpack_ghc(w[p], num_feat).abs().nan_to_num(0.0)
            w[p] = pack_rows(w[p, :, :num_feat], ghc)
        else:
            ghc = unpack_ghc_planes(w[p], num_feat).abs().nan_to_num(0.0)
            w[p] = pack_planes(w[p, :num_feat].t(), ghc.t())
    return w


def check_histogram(name, work, seg, num_bins, num_feat, exact, rows=False):
    """Kernel vs plain twin, planes or rows layout: counts equal, g/h
    within the kernel's f32 summation bound of the twin's exact sum, the
    same bits run to run; on the rows layout also the same bits as the
    planes kernel on the same rows. Returns max |diff|."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    kernel, plain = (H.segment_histogram_rows, H.segment_histogram_rows_plain) \
        if rows else (H.segment_histogram, H.segment_histogram_plain)
    sg = torch.tensor(seg, dtype=torch.int32, device=work.device)
    kw = dict(num_bins=num_bins, num_feat=num_feat, exact=exact)
    got = kernel(work, sg, cnt_bound=max(seg[2], 1), **kw)
    want = plain(work, sg, **kw)
    absum = plain(abs_work(work, num_feat, rows), sg, **kw)
    sync(work.device)
    if not torch.equal(got[..., 2], want[..., 2]):
        raise AssertionError("%s: count channel differs" % name)
    diff = (got - want).abs()
    bound = H.sum_error_bound(seg[2]) * absum
    if not torch.isfinite(got).all() or (diff > bound).any():
        raise AssertionError("%s: g/h off, max |diff| %.3g"
                             % (name, float(diff.max())))
    if seg[2] and not torch.equal(
            got, kernel(work, sg, cnt_bound=seg[2], **kw)):
        raise AssertionError("%s: not bit-equal run to run" % name)
    if rows:
        planes = work.transpose(1, 2).contiguous()
        other = H.segment_histogram(planes, sg, cnt_bound=max(seg[2], 1),
                                    **kw)
        if not torch.equal(got.view(torch.int32), other.view(torch.int32)):
            raise AssertionError("%s: rows and planes kernels differ" % name)
    return float(diff.max())


def check_histogram_q(name, work, seg, num_bins, num_feat, scale):
    """int8 kernel vs plain twin: byte-equal, and the same bytes run to
    run. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (segment_histogram_q,
                                                  segment_histogram_q_plain)

    sg = torch.tensor(seg, dtype=torch.int32, device=work.device)
    kw = dict(num_bins=num_bins, num_feat=num_feat)
    got = segment_histogram_q(work, sg, scale, cnt_bound=max(seg[2], 1), **kw)
    want = segment_histogram_q_plain(work, sg, scale, **kw)
    again = segment_histogram_q(work, sg, scale, cnt_bound=max(seg[2], 1),
                                **kw)
    sync(work.device)
    if not torch.isfinite(got).all() \
            or not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("%s: %d values differ from the twin" % (
            name, int(torch.count_nonzero(got != want))))
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("%s: not byte-equal run to run" % name)
    return 0.0


def seeded_rows_work(rng, bins, dev, quantized=False, guard=128):
    """(2, Npad, W) rows pair: buffer 0 packs ``bins`` (N, G) u8 with seeded
    g/h/cnt at row guard + i (a fifth of the rows out of bag: g = h = cnt
    = 0), int8 with a seeded dither when ``quantized``; buffer 1 is junk.
    Returns (work, the (3,) dequantization scale or None)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.histogram import dequant_scale
    from lightgbm_tpu_torch.ops.partition import (pack_rows,
                                                  pack_rows_quantized,
                                                  planes_npad,
                                                  quantize_scales, work_spec)
    from lightgbm_tpu_torch.prng import PRNGKey

    n, gcols = bins.shape
    m = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = torch.as_tensor(np.stack([rng.randn(n) * 2 * m,
                                    (np.abs(rng.randn(n)) + 0.01) * m, m],
                                   axis=1).astype(np.float32))
    _, width = work_spec(gcols, quantized)
    work = torch.as_tensor(rng.randint(0, 256, (2, planes_npad(n, guard),
                                                width)).astype(np.uint8))
    scale = None
    if quantized:
        scales = quantize_scales(ghc)
        work[0, guard:guard + n] = pack_rows_quantized(
            bins, ghc, PRNGKey(int(rng.randint(1 << 30))), scales)
        scale = dequant_scale(scales).to(dev)
    else:
        work[0, guard:guard + n] = pack_rows(bins, ghc)
    return work.to(dev), scale


#: (name, [src, start, cnt, feat], table) of the partition cases over a
#: 9000-row segment buffer: "table", all left ("all") or all right ("none")
PART_CASES = (("unaligned", [0, 128 + 13, 7001, 3], "table"),
              ("whole", [0, 128, 9000, 0], "table"),
              ("under_one_block", [0, 128 + 4095, 300, 5], "table"),
              ("empty_left", [0, 128 + 100, 777, 2], "none"),
              ("empty_right", [0, 128 + 100, 777, 2], "all"),
              ("one_row", [0, 128 + 8999, 1, 9], "table"))
#: (name, [plane, start, cnt]) of the histogram cases
HIST_CASES = (("whole", [0, 128, 9000]), ("unaligned", [0, 128 + 13, 7001]),
              ("one_row", [0, 128 + 77, 1]), ("empty", [0, 128 + 5, 0]))


def phase_segment_kernels(dev, rng):
    """Partition and segment histogram on the planes layout, kernel vs
    plain, small cases."""
    import numpy as np
    import torch

    n, nb = 9000, 64
    bins = torch.as_tensor(rng.randint(0, nb, (n, 10)).astype(np.uint8))
    work = seeded_work(rng, bins, dev)
    tables = _tables(rng, nb, dev)
    errs = {}
    for name, seg, tbl in PART_CASES:
        key = "partition/" + name
        errs[key] = check_partition(key, work, seg, tables[tbl])
    for exact in (True, False):
        for name, seg in HIST_CASES:
            key = "histogram/%s/%s" % ("hilo" if exact else "bf16", name)
            errs[key] = check_histogram(key, work, seg, nb, 10, exact)
    return errs


def _tables(rng, nb, dev):
    import torch
    none = torch.zeros(nb, dtype=torch.bool, device=dev)
    return {"table": torch.as_tensor(rng.rand(nb) < 0.45).to(dev),
            "none": none, "all": ~none}


def phase_rows_kernels(dev, rng):
    """The rows partition, the rows histogram and the int8 histogram,
    kernel vs plain, small cases: W = F + 12 and F + 3, F = 27 (its f32
    words start unaligned) and 28."""
    import numpy as np
    import torch

    n, nb = 9000, 64
    tables = _tables(rng, nb, dev)
    errs = {}
    for F, quantized in ((27, False), (28, True), (27, True)):
        bins = torch.as_tensor(rng.randint(0, nb, (n, F)).astype(np.uint8))
        work, scale = seeded_rows_work(rng, bins, dev, quantized)
        tag = "w%d" % work.shape[2]
        for name, seg, tbl in PART_CASES:
            key = "partition_rows/%s/%s" % (tag, name)
            errs[key] = check_partition(key, work, seg, tables[tbl],
                                        rows=True)
        if quantized:
            for name, seg in HIST_CASES:
                key = "histogram_q/%s/%s" % (tag, name)
                errs[key] = check_histogram_q(key, work, seg, nb, F, scale)
            continue
        for exact in (True, False):
            for name, seg in HIST_CASES:
                key = "histogram_rows/%s/%s/%s" % (
                    tag, "hilo" if exact else "bf16", name)
                errs[key] = check_histogram(key, work, seg, nb, F, exact,
                                            rows=True)
    return errs


def higgs_labels(rng, X):
    """0/1 labels with a learnable signal: the high-level masses and the
    lepton pT push toward "signal", as they do in HIGGS."""
    import numpy as np
    s = 1.5 * np.log(X[:, 21:28]).mean(axis=1) + 0.6 * np.log(X[:, 0]) \
        - 0.4 * np.abs(X[:, 1]) + 0.3 * (X[:, 8] > 0) \
        - 0.2 * np.log(X[:, 3])
    p = 1.0 / (1.0 + np.exp(-2.5 * s))
    return (rng.rand(len(X)) < p).astype(np.float64)


def training_data(seed, train_rows, valid_rows):
    """Seeded (X, y, X_valid, y_valid), Higgs-shaped."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = higgs_like(rng, train_rows + valid_rows)
    y = higgs_labels(rng, X)
    return X[:train_rows], y[:train_rows], X[train_rows:], y[train_rows:]


def train_params(dev, leaves, extra=None):
    return dict(TRAIN_PARAMS, num_leaves=leaves, device_type=dev.type,
                metric=["auc", "binary_logloss"], **(extra or {}))


def build_datasets(dev, data, leaves, extra=None):
    """The binned (train, valid) Datasets of a training phase (``train``
    re-bins a Dataset built with other params, so each phase builds its
    own)."""
    import lightgbm_tpu_torch as lgt
    X, y, Xv, yv = data
    t0 = time.perf_counter()
    train = lgt.Dataset(X, label=y, params=train_params(dev, leaves, extra))
    train.construct()
    valid = lgt.Dataset(Xv, label=yv, reference=train)
    valid.construct()
    log("train: binned %d + %d rows on the host in %.1f s"
        % (len(X), len(Xv), time.perf_counter() - t0))
    return train, valid


def phase_train(dev, datasets, trees, leaves, extra=None):
    """The training path: ``lightgbm_tpu_torch.train`` at full width with a
    valid set, ``extra`` params on TRAIN_PARAMS; every tree's segment
    counts checked against the router (all rows) and its histograms' count
    channel against the in-bag rows. Returns (booster, launch counts,
    summary dict)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels

    train, valid = datasets
    params = train_params(dev, leaves, extra)
    n = len(train.label)
    checked = []

    def check_tree(env):
        g = env.model.inner
        st = g.learner.last_stats
        ns = st["num_splits"]
        cnt = st["leaf_cnt"][:ns + 1].long()
        leaf = st["row_leaf"].long()
        routed = torch.bincount(leaf, minlength=ns + 1)
        inbag = torch.bincount(leaf, weights=g._inbag.double(),
                               minlength=ns + 1)
        hist = st["hist_cnt"][:ns + 1].double()
        if int(cnt.sum()) != n or not torch.equal(cnt, routed[:ns + 1]) \
                or not torch.equal(hist, inbag[:ns + 1]):
            raise AssertionError("tree %d: leaf segment counts disagree "
                                 "with the router or the histograms' "
                                 "in-bag counts" % env.iteration)
        checked.append(ns)

    evals = {}
    sync(dev)
    kernels.reset_launch_counts()
    if dev.type == "cuda":
        kernels.start_timing()
    t0 = time.perf_counter()
    bst = lgt.train(params, train, trees, valid_sets=[valid],
                    callbacks=[check_tree, lgt.record_evaluation(evals)])
    sync(dev)
    wall = time.perf_counter() - t0
    dev_ms = kernels.stop_timing() if dev.type == "cuda" else {}
    counts = kernels.launch_counts()
    if len(checked) != trees:
        raise AssertionError("checked %d trees of %d" % (len(checked), trees))
    auc = evals["valid_0"]["auc"][-1]
    ll = evals["valid_0"]["binary_logloss"][-1]
    if not (np.isfinite(ll) and 0.5 < auc <= 1.0):
        raise AssertionError("valid auc %.4f logloss %.4f" % (auc, ll))
    summary = dict(trees=trees, splits=int(sum(checked)), wall_s=wall,
                   wall_per_tree_ms=wall / trees * 1e3, valid_auc=auc,
                   valid_logloss=ll,
                   layout=bst.inner.learner._kw["work_layout"],
                   kernel_ms_per_tree={k: v / trees for k, v in dev_ms.items()
                                       if v})
    log("train %s: %d trees x %d leaves on %d rows (%s layout) in %.2f s "
        "(%.1f ms/tree), %d splits; valid auc %.5f logloss %.5f; "
        "launches %s" % (json.dumps(extra or {}), trees, leaves, n,
                         summary["layout"], wall, summary["wall_per_tree_ms"],
                         summary["splits"], auc, ll, counts))
    if dev_ms:
        log("train: device ms per tree %s" % ", ".join(
            "%s %.3f" % kv for kv in summary["kernel_ms_per_tree"].items()))
    return bst, counts, summary


def check_determinism(dev, train, leaves, iters=3, extra=None):
    """Two card runs of ``iters`` iterations: byte-equal model strings."""
    import lightgbm_tpu_torch as lgt
    params = train_params(dev, leaves, extra)
    a = lgt.train(params, train, iters).model_to_string()
    b = lgt.train(params, train, iters).model_to_string()
    if a != b:
        raise AssertionError("two runs gave different model strings")
    log("determinism %s: %d iterations twice, model strings byte-equal "
        "(%d bytes)" % (json.dumps(extra or {}), iters, len(a)))


def profile_iteration(dev, train, leaves, extra=None):
    """One boosting iteration (after a warm-up one) under torch.profiler:
    device time by kernel name and the device's busy share of the wall.
    Returns a dict; kernel times are None when the profiler saw no device
    activity."""
    import torch
    import lightgbm_tpu_torch as lgt
    from torch.profiler import ProfilerActivity, profile

    bst = lgt.Booster(train_params(dev, leaves, extra), train)
    bst.update()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.key not in by_name:
            by_name[ev.key] = us / 1e3
    # kernels only (not the cudaLaunchKernel host events): names of device
    # events; their sum over the wall is the busy share
    kern = {k: v for k, v in by_name.items()
            if not k.startswith("cuda") and not k.startswith("aten::")}
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    log("profile %s: one iteration, wall %.1f ms, device busy %.1f ms "
        "(%.1f%%); top kernels %s" % (json.dumps(extra or {}), wall_ms, busy,
                                      100.0 * busy / wall_ms,
                              ", ".join("%s %.2f" % kv for kv in top)))
    return dict(wall_ms=wall_ms, device_busy_ms=busy if kern else None,
                top=top)


def card_vs_host(dev, data, rows, leaves, iters=3, extra=None,
                 first_tree_equal=False):
    """The same small training on the card and on the host (plain twins):
    splits that agree (every split of the first tree when
    ``first_tree_equal``), and train logloss within LOGLOSS_TOL."""
    import lightgbm_tpu_torch as lgt
    X, y = data[0][:rows], data[1][:rows]
    out = {}
    for name, d in (("card", dev.type), ("host", "cpu")):
        params = dict(train_params(dev, leaves, extra), device_type=d,
                      metric=["binary_logloss"])
        ds = lgt.Dataset(X, label=y, params=params)
        t0 = time.perf_counter()
        bst = lgt.train(params, ds, iters)
        out[name] = (bst, time.perf_counter() - t0,
                     bst.eval_train()[0][2])
    (ca, ta, la), (ho, th, lh) = out["card"], out["host"]
    agree = total = 0
    first = None
    for a, b in zip(ca.inner.models, ho.inner.models):
        k = max(a.num_internal, b.num_internal)
        total += k
        same = 0
        for r in range(min(a.num_internal, b.num_internal)):
            if (a.split_feature[r], a.threshold[r]) != \
                    (b.split_feature[r], b.threshold[r]):
                break
            same += 1
        agree += same
        if first is None:
            first = (same, k)
    log("card vs host %s: %d rows x %d iterations; %d of %d splits agree "
        "(in order, up to the first difference per tree; first tree %d of "
        "%d); train logloss card %.7f host %.7f; card %.1f s, host %.1f s"
        % (json.dumps(extra or {}), rows, iters, agree, total, first[0],
           first[1], la, lh, ta, th))
    if abs(la - lh) > LOGLOSS_TOL:
        raise AssertionError("train logloss card %.6f vs host %.6f"
                             % (la, lh))
    if first_tree_equal and first[0] != first[1]:
        raise AssertionError("first tree: %d of %d splits agree" % first)
    return dict(splits_agree=agree, splits=total, first_tree=first,
                logloss_card=la, logloss_host=lh)


def rows_vs_planes(dev, data, rows, leaves, iters=3):
    """Unquantized training on the rows layout against the planes layout
    on the card: byte-equal model strings (the two layouts hold the same
    rows in the same order and their histogram kernels share one body).
    Launch counts are zeroed before the rows run and read after it."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels
    X, y = data[0][:rows], data[1][:rows]
    ds = lgt.Dataset(X, label=y, params=train_params(dev, leaves))
    planes = lgt.train(train_params(dev, leaves), ds, iters)
    sync(dev)
    kernels.reset_launch_counts()
    rows_bst = lgt.train(train_params(dev, leaves,
                                      {"tpu_work_layout": "rows"}), ds, iters)
    sync(dev)
    counts = kernels.launch_counts()
    a, b = planes.model_to_string(), rows_bst.model_to_string()
    log("rows vs planes: %d rows x %d iterations, model strings %s (%d "
        "bytes); rows launches %s" % (rows, iters,
                                      "byte-equal" if a == b else "DIFFER",
                                      len(a), counts))
    if a != b:
        raise AssertionError("rows and planes layouts grew different models")
    for name in ("partition_segment_rows", "segment_histogram_rows"):
        if counts.get(name, 0) <= 0:
            raise AssertionError("the rows run never launched %s" % name)
    return counts


def full_width_segment_kernels(bst, dev, errs):
    """Partition and histogram kernels vs their twins at the training
    shapes: the root segment of all rows, with the trained first tree's
    root split; then each kernel's ms, twin ms, library ms and bound."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.histogram import segment_histogram_plain
    from lightgbm_tpu_torch.ops.partition import (partition_segment,
                                                  partition_segment_plain,
                                                  planes_npad, work_spec,
                                                  pack_planes_fold_root)

    g = bst.inner
    lrn = g.learner
    bins = lrn.bins
    n, F = bins.shape
    B = lrn.num_bin_hist
    grad, hess = g.objective.get_gradients(g.train_score.score)
    ghc = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
    guard, width = work_spec(F)
    work = torch.zeros((2, width, planes_npad(n, guard)), dtype=torch.uint8,
                       device=dev)
    pack_planes_fold_root(work, bins, ghc, guard, num_bins=B, exact=True)
    t0 = g.models[0]
    feat = g.train_set.inner_feature_index(int(t0.split_feature[0]))
    table = torch.arange(B, device=dev) <= int(t0.split_bin[0])
    seg = [0, guard, n, feat]
    errs["partition/full_width"] = check_partition(
        "partition/full_width", work, seg, table)
    for exact in (True, False):
        key = "histogram/%s/full_width" % ("hilo" if exact else "bf16")
        errs[key] = check_histogram(key, work, seg[:3], B, F, exact)
    rows = {}
    sg4 = torch.tensor(seg, dtype=torch.int32, device=dev)
    sg3 = sg4[:3].contiguous()
    from lightgbm_tpu_torch.ops.histogram import segment_histogram
    p_ms = cuda_ms(lambda: partition_segment(work, sg4, table, n))
    pp_ms = cuda_ms(lambda: partition_segment_plain(work, sg4, table),
                    iters=3, warmup=1)
    h_ms = cuda_ms(lambda: segment_histogram(work, sg3, num_bins=B,
                                             num_feat=F, cnt_bound=n))
    hp_ms = cuda_ms(lambda: segment_histogram_plain(work, sg3, num_bins=B,
                                                    num_feat=F),
                    iters=3, warmup=1)
    # library yardstick: one index_add_ over precomputed flat (f*B + bin)
    # indices and the rows' (g, h, cnt) repeated per feature; the timed
    # window holds the zeroed (F*B, 3) output and the index_add_ only
    idx = (bins.long() + torch.arange(F, device=dev) * B).t().reshape(-1)
    vals = ghc.repeat(F, 1)
    out = torch.zeros((F * B, 3), device=dev)
    l_ms = cuda_ms(lambda: out.zero_().index_add_(0, idx, vals))
    rows["partition_segment"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/partition_segment.cu",
        replaces="lightgbm_tpu/ops/partition.py:1249",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("partition/")),
        ms=p_ms, plain_ms=pp_ms, library_ms=None,
        bytes=2 * width * n, ops=n)
    rows["segment_histogram"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/segment_histogram.cu",
        replaces="lightgbm_tpu/ops/histogram.py:698",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("histogram/")),
        ms=h_ms, plain_ms=hp_ms, library_ms=l_ms,
        bytes=(F + 12) * n + F * B * 3 * 4, ops=n * F * 5)
    log("full width: partition %.4f ms (twin %.2f), histogram %.4f ms "
        "(twin %.2f, index_add_ %.4f) over %d rows x %d columns"
        % (p_ms, pp_ms, h_ms, hp_ms, l_ms, n, F))
    return rows


def full_width_rows_kernels(bst, dev, errs, timed=True):
    """The rows partition, the rows histogram and the int8 histogram vs
    their twins at the quantized training's shapes: the root segment of
    all rows, packed as that training packs it (int8, W = F + 3) and,
    for the rows histogram, unquantized (W = F + 12); the partition with
    the trained first tree's root split. Then, when ``timed`` (on the
    card), each kernel's ms, twin ms, library ms and bound."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.prng import PRNGKey, fold_in

    g = bst.inner
    lrn = g.learner
    bins = lrn.bins
    n, F = bins.shape
    B = lrn.num_bin_hist
    grad, hess = g.objective.get_gradients(g.train_score.score)
    m = g._inbag
    ghc = torch.stack([grad * m, hess * m, m], dim=1)
    guard, _ = P.work_spec(F, True)
    qwork = P.work_buffer(n, F, "rows", True, dev)
    scales = P.quantize_scales(ghc)
    scale = H.dequant_scale(scales)
    qwork[0, guard:guard + n] = P.pack_rows_quantized(
        bins, ghc, fold_in(PRNGKey(0), 987123), scales,
        offset=lrn._kw["dither_offset"])
    fwork = P.work_buffer(n, F, "rows", False, dev)
    fwork[0, guard:guard + n] = P.pack_rows(bins, ghc)
    t0 = g.models[0]
    feat = g.train_set.inner_feature_index(int(t0.split_feature[0]))
    table = torch.arange(B, device=dev) <= int(t0.split_bin[0])
    seg = [0, guard, n, feat]
    errs["partition_rows/full_width"] = check_partition(
        "partition_rows/full_width", qwork, seg, table, rows=True)
    errs["histogram_q/full_width"] = check_histogram_q(
        "histogram_q/full_width", qwork, seg[:3], B, F, scale)
    errs["histogram_rows/full_width"] = check_histogram(
        "histogram_rows/full_width", fwork, seg[:3], B, F, True, rows=True)
    if not timed:
        return {}
    sg4 = torch.tensor(seg, dtype=torch.int32, device=dev)
    sg3 = sg4[:3].contiguous()
    p_ms = cuda_ms(lambda: P.partition_segment_rows(qwork, sg4, table, n))
    pp_ms = cuda_ms(lambda: P.partition_segment_rows_plain(qwork, sg4, table),
                    iters=3, warmup=1)
    h_ms = cuda_ms(lambda: H.segment_histogram_rows(
        fwork, sg3, num_bins=B, num_feat=F, cnt_bound=n))
    hp_ms = cuda_ms(lambda: H.segment_histogram_rows_plain(
        fwork, sg3, num_bins=B, num_feat=F), iters=3, warmup=1)
    q_ms = cuda_ms(lambda: H.segment_histogram_q(
        qwork, sg3, scale, num_bins=B, num_feat=F, cnt_bound=n))
    qp_ms = cuda_ms(lambda: H.segment_histogram_q_plain(
        qwork, sg3, scale, num_bins=B, num_feat=F), iters=3, warmup=1)
    # library yardsticks: one index_add_ over precomputed flat (f*B + bin)
    # indices with the rows' channels repeated per feature, f32 (g, h, cnt)
    # for the rows histogram, the int8 bytes as int32 for the int8 one
    idx = (bins.long() + torch.arange(F, device=dev) * B).t().reshape(-1)
    vals = ghc.repeat(F, 1)
    out = torch.zeros((F * B, 3), device=dev)
    l_ms = cuda_ms(lambda: out.zero_().index_add_(0, idx, vals))
    gq, hq, cq = P.unpack_ghq(qwork[0, guard:guard + n], F)
    qvals = torch.stack([gq.int(), hq.int(), cq.int()], dim=1).repeat(F, 1)
    qout = torch.zeros((F * B, 3), dtype=torch.int32, device=dev)
    lq_ms = cuda_ms(lambda: qout.zero_().index_add_(0, idx, qvals))
    inbag = int(m.sum())
    W = qwork.shape[2]

    def err(prefix):
        return max(v for k, v in errs.items() if k.startswith(prefix))

    rows = {
        "partition_segment_rows": dict(
            route="cuda",
            source="lightgbm_tpu_torch/csrc/partition_segment.cu",
            replaces="lightgbm_tpu/ops/partition.py:908",
            max_abs_err=err("partition_rows/"), ms=p_ms, plain_ms=pp_ms,
            library_ms=None, bytes=2 * W * n, ops=n),
        "segment_histogram_rows": dict(
            route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_histogram.cu",
            replaces="lightgbm_tpu/ops/histogram.py:385",
            max_abs_err=err("histogram_rows/"), ms=h_ms, plain_ms=hp_ms,
            library_ms=l_ms, bytes=(F + 12) * n + F * B * 3 * 4,
            ops=n * F * 5),
        "segment_histogram_q": dict(
            route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_histogram_q.cu",
            replaces="lightgbm_tpu/ops/histogram.py:891",
            max_abs_err=err("histogram_q/"), ms=q_ms, plain_ms=qp_ms,
            library_ms=lq_ms, bytes=(F + 3) * n + F * B * 3 * 4,
            ops=inbag * F * 3),
    }
    log("full width rows: partition %.4f ms (twin %.2f) at W = %d, rows "
        "histogram %.4f ms (twin %.2f, index_add_ %.4f), int8 histogram "
        "%.4f ms (twin %.2f, int32 index_add_ %.4f) over %d rows x %d "
        "columns, %d in bag" % (p_ms, pp_ms, W, h_ms, hp_ms, l_ms, q_ms,
                                qp_ms, lq_ms, n, F, inbag))
    return rows


def phase_serve(bst, train, rng, binned_rows):
    """The main path; returns (outputs to check, launch counts)."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.serve import (MicroBatcher, PredictServer,
                                          PredictSession)

    reqs = {n: higgs_like(rng, n) for n in REQUEST_ROWS}
    mb_rows = [higgs_like(rng, 1 + int(rng.randint(0, 64)))
               for _ in range(64)]
    http_rows = [higgs_like(rng, 16) for _ in range(3)]
    Xb = higgs_like(rng, binned_rows)
    t0 = time.perf_counter()
    binned = lgt.Dataset(Xb, reference=train).construct()
    log("serve: binned %d rows on the host in %.1f s"
        % (binned_rows, time.perf_counter() - t0))

    out = {"reqs": reqs, "mb_rows": mb_rows, "http_rows": http_rows,
           "Xb": Xb}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sess = PredictSession(bst)
    out["session"] = {n: sess.predict(X) for n, X in reqs.items()}
    with MicroBatcher(PredictSession(bst), max_batch_rows=4096) as mb:
        futs = [None] * len(mb_rows)

        def submit(i):
            futs[i] = mb.submit(mb_rows[i])

        ths = [threading.Thread(target=submit, args=(i,))
               for i in range(len(mb_rows))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
        out["batcher"] = [f.result(timeout=120) for f in futs]
    server = PredictServer(bst, port=0, buckets=(16, 256))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        host, port = server.address
        out["http"] = []
        for X in http_rows:
            req = urllib.request.Request(
                "http://%s:%d/predict" % (host, port),
                data=json.dumps({"rows": X.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out["http"].append(json.loads(r.read())["predictions"])
    finally:
        server.shutdown()
        server.close()
        th.join(timeout=30)
    t1 = time.perf_counter()
    out["binned"] = sess.predict_binned(binned)
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    log("serve: requests+batcher+http %.2f s, predict_binned(%d) %.2f s, "
        "launches %s" % (t1 - t0, binned_rows, t2 - t1, counts))
    out["binned_ds"] = binned
    return out, counts


def check_serve(bst, out):
    """Every main-path answer against the plain path (raw thresholds,
    plain torch on the card) and a small input against the host walk."""
    import numpy as np
    from lightgbm_tpu_torch.serve import PredictSession

    plain = PredictSession(bst, forest="off")
    errs = {}
    for n, X in out["reqs"].items():
        errs["session/%d" % n] = check_scores(
            "session/%d" % n, out["session"][n], plain.predict(X))
    errs["batcher"] = check_scores(
        "batcher", np.concatenate(out["batcher"]),
        plain.predict(np.concatenate(out["mb_rows"])))
    errs["http"] = check_scores(
        "http", np.concatenate([np.asarray(p) for p in out["http"]]),
        plain.predict(np.concatenate(out["http_rows"])))
    head = 65536
    errs["binned/plain"] = check_scores(
        "binned/plain", out["binned"][:head], plain.predict(out["Xb"][:head]))
    errs["binned/forest"] = check_scores(
        "binned/forest", out["binned"], PredictSession(bst).predict(out["Xb"]))
    # host reference: the numpy tree walk on a small input
    X = out["reqs"][256]
    g = bst.inner
    raw = sum(t.predict(X) for t in g.models) + g.init_scores[0]
    ref = 1.0 / (1.0 + np.exp(-raw))
    errs["host_walk"] = check_scores("host_walk", out["session"][256], ref)
    if out["binned"].shape != (len(out["Xb"]),):
        raise AssertionError("predict_binned shape %s"
                             % (out["binned"].shape,))
    return errs


def phase_timings(bst, out, dev, errs, rows):
    """Kernel vs plain ms and bound at the main path's shapes, added to
    ``rows`` (which may already hold the training kernels' rows)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.learner import assign_leaves, route_layout
    from lightgbm_tpu_torch.ops.forest import (forest_predict_impl,
                                               forest_predict_plain,
                                               forest_table_bytes)
    from lightgbm_tpu_torch.ops.predict import tree_to_bin_log
    from lightgbm_tpu_torch.ops.route import (build_route_table, route_rows,
                                              route_rows_plain)

    g = bst.inner
    fp, has_cat, has_lin = g._forest_model(0, len(g.models))
    ds = g.train_set
    # forest at the top rung: one 65536-row dispatch
    X = out["reqs"][65536]
    b, _ = bin_rows(ds, X)
    bins = torch.from_numpy(b).to(dev)
    kw = dict(num_class=1, has_cat=has_cat, has_linear=has_lin)
    f_ms = cuda_ms(lambda: forest_predict_impl(bins, None, fp, **kw))
    p_ms = cuda_ms(lambda: forest_predict_plain(bins, None, fp, **kw),
                   iters=3, warmup=1)
    # work the walk needs on these rows: one bin compare per split on
    # each row's root-to-leaf path, one add per tree
    bins_u8 = torch.from_numpy(b.astype(np.uint8)).to(dev)
    bt = route_layout(bins_u8)
    steps = 0
    for t in g.models:
        lg = tree_to_bin_log(t, ds, dev)
        slot = assign_leaves(bins_u8, lg, has_categorical=False, bins_t=bt)
        leaf_of_slot = t.to_split_arrays()["leaf_of_slot"]
        depth = torch.as_tensor(t.leaf_depths()[leaf_of_slot]).to(dev)
        steps += int(depth[slot.long()].sum())
    f_ops = 2 * steps + len(g.models) * X.shape[0]
    f_bytes = bins.numel() * 4 + forest_table_bytes(fp) + X.shape[0] * 4
    rows["forest_predict"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/forest_predict.cu",
        replaces="lightgbm_tpu/ops/forest.py:268",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("forest/")),
        ms=f_ms, plain_ms=p_ms, bytes=f_bytes, ops=f_ops)
    # router at the binned shape: one tree over the 2M-row matrix
    bd = out["binned_ds"]
    dbins = g._valid_bins(bd)
    dbt = g._valid_bins_t(bd)
    t0 = g.models[0]
    lg = tree_to_bin_log(t0, bd, dev)
    table = build_route_table(lg, None)
    got = route_rows(dbt, table, lg.num_splits)
    want = route_rows_plain(dbt, table, lg.num_splits)
    torch.cuda.synchronize()
    errs["router/full_width"] = float(id_diff("router/full_width", got, want))
    r_ms = cuda_ms(lambda: route_rows(dbt, table, lg.num_splits))
    rp_ms = cuda_ms(lambda: route_rows_plain(dbt, table, lg.num_splits),
                    iters=3, warmup=1)
    leaf_of_slot = t0.to_split_arrays()["leaf_of_slot"]
    depth = torch.as_tensor(t0.leaf_depths()[leaf_of_slot]).to(dev)
    r_steps = int(depth[got[:bd.num_data].long()].sum())
    r_bytes = dbins.numel() + table.numel() * 4 + bd.num_data * 4
    rows["route_rows"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/route_rows.cu",
        replaces="lightgbm_tpu/ops/route.py:88",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("router/")),
        ms=r_ms, plain_ms=rp_ms, bytes=r_bytes,
        ops=2 * r_steps)
    for name, r in rows.items():
        t_bytes = r.pop("bytes") / PEAK_BYTES_PER_S * 1e3
        t_ops = r.pop("ops") / PEAK_SCALAR_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r.setdefault("library_ms", None)
        log("timing %s: kernel %.4f ms, plain %.3f ms, bound %.5f ms (%s)"
            % (name, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", type=int, default=40)
    ap.add_argument("--leaves", type=int, default=255)
    ap.add_argument("--train-rows", type=int, default=TRAIN_ROWS)
    ap.add_argument("--valid-rows", type=int, default=VALID_ROWS)
    ap.add_argument("--host-rows", type=int, default=200_000)
    ap.add_argument("--binned-rows", type=int, default=BINNED_ROWS)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "lightgbm_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(lightgbm_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # importing the op modules registers their kernels
    from lightgbm_tpu_torch.ops import (forest, histogram,  # noqa: F401
                                        kernels, partition, route)

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[dev.index] if len(smi) > dev.index else "unknown"
    log("torch %s cuda %s, %s" % (torch.__version__, torch.version.cuda,
                                  torch.cuda.get_device_name(dev)))
    t_start = time.perf_counter()

    log("== phase 1: build")
    secs = kernels.build_all()
    for k in kernels.KERNELS.values():
        lines = [ln for ln in k.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        log("build %s: %.1f s %s" % (k.symbol, k.build_seconds,
                                     " | ".join(lines)))
    log("build: %d kernels in %.1f s" % (len(kernels.KERNELS), secs))

    log("== phase 2: kernels vs plain")
    errs = phase_kernels(dev, args.seed)
    for name, e in errs.items():
        log("check %s: max |diff| %.3g" % (name, e))

    log("== phase 3: full-width training, planes layout (%s)" % card)
    data = training_data(args.seed, args.train_rows, args.valid_rows)
    planes_ds = build_datasets(dev, data, args.leaves)
    bst_p, counts_p, summary_p = phase_train(dev, planes_ds, args.trees,
                                             args.leaves)
    for name in ("partition_segment", "segment_histogram", "route_rows"):
        if counts_p.get(name, 0) <= 0:
            raise AssertionError("planes training never launched %s" % name)
    rows = full_width_segment_kernels(bst_p, dev, errs)
    check_determinism(dev, planes_ds[0], args.leaves)
    summary_p["profile"] = profile_iteration(dev, planes_ds[0], args.leaves)
    summary_p["card_vs_host"] = card_vs_host(dev, data, args.host_rows,
                                             args.leaves)

    log("== phase 4: full-width quantized, sampled training (%s)" % card)
    quant_ds = build_datasets(dev, data, args.leaves, QUANT_PARAMS)
    bst_q, counts_q, summary_q = phase_train(dev, quant_ds, args.trees,
                                             args.leaves, QUANT_PARAMS)
    if summary_q["layout"] != "rows":
        raise AssertionError("quantized training ran on the %s layout"
                             % summary_q["layout"])
    for name in ("partition_segment_rows", "segment_histogram_q",
                 "route_rows"):
        if counts_q.get(name, 0) <= 0:
            raise AssertionError("quantized training never launched %s"
                                 % name)
    rows.update(full_width_rows_kernels(bst_q, dev, errs))
    check_determinism(dev, quant_ds[0], args.leaves, extra=QUANT_PARAMS)
    summary_q["profile"] = profile_iteration(dev, quant_ds[0], args.leaves,
                                             QUANT_PARAMS)
    summary_q["card_vs_host"] = card_vs_host(
        dev, data, args.host_rows, args.leaves, extra=QUANT_PARAMS,
        first_tree_equal=True)
    gap = abs(summary_q["valid_auc"] - summary_p["valid_auc"])
    log("valid auc after %d trees: planes %.5f, quantized and sampled %.5f "
        "(|diff| %.5f, limit %.2f)" % (args.trees, summary_p["valid_auc"],
                                       summary_q["valid_auc"], gap, AUC_TOL))
    if gap > AUC_TOL:
        raise AssertionError("quantized valid auc %.5f vs planes %.5f"
                             % (summary_q["valid_auc"],
                                summary_p["valid_auc"]))

    log("== phase 5: rows layout and GOSS, short runs (%s)" % card)
    counts_r = rows_vs_planes(dev, data, args.host_rows, args.leaves)
    summary_q["goss_card_vs_host"] = card_vs_host(
        dev, data, args.host_rows, args.leaves, iters=4, extra=GOSS_PARAMS)

    log("== phase 6: serving the quantized model")
    import numpy as np
    rng = np.random.RandomState(args.seed + 7)
    g = bst_q.inner
    log("model: %d trees x %d leaves, %d features, device %s"
        % (len(g.models), args.leaves, g.train_set.num_total_features,
           g.device))
    out, serve_counts = phase_serve(bst_q, quant_ds[0], rng,
                                    args.binned_rows)
    for name in ("forest_predict", "route_rows"):
        if serve_counts.get(name, 0) <= 0:
            raise AssertionError("serving never launched %s" % name)
    serve_errs = check_serve(bst_q, out)
    for name, e in serve_errs.items():
        log("check %s: max |diff| %.3g" % (name, e))
    fp, has_cat, has_lin = g._forest_model(0, len(g.models))
    b, _ = bin_rows(g.train_set, out["reqs"][65536])
    bins = torch.from_numpy(b).to(dev)
    errs["forest/full_width"] = check_scores(
        "forest/full_width",
        forest.forest_predict_impl(bins, None, fp).cpu().numpy(),
        forest.forest_predict_plain(bins, None, fp).cpu().numpy())
    log("check forest/full_width: max |diff| %.3g" % errs["forest/full_width"])

    log("== phase 7: timings (%s)" % card)
    rows = phase_timings(bst_q, out, dev, errs, rows)
    launches = {"partition_segment": counts_p["partition_segment"],
                "segment_histogram": counts_p["segment_histogram"],
                "partition_segment_rows": counts_q["partition_segment_rows"],
                "segment_histogram_q": counts_q["segment_histogram_q"],
                "segment_histogram_rows": counts_r["segment_histogram_rows"],
                "route_rows": counts_p["route_rows"] + counts_q["route_rows"]
                + serve_counts["route_rows"],
                "forest_predict": serve_counts["forest_predict"]}
    log("launches: planes training %s; quantized training %s; rows run %s; "
        "serving %s" % (counts_p, counts_q, counts_r, serve_counts))
    log("train summary planes %s" % json.dumps(summary_p))
    log("train summary quantized %s" % json.dumps(summary_q))
    kernels_line = {"kernels": [dict(name=name, launches=launches[name], **r)
                                for name, r in rows.items()]}
    log(card)
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
