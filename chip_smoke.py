#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``lightgbm_tpu_torch``).

    python3 chip_smoke.py [--seed 0] [--trees 100] [--leaves 255]

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
the checkout it sits in. Four phases, each fatal on failure:

1. build   — compile both hand-written kernels (``csrc/*.cu``), one nvcc
             per source, started together.
2. kernels — hold each kernel against its plain torch twin on the card:
             the forest kernel on small seeded packs covering every branch
             (numerical, NaN-missing, categorical, multiclass K=3, linear,
             linear + NaN) and at full width; the row router with and
             without EFB bundle columns. Leaf ids must be equal, scores
             within |a - b| <= SCORE_ATOL + SCORE_RTOL * |b|.
3. serve   — the main path: a seeded binary ensemble of 100 trees x 255
             leaves over a Higgs-shaped 28-feature dataset (max_bin=255),
             serialised with ``model_to_string`` and reloaded through
             ``Booster(model_str=...)`` + ``booster_from_reference``; then
             PredictSession requests of 1, 256, 4096 and 65536 rows, 64
             concurrent MicroBatcher submits, loopback ``POST /predict``
             and ``predict_binned`` over 2,000,000 binned rows. Launch
             counts are zeroed just before and read just after; both
             kernels must have run. Every answer is checked against the
             plain path and, on a small input, against the host tree walk.
4. timings — each kernel's ms (CUDA events), its plain twin's ms and its
             bound at the main path's shapes, printed beside the card's
             name and power limit.

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

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores (the routing work is scalar)
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12

HIGGS_FEATURES = 28
BINNED_ROWS = 2_000_000
REQUEST_ROWS = (1, 256, 4096, 65536)


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
    return errs


def build_main_model(seed, trees, leaves, train_rows, tmpdir,
                     device_type="cuda"):
    """The full-width binary model, as a user would load it: model text
    through Booster(model_str=...) plus the binned training set written
    with save_binned, through booster_from_reference."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.boosting import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import save_binned

    rng = np.random.RandomState(seed)
    Xtr = higgs_like(rng, train_rows)
    ytr = (rng.rand(train_rows) < 0.53).astype(np.float64)
    params = {"objective": "binary", "max_bin": 255, "verbosity": -1,
              "device_type": device_type}
    train = lgt.Dataset(Xtr, label=ytr, params=params)
    ds = train.construct()
    cfg = Config.from_params(params)
    g = GBDT(cfg, ds)
    g.models = random_trees(ds, rng, trees, leaves)
    g.init_scores = np.array([0.12], np.float64)
    g.iter_ = trees
    path = os.path.join(tmpdir, "higgs_train_binned.npz")
    save_binned(ds, path)
    text = g.model_to_string()
    lgt.Booster(params=params, model_str=text)   # the text alone loads
    return lgt.booster_from_reference(text, path, params), train, rng


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


def phase_timings(bst, out, dev, errs):
    """Kernel vs plain ms and bound at the main path's shapes."""
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
    rows = {}
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
        r["library_ms"] = None
        log("timing %s: kernel %.4f ms, plain %.3f ms, bound %.5f ms (%s)"
            % (name, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", type=int, default=100)
    ap.add_argument("--leaves", type=int, default=255)
    ap.add_argument("--train-rows", type=int, default=200_000)
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
    from lightgbm_tpu_torch.ops import forest, kernels, route  # noqa: F401

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
    log("build: both kernels in %.1f s" % secs)

    log("== phase 2: kernels vs plain")
    errs = phase_kernels(dev, args.seed)
    for name, e in errs.items():
        log("check %s: max |diff| %.3g" % (name, e))

    log("== phase 3: full-width serving")
    with tempfile.TemporaryDirectory() as tmp:
        bst, train, rng = build_main_model(args.seed, args.trees,
                                           args.leaves, args.train_rows, tmp)
        g = bst.inner
        log("model: %d trees x %d leaves, %d features, device %s"
            % (len(g.models), args.leaves, g.train_set.num_total_features,
               g.device))
        out, counts = phase_serve(bst, train, rng, args.binned_rows)
        for name in ("forest_predict", "route_rows"):
            if counts.get(name, 0) <= 0:
                raise AssertionError("main path never launched %s" % name)
        serve_errs = check_serve(bst, out)
        for name, e in serve_errs.items():
            log("check %s: max |diff| %.3g" % (name, e))
        # full-width forest kernel vs its twin at the 65536-row rung
        from lightgbm_tpu_torch.ops.forest import forest_predict_plain
        fp, has_cat, has_lin = g._forest_model(0, len(g.models))
        b, _ = bin_rows(g.train_set, out["reqs"][65536])
        bins = torch.from_numpy(b).to(dev)
        errs["forest/full_width"] = check_scores(
            "forest/full_width",
            forest.forest_predict_impl(bins, None, fp).cpu().numpy(),
            forest_predict_plain(bins, None, fp).cpu().numpy())
        log("check forest/full_width: max |diff| %.3g"
            % errs["forest/full_width"])

        log("== phase 4: timings (%s)" % card)
        rows = phase_timings(bst, out, dev, errs)
    kernels_line = {"kernels": [dict(name=name, launches=counts[name], **r)
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
