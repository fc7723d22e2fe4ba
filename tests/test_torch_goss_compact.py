"""GOSS row compaction in the PyTorch port (``tpu_goss_compact=on``) on
the CPU: mirrors of tests/test_goss_compact.py, and the device tree loop.

Every GOSS tree with f32 histograms grows over its rows gathered
in-bag first, in their order (``ops/partition.inbag_order``); with
compaction on, the root segment holds the in-bag rows alone (its count
set on the device by the tree loop). The root sums come from the channels
as given, and every row is routed through the grown tree. The JAX package
grows over a static M-row prefix and falls back to the dense tree when
the in-bag rows overflow it; the port's kernels read their counts on the
device, so it needs neither. The card's histograms sum a segment's rows
in an order fixed by their positions; with the in-bag rows first in every
leaf (the partition is stable) the compacted and dense segments give the
same bits, which ``test_inbag_first_gives_compaction_the_dense_bits``
shows on that order's numpy emulation. On the host the twins sum in
float64, and the model strings are byte-equal, per iteration and fused,
on the host loop and on the device tree loop, and equal the JAX package's
compacted trees. The JAX package's own functions are the oracle of the
helpers.
"""
import numpy as np
import pytest
import torch

from torch_port_cases import CPU, grid, one_torch_thread

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import partition as JP

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.ops import partition as P

# lr=0.5 keeps the 1/lr GOSS warmup at 2 rounds, so rounds 2+ exercise the
# compacted branch
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
        "boosting": "goss", "top_rate": 0.3, "other_rate": 0.2,
        "learning_rate": 0.5, "tpu_iter_block": 2,
        "min_gain_to_split": 1e-3, **CPU}


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Training-heavy: one torch thread (torch_port_cases)."""


# --------------------------------------------------------------- op level

def test_topk_threshold_matches_sort():
    """The GOSS threshold of fused.make_sampler (the k-th value of
    torch.topk) is the full sort's bit for bit, ties included
    (tests/test_goss_compact.py:45)."""
    rng = np.random.RandomState(0)
    for n, k in ((700, 210), (1024, 1), (333, 333), (64, 17)):
        s = torch.as_tensor(rng.randn(n).astype(np.float32))
        s = torch.where(torch.as_tensor(rng.rand(n) < 0.3), s[0], s)
        thr_topk = torch.topk(s, k, sorted=True).values[k - 1]
        thr_sort = torch.sort(s).values[n - k]
        assert thr_topk.dtype == thr_sort.dtype
        assert thr_topk.numpy().tobytes() == thr_sort.numpy().tobytes()


def test_config_rejects_bad_goss_compact():
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.utils.log import LightGBMError

    with pytest.raises(LightGBMError, match="tpu_goss_compact"):
        Config.from_params({"tpu_goss_compact": "maybe"})


@pytest.mark.parametrize("n,top,other", [(1000, 0.2, 0.1),
                                         (10_500_000, 0.2, 0.1),
                                         (100, 0.9, 0.5), (50_000, 0.2, 0.1),
                                         (700, 0.3, 0.2)])
def test_goss_compact_rows_matches_jax(n, top, other):
    m = P.goss_compact_rows(n, top, other)
    assert m == JP.goss_compact_rows(n, top, other)
    assert int(n * (top + other)) < m <= n or m == n


def test_goss_compact_rows_margin():
    assert P.goss_compact_rows(10_500_000, 0.2, 0.1) < 0.35 * 10_500_000
    assert P.goss_compact_rows(100, 0.9, 0.5) == 100
    n, top, other = 50_000, 0.2, 0.1
    m = P.goss_compact_rows(n, top, other)
    top_k = int(n * top)
    rest = n - top_k
    p = other / (1 - top)
    assert m >= top_k + rest * p + 4 * np.sqrt(rest * p * (1 - p))


def test_inbag_order_matches_jax():
    """In-bag rows first in their order, then the out-of-bag rows in
    theirs: the order of the JAX package's compact_rows_by_inbag, and the
    in-bag count."""
    rng = np.random.RandomState(0)
    n, f, m = 500, 6, 320
    bins = rng.randint(0, 32, (n, f)).astype(np.uint8)
    ghc = rng.randn(n, 3).astype(np.float32)
    mask = rng.rand(n) < 0.5
    ghc[:, 2] = mask
    order, c = P.inbag_order(torch.as_tensor(ghc))
    assert int(c[0]) == int(mask.sum())
    idx = np.nonzero(mask)[0]
    np.testing.assert_array_equal(order.numpy(), np.concatenate(
        [idx, np.nonzero(~mask)[0]]))
    jb, jg, jc = JP.compact_rows_by_inbag(bins, ghc, m)
    np.testing.assert_array_equal(bins[order.numpy()[:m]], np.asarray(jb))
    np.testing.assert_array_equal(ghc[order.numpy()[:m]], np.asarray(jg))
    assert int(jc) == int(c[0])
    for ones in (np.ones(n, np.float32), np.zeros(n, np.float32)):
        g = ghc.copy()
        g[:, 2] = ones
        order, c = P.inbag_order(torch.as_tensor(g))
        np.testing.assert_array_equal(order.numpy(), np.arange(n))
        assert int(c[0]) == int(ones.sum())


def _kernel_order_hist(bins, ghc, num_bins):
    """The card's f32 segment histogram of these rows, in their order
    (the kernels' summation order, emulated in numpy), hi + lo combined."""
    from torch_port_cases import combine_np, hist_order_np
    from lightgbm_tpu_torch.ops.histogram import channels

    ch = channels(torch.as_tensor(ghc).t(), True).t().numpy()
    return combine_np(hist_order_np(bins, ch, num_bins), True)


def test_inbag_first_gives_compaction_the_dense_bits():
    """Why every GOSS tree grows over its rows in-bag first: on gradients
    drawn in full float32 over a wide range of magnitudes (so that the
    hi/lo channels' f32 sums round), the card's order of additions over a
    segment
    (chunks of 2,048 rows, 32-row steps in four slices) gives the compacted
    segment (the in-bag rows alone) the bits of the dense in-bag-first one,
    at the root and in both children of a stable partition, while the
    dense segment in the rows' own order differs in its last bits."""
    rng = np.random.RandomState(8)
    n, f, b = 9000, 3, 16
    bins = rng.randint(0, b, (n, f)).astype(np.uint8)
    inbag = (rng.rand(n) < 0.3).astype(np.float32)
    w = np.exp(rng.uniform(-4, 4, n)) * inbag
    ghc = np.stack([rng.randn(n) * w, (rng.rand(n) + 1e-3) * w, inbag],
                   axis=1).astype(np.float32)
    order, c = P.inbag_order(torch.as_tensor(ghc))
    order, c = order.numpy(), int(c[0])
    dense, compact = order, order[:c]
    for rows in (lambda o: o, lambda o: o[bins[o, 0] < 7],
                 lambda o: o[bins[o, 0] >= 7]):
        d, k = rows(dense), rows(compact)
        assert k.size < d.size
        np.testing.assert_array_equal(
            _kernel_order_hist(bins[d], ghc[d], b).view(np.uint32),
            _kernel_order_hist(bins[k], ghc[k], b).view(np.uint32))
    own = _kernel_order_hist(bins, ghc, b)
    assert not np.array_equal(own.view(np.uint32),
                              _kernel_order_hist(bins[compact], ghc[compact],
                                                 b).view(np.uint32))


# ----------------------------------------------------- full-train parity

def _data(case, n=700, seed=0):
    rng = np.random.RandomState(seed)
    X = grid(rng, n, 8)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * grid(rng, n, 1)[:, 0] > 0) \
        .astype(np.float64)
    extra, cats = {}, []
    if case == "multiclass":
        y = y + (X[:, 2] > 0.1)
        extra = {"objective": "multiclass", "num_class": 3}
    elif case == "nan_missing":
        X[rng.rand(n, 8) < 0.1] = np.nan
        extra = {"use_missing": True}
    elif case == "categorical":
        X[:, 0] = rng.randint(0, 12, n)
        y = ((X[:, 0] % 3 == 0) ^ (X[:, 1] > 0)).astype(np.float64)
        extra, cats = {"min_data_per_group": 5, "max_cat_to_onehot": 16}, [0]
    elif case == "split_kernel":
        extra = {"tpu_split_kernel": "on", "max_bin": 31}
    elif case == "resident":
        extra = {"tpu_split_kernel": "on", "tpu_resident_state": "on"}
    elif case == "rows":
        extra = {"tpu_work_layout": "rows"}
    elif case == "options":
        extra = {"feature_fraction_bynode": 0.6, "extra_trees": True,
                 "cegb_penalty_split": 0.001}
    return X, y, cats, extra


def _models(params, X, y, cats, rounds=6, callbacks=None):
    ds = lgt.Dataset(X, label=y, categorical_feature=cats,
                     params=dict(params))
    bst = lgt.train(dict(params), ds, rounds, callbacks=callbacks)
    return bst


PARITY_CASES = ("binary", "multiclass", "nan_missing", "categorical",
                "split_kernel", "resident", "rows", "options")


@pytest.mark.parametrize("case", PARITY_CASES)
def test_train_parity(case):
    """on == off byte for byte, fused and per iteration."""
    X, y, cats, extra = _data(case)
    on = dict(BASE, tpu_goss_compact="on", **extra)
    off = dict(BASE, tpu_goss_compact="off", **extra)
    telemetry.reset()
    b_on = _models(on, X, y, cats)
    kw = b_on.inner.learner._kw
    assert kw["goss_compact"] and kw["inbag_first"]
    # every tree compacts (the warmup rounds keep every row in bag)
    K = 3 if case == "multiclass" else 1
    assert telemetry.counter("learner/goss_compact_trees") == 6 * K
    b_off = _models(off, X, y, cats)
    assert b_on.model_to_string() == b_off.model_to_string()
    eager = _models(on, X, y, cats, callbacks=[lambda env: None])
    assert eager.model_to_string() == b_off.model_to_string()


@pytest.mark.parametrize("case", ["binary", "resident", "options"])
def test_device_loop_parity(case):
    """The card's tree loop on its twins: the compacting device tree loop
    inside fused blocks."""
    from lightgbm_tpu_torch.fused import FusedTrainer

    X, y, cats, extra = _data(case)
    on = dict(BASE, tpu_goss_compact="on", **extra)
    off = dict(BASE, tpu_goss_compact="off", **extra)
    want = _models(off, X, y, cats).model_to_string()
    bst = lgt.Booster(dict(on), lgt.Dataset(X, label=y, params=dict(on)))
    bst.inner._fused = FusedTrainer(bst.inner)
    bst.inner._fused.device_loop = True
    assert bst.inner.train_block(6) is False
    bst.inner.finish_fused("test")
    lrn = bst.inner.learner
    assert lrn._loop is not None and lrn._loop.compact
    assert lrn._kw["goss_compact"]
    got = "\n".join(ln for ln in bst.model_to_string().splitlines()
                    if not ln.startswith("best_iteration="))
    want = "\n".join(ln for ln in want.splitlines()
                     if not ln.startswith("best_iteration="))
    assert got == want


@pytest.mark.parametrize("frac", [1.0, 0.3, 0.0])
def test_device_loop_tree_over_the_inbag_rows(frac):
    """The compacted tree's root segment holds the in-bag rows alone (all
    of them in a GOSS warmup round; none: a one-leaf tree), and the
    device tree loop grows the host loop's tree."""
    X, y, _, _ = _data("binary")
    on = dict(BASE, tpu_goss_compact="on")
    bst = lgt.Booster(dict(on), lgt.Dataset(X, label=y, params=dict(on)))
    g = bst.inner
    lrn = g.learner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    rng = np.random.RandomState(4)
    inbag = torch.as_tensor(rng.rand(len(y)) < frac).to(torch.float32)
    ghc = torch.stack([grad * inbag, hess * inbag, inbag], dim=1)
    want = lrn.train(ghc)
    stats = dict(lrn.last_stats)
    got = lrn.train_device(ghc)
    for fld in got._fields:
        assert torch.equal(getattr(got, fld), getattr(want, fld)), fld
    ns = int(got.num_splits[0])
    assert int(stats["leaf_cnt"][:ns + 1].sum()) == int(inbag.sum())
    assert torch.equal(lrn.last_stats["leaf_cnt"], stats["leaf_cnt"])
    assert (ns > 1) == (frac > 0)


def test_matches_jax_compact(tmp_path):
    """The port's compacted GOSS training against the JAX package's."""
    from torch_port_cases import assert_same_trees
    X, y, _, _ = _data("binary", n=900, seed=2)
    jparams = {k: v for k, v in BASE.items() if k != "device_type"}
    ds = lgb.Dataset(X, label=y)
    ds.construct(dict(jparams, tpu_goss_compact="on"))
    path = str(tmp_path / "goss.npz")
    ds.save_binary(path)
    jb = lgb.train(dict(jparams, tpu_goss_compact="on"), ds, 6)
    pb = lgt.train(dict(BASE, tpu_goss_compact="on"),
                   lgt.dataset_from_reference(path, CPU), 6)
    assert_same_trees(jb.inner.models, pb.inner.models)


# --------------------------------------------------- knob gates + spec

def _learner(params, n=300):
    rng = np.random.RandomState(1)
    X = rng.randn(n, 4)
    y = (X[:, 0] > 0).astype(np.float64)
    bst = lgt.Booster(dict(params), lgt.Dataset(X, label=y,
                                                params=dict(params)))
    return bst.inner.learner


def test_traffic_spec_effective_rows():
    m = P.goss_compact_rows(300, 0.3, 0.2)
    lrn = _learner(dict(BASE, num_leaves=4, max_bin=15,
                        tpu_goss_compact="on"))
    assert lrn.build_kwargs()["goss_compact"]
    tr = lrn.traffic_spec()
    assert tr["goss_compact"] == "on" and tr["effective_rows"] == m
    lrn = _learner(dict(BASE, num_leaves=4, max_bin=15,
                        tpu_goss_compact="off"))
    tr = lrn.traffic_spec()
    kw = lrn.build_kwargs()
    assert not kw["goss_compact"] and kw["inbag_first"]
    assert tr["goss_compact"] == "off" and tr["effective_rows"] == 300


def test_auto_resolves_off_with_record():
    def resolve(params, cuda=False):
        telemetry.reset()
        lrn = _learner(params)
        if cuda:
            lrn.device = torch.device("cuda")
            telemetry.reset()
        kw = lrn.build_kwargs()
        mine = [r for r in telemetry.records("auto_resolution")
                if r["knob"] == "tpu_goss_compact"]
        assert len(mine) == 1 and not kw["goss_compact"]
        return mine[0]

    rec = resolve(dict(BASE, num_leaves=4, max_bin=15))
    assert rec["value"] == "off" and "unmeasured" in rec["reason"]
    rec = resolve(dict(BASE, num_leaves=4, max_bin=15), cuda=True)
    assert rec["value"] == "off" and "on the card" in rec["reason"]
    rec = resolve({"objective": "binary", "num_leaves": 4, "max_bin": 15,
                   "verbosity": -1, **CPU})
    assert rec["value"] == "off" and "no GOSS sampling" in rec["reason"]


def test_ineligible_on_downgrades_to_off():
    from lightgbm_tpu_torch.utils.log import (Log, set_thread_log_level,
                                               set_thread_log_sink)

    lines = []
    set_thread_log_sink(lines.append)
    # another test of the worker may have left the level above warnings
    set_thread_log_level(Log.WARNING)
    try:
        lrn = _learner({"objective": "binary", "num_leaves": 4,
                        "max_bin": 15, "verbosity": -1,
                        "tpu_goss_compact": "on", **CPU})
        kw = lrn.build_kwargs()
        assert not kw["goss_compact"] and not kw["inbag_first"]
        # int8: the dither is seeded by row position, so no reordering
        lrn = _learner(dict(BASE, num_leaves=4, max_bin=15,
                            tpu_goss_compact="on", use_quantized_grad=True))
        kw = lrn.build_kwargs()
        assert not kw["goss_compact"] and not kw["inbag_first"]
        # M >= N (the JAX package's downgrade) needs none in the port: the
        # kernels read the in-bag count on the device
        lrn = _learner(dict(BASE, num_leaves=4, max_bin=15, top_rate=0.6,
                            other_rate=0.39, tpu_goss_compact="on"))
        assert P.goss_compact_rows(300, 0.6, 0.39) == 300
        assert lrn.build_kwargs()["goss_compact"]
    finally:
        set_thread_log_sink(None, clear=True)
        set_thread_log_level(None)
    warned = [ln for ln in lines if "tpu_goss_compact=on is not eligible"
              in ln]
    assert warned and "no GOSS sampling" in warned[0]
    assert any("int8" in ln for ln in warned)
    # the third learner compacts: no other reason warns
    assert all("no GOSS sampling" in ln or "int8" in ln for ln in warned)
