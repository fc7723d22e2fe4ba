"""Ranking in the PyTorch port against the JAX package, on the CPU.

- The lambda twin (``ops/rank.lambdarank_gradients_plain``, which the
  objective takes for a CPU tensor) against JAX
  ``LambdarankNDCG.get_gradients`` on the same seeded labels and scores:
  every row within TWIN_RTOL of its query's largest |grad| (|hess|); the
  twin is the JAX code op for op, so only the reductions' orders differ.
- A numpy emulation of the kernel ``csrc/rank_lambdas.cu``
  (``kernel_lambdas_np``: ranks by counting, each rank's pairs summed in
  the kernel's order, the norm's fixed-order block reduction, K =
  min(truncation_level, len_q)) against the same JAX gradients within
  rank.LAMBDA_RTOL, the tolerance the card holds the kernel to against
  the twin (chip_smoke.check_lambdas).
- The cases: all-tied scores (iteration 0), seeded scores, scores on a
  coarse grid (ties), ``lambdarank_truncation_level`` below and above the
  query lengths, ``lambdarank_norm`` off, weights, a custom
  ``label_gain``; the queries include one document, one all-zero-label
  query (inverse max DCG 0) and one of 1,100 documents (past the JAX
  ladder's 1024 and the kernel's shared-memory path).
- ``prng.uniform(minval=tiny)`` bit for bit (other bounds within an ulp:
  XLA fuses the scaling into an FMA on the CPU) and ``prng.gumbel`` within
  2 ulps of max(|g|, 1) against ``jax.random`` (torch's and XLA's ``log``
  may round an ulp apart).
- Five rounds of lambdarank and rank_xendcg, per iteration and fused,
  against the JAX package's trees (``assert_same_trees`` at TRAIN_RTOL /
  TRAIN_ATOL), and ``Dataset.set_group`` / ``get_group``.
- chip_smoke's phase 3f rehearsed at a small size.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_cases import CPU, assert_same_trees, grid, one_torch_thread

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.objective import create_objective as jax_objective

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import prng
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import Metadata
from lightgbm_tpu_torch.objective import _BUCKET_LADDER, create_objective
from lightgbm_tpu_torch.ops import rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """The training tests here run the port on the host: one torch thread
    (torch_port_cases.one_torch_thread)."""


#: twin vs JAX: |diff| <= TWIN_RTOL * the query's largest |value| (the
#: same f32 ops; XLA's and torch's reductions sum in other orders)
TWIN_RTOL = 2e-6
#: query sizes: one document, an all-zero-label query (size 50: inverse
#: max DCG 0), one past 1024 documents, and ordinary ones
SIZES = (1, 50, 1100, 37, 8, 120, 64, 200, 3)


def _labels(rng, sizes):
    n = int(np.sum(sizes))
    y = rng.randint(0, 5, n).astype(np.float64)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    for q in np.flatnonzero(np.asarray(sizes) == 50):
        y[qb[q]:qb[q + 1]] = 0.0
    return y, qb


CASES = {
    "default": ({}, False),
    "trunc3": ({"lambdarank_truncation_level": 3}, False),
    "trunc2000": ({"lambdarank_truncation_level": 2000}, False),
    "no_norm": ({"lambdarank_norm": False}, False),
    "weights": ({}, True),
    "label_gain": ({"label_gain": [0.0, 1.0, 3.0, 7.5, 15.0, 40.0]}, False),
}


def _scores(kind, rng, n):
    if kind == "tied":
        return np.zeros(n, np.float32)
    if kind == "grid":
        return (np.round(rng.randn(n) * 4) / 4).astype(np.float32)
    return rng.randn(n).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, JAX objective, port objective, labels, weights, qb) of one
    CASES entry on SIZES."""
    params, weighted = CASES[request.param]
    rng = np.random.RandomState(len(request.param))
    y, qb = _labels(rng, SIZES)
    n = len(y)
    w = rng.uniform(0.5, 2.0, n) if weighted else None
    p = dict(objective="lambdarank", **params)
    jo = jax_objective(JConfig.from_params(p))
    jo.init(JMetadata(n, label=y, weight=w, group=np.asarray(SIZES)))
    po = create_objective(Config.from_params(p))
    po.init(Metadata(n, label=y, weight=w, group=np.asarray(SIZES)))
    return request.param, jo, po, w, qb


def _query_scale(x, qb):
    """Each row's query's largest |x|."""
    out = np.empty_like(x)
    for q in range(len(qb) - 1):
        sl = slice(qb[q], qb[q + 1])
        if qb[q + 1] > qb[q]:
            out[sl] = np.abs(x[sl]).max()
    return out


def _assert_close(name, got, want, qb, rtol):
    bound = rtol * _query_scale(want, qb)
    bad = np.abs(got - want) > bound
    assert np.isfinite(got).all(), name
    assert not bad.any(), "%s: %d rows off, max |diff| %.3g" % (
        name, bad.sum(), np.abs(got - want).max())


def top_ranks(n, n_fin, trunc):
    """The kernel's top_ranks: how many of a query's ranks the JAX
    package keeps in its top K_b = min(trunc, P_b), its NaN documents
    sitting after the bucket's padding."""
    ladder = [p for p in _BUCKET_LADDER if n <= p]
    p_b = ladder[0] if ladder else -(-n // 256) * 256
    k_b = min(trunc, p_b)
    return min(n_fin, k_b) + max(0, min(n, k_b - (p_b - n)) - n_fin)


def kernel_lambdas_np(score, t, weight=None, threads=256):
    """csrc/rank_lambdas.cu in numpy float32, in its order: per query the
    ranks by counting (a higher score, or an equal score and a lower
    slot; NaN after every number, in slot order), each rank's pairs
    summed sequentially (as the higher side with every lower rank when r
    < K, then as the lower side with each rank above it in the top K), the
    norm as the block sums it (each thread's ranks in order, a
    shuffle-down tree in each warp, the warps in order), then max(hess *
    scale, 1e-20) (NaN kept) and the weights."""
    f32 = np.float32
    qb = t.qb.numpy()
    gains, inv_q = t.gains.numpy(), t.inv_max_dcg.numpy()
    disc = t.discount.numpy()
    sig, sig2 = f32(t.sigmoid), f32(t.sigmoid * t.sigmoid)
    n = len(score)
    grad = np.zeros(n, f32)
    hess = np.zeros(n, f32)

    def pair_terms(d, g_abs, dd, inv):
        p = f32(1) / (f32(1) + np.exp(sig * d))
        dn = dd * g_abs * inv
        lam = -sig * p * dn
        return lam, sig2 * p * (f32(1) - p) * dn

    for q in range(len(qb) - 1):
        start, m = qb[q], qb[q + 1] - qb[q]
        sp, gp = score[start:start + m], gains[start:start + m]
        slots = np.arange(m)
        nan = np.isnan(sp)
        rank_of = np.array([np.sum(np.where(
            nan, nan[d] & (slots < d),
            nan[d] | (sp > sp[d]) | ((sp == sp[d]) & (slots < d))))
            for d in range(m)], np.int64)
        ss, gs, dr = (np.empty(m, f32), np.empty(m, f32),
                      np.empty(m, np.int64))
        ss[rank_of], gs[rank_of], dr[rank_of] = sp, gp, slots
        K = top_ranks(m, int(np.sum(~nan)),
                      min(t.truncation_level, t.max_len))
        inv = inv_q[q]
        gr, hr = np.zeros(m, f32), np.zeros(m, f32)
        for r in range(m):
            lam_hi = h_hi = lam_lo = h_lo = f32(0)
            if r < K:
                j = np.arange(r + 1, m)
                j = j[gs[j] != gs[r]]
                sgn = np.where(gs[r] > gs[j], f32(1), f32(-1))
                lam, h = pair_terms(sgn * (ss[r] - ss[j]),
                                    np.abs(gs[r] - gs[j]),
                                    np.abs(disc[r] - disc[j]), inv)
                if len(j):
                    lam_hi = np.cumsum(lam * sgn, dtype=f32)[-1]
                    h_hi = np.cumsum(h, dtype=f32)[-1]
            i = np.arange(min(K, r))
            i = i[gs[i] != gs[r]]
            sgn = np.where(gs[i] > gs[r], f32(1), f32(-1))
            lam, h = pair_terms(sgn * (ss[i] - ss[r]),
                                np.abs(gs[i] - gs[r]),
                                np.abs(disc[i] - disc[r]), inv)
            if len(i):
                lam_lo = np.cumsum(-lam * sgn, dtype=f32)[-1]
                h_lo = np.cumsum(h, dtype=f32)[-1]
            gr[r], hr[r] = lam_hi + lam_lo, h_hi + h_lo
        per_thread = np.zeros(threads, f32)
        for tid in range(threads):
            mine = np.abs(gr[tid::threads])
            if len(mine):
                per_thread[tid] = np.cumsum(mine, dtype=f32)[-1]
        warps = per_thread.reshape(-1, 32).copy()
        for o in (16, 8, 4, 2, 1):
            warps[:, :32 - o] = warps[:, :32 - o] + warps[:, o:]
        total = np.cumsum(warps[:, 0], dtype=f32)[-1]
        scale = f32(np.log2(f32(1) + total) / max(total, f32(1e-20))) \
            if t.norm and total > 0 else f32(1)
        w = np.ones(m, f32) if weight is None \
            else weight[start + dr].astype(f32)
        grad[start + dr] = gr * scale * w
        h = hr * scale
        hess[start + dr] = np.where(h < f32(1e-20), f32(1e-20), h) * w
    return grad, hess


@pytest.mark.parametrize("scores", ["tied", "seeded", "grid"])
def test_lambda_twin_and_kernel_order_equal_jax(case, scores):
    name, jo, po, w, qb = case
    rng = np.random.RandomState(17)
    s = _scores(scores, rng, len(w) if w is not None else qb[-1])
    gj, hj = jax.jit(jo.get_gradients)(jnp.asarray(s))
    gj, hj = np.asarray(gj), np.asarray(hj)
    gp, hp = po.get_gradients(torch.as_tensor(s))
    _assert_close(name + "/twin/grad", gp.numpy(), gj, qb, TWIN_RTOL)
    _assert_close(name + "/twin/hess", hp.numpy(), hj, qb, TWIN_RTOL)
    wt = None if w is None else np.asarray(w, np.float32)
    gk, hk = kernel_lambdas_np(s, po.tables, wt)
    _assert_close(name + "/kernel/grad", gk, gj, qb, rank.LAMBDA_RTOL)
    _assert_close(name + "/kernel/hess", hk, hj, qb, rank.LAMBDA_RTOL)


@pytest.mark.parametrize("level", [1, 8, 9, 31, 64, 99, 100, 101, 500])
def test_kernel_truncation_is_the_jax_one(level):
    """K = min(truncation_level, len_q) takes the JAX package's pairs: on
    tied scores every truncation level gives the JAX gradients, levels
    between the bucket rungs and past the longest query included."""
    rng = np.random.RandomState(5)
    sizes = np.array([7, 9, 30, 33, 100])
    y, qb = _labels(rng, sizes)
    s = _scores("grid", rng, len(y))
    p = dict(objective="lambdarank", lambdarank_truncation_level=level)
    jo = jax_objective(JConfig.from_params(p))
    jo.init(JMetadata(len(y), label=y, group=sizes))
    po = create_objective(Config.from_params(p))
    po.init(Metadata(len(y), label=y, group=sizes))
    gj, _ = jax.jit(jo.get_gradients)(jnp.asarray(s))
    gk, _ = kernel_lambdas_np(s, po.tables)
    _assert_close("level %d" % level, gk, np.asarray(gj), qb,
                  rank.LAMBDA_RTOL)


def _assert_close_nan(name, got, want, qb, rtol):
    """NaN in the same rows; the others within rtol of their query's
    largest finite |want|."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), name)
    num = ~np.isnan(want)
    bound = rtol * _query_scale(np.where(num, want, 0.0), qb)
    diff = np.where(num, np.abs(got - want), 0.0)
    assert not (diff > bound).any(), "%s: max |diff| %.3g" % (name,
                                                              diff.max())


#: NaN scores: a 37-document query (bucket 48) whose NaN documents are
#: slot 4 (label 1, as every numeric document) and slot 20 (label 3), two
#: NaN in a 60-document query, two (one -NaN) past 1024 documents
NAN_SIZES = (37, 8, 60, 1100, 5)


@pytest.mark.parametrize("level", [3, 30, 36, 40, 47, 2000])
def test_nan_scores_rank_as_jax(level):
    """A NaN score sorts after every number and after the bucket's
    padding (jnp.argsort of -s): the twin and the kernel's order give the
    JAX package's NaN rows and, elsewhere, its gradients. In JAX's padded
    row the 37-document query's NaN documents take ranks 46 and 47, so
    the slot-4 one (which differs in label only from the slot-20 NaN)
    pairs with nothing and stays finite up to level 46; a truncation of
    min(level, 37) over the query's own ranks would make it NaN from
    level 36."""
    rng = np.random.RandomState(level)
    y, qb = _labels(rng, NAN_SIZES)
    y[:37] = 1.0
    y[20] = 3.0
    s = rng.randn(len(y)).astype(np.float32)
    s[[4, 20, qb[2] + 7, qb[2] + 33, qb[3] + 2, qb[3] + 1099]] = np.nan
    s[qb[3] + 2] = -np.nan
    p = dict(objective="lambdarank", lambdarank_truncation_level=level)
    jo = jax_objective(JConfig.from_params(p))
    jo.init(JMetadata(len(y), label=y, group=np.asarray(NAN_SIZES)))
    po = create_objective(Config.from_params(p))
    po.init(Metadata(len(y), label=y, group=np.asarray(NAN_SIZES)))
    gj, hj = (np.asarray(a) for a in jax.jit(jo.get_gradients)(
        jnp.asarray(s)))
    assert np.isnan(gj[20]) and np.isnan(gj).sum() < len(gj)
    assert np.isfinite(gj[4]) == (level <= 46)
    gp, hp = po.get_gradients(torch.as_tensor(s))
    _assert_close_nan("twin/grad", gp.numpy(), gj, qb, TWIN_RTOL)
    _assert_close_nan("twin/hess", hp.numpy(), hj, qb, TWIN_RTOL)
    gk, hk = kernel_lambdas_np(s, po.tables)
    _assert_close_nan("kernel/grad", gk, gj, qb, rank.LAMBDA_RTOL)
    _assert_close_nan("kernel/hess", hk, hj, qb, rank.LAMBDA_RTOL)


def test_empty_queries_as_jax():
    """Both packages' Metadata refuse a group size of 0; boundaries with
    an empty query, set on the metadata directly, reach the objective, and
    the JAX one accepts them (its buckets leave the query out). So does
    the port's (the kernel's block for it does nothing): the gradients
    equal JAX's around empty queries at the start, the middle and the
    end."""
    rng = np.random.RandomState(8)
    sizes = np.array([0, 12, 0, 0, 40, 7, 0])
    y, qb = _labels(rng, sizes)
    s = rng.randn(len(y)).astype(np.float32)
    jmd, pmd = JMetadata(len(y), label=y), Metadata(len(y), label=y)
    jmd.query_boundaries = qb.astype(np.int32)
    pmd.query_boundaries = qb.astype(np.int32)
    jo = jax_objective(JConfig.from_params({"objective": "lambdarank"}))
    jo.init(jmd)
    po = create_objective(Config.from_params({"objective": "lambdarank"}))
    po.init(pmd)
    assert po.tables.num_queries == len(sizes)
    gj, hj = (np.asarray(a) for a in jax.jit(jo.get_gradients)(
        jnp.asarray(s)))
    gp, hp = po.get_gradients(torch.as_tensor(s))
    gk, hk = kernel_lambdas_np(s, po.tables)
    for name, got, want, tol in (("twin/grad", gp.numpy(), gj, TWIN_RTOL),
                                 ("twin/hess", hp.numpy(), hj, TWIN_RTOL),
                                 ("kernel/grad", gk, gj, rank.LAMBDA_RTOL),
                                 ("kernel/hess", hk, hj, rank.LAMBDA_RTOL)):
        _assert_close(name, got, want, qb, tol)


def test_rank_tables():
    """The kernel's tables: boundaries, per-row gains, one inverse max DCG
    per query (0 for equal labels), a discount table covering the longest
    query, the shared-memory bound below RANK_SMEM_DOCS."""
    rng = np.random.RandomState(3)
    y, qb = _labels(rng, SIZES)
    po = create_objective(Config.from_params({"objective": "lambdarank"}))
    po.init(Metadata(len(y), label=y, group=np.asarray(SIZES)))
    t = po.tables
    np.testing.assert_array_equal(t.qb.numpy(), qb)
    np.testing.assert_array_equal(t.gains.numpy(), 2.0 ** y - 1)
    assert t.inv_max_dcg.numpy()[SIZES.index(50)] == 0.0
    assert (t.inv_max_dcg.numpy()[[2, 3]] > 0).all()
    assert t.discount.shape[0] >= max(SIZES)
    assert t.max_len == 1100 and t.smem_docs == 200
    assert t.num_queries == len(SIZES)


def test_cpu_tensor_takes_the_twin(monkeypatch):
    """The wrapper's path is the tensor's device: a CPU tensor calls the
    twin and never the kernel."""
    y, _ = _labels(np.random.RandomState(1), (9, 4))
    po = create_objective(Config.from_params({"objective": "lambdarank"}))
    po.init(Metadata(len(y), label=y, group=np.array([9, 4])))

    def refuse(*_a, **_k):
        raise AssertionError("launched on a CPU tensor")

    monkeypatch.setattr(rank.RANK_KERNEL, "launch", refuse)
    g, h = po.get_gradients(torch.zeros(len(y)))
    assert torch.isfinite(g).all() and bool((h >= 1e-20).all())
    with pytest.raises(ValueError):
        rank.lambdarank_gradients(torch.zeros(len(y) + 1), po.tables)


# ------------------------------------------------------------- threefry

@pytest.mark.parametrize("it", [0, 3, 41])
def test_uniform_bounds_and_gumbel_equal_jax(it):
    key = jax.random.fold_in(jax.random.PRNGKey(5), jnp.int32(it))
    pkey = prng.fold_in(prng.PRNGKey(5), it)
    shape = (23, 57)
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((tiny, 1.0), (0.0, 1.0), (-2.5, 3.0)):
        a = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
        b = prng.uniform(pkey, shape, minval=lo, maxval=hi).numpy()
        if hi - lo == 1.0:      # the scaling is exact: bit for bit
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
        else:   # XLA's CPU backend fuses the multiply-add: one rounding
            ulp = np.finfo(np.float32).eps * max(abs(lo), abs(hi))
            assert np.abs(a - b).max() <= ulp, (lo, hi)
    a = np.asarray(jax.random.gumbel(key, shape))
    b = prng.gumbel(pkey, shape).numpy()
    ulp = np.finfo(np.float32).eps * np.maximum(np.abs(a), 1.0)
    assert (np.abs(a - b) <= 2 * ulp).all()


# -------------------------------------------------------------- training

def rank_data(rng, n=1200, f=8):
    """Grid features, five grades from a linear score with grid noise,
    queries of 5-59 documents."""
    X = grid(rng, n, f)
    w = np.array([1.0, -0.8, 0.6, -0.45, 0.3, -0.2, 0.12, 0.07])[:f]
    z = X @ w + 0.5 * grid(rng, n, 1)[:, 0]
    y = np.digitize(z, np.quantile(z, [0.5, 0.75, 0.9, 0.97])) \
        .astype(np.float64)
    sizes, left = [], n
    while left > 0:
        s = min(left, rng.randint(5, 60))
        sizes.append(s)
        left -= s
    return X, y, np.asarray(sizes)


RANK_PARAMS = {"verbosity": -1, "num_leaves": 15, "min_gain_to_split": 1e-3}


@pytest.fixture(scope="module", params=["lambdarank", "rank_xendcg"])
def jax_ranker(request, tmp_path_factory):
    """(objective, JAX booster of 5 fused rounds, npz of its dataset)."""
    rng = np.random.RandomState(3)
    X, y, sizes = rank_data(rng)
    p = dict(RANK_PARAMS, objective=request.param)
    ds = lgb.Dataset(X, label=y, group=sizes)
    ds.construct(p)
    path = str(tmp_path_factory.mktemp("rank") / ("%s.npz"
                                                   % request.param))
    ds.save_binary(path)
    return request.param, lgb.train(dict(p), ds, 5), path


@pytest.mark.parametrize("fused", [False, True])
def test_ranking_training_equals_jax(jax_ranker, fused):
    objective, jb, path = jax_ranker
    params = dict(RANK_PARAMS, objective=objective, **CPU)
    callbacks = [] if fused else [lambda env: None]
    pb = lgt.train(params, lgt.dataset_from_reference(path, CPU), 5,
                   callbacks=callbacks)
    assert (getattr(pb.inner, "_fused", None) is not None) == fused
    assert_same_trees(jb.inner.models, pb.inner.models)


def test_fused_xendcg_equals_per_iteration():
    """rank_xendcg draws its noise from the iteration index, so a fused
    model equals the per-iteration one byte for byte."""
    X, y, sizes = rank_data(np.random.RandomState(8), n=700)
    params = dict(RANK_PARAMS, objective="rank_xendcg", tpu_iter_block=2,
                  **CPU)
    texts = [lgt.train(dict(params), lgt.Dataset(X, label=y, group=sizes),
                       5, callbacks=cb).model_to_string()
             for cb in ([], [lambda env: None])]
    assert texts[0] == texts[1]


def test_set_group_and_get_group(tmp_path):
    X, y, sizes = rank_data(np.random.RandomState(4), n=300)
    ds = lgt.Dataset(X, label=y)
    assert ds.get_group() is None
    assert ds.set_group(sizes) is ds
    np.testing.assert_array_equal(ds.get_group(), sizes)
    ds.construct()
    np.testing.assert_array_equal(ds.get_group(), sizes)
    # per-row query ids become sizes at construction
    ids = np.repeat(np.arange(len(sizes)), sizes)
    np.testing.assert_array_equal(ds.set_group(ids).get_group(), ids)
    ds.construct()
    np.testing.assert_array_equal(ds.get_group(), sizes)
    # a binned npz takes new groups too
    path = str(tmp_path / "rank.npz")
    ds.save_binary(path)
    other = lgt.Dataset(path).set_group([100, 200])
    other.construct()
    np.testing.assert_array_equal(other.get_group(), [100, 200])
    bst = lgt.train(dict(RANK_PARAMS, objective="lambdarank", **CPU),
                    lgt.Dataset(X, label=y).set_group(sizes), 2)
    assert bst.num_trees() == 2
    with pytest.raises(lgt.LightGBMError, match="group"):
        lgt.train(dict(RANK_PARAMS, objective="lambdarank", **CPU),
                  lgt.Dataset(X, label=y), 1)


def test_rank_phase_small_on_cpu():
    """chip_smoke's phase 3f at a small size on the host (the twin in
    place of the kernel): fused twice with the same model, per iteration
    equal to fused, the lambda checks, the draws, rank_xendcg."""
    summary, counts, row, errs = chip_smoke.phase_rank(
        torch.device("cpu"), "cpu", rows=2500, trees=3, per_iter=2,
        xendcg_trees=2, extra={"num_leaves": 7, "tpu_iter_block": 2})
    assert summary["model_sha256"] == summary["second_model_sha256"]
    assert summary["train_ndcg10"] > summary["untrained_train_ndcg10"]
    assert row == {} and errs["prng/gumbel_ulps"] == 0.0
    assert {k for k in errs if k.startswith("lambdas/")} == {
        "lambdas/full_width/tied", "lambdas/full_width/seeded",
        "lambdas/full_width/after_3_trees"} | {
        "lambdas/%s/%s" % (tag, case) for tag in
        ("default", "weighted", "no_norm_trunc300", "trunc40")
        for case in ("tied", "seeded", "grid", "nan")}
    # the tree loop's kernels at the phase's width, against their twins
    assert {k for k in errs if k.startswith("rank/")} == {
        "rank/one_kernel/full_width", "rank/one_kernel/deep",
        "rank/commit/full_width_s1", "rank/commit/full_width_s3",
        "rank/commit/full_width_s6"} | {
        "rank/router/full_width_" + tag
        for tag in ("train", "valid", "serve", "chain")}
