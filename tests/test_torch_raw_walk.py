"""The raw-threshold walk (``csrc/forest_predict.cu``'s ``forest_raw``) on
the CPU: its walk tables (``ops/forest.raw_walk``) and launch plan
(``ops/forest.forest_plan`` with ``raw=True``), its wrapper
(``ops/predict.predict_raw``) and the serving path of a model read from
its text.

The kernel walks each (row, tree) pair along the forest kernel's child
links (``ops/forest.walk_links``) with raw f32 comparisons from each
entry's threshold bits, missing type and default direction. Its link
walk, as plain torch over the tables (``raw_walk_slots_plain``), must
give the slots of the twin's front update (``ops/predict._route_trees``)
and of the JAX package's ``_route_tree``, as integers, on every
``chip_smoke.RAW_EDGE_CASES`` pack: each missing type at its edges
(threshold ties, +-0, the 1e-35 edge, NaN, +-inf), categorical sets
(non-integers, -1, NaN, inf), 3 classes, linear leaves, a 254-round chain,
a chain deeper than the forest kernel's shared memory holds, links past
16 bits, trees without splits, padded rounds and trees, 1000 columns. Its sums,
emulated in numpy in the kernel's order (the lanes' xor shuffles 4, 2,
1; a class's trees in order; groups chained from 0), must equal the
twin's bit for bit. On the host the wrapper runs the twin; the served
answers of models read from their text equal the JAX package's."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_cases import ATOL, CPU, RTOL, torch_threads, train_case

from lightgbm_tpu.ops import predict as jax_predict

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import forest as Fo
from lightgbm_tpu_torch.ops.predict import (_route_trees, predict_raw,
                                            predict_raw_impl)
from lightgbm_tpu_torch.serve import PredictSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

DEV = torch.device("cpu")
ROWS = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    with torch_threads(1):
        yield


def edge_pack(name, seed=5):
    return chip_smoke.raw_edge_pack(name, np.random.RandomState(seed), ROWS,
                                    DEV)


def jax_slots(pk, X, has_cat):
    """(T, N) slots of the JAX package's ``_route_tree`` over the same
    pack (its fields as jnp arrays, features as int32)."""
    jpk = jax_predict.PackedSplits(**{
        k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                       else v.numpy())
        for k, v in pk._asdict().items()})
    return np.asarray(jax.vmap(
        lambda tp: jax_predict._route_tree(jnp.asarray(X.numpy()), tp,
                                           has_cat))(jpk))


@pytest.mark.parametrize("name", chip_smoke.RAW_EDGE_CASES)
def test_walk_tables_route_like_the_twin_and_jax(name):
    pk, X, kw = edge_pack(name)
    rw = Fo.raw_walk(pk)
    T = pk.slot.shape[0]
    assert rw.nodes.shape[1] % Fo.FOREST_TREE_BATCH == 0
    assert rw.num_features <= X.shape[1]
    walk = Fo.raw_walk_slots_plain(X, rw, kw["has_cat"])
    # the padded trees have no split: their rows stay at slot 0
    assert not walk[T:].any()
    twin = _route_trees(X, pk, kw["has_cat"])
    np.testing.assert_array_equal(walk[:T].numpy(), twin.numpy())
    np.testing.assert_array_equal(walk[:T].numpy(),
                                  jax_slots(pk, X, kw["has_cat"]))


def kernel_sums_np(X, rw, num_class, has_cat, has_linear):
    """The kernel's scores in numpy, in its order: each (row, tree) value
    at its walk's slot (a linear leaf's const plus its coefficients times
    the row's values, in coefficient order, unless a used value is NaN),
    then per group of 8 trees the xor shuffles (4, 2, 1) for one class or
    each class's trees in order from 0, and the groups chained in order
    from 0."""
    f32 = np.float32
    slots = Fo.raw_walk_slots_plain(X, rw, has_cat).numpy().astype(np.int64)
    Tp, n = slots.shape
    vals = np.take_along_axis(rw.value_of_slot.numpy(), slots, axis=1)
    if has_linear:
        x = X.numpy()
        for t in range(Tp):
            for i in range(n):
                s = slots[t, i]
                acc, nanrow = f32(0), False
                for k in range(rw.coeff.shape[2]):
                    if not rw.coeff_mask[t, s, k] > 0.5:
                        continue
                    z = x[i, rw.coeff_feat[t, s, k]]
                    if np.isnan(z):
                        nanrow = True
                    else:
                        acc = f32(acc + f32(z * rw.coeff[t, s, k].item()))
                if not nanrow:
                    vals[t, i] = f32(rw.const_of_slot[t, s].item() + acc)
    cls = rw.tree_class.numpy()
    K = max(1, num_class)
    out = np.zeros((n, K), f32)
    for g in range(0, Tp, 8):
        v = vals[g:g + 8]
        if K == 1:
            w = v.copy()
            for step in (4, 2, 1):
                w = np.stack([f32(w[j] + w[j ^ step]) for j in range(8)])
            out[:, 0] = f32(out[:, 0] + w[0])
        else:
            for k in range(K):
                acc = np.zeros(n, f32)
                for j in range(8):
                    acc = f32(acc + (v[j] if cls[g + j] == k else f32(0)))
                out[:, k] = f32(out[:, k] + acc)
    return out[:, 0] if K == 1 else out


@pytest.mark.parametrize("name", chip_smoke.RAW_EDGE_CASES)
def test_kernel_order_sums_equal_the_twin(name):
    pk, X, kw = edge_pack(name)
    if kw["has_linear"]:
        X = X[:40]            # the numpy emulation walks row by row
    rw = Fo.raw_walk(pk)
    got = kernel_sums_np(X, rw, kw["num_class"], kw["has_cat"],
                         kw["has_linear"])
    want = predict_raw_impl(X, pk, **kw).numpy()
    if kw["has_linear"]:
        np.testing.assert_allclose(got, want, rtol=chip_smoke.SCORE_RTOL,
                                   atol=chip_smoke.SCORE_ATOL)
    else:
        assert got.tobytes() == want.tobytes()


def test_predict_raw_takes_the_twin_on_the_host():
    pk, X, kw = edge_pack("mixed_missing")
    want = predict_raw_impl(X, pk, **kw)
    for walk in (None, Fo.raw_walk(pk)):
        got = predict_raw(X, pk, walk=walk, **kw)
        assert got.numpy().tobytes() == want.numpy().tobytes()
    # a tensor on another device launches the kernel or raises: there is
    # no fallback to the twin
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        predict_raw(X.to("meta"), pk, **kw)


def test_raw_plan_covers_rows_and_stages_by_width():
    sms = 132

    def plan(n, T, R, F, K=1):
        return Fo.forest_plan(n, T, R, sms, F, K, raw=True)

    for n in (1, 31, 32, 33, 4096, 65536, 65537):
        p = plan(n, 40, 254, 28)
        assert p.staged and p.tables
        assert p.rows_per_block % Fo.FOREST_PASS_ROWS == 0
        assert p.chunks * p.rows_per_block >= n
        assert p.smem == Fo.forest_smem_bytes(254, 28, True)
        assert p.smem <= Fo.FOREST_SMEM_BYTES
        # one class: a group a span, summed in group order
        assert (p.groups, p.span, p.spans) == (5, 1, 5)
    # a 65,536-row call fills about one wave of the card
    p = plan(65536, 40, 254, 28)
    assert p.chunks * p.spans <= sms * Fo.FOREST_BLOCKS_PER_SM
    # K classes: every group in one span (each class chains its groups)
    p = plan(4096, 120, 254, 28, K=3)
    assert (p.groups, p.span, p.spans) == (15, 15, 1)
    p = plan(10, 16, 254, chip_smoke.RAW_WIDE_F)
    assert not p.staged and p.smem == Fo.forest_smem_bytes(254, 0, False)
    # past the forest kernel's limit the tables stay in device memory
    deep = Fo.FOREST_MAX_ROUNDS + 1
    p = plan(10, 8, deep, 28)
    assert p.staged and not p.tables
    assert p.smem == Fo.forest_smem_bytes(deep, 28, True, False) == \
        2 * Fo.FOREST_PASS_ROWS * 28 * 4
    assert plan(10, 8, 1 << 20, 28).smem == p.smem
    with pytest.raises(ValueError, match="rounds"):
        Fo.forest_plan(10, 8, deep, sms, 28, 1)
    with pytest.raises(ValueError, match="rounds"):
        plan(10, 8, Fo.FOREST_RAW_END, 28)
    with pytest.raises(ValueError, match="groups of 8"):
        plan(10, 12, 10, 28)


def test_walk_links_reach_past_16_bits():
    """A tree of 70,000 rounds whose round 0's left child is split again
    only at the last round: the walk's links hold round numbers past
    16 bits, and a row that goes left at round 0 jumps straight there."""
    from lightgbm_tpu_torch.ops.predict import PackedSplits

    R = 70_000
    slot = np.ones(R, np.int32)
    slot[0] = slot[-1] = 0
    feature = np.zeros(R, np.int64)
    feature[-1] = 1
    threshold = np.full(R, -1e30, np.float32)
    threshold[0], threshold[-1] = 0.0, 0.5

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)[None]).to(dtype)

    pk = PackedSplits(
        slot=t(slot, torch.int32), feature=t(feature, torch.int64),
        threshold=t(threshold, torch.float32),
        kind=torch.zeros((1, R), dtype=torch.int32),
        default_left=torch.zeros((1, R), dtype=torch.bool),
        missing_type=torch.zeros((1, R), dtype=torch.int32),
        num_splits=torch.tensor([R], dtype=torch.int32),
        value_of_slot=t(np.arange(R + 1, dtype=np.float32), torch.float32),
        tree_class=torch.zeros(1, dtype=torch.int32),
        cat_values=torch.full((1, R, 1), -2, dtype=torch.int32),
        const_of_slot=torch.zeros((1, R + 1)),
        coeff=torch.zeros((1, R + 1, 1)),
        coeff_feat=torch.zeros((1, R + 1, 1), dtype=torch.int64),
        coeff_mask=torch.zeros((1, R + 1, 1), dtype=torch.bool))
    rw = Fo.raw_walk(pk)
    assert rw.nodes.shape == (R, 8, 4)
    assert int(rw.nodes[0, 0, 3]) == R - 1          # next_left of round 0
    assert int(rw.nodes[0, 0, 2]) >> 3 == 1         # next_right: round 1
    assert int(rw.nodes[R - 1, 0, 3]) == Fo.FOREST_RAW_END
    assert not Fo.forest_plan(3, 8, R, 132, 2, 1, raw=True).tables
    X = torch.tensor([[-1.0, 0.0], [-1.0, 1.0], [1.0, 0.0]])
    slots = Fo.raw_walk_slots_plain(X, rw)
    assert slots[0].tolist() == [0, R, 2]
    assert not slots[1:].any()


def test_raw_walk_reads_the_widest_column():
    pk, X, kw = edge_pack("linear_nan")
    rw = Fo.raw_walk(pk)
    used = [int(pk.feature.max())]
    used += [int(pk.coeff_feat[pk.coeff_mask].max())]
    assert rw.num_features == max(used) + 1
    assert rw.first[pk.slot.shape[0]:].eq(Fo.FOREST_RAW_END).all()


@pytest.mark.parametrize("name", ["binary", "nan_missing", "categorical",
                                  "multiclass", "linear_nan"])
def test_model_text_serves_the_jax_answers(name, tmp_path):
    """The slice as a whole: a JAX model read by the port from its text
    alone (no bin mappers, so the raw-threshold path serves it) answers
    as the JAX booster does, through a PredictSession and Booster.predict
    (past its device threshold), within the port's score tolerance."""
    bst, _, Xq, _ = train_case(name, tmp_path, n_query=700)
    port = lgt.Booster(dict(CPU), model_str=bst.model_to_string())
    assert port.inner.train_set is None
    want = np.asarray(bst.predict(Xq))
    sess = PredictSession(port, buckets=(256, 1024))
    np.testing.assert_allclose(sess.predict(Xq), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.predict(Xq), want, rtol=RTOL, atol=ATOL)
