"""Shared cases for the PyTorch port's parity tests (tests/test_torch_*.py).

Each case trains a small model with the JAX package on a seeded numpy
grid, writes its training set with ``save_binned`` and carries both into
the port with ``booster_from_reference`` on the CPU — the same inputs go
through both packages. Feature grids are quantized to 1/64 (f32-exact,
including the 1/128 bin midpoints), as in tests/test_forest_kernel.py, so
BIN-space and raw-threshold routing cannot split a row on representation
error.
"""
import contextlib
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lgt  # noqa: E402

#: f32 sums of up to T leaf values in another order than the reference's
#: (which itself differs from its own Pallas kernel by 1 ulp)
RTOL, ATOL = 1e-5, 1e-6

CPU = {"device_type": "cpu"}


@contextlib.contextmanager
def torch_threads(n: int = 1):
    """Run the block on ``n`` torch threads, then restore the count. A
    module-scoped training fixture runs before any function-scoped
    fixture, so it pins its own threads with this (through a module-scoped
    autouse fixture of its test file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def one_torch_thread():
    """One torch thread a test. Training on the host runs many small torch
    ops, which the OpenMP threads of several test workers sharing the
    host's cores slow down many times over; a training-heavy test module
    imports this fixture and makes it autouse."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def grid(rng, n, f):
    return np.round(rng.randn(n, f) * 16) / 64.0


CLASSES = {
    "binary": dict(params={"objective": "binary"}),
    "nan_missing": dict(params={"objective": "binary"}, nan=True),
    "categorical": dict(params={"objective": "binary"}, cat=True),
    "multiclass": dict(params={"objective": "multiclass", "num_class": 3},
                       classes=3),
    "linear": dict(params={"objective": "regression", "linear_tree": True}),
    "linear_nan": dict(params={"objective": "regression",
                               "linear_tree": True}, nan=True),
}


def make_data(rng, n, f, cat=False, nan=False, classes=0):
    X = grid(rng, n, f)
    if cat:
        X[:, 0] = rng.randint(0, 6, size=n)
    if classes:
        y = np.digitize(X[:, 1], [-0.5, 0.5]).astype(np.float64)
    else:
        z = X[:, 1] + 0.25 * grid(rng, n, 1)[:, 0]
        if cat:   # categories 1, 3 and 4 push the label up
            z = z + np.isin(X[:, 0], (1, 3, 4)) - 0.5
        y = (z > 0).astype(np.float64)
    if nan:
        m = rng.rand(n, f) < 0.15
        if cat:
            m[:, 0] = False
        X[m] = np.nan
    return X, y


def train_case(name, tmpdir, rounds=6, n=600, f=8, n_query=300, seed=7,
               extra=None):
    """(jax Booster, port Booster, query rows, npz path) for one class."""
    spec = CLASSES[name]
    rng = np.random.RandomState(seed)
    X, y = make_data(rng, n, f, cat=spec.get("cat", False),
                     nan=spec.get("nan", False),
                     classes=spec.get("classes", 0))
    Xq, _ = make_data(rng, n_query, f, cat=spec.get("cat", False),
                      nan=spec.get("nan", False))
    p = dict(spec["params"], verbosity=-1, num_leaves=15)
    p.update(extra or {})
    ds = lgb.Dataset(X, label=y,
                     categorical_feature=[0] if spec.get("cat") else [])
    bst = lgb.train(p, ds, num_boost_round=rounds)
    path = os.path.join(str(tmpdir), "%s_train.npz" % name)
    ds.save_binary(path)
    port = lgt.booster_from_reference(bst.model_to_string(), path, CPU)
    return bst, port, Xq, path


# ---------------------------------------------------------------- training
#
# Training parity needs data on which every split the two packages take is
# decided by a real gain. The label is a weighted sum of the features plus
# grid noise (no feature is irrelevant, no leaf is pure), and
# min_gain_to_split=1e-3 rejects the splits that exist only by f32
# rounding: on a pure leaf both packages compute "gains" of 1e-5 to 1e-4
# from summation-order noise, and which of those wins is arbitrary. The
# categorical case splits one category against the rest: a many-vs-many
# split and its complement (ascending and descending category order) have
# the same gain up to rounding, so either package may send a set left or
# right (the split scan is held to the many-vs-many case in
# test_torch_split.py on exact sums).

#: tree leaf values and predictions, port vs JAX: the gradients differ by
#: an ulp (exp in XLA vs torch) and histogram sums run in another order
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5

TRAIN_CASES = {
    "binary": dict(objective="binary"),
    "regression": dict(objective="regression"),
    "multiclass": dict(objective="multiclass", num_class=3),
    "nan_missing": dict(objective="binary", nan=True),
    "categorical": dict(objective="binary", cat=True, max_cat_to_onehot=8),
    "efb": dict(objective="binary", efb=True),
}


def make_train_data(rng, n, f=8, objective="binary", cat=False, nan=False,
                    efb=False):
    """(X, y, categorical_feature) for one training case."""
    X = grid(rng, n, f)
    w = np.array([1.0, -0.8, 0.6, -0.45, 0.3, -0.2, 0.12, 0.07])[:f]
    z = X @ w + 0.5 * grid(rng, n, 1)[:, 0]
    if cat:
        X[:, 0] = rng.randint(0, 6, n)
        z = X[:, 1:] @ w[1:] + 0.3 * (np.isin(X[:, 0], (1, 3, 4)) - 0.5) \
            + 0.5 * grid(rng, n, 1)[:, 0]
    if efb:
        # one-hot blocks that EFB bundles, beside the dense columns
        blocks = []
        for _ in range(3):
            ids = rng.randint(0, 8, n)
            oh = np.zeros((n, 8))
            oh[np.arange(n), ids] = 1.0
            z = z + 0.25 * (ids % 3 == 0) - 0.08
            blocks.append(oh)
        X = np.concatenate(blocks + [X], axis=1)
    if objective == "multiclass":
        y = np.digitize(z, [-0.3, 0.3]).astype(np.float64)
    elif objective == "regression":
        y = np.round(z * 64) / 64
    else:
        y = (z > 0).astype(np.float64)
    if nan:
        X[rng.rand(*X.shape) < 0.15] = np.nan
    return X, y, ([0] if cat else [])


def train_params(name, leaves=15):
    spec = dict(TRAIN_CASES[name])
    for k in ("nan", "cat", "efb"):
        spec.pop(k, None)
    return dict(spec, verbosity=-1, num_leaves=leaves, min_gain_to_split=1e-3)


def jax_dataset(name, tmpdir, n=2000, seed=1, valid_rows=0):
    """(JAX Dataset, npz path, X, y, valid (X, y) or None) for a case:
    the JAX side bins and writes the npz that the port trains on."""
    spec = TRAIN_CASES[name]
    rng = np.random.RandomState(seed)
    X, y, cats = make_train_data(
        rng, n + valid_rows, objective=spec["objective"],
        cat=spec.get("cat", False), nan=spec.get("nan", False),
        efb=spec.get("efb", False))
    valid = (X[n:], y[n:]) if valid_rows else None
    X, y = X[:n], y[:n]
    ds = lgb.Dataset(X, label=y, categorical_feature=cats)
    ds.construct(train_params(name))
    path = os.path.join(str(tmpdir), "%s_train_%d.npz" % (name, seed))
    ds.save_binary(path)
    return ds, path, X, y, valid


def assert_same_trees(jax_models, port_models, rtol=TRAIN_RTOL,
                      atol=TRAIN_ATOL):
    """Equal structure (features, thresholds, decision types, categories,
    leaf counts); leaf values at ``rtol`` / ``atol``."""
    assert len(jax_models) == len(port_models)
    for i, (a, b) in enumerate(zip(jax_models, port_models)):
        assert a.num_leaves == b.num_leaves, i
        k = a.num_internal
        for fld in ("split_feature", "threshold", "decision_type",
                    "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, fld)[:k],
                                          getattr(b, fld)[:k],
                                          err_msg="tree %d %s" % (i, fld))
        np.testing.assert_array_equal(a.leaf_count[:a.num_leaves],
                                      b.leaf_count[:b.num_leaves])
        assert {f: list(v) for f, v in a.cat_threshold.items()} == \
            {f: list(v) for f, v in b.cat_threshold.items()}, i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=rtol, atol=atol,
                                   err_msg="tree %d leaf_value" % i)


# ------------------------------------------------------- one-kernel split
#
# The JAX package runs its one-kernel split (``one_kernel_split_planes``)
# as tests/test_one_kernel.py runs it: the Pallas interpreter, the planes
# layout with the fused partition and 256-row chunks.

#: JAX settings of the one-kernel path under the interpreter
JAX_ONE_KERNEL = {"tree_builder": "partition", "tpu_work_layout": "planes",
                  "tpu_partition_kernel": "pallas", "tpu_part_chunk": 256,
                  "tpu_hist_chunk": 256}


def one_kernel_jax_inputs(case):
    """A ``chip_smoke.split_case`` tuple as the JAX ``one_kernel_split_planes``
    takes it, and the same numpy inputs for the port: returns ``(jax
    positional args, jax keyword args, port keyword args, the JAX work
    buffer as numpy, [src, start, cnt, col])``. The segment is all rows,
    routed by the last feature at its middle bin (``split_inputs``); the
    parent histogram is the JAX package's; the port's work buffer is the
    JAX buffer without its sublane padding (its first F + 12 planes)."""
    import jax.numpy as jnp
    import torch
    from lightgbm_tpu.ops import partition as JP
    from lightgbm_tpu.ops.split import FeatureMeta, SplitHyper
    from lightgbm_tpu_torch.ops import split as PS

    bins, ghc, meta, hp, fmask, (lows2, ups2, outs2), depth, nan_at = case
    n, f = bins.shape
    nb = int(meta["num_bins"].max())
    ch = JAX_ONE_KERNEL["tpu_part_chunk"]
    guard = ch + 2 * JP.PLANE_ALIGN
    npad = JP.planes_npad(n, guard, "pallas")
    _, w_pl = JP.work_spec(f, False, "pallas", ch, ch, layout="planes")
    work = jnp.zeros((2, w_pl, npad), jnp.uint8)
    work, root = JP.pack_planes_fold_root(work, jnp.asarray(bins),
                                          jnp.asarray(ghc), guard,
                                          num_bins=nb, exact=True, chunk=ch)
    root = np.array(root)
    if nan_at is not None:
        root[nan_at[0], nan_at[1], 0] = np.nan
    col = f - 1
    table = np.arange(nb) <= int(meta["num_bins"][col]) // 2
    go = table[bins[:, col]]
    sums2 = np.stack([ghc[go].sum(axis=0), ghc[~go].sum(axis=0)]) \
        .astype(np.float32)
    left_smaller = bool(go.sum() <= (~go).sum())
    seg = [0, guard, n, col]
    jargs = (work, jnp.int32(0), jnp.int32(guard), jnp.int32(n),
             jnp.int32(col), jnp.asarray(table), jnp.bool_(left_smaller),
             jnp.int32(depth), jnp.asarray(root),
             FeatureMeta(**{k: jnp.asarray(v) for k, v in meta.items()}),
             jnp.asarray(fmask), jnp.asarray(sums2), jnp.asarray(outs2),
             jnp.asarray(lows2), jnp.asarray(ups2), SplitHyper(**hp))
    jkw = dict(num_bins=nb, num_feat=f, ch=ch, hist_chunk=ch)

    def t(a):
        return torch.as_tensor(np.array(a))

    pkw = dict(go_left=t(table), left_smaller=left_smaller, depth=depth,
               parent_hist=t(root),
               meta=PS.FeatureMeta(**{k: t(v) for k, v in meta.items()}),
               fmask=t(fmask), sums2=t(sums2), outs2=t(outs2),
               lows2=t(lows2), ups2=t(ups2), hp=PS.SplitHyper(**hp),
               num_bins=nb, num_feat=f, cnt_bound=n)
    return jargs, jkw, pkw, np.array(work), seg


def one_kernel_tree_data(rng, n=1501, f=20):
    """(X, y) on the 1/64 grid: a weighted sum of every feature plus grid
    noise, so no feature is irrelevant and no leaf is pure."""
    X = grid(rng, n, f)
    z = X @ rng.randn(f) + 0.5 * grid(rng, n, 1)[:, 0]
    return X, (z > 0).astype(np.float64)


# ------------------------------------------------- f32 histogram order
#
# The summation order of the port's f32 segment histograms (K4 planes,
# rows and resident, and phase B of the one-kernel split; see
# lightgbm_tpu_torch/csrc/segment_hist.cuh), emulated in float32 numpy.

def hist_order_np(bins, ch, num_bins):
    """(n, F) bin codes + (n, NCH) f32 per-row contributions -> (F, B, NCH)
    f32 sums in the kernels' order: chunks of HIST_CHUNK rows; in a chunk,
    slice s holds the 32-row steps q with q % HIST_SLICES == s and adds its
    rows one by one in row order (``np.add.at`` accumulates repeated
    indices sequentially, in the array's float32); a chunk's partial is
    its slices added left to right; the segment's sum is zero plus the
    partials in chunk order."""
    from lightgbm_tpu_torch.ops.histogram import HIST_CHUNK, HIST_SLICES

    n, nf = bins.shape
    nch = ch.shape[1]
    ch = np.asarray(ch, np.float32)
    total = np.zeros((nf, num_bins, nch), np.float32)
    for c0 in range(0, n, HIST_CHUNK):
        rows = np.arange(c0, min(c0 + HIST_CHUNK, n))
        sl = ((rows - c0) // 32) % HIST_SLICES
        part = None
        for s in range(HIST_SLICES):
            r = rows[sl == s]
            h = np.zeros((nf, num_bins, nch), np.float32)
            for f in range(nf):
                for k in range(nch):
                    np.add.at(h[f, :, k], bins[r, f], ch[r, k])
            part = h if part is None else part + h
        total = total + part
    return total


def combine_np(acc, exact):
    """(F, B, NCH) f32 channel sums -> (F, B, 3): hi + lo in f32."""
    if not exact:
        return acc
    return np.stack([acc[..., 0] + acc[..., 1], acc[..., 2] + acc[..., 3],
                     acc[..., 4]], axis=-1).astype(np.float32)
