"""Shared cases for the PyTorch port's parity tests (tests/test_torch_*.py).

Each case trains a small model with the JAX package on a seeded numpy
grid, writes its training set with ``save_binned`` and carries both into
the port with ``booster_from_reference`` on the CPU — the same inputs go
through both packages. Feature grids are quantized to 1/64 (f32-exact,
including the 1/128 bin midpoints), as in tests/test_forest_kernel.py, so
BIN-space and raw-threshold routing cannot split a row on representation
error.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lgt  # noqa: E402

#: f32 sums of up to T leaf values in another order than the reference's
#: (which itself differs from its own Pallas kernel by 1 ulp)
RTOL, ATOL = 1e-5, 1e-6

CPU = {"device_type": "cpu"}


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
