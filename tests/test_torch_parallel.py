"""The distributed tree learners of the PyTorch port (``parallel/``)
against the JAX package's, on the CPU.

The JAX learners run on sub-meshes of the suite's 8 CPU devices
(``lightgbm_tpu.parallel.mesh.make_mesh(D)``, the classes called
directly; ``lgb.train(tree_learner=...)`` takes all 8). The port runs D
gloo ranks, one process each (``torch_parallel_worker.run_group``: every
group once per module, every case inside it), on the same npz and the
same numpy-seeded channels.

The bars:
- one tree per mode (data with and without ``tpu_hist_scatter``,
  feature, voting) at D = 2 and 4 (4001 rows: the last rank's block
  padded) and the further cases at D = 2 (GOSS, int8 on the rows layout,
  a forced split under voting and under scatter, voting at F = 60 with
  ``top_k=8``, the dense builder under data): split count, leaves,
  features, bins, kinds, default directions, routing tables and every
  row's leaf EQUAL; gains, sums and
  leaf values within TRAIN_RTOL / TRAIN_ATOL (1/64-grid L2 channels, so
  the histogram sums are exact in both packages); every rank's log equal
  to rank 0's bit for bit;
- ``lgt.train`` per mode with 8 ranks against ``lgb.train`` on the 8-device
  mesh: the same trees (``assert_same_trees``), the same model text on
  every rank, the mode's learner class and no fused blocks;
- ``reset_parameter`` keeps the learner's class and group; without a
  group, or on a group of one rank, the factory builds the serial learner.
"""
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_port_cases import (CPU, TRAIN_ATOL, TRAIN_RTOL, assert_same_trees,
                              grid, make_train_data)
from torch_parallel_worker import run_group

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.parallel import mesh as jmesh

import lightgbm_tpu_torch as lgt

MODES = ("data", "data_noscatter", "feature", "voting")
JAX_CLASSES = {"data": jmesh.DataParallelTreeLearner,
               "feature": jmesh.FeatureParallelTreeLearner,
               "voting": jmesh.VotingParallelTreeLearner}
PORT_CLASSES = {"data": "DataParallelTreeLearner",
                "feature": "FeatureParallelTreeLearner",
                "voting": "VotingParallelTreeLearner"}
BASE = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
        "min_data_in_leaf": 5, "min_gain_to_split": 1e-3,
        "boost_from_average": False}
#: the forced splits of the forced cases (feature index, threshold)
FORCED = {"feature": 0, "threshold": 0.0,
          "left": {"feature": 1, "threshold": -0.25},
          "right": {"feature": 2, "threshold": 0.125}}
TRAIN_ROUNDS = 5


def mode_params(mode, **extra):
    p = dict(BASE, tree_learner=mode.split("_")[0], **extra)
    if mode == "data_noscatter":
        p["tpu_hist_scatter"] = False
    return p


def save(tmp, name, X, y, params):
    """(JAX BinnedDataset, npz path) of a case: the JAX side bins and
    writes the npz that the port's ranks train on."""
    ds = lgb.Dataset(X, label=y)
    bd = ds.construct(params)
    path = os.path.join(str(tmp), name + ".npz")
    ds.save_binary(path)
    return bd, path


def l2_channels(y, mask=None, amp=None):
    """(N, 3) f32 L2 channels at score 0: (-y, 1, 1), bagged by ``mask``
    and amplified by ``amp`` (GOSS): every value on the 1/64 grid."""
    m = np.ones_like(y) if mask is None else mask.astype(np.float64)
    a = np.ones_like(y) if amp is None else amp
    return np.stack([-y * m * a, m * a, m], axis=1).astype(np.float32)


def wide_data(rng, n, f=60):
    """F = 60 grid columns, a label on the 1/64 grid from 12 of them."""
    X = grid(rng, n, f)
    w = np.zeros(f)
    w[rng.choice(f, 12, replace=False)] = np.round(rng.randn(12) * 8) / 8
    return X, np.round((X @ w) * 64) / 64


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every case's inputs: the JAX dataset, the npz, the channels and the
    parameters, keyed ``(D, name)``."""
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.RandomState(11)
    out = {}
    X2, y2, _ = make_train_data(rng, 3000, objective="regression")
    X4, y4, _ = make_train_data(rng, 4001, objective="regression", efb=True)
    Xw, yw = wide_data(rng, 3000)
    bd2, p2 = save(tmp, "d2", X2, y2, BASE)
    bd4, p4 = save(tmp, "d4", X4, y4, BASE)
    bdw, pw = save(tmp, "wide", Xw, yw, BASE)
    for mode in MODES:
        out[2, mode] = (bd2, p2, l2_channels(y2), mode_params(mode), None)
        out[4, mode] = (bd4, p4, l2_channels(y4), mode_params(mode), None)
    inbag = rng.rand(len(y2)) < 0.4
    amp = np.where(np.abs(y2) < 0.25, 2.0, 1.0)
    out[2, "goss"] = (bd2, p2, l2_channels(y2, inbag, amp),
                      mode_params("data", data_sample_strategy="goss",
                                  top_rate=0.2, other_rate=0.2,
                                  tpu_goss_compact="on"), None)
    out[2, "int8"] = (bd2, p2, l2_channels(y2),
                      mode_params("data", use_quantized_grad=True), None)
    forced = os.path.join(str(tmp), "forced.json")
    with open(forced, "w") as f:
        json.dump(FORCED, f)
    out[2, "forced_voting"] = (bd2, p2, l2_channels(y2),
                               mode_params("voting"), forced)
    out[2, "forced_scatter"] = (bd2, p2, l2_channels(y2),
                                mode_params("data"), forced)
    out[2, "voting_wide"] = (bdw, pw, l2_channels(yw),
                             mode_params("voting", top_k=8), None)
    out[2, "dense"] = (bd2, p2, l2_channels(y2),
                       mode_params("data", tree_builder="dense"), None)
    return out


def _group(world, cases, tmp_path_factory, extra=()):
    todo = [("%s" % name, "tree",
             dict(npz=path, params=params, ghc=ghc, forced=forced))
            for (d, name), (_, path, ghc, params, forced) in cases.items()
            if d == world] + list(extra)
    return run_group(world, todo, tmp_path_factory.mktemp("group%d" % world))


@pytest.fixture(scope="module")
def group2(cases, tmp_path_factory):
    _, path, _, _, _ = cases[2, "data"]
    return _group(2, cases, tmp_path_factory, extra=[
        ("dense_" + m, "refused",
         dict(npz=path, params=mode_params(m, tree_builder="dense")))
        for m in ("feature", "voting")])


@pytest.fixture(scope="module")
def group4(cases, tmp_path_factory):
    return _group(4, cases, tmp_path_factory)


def jax_tree(world, case):
    bd, _, ghc, params, forced = case
    p = dict(params)
    if forced is not None:
        p["forcedsplits_filename"] = forced
    cfg = JConfig.from_params(p)
    lrn = JAX_CLASSES[p["tree_learner"]](cfg, bd, jmesh.make_mesh(world))
    log = lrn.train(jnp.asarray(ghc), jnp.ones(bd.num_features, bool),
                    jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in jax.device_get(log)._asdict()
            .items()}


def check_tree(world, name, case, results):
    want = jax_tree(world, case)
    logs = [r[name]["log"] for r in results]
    for rank, got in enumerate(logs):
        # every rank grew the same tree from the same reduced sums
        for k, v in got.items():
            np.testing.assert_array_equal(v, logs[0][k],
                                          err_msg="rank %d %s" % (rank, k))
    got = logs[0]
    ns = int(want["num_splits"])
    assert int(got["num_splits"][0]) == ns
    assert ns > 3
    for k in ("split_leaf", "feature", "bin", "kind", "default_left",
              "go_left"):
        np.testing.assert_array_equal(got[k][:ns], want[k][:ns], err_msg=k)
    np.testing.assert_array_equal(got["row_leaf"], want["row_leaf"])
    for k in ("gain", "left_sum", "right_sum"):
        np.testing.assert_allclose(got[k][:ns], want[k][:ns], rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=k)
    for k in ("leaf_value", "leaf_sum"):
        np.testing.assert_allclose(got[k][:ns + 1], want[k][:ns + 1],
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=k)
    mode = case[3]["tree_learner"]
    assert results[0][name]["learner"] == PORT_CLASSES[mode]
    return got, want


@pytest.mark.parametrize("mode", MODES)
def test_one_tree_two_ranks(cases, group2, mode):
    check_tree(2, mode, cases[2, mode], group2)


@pytest.mark.parametrize("mode", MODES)
def test_one_tree_four_ranks_uneven_rows(cases, group4, mode):
    """4001 rows of EFB-bundled data: the last rank's block holds three
    pad rows, which reach no histogram, count or leaf."""
    got, _ = check_tree(4, mode, cases[4, mode], group4)
    assert got["row_leaf"].shape == (4001,)
    assert float(got["leaf_sum"][:, 2].sum()) == 4001.0


@pytest.mark.parametrize("name", ["goss", "int8", "forced_voting",
                                  "forced_scatter", "voting_wide", "dense"])
def test_further_cases_two_ranks(cases, group2, name):
    got, _ = check_tree(2, name, cases[2, name], group2)
    if name.startswith("forced"):
        # the forced splits lead the tree: feature 0, then 1 and 2
        np.testing.assert_array_equal(got["feature"][:3], [0, 1, 2])
    if name == "voting_wide":
        # 2k = 16 of 60 features merged a node: the collectives carry
        # 16-row slices, not the whole histogram
        st = group2[0][name]["stats"]
        assert st["bytes"] > 0


@pytest.mark.parametrize("mode", ["feature", "voting"])
def test_dense_builder_refused_but_in_data_mode(group2, mode):
    """The dense builder sums every histogram over the ranks, so it runs
    under tree_learner=data only; the other modes refuse it, as the JAX
    package's learners do (``parallel/mesh.py``)."""
    for r in group2:
        assert "requires the partitioned builder" in r["dense_" + mode][
            "error"]


def test_collective_bytes_by_mode(group2):
    """Per tree, the feature mode moves only votes and SplitInfos, scatter
    mode less than the all-reduce of whole histograms."""
    b = {m: group2[0][m]["stats"]["bytes"] for m in MODES}
    assert b["feature"] < b["data"] and b["feature"] < b["voting"]
    assert b["data"] < 2 * b["data_noscatter"]
    assert group2[0]["data"]["stats"]["staged_bytes"] == 0


# ------------------------------------------------- lgb.train, 8 ranks

@pytest.fixture(scope="module")
def trained8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train8")
    rng = np.random.RandomState(5)
    X, y, _ = make_train_data(rng, 4001, objective="regression")
    params = dict(BASE, min_data_in_leaf=20)
    ds, path = save(tmp, "t8", X, y, params)
    todo = [("train_" + m, "train",
             dict(npz=path, params=dict(params, tree_learner=m),
                  rounds=TRAIN_ROUNDS)) for m in ("data", "feature", "voting")]
    todo.append(("reset", "train",
                 dict(npz=path, params=dict(params, tree_learner="voting"),
                      rounds=3, reset={"learning_rate": 0.05})))
    todo.append(("solo", "solo", dict(npz=path, params=params)))
    res = run_group(8, todo, tmp_path_factory.mktemp("group8"))
    return X, y, params, res


@pytest.mark.parametrize("mode", ["data", "feature", "voting"])
def test_train_eight_ranks_equals_jax_mesh(trained8, mode):
    X, y, params, res = trained8
    p = dict(params, tree_learner=mode)
    jb = lgb.train(p, lgb.Dataset(X, label=y), num_boost_round=TRAIN_ROUNDS)
    assert isinstance(jb.inner.learner, JAX_CLASSES[mode])
    texts = [r["train_" + mode]["model"] for r in res]
    assert all(t == texts[0] for t in texts)
    r0 = res[0]["train_" + mode]
    assert r0["learner"] == PORT_CLASSES[mode]
    assert not r0["fused"]
    port = lgt.Booster(dict(CPU), model_str=texts[0])
    assert_same_trees(jb.inner.models, port.inner.models)
    np.testing.assert_allclose(port.predict(X[:500]), jb.predict(X[:500]),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


def test_reset_parameter_keeps_the_learner(trained8):
    res = trained8[3]
    for r in res:
        before, after, same_group = r["reset"]["classes"]
        assert before == after == PORT_CLASSES["voting"]
        assert same_group
    texts = [r["reset"]["model"] for r in res]
    assert all(t == texts[0] for t in texts)
    # the first tree at the default rate, the next two at the new one
    assert texts[0].count("Tree=") == 3
    assert texts[0].count("shrinkage=0.05\n") == 2


def test_world_size_one_builds_serial(trained8):
    for r in trained8[3]:
        assert r["solo"]["no_group"] == "SerialTreeLearner"
        assert r["solo"]["one_rank"] == "SerialTreeLearner"


@pytest.mark.parametrize("kw", [dict(device_type="cpu"),
                                dict(coordinator_address="127.0.0.1:9",
                                     num_processes=2, process_id=0,
                                     device_type="cuda")])
def test_init_distributed_fails_loudly(monkeypatch, kw):
    """A bootstrap that cannot join a group raises (no env:// variables; a
    card asked for on a host without one) and leaves no group behind: a
    rank never trains alone or on the host in its peers' place."""
    import torch
    import torch.distributed as dist

    from lightgbm_tpu_torch.parallel.distributed import (current_group,
                                                         init_distributed)
    from lightgbm_tpu_torch.utils.log import LightGBMError

    if kw["device_type"] == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(LightGBMError, match="init_process_group failed"):
        init_distributed(**kw)
    assert not dist.is_initialized()
    assert current_group() is None
