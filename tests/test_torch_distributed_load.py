"""Sharded dataset loading of the PyTorch port
(``lightgbm_tpu_torch.io.load_dataset_sharded``) against the JAX
package's, on the CPU; the port's mirror of tests/test_distributed_load.py.

Each rank streams only its row slice and the bin mappers come from a
gathered sample, so no rank holds the whole matrix. The loader is called
once per rank in this process with an explicit gather, in both packages
(the same stand-in for the gather), and every rank's shard is held to the
JAX package's: bins, labels, weights, ``shard_info`` and the mappers'
upper bounds equal. One case runs the port's loader inside a 2-rank gloo
group with its default gathers (``dist.all_gather_object``), and trains
on the shards (data-parallel) against one rank's load of the whole file.
"""
import numpy as np
import pytest

from torch_port_cases import CPU, assert_same_trees
from torch_parallel_worker import run_group

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import load_dataset_sharded as jax_load

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import load_dataset_sharded


@pytest.fixture()
def csv_file(tmp_path):
    rng = np.random.RandomState(7)
    n = 4003   # deliberately not divisible by the shard count
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    w = rng.uniform(0.5, 1.5, size=n)
    f = tmp_path / "train.csv"
    np.savetxt(f, np.column_stack([y, X, w]), delimiter=",", fmt="%.10g")
    return str(f), X, y, w, n


def same_shard(port, jax_ds):
    """A port shard equals the JAX package's."""
    np.testing.assert_array_equal(port.binned, jax_ds.binned)
    assert port.num_data == jax_ds.num_data
    assert port.shard_info == jax_ds.shard_info
    for f in ("label", "weight"):
        a, b = getattr(port.metadata, f), getattr(jax_ds.metadata, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(port.bin_mappers) == len(jax_ds.bin_mappers)
    for ma, mb in zip(port.bin_mappers, jax_ds.bin_mappers):
        np.testing.assert_array_equal(ma.upper_bounds, mb.upper_bounds)


def test_shards_reassemble_to_full_dataset(csv_file):
    path, X, y, w, n = csv_file
    world = 4
    params = {"weight_column": "7", "bin_construct_sample_cnt": 4 * n,
              "verbosity": -1}
    per_rank = [X[r * n // world:(r + 1) * n // world] for r in range(world)]

    def gather(local):
        # with the sample budget >= the slices, each rank's reservoir IS
        # its slice: the gathered sample is every row
        return np.concatenate(per_rank)

    shards = [load_dataset_sharded(path, Config.from_params(
        dict(params, **CPU)), rank=r, world=world, sample_gather=gather)
        for r in range(world)]
    for rank, ds in enumerate(shards):
        r0, r1 = rank * n // world, (rank + 1) * n // world
        assert ds.num_data == r1 - r0 == ds.binned.shape[0]
        assert ds.shard_info == (rank, world, n)
        np.testing.assert_allclose(ds.metadata.label,
                                   y[r0:r1].astype(np.float32))
        np.testing.assert_allclose(ds.metadata.weight,
                                   w[r0:r1].astype(np.float32), rtol=1e-6)
        same_shard(ds, jax_load(path, JConfig.from_params(params), rank=rank,
                                world=world, sample_gather=gather))
    from lightgbm_tpu_torch.dataset import construct_dataset
    full = construct_dataset(np.concatenate(per_rank),
                             Config.from_params(dict(params, **CPU)))
    np.testing.assert_array_equal(np.concatenate([d.binned for d in shards]),
                                  full.binned)


def test_sharded_training_quality(csv_file):
    path, X, y, w, n = csv_file
    params = {"weight_column": "7", "verbosity": -1}
    ds = load_dataset_sharded(path, Config.from_params(dict(params, **CPU)),
                              rank=0, world=1)
    assert ds.shard_info == (0, 1, n)
    same_shard(ds, jax_load(path, JConfig.from_params(params), rank=0,
                            world=1))
    wrap = lgt.Dataset(None)
    wrap._constructed = ds
    bst = lgt.train({"objective": "binary", "num_leaves": 15,
                     "verbose": -1, **CPU}, wrap, num_boost_round=10)
    assert ((bst.predict(X) > 0.5) == y).mean() > 0.95


def test_sharded_group_column(tmp_path):
    rng = np.random.RandomState(9)
    n, qsize = 1200, 20
    X = rng.normal(size=(n, 4))
    y = rng.randint(0, 3, n).astype(float)
    qid = np.repeat(np.arange(n // qsize), qsize).astype(float)
    f = tmp_path / "rank.csv"
    np.savetxt(f, np.column_stack([y, qid, X]), delimiter=",", fmt="%.10g")
    params = {"group_column": "1", "verbosity": -1}
    world = 3   # 400 rows a shard: 20 whole queries each
    for r in range(world):
        ds = load_dataset_sharded(str(f), Config.from_params(
            dict(params, **CPU)), rank=r, world=world,
            sample_gather=lambda s: X)
        assert ds.num_features == 4          # the qid column is no feature
        assert ds.metadata.num_queries == 20
        jds = jax_load(str(f), JConfig.from_params(params), rank=r,
                       world=world, sample_gather=lambda s: X)
        same_shard(ds, jds)
        np.testing.assert_array_equal(ds.metadata.query_boundaries,
                                      jds.metadata.query_boundaries)


def test_pre_partitioned_files(tmp_path):
    """pre_partition=true: each rank's file is its partition; unequal
    shards publish a world * max capacity."""
    rng = np.random.RandomState(5)
    sizes = [600, 400]
    world = 2
    Xs, paths = [], []
    for r, sz in enumerate(sizes):
        X = rng.normal(size=(sz, 5))
        y = (X[:, 0] > 0).astype(np.float64)
        f = tmp_path / f"part{r}.csv"
        np.savetxt(f, np.column_stack([y, X]), delimiter=",", fmt="%.8g")
        Xs.append(X)
        paths.append(str(f))
    params = {"pre_partition": True, "verbosity": -1,
              "bin_construct_sample_cnt": 4000}

    def gather(local):
        return np.concatenate(Xs)

    def counts(local):
        return np.asarray([[float(s), float(s)] for s in sizes])

    for r in range(world):
        ds = load_dataset_sharded(paths[r], Config.from_params(
            dict(params, **CPU)), rank=r, world=world, sample_gather=gather,
            count_gather=counts)
        assert ds.num_data == sizes[r] == ds.binned.shape[0]
        assert ds.shard_info == (r, world, world * max(sizes))
        same_shard(ds, jax_load(paths[r], JConfig.from_params(params),
                                rank=r, world=world, sample_gather=gather,
                                count_gather=counts))


def test_two_rank_group_default_gathers(csv_file, tmp_path):
    """The port's loader in a 2-rank gloo group with its default gathers:
    each rank's shard equals the JAX loader's with the gathered sample
    and counts passed in; data-parallel trees on the two shards equal the
    serial trees on one rank's load of the whole file."""
    path, X, y, w, n = csv_file
    world = 2
    # a budget past the file: every rank samples its whole slice, and the
    # whole-file load samples every row, so both find the same bins
    params = {"weight_column": "7", "verbosity": -1,
              "bin_construct_sample_cnt": 2 * n}
    res = run_group(world, [
        ("load", "load", dict(path=path, params=params)),
        ("train", "load_train", dict(
            path=path, params=dict(params, objective="binary",
                                   num_leaves=15, min_data_in_leaf=5,
                                   boost_from_average=False), rounds=3))],
        tmp_path)
    # each rank's slice as the JAX loader parses it (its slot padded by
    # cycling), the gathered sample without the padding, and the counts
    local = []
    for r in range(world):
        jax_load(path, JConfig.from_params(params), rank=r, world=world,
                 sample_gather=lambda s: local.append(s) or s)
    rows = [n // 2, n - n // 2]
    sample = np.concatenate([local[r][:rows[r]] for r in range(world)])
    stats = np.asarray([[float(k), float(k)] for k in rows])
    for r in range(world):
        jds = jax_load(path, JConfig.from_params(params), rank=r,
                       world=world, sample_gather=lambda s: sample,
                       count_gather=lambda s: stats)
        got = res[r]["load"]
        np.testing.assert_array_equal(got["binned"], jds.binned)
        np.testing.assert_array_equal(got["label"], jds.metadata.label)
        np.testing.assert_array_equal(got["weight"], jds.metadata.weight)
        assert got["shard_info"] == jds.shard_info == (r, world, n)
        for a, b in zip(got["bounds"], jds.bin_mappers):
            np.testing.assert_array_equal(a, b.upper_bounds)
    t0 = res[0]["train"]
    assert t0["sharded_learner"] == "DataParallelTreeLearner"
    assert t0["whole_learner"] == "SerialTreeLearner"
    assert res[1]["train"]["sharded"] == t0["sharded"]
    a = lgt.Booster(dict(CPU), model_str=t0["whole"]).inner.models
    b = lgt.Booster(dict(CPU), model_str=t0["sharded"]).inner.models
    assert_same_trees(a, b)
    # boost_from_average on a sharded load: every rank starts from its own
    # labels' score, as the JAX objective reads the rank's local metadata
    from lightgbm_tpu.objective import create_objective
    for r in range(world):
        jds = jax_load(path, JConfig.from_params(params), rank=r, world=world,
                       sample_gather=lambda s: sample,
                       count_gather=lambda s: stats)
        obj = create_objective(JConfig.from_params({"objective": "binary"}))
        obj.init(jds.metadata)
        np.testing.assert_allclose(res[r]["train"]["init_scores"][0],
                                   obj.boost_from_score(0), rtol=1e-12)
    assert res[0]["train"]["init_scores"] != res[1]["train"]["init_scores"]
