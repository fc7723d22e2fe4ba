"""Rank groups of the PyTorch port on the host, for the distributed
learners' tests (tests/test_torch_parallel.py,
tests/test_torch_distributed_load.py).

:func:`run_group` starts ``world`` processes of this file, one a rank, in
a gloo group that meets in a ``file://`` store under the test's temporary
directory (no port to collide with other test workers). Every rank runs
the same list of cases in the same order, so their collectives pair up,
and writes its results to ``out_<rank>.pkl``. Each join has a timeout;
a rank that fails or hangs kills the group. This file imports torch and
the port, never JAX: the ranks stand alone, as on the card.
"""
import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CPU = {"device_type": "cpu"}


def run_group(world, cases, tmpdir, timeout_s=240.0):
    """Run ``cases`` (a list of ``(name, function name, kwargs)``) on
    ``world`` ranks; returns ``[{name: result}]`` by rank."""
    tmpdir = str(tmpdir)
    spec = os.path.join(tmpdir, "cases.pkl")
    with open(spec, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(tmpdir, "rank%d.log" % rank), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank),
             str(world), tmpdir], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=REPO))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                failed = "a rank failed"
                break
            if time.monotonic() > deadline:
                failed = "timed out after %.0f s" % timeout_s
                break
            time.sleep(0.05)
        if failed is None and any(p.returncode != 0 for p in procs):
            failed = "a rank failed"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        tails = []
        for rank, log in enumerate(logs):
            log.seek(0)
            tails.append("--- rank %d (rc %s)\n%s"
                         % (rank, procs[rank].returncode,
                            log.read()[-3000:]))
        raise AssertionError("rank group of %d: %s\n%s"
                             % (world, failed, "\n".join(tails)))
    for log in logs:
        log.close()
    out = []
    for rank in range(world):
        with open(os.path.join(tmpdir, "out_%d.pkl" % rank), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------- cases

def _log_arrays(log):
    return {k: getattr(log, k).cpu().numpy() for k in log._fields}


def tree(npz, params, ghc, key_seed=0, fmask=None, forced=None):
    """One tree of the mode's learner, built by ``create_tree_learner``
    over the group, from the channels ``ghc`` of every row."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.parallel.distributed import current_group
    from lightgbm_tpu_torch.parallel.mesh import create_tree_learner
    from lightgbm_tpu_torch.prng import PRNGKey

    p = dict(params, **CPU)
    if forced is not None:
        p["forcedsplits_filename"] = forced
    ds = lgt.dataset_from_reference(npz, CPU).construct()
    lrn = create_tree_learner(Config.from_params(p), ds, current_group(),
                              torch.device("cpu"))
    fm = None if fmask is None else torch.as_tensor(fmask)
    log = lrn.train(torch.as_tensor(ghc), fm, PRNGKey(key_seed))
    return {"log": _log_arrays(log), "learner": type(lrn).__name__,
            "stats": dict(lrn.comm.stats)}


def refused(npz, params):
    """The message a learner's construction raises with (none: None)."""
    from lightgbm_tpu_torch.utils.log import LightGBMError
    try:
        tree(npz, params, None)
    except LightGBMError as e:
        return {"error": str(e)}
    return {"error": None}


def train(npz, params, rounds, valid_npz=None, reset=None):
    """``lgt.train`` on the npz's dataset; with ``reset``, one round,
    ``reset_parameter(reset)``, then the rest."""
    import lightgbm_tpu_torch as lgt

    p = dict(params, **CPU)
    ds = lgt.dataset_from_reference(npz, p)
    valid = [lgt.dataset_from_reference(valid_npz, p)] if valid_npz else []
    classes = []
    if reset is None:
        bst = lgt.train(p, ds, rounds, valid_sets=valid)
    else:
        bst = lgt.Booster(p, ds)
        bst.update()
        before = bst.inner.learner
        bst.reset_parameter(reset)
        classes = [type(before).__name__, type(bst.inner.learner).__name__,
                   getattr(before, "group", None)
                   is getattr(bst.inner.learner, "group", None)]
        for _ in range(rounds - 1):
            bst.update()
    return {"model": bst.model_to_string(),
            "learner": type(bst.inner.learner).__name__,
            "classes": classes, "fused": bst.inner.supports_fused()}


def solo(npz, params):
    """The factory without a group and on a group of this rank alone
    (every rank makes every one-rank group, in the same order)."""
    import torch
    import torch.distributed as dist

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.parallel.mesh import create_tree_learner

    cfg = Config.from_params(dict(params, tree_learner="data", **CPU))
    ds = lgt.dataset_from_reference(npz, CPU).construct()
    mine = None
    for r in range(dist.get_world_size()):
        g = dist.new_group(ranks=[r])
        if r == dist.get_rank():
            mine = g
    cpu = torch.device("cpu")
    return {"no_group": type(create_tree_learner(cfg, ds, None, cpu)).__name__,
            "one_rank": type(create_tree_learner(cfg, ds, mine,
                                                 cpu)).__name__}


def load(path, params, sharded=True):
    """``io.load_dataset_sharded`` with its default gathers over the
    group (``sharded``), or the whole file on one rank."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io import load_dataset_sharded

    cfg = Config.from_params(dict(params, **CPU))
    ds = load_dataset_sharded(path, cfg) if sharded else \
        load_dataset_sharded(path, cfg, rank=0, world=1)
    return {"binned": ds.binned, "label": ds.metadata.label,
            "weight": ds.metadata.weight, "shard_info": ds.shard_info,
            "bounds": [m.upper_bounds for m in ds.bin_mappers],
            "num_data": ds.num_data}


def load_train(path, params, rounds):
    """The model of ``rounds`` data-parallel trees on this group's
    sharded load of ``path``, and of the serial trees on one rank's load
    of the whole file."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io import load_dataset_sharded

    out = {}
    for name, kw, learner in (("sharded", {}, "data"),
                              ("whole", {"rank": 0, "world": 1}, "serial")):
        p = dict(params, tree_learner=learner, **CPU)
        wrap = lgt.Dataset(None)
        wrap._constructed = load_dataset_sharded(path, Config.from_params(p),
                                                 **kw)
        bst = lgt.train(p, wrap, rounds)
        out[name] = bst.model_to_string()
        out[name + "_learner"] = type(bst.inner.learner).__name__
    # boost_from_average on the shards: each rank's init score from its
    # own labels, as the JAX package's objective reads its local metadata
    bst = lgt.train(dict(params, tree_learner="data", boost_from_average=True,
                         **CPU), wrap_sharded(path, params), 1)
    out["init_scores"] = [float(v) for v in bst.inner.init_scores]
    return out


def wrap_sharded(path, params):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io import load_dataset_sharded

    wrap = lgt.Dataset(None)
    wrap._constructed = load_dataset_sharded(
        path, Config.from_params(dict(params, **CPU)))
    return wrap


def main(argv):
    rank, world, tmpdir = int(argv[1]), int(argv[2]), argv[3]
    import torch
    torch.set_num_threads(1)
    from lightgbm_tpu_torch.parallel.distributed import init_distributed
    init_distributed("file://" + os.path.join(tmpdir, "store"), world, rank,
                     device_type="cpu", timeout_s=120.0)
    with open(os.path.join(tmpdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    fns = {"tree": tree, "train": train, "solo": solo, "load": load,
           "load_train": load_train, "refused": refused}
    out = {}
    for name, fn, kw in cases:
        out[name] = fns[fn](**kw)
    with open(os.path.join(tmpdir, "out_%d.pkl" % rank), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
