"""Multi-process training entry (PyTorch port of
``lightgbm_tpu/parallel/distributed.py``; reference analog: the Dask
layer and the CLI's machine-list network init, application.cpp:168).

Every rank runs the same program, one process a rank, calls
:func:`init_distributed` once and trains with
``tree_learner=data|feature|voting``: the booster builds its learner over
the group (:func:`current_group`, every rank of the default group unless
:func:`global_mesh` names another)::

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.parallel.distributed import init_distributed

    init_distributed()        # torchrun's RANK, WORLD_SIZE, MASTER_ADDR ...
    bst = lgt.train({"tree_learner": "data", ...}, dset)

A rank's device is ``cuda:(local_rank % torch.cuda.device_count())``, or
the host with ``device_type="cpu"``. The backend is NCCL where every rank
of a machine has a card of its own, gloo on the host and where ranks share
a card (NCCL refuses two ranks on one device); ``backend=`` names another.
The choice is logged; a rank never falls back to the host when a card was
asked for.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from datetime import timedelta
from typing import Optional

import torch

from ..utils.log import Log

_CURRENT = []


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device_type: str = "cuda",
                     backend: Optional[str] = None,
                     local_rank: Optional[int] = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group (idempotent). With no arguments the
    ``env://`` variables that torchrun sets are read (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    ``coordinator_address`` is ``host:port`` (or a full ``tcp://`` /
    ``file://`` URL) with ``num_processes`` and ``process_id`` (the
    reference's ``machines`` / ``num_machines``). A failed bootstrap is
    fatal: a rank training alone would run other collectives than its
    peers (the reference aborts in Network::Init likewise)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    try:
        env = os.environ
        world = int(num_processes if num_processes is not None
                    else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
        if local_rank is None:
            local_rank = int(env.get("LOCAL_RANK", rank))
        if coordinator_address is None:
            init_method = "env://"
        elif "://" in coordinator_address:
            init_method = coordinator_address
        else:
            init_method = "tcp://" + coordinator_address
        cuda = str(device_type).lower() != "cpu"
        if cuda:
            if not torch.cuda.is_available():
                raise RuntimeError("device_type=%s asks for a CUDA card and "
                                   "torch finds none" % device_type)
            count = torch.cuda.device_count()
            torch.cuda.set_device(local_rank % count)
        if backend is None:
            local_world = int(env.get("LOCAL_WORLD_SIZE", world))
            backend = "nccl" if cuda and count >= local_world else "gloo"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
    except Exception as e:
        Log.fatal("torch.distributed.init_process_group failed: %s. Fix the "
                  "coordinator/num_processes/process_id bootstrap (or "
                  "torchrun's variables) or train on one process by not "
                  "calling init_distributed.", e)
    where = ("cuda:%d" % torch.cuda.current_device()) if cuda else "cpu"
    Log.info("distributed: rank %d of %d on %s, backend %s%s", rank, world,
             where, backend,
             " (ranks share a card: collectives stage through host memory)"
             if cuda and backend == "gloo" else "")


def backend() -> Optional[str]:
    """The default group's backend, or None outside a group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return str(dist.get_backend())


def make_mesh(n_devices: Optional[int] = None):
    """The group of the first ``n_devices`` ranks (every rank when None);
    every rank of the default group must call it."""
    import torch.distributed as dist
    if n_devices is None or n_devices == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks=list(range(int(n_devices))))


def current_group():
    """The group the booster's distributed learners run over: the
    innermost :func:`global_mesh`'s, else the default group once
    :func:`init_distributed` ran, else None (one process)."""
    import torch.distributed as dist
    if _CURRENT:
        return _CURRENT[-1]
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


@contextmanager
def global_mesh(n_devices: Optional[int] = None, group=None):
    """The boosters built inside train over the group of the first
    ``n_devices`` ranks (every rank when None), or over ``group``, a group
    made earlier (``make_mesh`` is collective: every rank of the default
    group takes part in each call)."""
    if group is None:
        group = make_mesh(n_devices)
    _CURRENT.append(group)
    try:
        yield group
    finally:
        _CURRENT.pop()
