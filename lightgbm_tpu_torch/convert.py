"""Carry training state and trained models across from the JAX package.

A model is its text (trees and leaf values, ``model_to_string``) plus the
bin mappers of the data it was trained on. The text alone serves through
the plain raw-threshold predict; the forest kernel and the binned router
route in BIN space and need the mappers too. The JAX package writes them
with ``save_binned`` (``Dataset.save_binary``) in an npz whose format the
port's :func:`~lightgbm_tpu_torch.dataset.load_binned` reads unchanged.

The training state of this system is that binned dataset (bins, mappers,
bundles, labels and metadata) and, when training continues, the model:
:func:`dataset_from_reference` gives the port exactly the JAX package's
bins to train on, and ``engine.train(..., init_model=<model text>)``
continues a JAX model.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .basic import Booster, Dataset
from .dataset import load_binned


def dataset_from_reference(binned_npz_path: str,
                           params: Optional[Dict[str, Any]] = None
                           ) -> Dataset:
    """A constructed port :class:`Dataset` over the npz that the JAX
    package's ``save_binned`` wrote: its bins, bin mappers, EFB bundles,
    labels and metadata, unchanged."""
    ds = Dataset(binned_npz_path, params=params)
    ds.construct()
    return ds


def booster_from_reference(model_str: str, binned_npz_path: str,
                           params: Optional[Dict[str, Any]] = None
                           ) -> Booster:
    """A port :class:`Booster` over ``model_str`` whose ``train_set`` is
    the dataset in ``binned_npz_path`` — eligible for the forest kernel.
    ``params`` (e.g. ``{"device_type": "cpu"}``) configure the booster."""
    bst = Booster(params=params, model_str=model_str)
    ds = load_binned(binned_npz_path)
    used = ds.used_feature_indices
    for t in bst.inner.models:
        for f in t.split_feature[:t.num_internal]:
            if int(f) not in used:
                raise ValueError(
                    "model splits on feature %d, which the binned dataset "
                    "%s does not map" % (int(f), binned_npz_path))
    with bst.inner._cache_lock:
        bst.inner.train_set = ds
        bst.inner._bump_model_version()
    return bst
