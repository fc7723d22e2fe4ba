"""Plotting utilities (PyTorch port of ``lightgbm_tpu/plotting.py``;
reference: python-package/lightgbm/plotting.py:25 plot_importance /
plot_metric / plot_tree / create_tree_digraph).

They read the host trees and run on the host. matplotlib and graphviz are
optional: importing this module is always safe; each function raises a
clear error if its backend is missing.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from .basic import Booster

__all__ = ["plot_importance", "plot_metric", "plot_tree",
           "create_tree_digraph"]


def _check_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("plot_* functions require matplotlib") from e


def _booster_of(model) -> Booster:
    if isinstance(model, Booster):
        return model
    if hasattr(model, "booster_"):
        return model.booster_
    raise TypeError("expected a Booster or fitted sklearn estimator")


def plot_importance(booster, ax=None, height: float = 0.2,
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features", grid: bool = True,
                    precision: int = 3, **kwargs):
    """Horizontal bar chart of feature importances
    (reference: plotting.py plot_importance)."""
    plt = _check_matplotlib()
    bst = _booster_of(booster)
    imp = bst.feature_importance(importance_type=importance_type)
    names = bst.feature_name()
    order = np.argsort(imp)
    order = order[imp[order] > 0]
    if max_num_features is not None and max_num_features > 0:
        order = order[-max_num_features:]
    if ax is None:
        _, ax = plt.subplots(1, 1)
    vals = imp[order]
    ylocs = np.arange(len(order))
    ax.barh(ylocs, vals, height=height, **kwargs)
    for v, y in zip(vals, ylocs):
        ax.text(v + 1e-9, y,
                ("%." + str(precision) + "g") % v, va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels([names[i] for i in order])
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(eval_result: Union[Dict, Booster], metric: Optional[str] = None,
                dataset_names=None, ax=None, title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "auto",
                grid: bool = True):
    """Plot recorded evaluation metrics (reference: plotting.py plot_metric;
    pass the dict filled by ``record_evaluation``)."""
    plt = _check_matplotlib()
    if isinstance(eval_result, Booster):
        raise TypeError("pass the dict from lgb.record_evaluation(), "
                        "not the Booster")
    if not isinstance(eval_result, dict) or not eval_result:
        raise ValueError("eval_result is empty — use record_evaluation")
    if ax is None:
        _, ax = plt.subplots(1, 1)
    names = dataset_names or list(eval_result.keys())
    chosen = None
    for name in names:
        metrics = eval_result[name]
        m = metric or next(iter(metrics))
        chosen = m
        vals = metrics[m]
        ax.plot(np.arange(1, len(vals) + 1), vals, label="%s %s" % (name, m))
    ax.legend(loc="best")
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(chosen if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: int = 3, **kwargs):
    """Graphviz Digraph of one tree (reference: plotting.py
    create_tree_digraph)."""
    try:
        import graphviz
    except ImportError as e:  # pragma: no cover
        raise ImportError("create_tree_digraph requires the graphviz "
                          "package") from e
    bst = _booster_of(booster)
    tree = bst.inner.models[tree_index]
    names = bst.feature_name()
    g = graphviz.Digraph(**kwargs)

    def node_name(nd):
        return "split%d" % nd if nd >= 0 else "leaf%d" % (~nd)

    for nd in range(tree.num_internal):
        f = int(tree.split_feature[nd])
        label = "%s <= %.*g\ngain: %.*g" % (
            names[f] if f < len(names) else "f%d" % f,
            precision, tree.threshold[nd], precision, tree.split_gain[nd])
        g.node(node_name(nd), label=label, shape="box")
        for child in (tree.left_child[nd], tree.right_child[nd]):
            if child < 0:
                leaf = ~int(child)
                g.node(node_name(child),
                       label="leaf %d: %.*g" % (leaf, precision,
                                                tree.leaf_value[leaf]))
            g.edge(node_name(nd), node_name(int(child)))
    if tree.num_leaves <= 1:
        g.node("leaf0", label="leaf 0: %.3g" % tree.leaf_value[0])
    return g


def plot_tree(booster, tree_index: int = 0, figsize=None, ax=None, **kwargs):
    """Render one tree (matplotlib image of the graphviz digraph —
    reference: plotting.py plot_tree)."""
    plt = _check_matplotlib()
    g = create_tree_digraph(booster, tree_index=tree_index, **kwargs)
    import io as _io
    try:
        png = g.pipe(format="png")
    except Exception as e:  # pragma: no cover - graphviz binary missing
        raise RuntimeError("graphviz executable not available: %s" % e)
    img = plt.imread(_io.BytesIO(png))
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ax.imshow(img)
    ax.axis("off")
    return ax
