"""Plotting: feature importance, metric history, tree rendering.

The port's own copy of ``lightgbm_tpu/plotting.py`` (the reference's
plotting module: ``plot_importance``, ``plot_metric``, ``plot_tree``,
``create_tree_digraph``). It reads a booster's ``feature_importance`` and
``dump_model`` on the host; matplotlib and graphviz are optional imports
that raise with a message naming what they are needed for.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster


def _resolve_booster(obj) -> Booster:
    """Accept a Booster or a fitted sklearn wrapper (``.booster_``)."""
    if isinstance(obj, Booster):
        return obj
    inner = getattr(obj, "booster_", None)
    if isinstance(inner, Booster):
        return inner
    raise TypeError("expected a Booster or fitted LGBMModel, got %s"
                    % type(obj).__name__)


def _pair(value, name: str):
    """Validate an (a, b) tuple argument (xlim/ylim/figsize)."""
    if not (isinstance(value, tuple) and len(value) == 2):
        raise TypeError("%s must be a tuple of 2 elements." % name)
    return value


def _new_axes(ax, figsize):
    if ax is not None:
        return ax
    import matplotlib.pyplot as plt
    if figsize is not None:
        _pair(figsize, "figsize")
    return plt.subplots(1, 1, figsize=figsize)[1]


def _style_axes(ax, *, title, xlabel, ylabel, xlim=None, ylim=None,
                grid=True):
    if xlim is not None:
        ax.set_xlim(_pair(xlim, "xlim"))
    if ylim is not None:
        ax.set_ylim(_pair(ylim, "ylim"))
    for setter, value in ((ax.set_title, title), (ax.set_xlabel, xlabel),
                          (ax.set_ylabel, ylabel)):
        if value is not None:
            setter(value)
    ax.grid(grid)
    return ax


def _require_matplotlib(what: str):
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("matplotlib is required to %s" % what) from e


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim=None, ylim=None, title="Feature importance",
                    xlabel="Feature importance", ylabel="Features",
                    importance_type: str = "split", max_num_features=None,
                    ignore_zero: bool = True, figsize=None, grid: bool = True,
                    precision: Optional[int] = 3, **kwargs):
    """Horizontal bar chart of per-feature importance."""
    _require_matplotlib("plot importance")
    bst = _resolve_booster(booster)
    values = np.asarray(bst.feature_importance(importance_type), np.float64)
    names = list(bst.feature_name())
    if values.size == 0:
        raise ValueError("the model has no feature importances to plot")

    order = np.argsort(values, kind="stable")
    if ignore_zero:
        order = order[values[order] > 0]
    if max_num_features is not None and max_num_features > 0:
        order = order[-max_num_features:]
    shown = values[order]
    ypos = np.arange(order.size)

    ax = _new_axes(ax, figsize)
    ax.barh(ypos, shown, align="center", height=height, **kwargs)
    fmt = ("%%.%df" % precision) if (precision is not None
                                     and importance_type == "gain") else None
    for y, v in zip(ypos, shown):
        ax.text(v + 1, y, fmt % v if fmt else str(int(v)), va="center")
    ax.set_yticks(ypos)
    ax.set_yticklabels([names[i] for i in order])
    return _style_axes(ax, title=title, xlabel=xlabel, ylabel=ylabel,
                       xlim=xlim, ylim=ylim, grid=grid)


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim=None, ylim=None, title="Metric during training",
                xlabel="Iterations", ylabel="auto", figsize=None,
                grid: bool = True):
    """Line chart of a recorded eval metric across iterations.

    ``booster`` is either the dict filled by ``record_evaluation`` or a
    fitted sklearn wrapper carrying ``evals_result_``.
    """
    _require_matplotlib("plot metrics")
    if isinstance(booster, dict):
        history = deepcopy(booster)
    elif hasattr(booster, "evals_result_"):
        history = deepcopy(booster.evals_result_)
    else:
        raise TypeError("expected a record_evaluation dict or fitted "
                        "LGBMModel, got %s" % type(booster).__name__)
    if not history:
        raise ValueError("no recorded evaluation results to plot")

    names = dataset_names if dataset_names is not None else list(history)
    first = history[names[0]]
    if metric is None:
        if len(first) != 1:
            raise ValueError("several metrics were recorded; pass `metric` "
                             "to pick one of %s" % sorted(first))
        metric = next(iter(first))
    elif metric not in first:
        raise ValueError("metric %r was not recorded for dataset %r"
                         % (metric, names[0]))

    ax = _new_axes(ax, figsize)
    lo, hi = float("inf"), float("-inf")
    for name in names:
        series = history[name][metric]
        lo, hi = min(lo, min(series)), max(hi, max(series))
        ax.plot(range(len(series)), series, label=name)
    ax.legend(loc="best")
    if ylim is None:
        margin = (hi - lo) * 0.2
        ylim = (lo - margin, hi + margin)
    return _style_axes(ax, title=title, xlabel=xlabel,
                       ylabel=metric if ylabel == "auto" else ylabel,
                       xlim=xlim, ylim=ylim, grid=grid)


def _node_label(node: Dict[str, Any], feature_names, show_info, precision):
    """Build the graphviz label for one dumped-model node."""
    def rnd(x):
        return round(x, precision) if isinstance(x, float) else x

    if "split_index" in node:
        feat = node["split_feature"]
        feat_name = (feature_names[feat] if feature_names
                     else "feature %d" % feat)
        lines = ["%s %s %s" % (feat_name, node.get("decision_type", "<="),
                               rnd(node["threshold"]))]
        for key in show_info:
            if key in ("split_gain", "internal_value"):
                lines.append("%s: %s" % (key, rnd(node[key])))
            elif key == "internal_count":
                lines.append("count: %d" % node[key])
        return "split%d" % node["split_index"], "\n".join(lines)
    lines = ["leaf %d: %s" % (node["leaf_index"], rnd(node["leaf_value"]))]
    if "leaf_count" in show_info:
        lines.append("count: %d" % node["leaf_count"])
    return "leaf%d" % node["leaf_index"], "\n".join(lines)


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: Optional[int] = 3, **kwargs):
    """Build a graphviz Digraph of one tree from the dumped model."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("graphviz is required to draw trees") from e
    bst = _resolve_booster(booster)
    model = bst.dump_model()
    trees = model["tree_info"]
    if not 0 <= tree_index < len(trees):
        raise IndexError("tree_index %d out of range (model has %d trees)"
                         % (tree_index, len(trees)))
    feature_names = model.get("feature_names")
    show_info = show_info or []

    graph = Digraph(**kwargs)
    stack = [(trees[tree_index]["tree_structure"], None, None)]
    while stack:
        node, parent, branch = stack.pop()
        name, label = _node_label(node, feature_names, show_info, precision)
        graph.node(name, label=label)
        if parent is not None:
            graph.edge(parent, name, branch)
        if "split_index" in node:
            stack.append((node["right_child"], name, "no"))
            stack.append((node["left_child"], name, "yes"))
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              show_info=None, precision: Optional[int] = 3, **kwargs):
    """Render one tree into a matplotlib axis (via graphviz png)."""
    _require_matplotlib("plot trees")
    import matplotlib.image as mpimg
    from io import BytesIO
    ax = _new_axes(ax, figsize)
    graph = create_tree_digraph(booster, tree_index, show_info, precision,
                                **kwargs)
    ax.imshow(mpimg.imread(BytesIO(graph.pipe(format="png"))))
    ax.axis("off")
    return ax
