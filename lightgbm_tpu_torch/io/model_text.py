"""LightGBM-compatible model text, its JSON dump and its C++ export.

The port's own copy of ``lightgbm_tpu/io/model_text.py``
(gbdt_model_text.cpp:244-341 SaveModelToString, :343+ LoadModelFromString,
:15-58 DumpModel and :60-243 ModelToIfElse, tree.cpp:207-238
Tree::ToString of the reference). A
model written here loads in the JAX package and in the reference, and the
other way round. ``decision_type`` is bit-packed: bit0 categorical, bit1
default_left, bits 2-3 missing type. A categorical node's threshold is its
index into ``cat_boundaries``, which delimit its words of raw-category
bitset in ``cat_threshold`` (trailing zero words dropped).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ..core.tree import split_leaf_of_nodes
from ..log import LightGBMError

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
_MISSING_NAMES = {0: "None", 1: "Zero", 2: "NaN"}


def _fmt(x: float) -> str:
    """Shortest round-trip float formatting (like C++ max_digits10 output)."""
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


def _join(arr, fmt=str) -> str:
    return " ".join(fmt(v) for v in arr)


def tree_to_string(ht, tree_index: int) -> str:
    """One ``Tree=i`` block (tree.cpp Tree::ToString:207-238)."""
    nl = ht.num_leaves_actual
    nn = max(nl - 1, 0)
    is_cat = np.asarray(ht.is_categorical[:nn], bool)
    num_cat = int(is_cat.sum())
    lines = ["Tree=%d" % tree_index, "num_leaves=%d" % nl,
             "num_cat=%d" % num_cat]
    if nn > 0:
        decision_type = (np.where(is_cat, K_CATEGORICAL_MASK, 0)
                         | np.where(ht.default_left[:nn], K_DEFAULT_LEFT_MASK,
                                    0)
                         | ((ht.missing_type[:nn].astype(np.int64) & 3) << 2))
        thresholds, cat_boundaries, cat_threshold = [], [0], []
        for i in range(nn):
            if not is_cat[i]:
                thresholds.append(_fmt(float(ht.threshold[i])))
                continue
            # the node's index into cat_boundaries (tree.h:276-291)
            thresholds.append(str(len(cat_boundaries) - 1))
            words = [int(w) for w in ht.cat_bitset[i]]
            while len(words) > 1 and words[-1] == 0:
                words.pop()
            cat_threshold.extend(words)
            cat_boundaries.append(len(cat_threshold))
        lines.append("split_feature=" + _join(ht.split_feature[:nn]))
        lines.append("split_gain=" + _join(ht.split_gain[:nn], _fmt))
        lines.append("threshold=" + " ".join(thresholds))
        lines.append("decision_type=" + _join(decision_type))
        lines.append("left_child=" + _join(ht.left_child[:nn]))
        lines.append("right_child=" + _join(ht.right_child[:nn]))
        lines.append("leaf_value=" + _join(ht.leaf_value[:nl], _fmt))
        lines.append("leaf_count=" + _join(ht.leaf_count[:nl]))
        lines.append("internal_value=" + _join(ht.internal_value[:nn], _fmt))
        lines.append("internal_count=" + _join(ht.internal_count[:nn]))
        if num_cat > 0:
            lines.append("cat_boundaries=" + _join(cat_boundaries))
            lines.append("cat_threshold=" + _join(cat_threshold))
    else:
        lines += ["split_feature=", "split_gain=", "threshold=",
                  "decision_type=", "left_child=", "right_child=",
                  "leaf_value=" + _fmt(float(ht.leaf_value[0])),
                  "leaf_count=" + str(int(ht.leaf_count[0])),
                  "internal_value=", "internal_count="]
    lines.append("shrinkage=" + _fmt(ht.shrinkage))
    return "\n".join(lines) + "\n\n"


def objective_to_string(objective, config) -> str:
    """ObjectiveFunction::ToString of the slice's objectives (each
    objective's ToString; model_text.py:124-141 of the JAX package). A
    multiclass header also writes ``num_class`` and
    ``num_tree_per_iteration``, which ``parse_model_string`` reads back."""
    if objective is None:
        return "custom"
    name = objective.name
    if name == "binary":
        return "binary sigmoid:%s" % _fmt(config.sigmoid)
    if name == "multiclass":
        return "multiclass num_class:%d" % config.num_class
    if name == "multiclassova":
        return "multiclassova num_class:%d sigmoid:%s" % (
            config.num_class, _fmt(config.sigmoid))
    if name == "regression" and config.reg_sqrt:
        return "regression sqrt"
    if name == "quantile":
        return "quantile alpha:%s" % _fmt(config.alpha)
    return name


def model_to_string(booster, feature_names: List[str],
                    feature_infos: List[str],
                    num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    parameters: str = "") -> str:
    """GBDT::SaveModelToString (gbdt_model_text.cpp:244-341)."""
    k = booster.num_tree_per_iteration
    total_iter = len(booster.models) // max(k, 1)
    start_iteration = min(max(start_iteration, 0), total_iter)
    if num_iteration is not None and num_iteration > 0:
        num_used = min((start_iteration + num_iteration) * k,
                       len(booster.models))
    else:
        num_used = len(booster.models)
    start_model = start_iteration * k

    out = ["tree", "version=v2",
           "num_class=%d" % booster.num_class,
           "num_tree_per_iteration=%d" % k,
           "label_index=0",
           "max_feature_idx=%d" % (len(feature_names) - 1),
           "objective=%s" % objective_to_string(booster.objective,
                                                booster.config)]
    if booster.average_output:
        out.append("average_output")
    out += ["feature_names=" + " ".join(feature_names),
           "feature_infos=" + " ".join(feature_infos)]
    tree_strs = [tree_to_string(booster.models[i], idx)
                 for idx, i in enumerate(range(start_model, num_used))]
    out.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
    out.append("")
    body = "\n".join(out) + "\n" + "".join(tree_strs) + "end of trees\n"

    # feature importances (gbdt_model_text.cpp:303-319)
    imp = booster.feature_importance("split")
    pairs = sorted(((imp[i], feature_names[i]) for i in range(len(imp))
                    if i < len(feature_names) and imp[i] > 0), reverse=True)
    body += "\nfeature importances:\n"
    for v, name in pairs:
        body += "%s=%d\n" % (name, int(v))
    if parameters:
        body += "\nparameters:\n" + parameters + "\nend of parameters\n"
    return body


class LoadedTree:
    """Parsed tree block, shaped like boosting.gbdt.HostTree for
    prediction."""

    def __init__(self, kv: Dict[str, str]):
        nl = int(kv["num_leaves"])
        num_cat = int(kv.get("num_cat", "0"))
        self.num_leaves = nl
        self.num_leaves_actual = nl
        nn = max(nl - 1, 0)

        def arr(key, dtype, n, default=0):
            s = kv.get(key, "").strip()
            if not s:
                return np.full(n, default, dtype)
            return np.array(s.split(" "), dtype=np.float64).astype(dtype)

        self.split_feature = arr("split_feature", np.int32, nn)
        self.split_gain = arr("split_gain", np.float32, nn)
        self.threshold_bin = np.zeros(nn, np.int32)
        self.left_child = arr("left_child", np.int32, nn, -1)
        self.right_child = arr("right_child", np.int32, nn, -1)
        if nl > 1:
            self.leaf_value = arr("leaf_value", np.float64, nl)
            self.leaf_count = arr("leaf_count", np.int64, nl)
        else:
            self.leaf_value = np.array(
                [float(kv.get("leaf_value", "0") or 0)], np.float64)
            self.leaf_count = np.array(
                [int(float(kv.get("leaf_count", "0") or 0))], np.int64)
        self.internal_value = arr("internal_value", np.float64, nn)
        self.internal_count = arr("internal_count", np.int64, nn)
        self.leaf_weight = np.zeros(nl, np.float64)
        self.internal_weight = np.zeros(nn, np.float64)
        dt = arr("decision_type", np.int32, nn)
        self.is_categorical = (dt & K_CATEGORICAL_MASK) > 0
        self.default_left = (dt & K_DEFAULT_LEFT_MASK) > 0
        self.missing_type = (dt >> 2) & 3
        self.shrinkage = float(kv.get("shrinkage", "1"))

        # a categorical node's threshold indexes cat_boundaries; its words
        # fill a bitset as wide as the tree's widest
        thr = kv.get("threshold", "").split() if nn else []
        self.threshold = np.array(
            [0.0 if c else float(v) for v, c in zip(thr, self.is_categorical)],
            np.float64)
        words = 8
        if num_cat > 0:
            bounds = arr("cat_boundaries", np.int64, num_cat + 1)
            cat_words = np.array(kv.get("cat_threshold", "").split(),
                                 np.int64)
            words = max(words, int(np.diff(bounds).max(initial=0)))
        self.cat_bitset = np.zeros((max(nn, 1), words), np.uint32)
        for i in np.flatnonzero(self.is_categorical):
            ci = int(float(thr[i]))
            w = cat_words[bounds[ci]:bounds[ci + 1]]
            self.cat_bitset[i, :len(w)] = w.astype(np.uint32)
        self.split_leaf = split_leaf_of_nodes(self.left_child, nn)


def parse_model_string(model_str: str) -> Dict:
    """GBDT::LoadModelFromString (gbdt_model_text.cpp:343+)."""
    if "tree" not in model_str[:200]:
        raise LightGBMError("Model format error: no 'tree' header")
    head, _, rest = model_str.partition("Tree=")
    kv: Dict[str, str] = {}
    for line in head.splitlines():
        line = line.strip()
        if "=" in line:
            key, _, v = line.partition("=")
            kv[key] = v
    trees: List[LoadedTree] = []
    body = "Tree=" + rest if rest else ""
    for block in body.split("Tree=")[1:]:
        block = block.split("end of trees")[0]
        tkv: Dict[str, str] = {}
        for line in block.splitlines():
            if "=" in line:
                key, _, v = line.partition("=")
                tkv[key.strip()] = v
        trees.append(LoadedTree(tkv))
    result = {
        "num_class": int(kv.get("num_class", "1")),
        "num_tree_per_iteration": int(kv.get("num_tree_per_iteration", "1")),
        "max_feature_idx": int(kv.get("max_feature_idx", "0")),
        "objective": kv.get("objective", ""),
        "average_output": "average_output" in head,
        "feature_names": kv.get("feature_names", "").split(),
        "feature_infos": kv.get("feature_infos", "").split(),
        "trees": trees,
    }
    if "\nparameters:" in model_str:
        params_part = model_str.split("\nparameters:", 1)[1]
        result["parameters"] = params_part.split("end of parameters")[0].strip()
    return result


def parse_model_file(path: str) -> Dict:
    """Load and parse a model-text file (GBDT::LoadModelFromFile): a
    malformed file raises here, before any Booster or device state is
    built (``task=convert_model`` reads its model this way)."""
    with open(path, "r") as fh:
        return parse_model_string(fh.read())


def model_to_json(booster, feature_names: List[str],
                  feature_infos: List[str],
                  num_iteration: Optional[int] = None) -> str:
    """GBDT::DumpModel JSON (gbdt_model_text.cpp:15-58, tree.cpp:242-301)."""
    k = booster.num_tree_per_iteration
    num_used = len(booster.models)
    if num_iteration is not None and num_iteration > 0:
        num_used = min(num_iteration * k, num_used)

    def node_to_json(ht, index):
        if index < 0:  # leaf
            li = ~index
            return {
                "leaf_index": int(li),
                "leaf_value": float(ht.leaf_value[li]),
                "leaf_count": int(ht.leaf_count[li]),
            }
        d = {
            "split_index": int(index),
            "split_feature": int(ht.split_feature[index]),
            "split_gain": float(ht.split_gain[index]),
            "threshold": float(ht.threshold[index]),
            "decision_type": "==" if ht.is_categorical[index] else "<=",
            "default_left": bool(ht.default_left[index]),
            "missing_type": _MISSING_NAMES.get(int(ht.missing_type[index]),
                                               "None"),
            "internal_value": float(ht.internal_value[index]),
            "internal_count": int(ht.internal_count[index]),
            "left_child": node_to_json(ht, int(ht.left_child[index])),
            "right_child": node_to_json(ht, int(ht.right_child[index])),
        }
        return d

    trees = []
    for i in range(num_used):
        ht = booster.models[i]
        t = {"tree_index": i,
             "num_leaves": int(ht.num_leaves_actual),
             "shrinkage": float(ht.shrinkage)}
        if ht.num_leaves_actual <= 1:
            t["tree_structure"] = {"leaf_value": float(ht.leaf_value[0])}
        else:
            t["tree_structure"] = node_to_json(ht, 0)
        trees.append(t)

    return json.dumps({
        "name": "tree",
        "version": "v2",
        "num_class": booster.num_class,
        "num_tree_per_iteration": k,
        "label_index": 0,
        "max_feature_idx": len(feature_names) - 1,
        "objective": objective_to_string(booster.objective, booster.config),
        "average_output": booster.average_output,
        "feature_names": feature_names,
        "feature_infos": feature_infos,
        "tree_info": trees,
    }, indent=2)


def model_to_cpp(parsed: Dict) -> str:
    """Standalone C++ scorer from a parsed model (the ModelToIfElse /
    convert_model export, gbdt_model_text.cpp:60-243): one nested if/else
    function per tree plus PredictRaw / Predict entry points with the
    objective's link function applied."""
    trees: List = parsed["trees"]
    k = parsed["num_tree_per_iteration"]
    obj = parsed.get("objective", "").split()
    obj_name = obj[0] if obj else ""
    sigmoid = 1.0
    for tok in obj[1:]:
        if tok.startswith("sigmoid:"):
            sigmoid = float(tok.split(":", 1)[1])

    lines: List[str] = [
        "// generated by lightgbm_tpu task=convert_model",
        "#include <cmath>",
        "#include <cstring>",
        "",
        "static inline bool IsZero(double v) "
        "{ return v > -1e-35 && v <= 1e-35; }",
        "",
    ]

    def emit_node(ht, root, root_depth):
        # explicit work stack — trees can be chain-shaped (depth ~num_leaves)
        # and must not hit the Python recursion limit
        stack = [("node", root, root_depth)]
        while stack:
            kind, payload, depth = stack.pop()
            pad = "  " * depth
            if kind == "text":
                lines.append(pad + payload)
                continue
            index = payload
            if index < 0:
                lines.append("%sreturn %.17g;"
                             % (pad, float(ht.leaf_value[~index])))
                continue
            f = int(ht.split_feature[index])
            missing = int(ht.missing_type[index])
            dl = bool(ht.default_left[index])
            if ht.is_categorical[index]:
                nw = ht.cat_bitset.shape[1]
                words = ", ".join("0x%xu" % int(w)
                                  for w in ht.cat_bitset[index])
                lines.append(
                    "%s{ static const unsigned cat[%d] = {%s};"
                    % (pad, nw, words))
                lines.append("%s  int c = (int)arr[%d];" % (pad, f))
                lines.append(
                    "%s  if (!std::isnan(arr[%d]) && c >= 0 && c < %d && "
                    "((cat[c >> 5] >> (c & 31)) & 1)) {" % (pad, f, nw * 32))
                closer = "} }"
            else:
                thr = float(ht.threshold[index])
                cond = "arr[%d] <= %.17g" % (f, thr)
                if missing == 2:    # NaN
                    cond = ("(std::isnan(arr[%d]) ? %s : (%s))"
                            % (f, "true" if dl else "false", cond))
                elif missing == 1:  # Zero
                    cond = ("((IsZero(arr[%d]) || std::isnan(arr[%d])) ? "
                            "%s : (%s))"
                            % (f, f, "true" if dl else "false", cond))
                else:
                    cond = ("(std::isnan(arr[%d]) ? 0.0 <= %.17g : (%s))"
                            % (f, thr, cond))
                lines.append("%sif (%s) {" % (pad, cond))
                closer = "}"
            stack.append(("text", closer, depth))
            stack.append(("node", int(ht.right_child[index]), depth + 1))
            stack.append(("text", "} else {", depth))
            stack.append(("node", int(ht.left_child[index]), depth + 1))

    for i, ht in enumerate(trees):
        lines.append("static double PredictTree%d(const double* arr) {" % i)
        if ht.num_leaves_actual <= 1:
            lines.append("  return %.17g;" % float(ht.leaf_value[0]))
        else:
            emit_node(ht, 0, 1)
        lines.append("}")
        lines.append("")

    lines.append('extern "C" void PredictRaw(const double* arr, double* out) {')
    lines.append("  for (int c = 0; c < %d; ++c) out[c] = 0.0;" % k)
    for i in range(len(trees)):
        lines.append("  out[%d] += PredictTree%d(arr);" % (i % k, i))
    if parsed.get("average_output"):
        niter = max(len(trees) // max(k, 1), 1)
        lines.append("  for (int c = 0; c < %d; ++c) out[c] /= %d.0;"
                     % (k, niter))
    lines.append("}")
    lines.append("")
    lines.append('extern "C" void Predict(const double* arr, double* out) {')
    lines.append("  PredictRaw(arr, out);")
    if "sqrt" in obj[1:]:
        # reg_sqrt back-transform: sign(x) * x^2 (regression_objective.hpp)
        lines.append("  for (int c = 0; c < %d; ++c) "
                     "out[c] = (out[c] < 0 ? -1.0 : 1.0) * out[c] * out[c];"
                     % k)
    if obj_name in ("binary", "cross_entropy", "xentropy"):
        lines.append("  out[0] = 1.0 / (1.0 + std::exp(%.17g * -out[0]));"
                     % sigmoid)
    elif obj_name in ("multiclass", "softmax"):
        lines.append("  double m = out[0], s = 0.0;")
        lines.append("  for (int c = 1; c < %d; ++c) if (out[c] > m) m = out[c];" % k)
        lines.append("  for (int c = 0; c < %d; ++c) { out[c] = std::exp(out[c] - m); s += out[c]; }" % k)
        lines.append("  for (int c = 0; c < %d; ++c) out[c] /= s;" % k)
    elif obj_name in ("multiclassova", "multiclass_ova", "ova", "ovr"):
        lines.append("  for (int c = 0; c < %d; ++c) "
                     "out[c] = 1.0 / (1.0 + std::exp(%.17g * -out[c]));"
                     % (k, sigmoid))
    elif obj_name in ("poisson", "gamma", "tweedie"):
        lines.append("  for (int c = 0; c < %d; ++c) out[c] = std::exp(out[c]);" % k)
    lines.append("}")
    lines.append("")
    return "\n".join(lines)
