"""XGBoost model-format interop; counterpart of `repro.serve.interop`.

`import_xgboost_json` loads a real `xgboost.Booster` JSON model (the
`save_model("*.json")` schema) into the port's ensemble arena on the card
(or the CPU), so the serving stack can front models trained anywhere;
`export_xgboost_json` writes a port Booster back out to that schema, so
models trained here load in stock XGBoost. The documents are handled in
numpy and json, a copy of the reference's mapping:

  pointer trees -> implicit heap. XGBoost stores explicit
    left_children/right_children indices; our arena is an implicit binary
    heap (children of slot i at 2i+1 / 2i+2). Import walks each tree from
    the root placing nodes at their heap slot; the arena spans the deepest
    imported tree. Export walks the heap back into pointer arrays in
    preorder.
  `x < t` -> `x <= t`. XGBoost routes left on strictly-less; this repo on
    less-or-equal (cuts are inclusive upper bin edges). In float32 the two
    are exactly interconvertible: import stores nextafter(t, -inf), export
    stores nextafter(t, +inf); pred(succ(t)) == t makes the round trip
    bit-exact.
  NaN semantics agree: missing rows follow the split's default_left flag in
    both systems, so the flags transfer verbatim.
  base_score. XGBoost persists it in PROBABILITY space; margins start from
    ProbToMargin(base_score) (logit for logistic, log for poisson, identity
    otherwise). Import applies that map, export inverts it.
  round-robin multiclass. Both systems emit n_classes trees per boosting
    round; `tree_info` carries each tree's class id. Import reorders trees
    per iteration to the round-robin layout the arena assumes, export emits
    it directly.
  split_bin. Imported models carry no cut points, so bin-space thresholds
    do not exist: split_bin stays 0, `cuts=None`, and prediction runs the
    raw-threshold traversal only (DMatrix inputs are rejected by the cuts
    mismatch check, as with any foreign-cut matrix).

Unsupported and rejected explicitly: gblinear/dart boosters,
num_parallel_tree > 1 (random forests), categorical splits.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.device import resolve_device

_SUPPORTED_OBJECTIVES = {
    "reg:squarederror": "reg:squarederror",
    "reg:quantileerror": "reg:quantile",
    "reg:pseudohubererror": "reg:pseudohubererror",
    "count:poisson": "count:poisson",
    "binary:logistic": "binary:logistic",
    "multi:softmax": "multi:softmax",
    "multi:softprob": "multi:softmax",  # same margins; transform is argmax
    "rank:pairwise": "rank:pairwise",
}
_EXPORT_OBJECTIVE = {
    "reg:squarederror": "reg:squarederror",
    "reg:quantile": "reg:quantileerror",
    "reg:pseudohubererror": "reg:pseudohubererror",
    "count:poisson": "count:poisson",
    "binary:logistic": "binary:logistic",
    "multi:softmax": "multi:softmax",
    "rank:pairwise": "rank:pairwise",
}

_INT32_MAX = 2147483647  # xgboost's root parent sentinel


def _prob_to_margin(p: float, objective: str) -> float:
    """XGBoost LogisticRegression::ProbToMargin and friends."""
    if objective == "binary:logistic":
        p = min(max(p, 1e-16), 1.0 - 1e-16)
        return float(np.log(p / (1.0 - p)))
    if objective == "count:poisson":
        return float(np.log(max(p, 1e-16)))
    return float(p)


def _margin_to_prob(m: float, objective: str) -> float:
    if objective == "binary:logistic":
        return float(1.0 / (1.0 + np.exp(-m)))
    if objective == "count:poisson":
        return float(np.exp(m))
    return float(m)


def _tree_depth(lc, rc) -> int:
    depth = 0
    stack = [(0, 0)]
    while stack:
        nid, d = stack.pop()
        depth = max(depth, d)
        if lc[nid] != -1:
            stack.append((lc[nid], d + 1))
            stack.append((rc[nid], d + 1))
    return depth


def _tree_to_arena(tree: dict, arena: int) -> dict:
    """One pointer tree -> one implicit-heap arena row (numpy fields)."""
    lc, rc = tree["left_children"], tree["right_children"]
    sc = np.asarray(tree["split_conditions"], np.float32)
    si = tree["split_indices"]
    dl = tree["default_left"]
    lg = np.asarray(tree.get("loss_changes", [0.0] * len(lc)), np.float32)

    out = {
        "feature": np.zeros(arena, np.int32),
        "split_bin": np.zeros(arena, np.int32),
        "threshold": np.zeros(arena, np.float32),
        "default_left": np.zeros(arena, bool),
        "leaf_value": np.zeros(arena, np.float32),
        "is_leaf": np.ones(arena, bool),
        "gain": np.full(arena, -np.inf, np.float32),
    }
    stack = [(0, 0)]
    while stack:
        nid, slot = stack.pop()
        if lc[nid] == -1:
            out["leaf_value"][slot] = sc[nid]  # split_conditions holds the
            continue  # leaf value on leaves
        out["is_leaf"][slot] = False
        out["feature"][slot] = si[nid]
        # x < t (xgboost) == x <= pred(t) (ours), exactly, in float32.
        out["threshold"][slot] = np.nextafter(
            sc[nid], np.float32(-np.inf), dtype=np.float32
        )
        out["default_left"][slot] = bool(dl[nid])
        out["gain"][slot] = lg[nid]
        stack.append((lc[nid], 2 * slot + 1))
        stack.append((rc[nid], 2 * slot + 2))
    return out


def import_xgboost_json(model, *, device=None) -> "Booster":
    """Load an `xgboost.Booster` JSON model into a port Booster on `device`
    (the card unless "cpu").

    `model` may be a file path, a JSON string, or an already-parsed dict.
    The result predicts on raw float arrays (NaN = missing) through the
    ensemble-traversal kernel and matches xgboost's `predict()` to float32
    tolerance; it carries no cut points, so quantised-matrix inputs are not
    accepted.
    """
    from repro_torch.core.booster import Booster, BoosterConfig
    from repro_torch.core.predict import Ensemble

    dev = resolve_device(device)

    if isinstance(model, dict):
        doc = model
    else:
        text = str(model)
        if text.lstrip().startswith("{"):
            doc = json.loads(text)
        else:
            with open(text) as fh:
                doc = json.load(fh)

    learner = doc["learner"]
    booster_name = learner["gradient_booster"].get("name", "gbtree")
    if booster_name != "gbtree":
        raise ValueError(
            f"unsupported booster type {booster_name!r}: only gbtree "
            "models import (gblinear has no trees; dart's per-tree weights "
            "are not representable in the arena)"
        )
    xgb_objective = learner["objective"]["name"]
    if xgb_objective not in _SUPPORTED_OBJECTIVES:
        raise ValueError(
            f"unsupported objective {xgb_objective!r}; supported: "
            f"{sorted(_SUPPORTED_OBJECTIVES)}"
        )
    objective = _SUPPORTED_OBJECTIVES[xgb_objective]

    lmp = learner["learner_model_param"]
    num_feature = int(lmp["num_feature"])
    n_classes = max(int(lmp.get("num_class", "0")), 1)
    base_score = _prob_to_margin(float(lmp["base_score"]), objective)

    gb_model = learner["gradient_booster"]["model"]
    gbp = gb_model.get("gbtree_model_param", {})
    if int(gbp.get("num_parallel_tree", "1")) != 1:
        raise ValueError(
            "num_parallel_tree > 1 (random forest rounds) is not supported"
        )
    trees = gb_model["trees"]
    if not trees:
        raise ValueError("model has no trees")
    for i, t in enumerate(trees):
        if any(int(s) != 0 for s in t.get("split_type", [])) or \
                t.get("categories"):
            raise ValueError(
                f"tree {i} uses categorical splits, which the arena does "
                "not represent; export the model with numeric splits only"
            )

    # Reorder to round-robin: iteration-major, class-minor (the arena's
    # layout contract). tree_info carries each tree's class id.
    tree_info = [int(c) for c in gb_model.get("tree_info", [0] * len(trees))]
    indptr = gb_model.get(
        "iteration_indptr",
        list(range(0, len(trees) + 1, max(n_classes, 1))),
    )
    order: list[int] = []
    for it in range(len(indptr) - 1):
        span = list(range(int(indptr[it]), int(indptr[it + 1])))
        if n_classes > 1:
            if sorted(tree_info[i] for i in span) != list(range(n_classes)):
                raise ValueError(
                    f"iteration {it} does not contain exactly one tree per "
                    "class; cannot map onto the round-robin arena layout"
                )
            span.sort(key=lambda i: tree_info[i])
        order.extend(span)
    if len(order) != len(trees):
        raise ValueError(
            f"iteration_indptr covers {len(order)} trees, model has "
            f"{len(trees)}"
        )

    depth = max(
        _tree_depth(t["left_children"], t["right_children"]) for t in trees
    )
    depth = max(depth, 1)
    arena = 2 ** (depth + 1) - 1
    rows = [_tree_to_arena(trees[i], arena) for i in order]
    fields = {
        k: torch.from_numpy(np.stack([r[k] for r in rows])).to(dev)
        for k in rows[0]
    }

    bst = Booster(BoosterConfig(
        n_rounds=len(trees) // n_classes,
        max_depth=depth,
        objective=objective,
        n_classes=n_classes,
    ))
    bst.ensemble = Ensemble(
        **fields, n_classes=n_classes, base_score=base_score
    )
    bst.device = dev
    bst.base_score = base_score
    bst.n_rounds_trained = len(trees) // n_classes
    bst.cuts = None  # no bin space: raw-threshold traversal only
    bst.n_features_in_ = num_feature
    return bst


def _arena_to_tree(arrays: dict, t: int, num_feature: int) -> dict:
    """One arena row (numpy fields) -> one xgboost pointer tree (preorder
    node ids)."""
    feature = arrays["feature"][t]
    threshold = arrays["threshold"][t].astype(np.float32)
    default_left = arrays["default_left"][t]
    leaf_value = arrays["leaf_value"][t].astype(np.float32)
    is_leaf = arrays["is_leaf"][t]
    gain = arrays["gain"][t].astype(np.float32)

    ids: dict[int, int] = {}  # heap slot -> xgboost node id (preorder)
    slots: list[int] = []
    stack = [0]
    while stack:
        slot = stack.pop()
        ids[slot] = len(slots)
        slots.append(slot)
        if not is_leaf[slot]:
            stack.append(2 * slot + 2)  # preorder: left pops first
            stack.append(2 * slot + 1)

    n = len(slots)
    lc, rc, parents = [-1] * n, [-1] * n, [_INT32_MAX] * n
    sc, si, dl = [0.0] * n, [0] * n, [0] * n
    lg, sh, bw = [0.0] * n, [0.0] * n, [0.0] * n
    for slot in slots:
        nid = ids[slot]
        if is_leaf[slot]:
            sc[nid] = float(leaf_value[slot])
            bw[nid] = float(leaf_value[slot])
            continue
        lc[nid] = ids[2 * slot + 1]
        rc[nid] = ids[2 * slot + 2]
        parents[lc[nid]] = nid
        parents[rc[nid]] = nid
        # x <= t (ours) == x < succ(t) (xgboost), exactly, in float32.
        sc[nid] = float(np.nextafter(
            threshold[slot], np.float32(np.inf), dtype=np.float32
        ))
        si[nid] = int(feature[slot])
        dl[nid] = int(default_left[slot])
        g = float(gain[slot])
        lg[nid] = g if np.isfinite(g) else 0.0

    return {
        "base_weights": bw,
        "categories": [],
        "categories_nodes": [],
        "categories_segments": [],
        "categories_sizes": [],
        "default_left": dl,
        "id": t,
        "left_children": lc,
        "loss_changes": lg,
        "parents": parents,
        "right_children": rc,
        "split_conditions": sc,
        "split_indices": si,
        "split_type": [0] * n,
        "sum_hessian": sh,
        "tree_param": {
            "num_deleted": "0",
            "num_feature": str(num_feature),
            "num_nodes": str(n),
            "size_leaf_vector": "1",
        },
    }


def export_xgboost_json(booster, path: str | None = None) -> dict:
    """Write a fitted port Booster as an `xgboost.Booster` JSON model.

    Returns the model dict; when `path` is given it is also serialised
    there, ready for `xgboost.Booster(model_file=path)`. Thresholds are
    nudged one float32 ulp up so xgboost's strict-less routing reproduces
    our traversal exactly; a later re-import round-trips bit-exactly.
    """
    ens = getattr(booster, "ensemble", None)
    if ens is None:
        raise RuntimeError("Booster is not fitted yet — nothing to export")
    objective = booster.cfg.objective
    if objective not in _EXPORT_OBJECTIVE:
        raise ValueError(
            f"objective {objective!r} has no xgboost equivalent; "
            f"exportable: {sorted(_EXPORT_OBJECTIVE)}"
        )
    nf = getattr(booster, "n_features_in_", None)
    if nf is None and getattr(booster, "cuts", None) is not None:
        nf = int(booster.cuts.shape[0])
    if nf is None:
        raise ValueError("cannot infer feature count for export")

    k = ens.n_classes
    n_trees = ens.n_trees
    arrays = {f: getattr(ens, f).cpu().numpy() for f in
              ("feature", "threshold", "default_left", "leaf_value", "is_leaf", "gain")}
    trees = [_arena_to_tree(arrays, t, nf) for t in range(n_trees)]
    doc = {
        "learner": {
            "attributes": {},
            "feature_names": [],
            "feature_types": [],
            "gradient_booster": {
                "model": {
                    "gbtree_model_param": {
                        "num_parallel_tree": "1",
                        "num_trees": str(n_trees),
                    },
                    "iteration_indptr": list(range(0, n_trees + 1, k)),
                    "tree_info": [t % k for t in range(n_trees)],
                    "trees": trees,
                },
                "name": "gbtree",
            },
            "learner_model_param": {
                "base_score": repr(
                    _margin_to_prob(float(ens.base_score), objective)
                ),
                "boost_from_average": "1",
                "num_class": str(k if k > 1 else 0),
                "num_feature": str(nf),
                "num_target": "1",
            },
            "objective": {"name": _EXPORT_OBJECTIVE[objective]},
        },
        "version": [2, 0, 0],
    }
    if objective == "binary:logistic":
        doc["learner"]["objective"]["reg_loss_param"] = {
            "scale_pos_weight": "1"
        }
    if objective == "multi:softmax":
        doc["learner"]["objective"]["softmax_multiclass_param"] = {
            "num_class": str(k)
        }
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return doc
