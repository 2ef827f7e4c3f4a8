"""XGBoost JSON interop of the port (`repro_torch.serve.interop`) against
the reference's (`repro.serve.interop`), on the CPU.

The schema fixtures and the independent interpreter below are copied from
`tests/test_interop.py` (not imported: that module imports the reference's
package at its top). Each document is imported into both packages, and
their arenas must be equal array for array; the port's margins agree with
the interpreter within rtol 1e-5, atol 1e-6, as the reference's test holds
its own. A model exported by both packages gives equal documents, and the
port's import -> export -> import round trip is bit-exact.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.serve import export_xgboost_json as j_export
from repro.serve import import_xgboost_json as j_import
from repro_torch.core import Booster, DeviceDMatrix, booster_from_numpy
from repro_torch.core.predict import ENSEMBLE_FIELDS
from repro_torch.serve import export_xgboost_json, import_xgboost_json

TOL = dict(rtol=1e-5, atol=1e-6)


# --- independent schema interpreter -----------------------------------------

def _prob_to_margin(p, objective):
    if objective == "binary:logistic":
        return float(np.log(p / (1.0 - p)))
    if objective == "count:poisson":
        return float(np.log(p))
    return float(p)


def _oracle_margins(doc, x):
    """Margins per xgboost's documented semantics: strict x < t goes left,
    NaN follows default_left, leaf values accumulate per tree_info class,
    base_score enters margin space via the objective's link."""
    learner = doc["learner"]
    objective = learner["objective"]["name"]
    lmp = learner["learner_model_param"]
    k = max(int(lmp.get("num_class", "0")), 1)
    base = _prob_to_margin(float(lmp["base_score"]), objective)
    model = learner["gradient_booster"]["model"]
    trees = model["trees"]
    tree_info = model.get("tree_info", [0] * len(trees))

    out = np.full((x.shape[0], k), np.float32(base), np.float32)
    for t, tree in enumerate(trees):
        cls = int(tree_info[t]) if k > 1 else 0
        lc, rc = tree["left_children"], tree["right_children"]
        sc = np.asarray(tree["split_conditions"], np.float32)
        si, dl = tree["split_indices"], tree["default_left"]
        for r in range(x.shape[0]):
            nid = 0
            while lc[nid] != -1:
                v = x[r, si[nid]]
                if np.isnan(v):
                    nid = lc[nid] if dl[nid] else rc[nid]
                elif np.float32(v) < sc[nid]:
                    nid = lc[nid]
                else:
                    nid = rc[nid]
            out[r, cls] += sc[nid]
    return out


# --- schema fixture builders ------------------------------------------------

def _leaf(value):
    return {"leaf": float(value)}


def _split(feature, threshold, left, right, default_left=True, gain=1.0):
    return {"f": int(feature), "t": float(threshold), "l": left, "r": right,
            "dl": bool(default_left), "g": float(gain)}


def _tree_doc(spec, num_feature):
    """Nested spec -> an xgboost-schema tree dict (preorder node ids)."""
    nodes = []

    def place(s, parent):
        nid = len(nodes)
        nodes.append(None)
        if "leaf" in s:
            nodes[nid] = dict(leaf=s["leaf"], parent=parent)
        else:
            nodes[nid] = dict(split=s, parent=parent)
            nodes[nid]["left"] = place(s["l"], nid)
            nodes[nid]["right"] = place(s["r"], nid)
        return nid

    place(spec, 2147483647)
    n = len(nodes)
    tree = {
        "base_weights": [0.0] * n,
        "categories": [], "categories_nodes": [],
        "categories_segments": [], "categories_sizes": [],
        "default_left": [0] * n,
        "id": 0,
        "left_children": [-1] * n,
        "loss_changes": [0.0] * n,
        "parents": [nd["parent"] for nd in nodes],
        "right_children": [-1] * n,
        "split_conditions": [0.0] * n,
        "split_indices": [0] * n,
        "split_type": [0] * n,
        "sum_hessian": [1.0] * n,
        "tree_param": {
            "num_deleted": "0", "num_feature": str(num_feature),
            "num_nodes": str(n), "size_leaf_vector": "1",
        },
    }
    for nid, nd in enumerate(nodes):
        if "leaf" in nd:
            tree["split_conditions"][nid] = nd["leaf"]
            tree["base_weights"][nid] = nd["leaf"]
        else:
            s = nd["split"]
            tree["left_children"][nid] = nd["left"]
            tree["right_children"][nid] = nd["right"]
            tree["split_conditions"][nid] = s["t"]
            tree["split_indices"][nid] = s["f"]
            tree["default_left"][nid] = int(s["dl"])
            tree["loss_changes"][nid] = s["g"]
    return tree


def _model_doc(tree_specs, *, objective, num_feature, base_score,
               num_class=0, tree_info=None):
    trees = [_tree_doc(s, num_feature) for s in tree_specs]
    for i, t in enumerate(trees):
        t["id"] = i
    k = max(num_class, 1)
    return {
        "learner": {
            "attributes": {},
            "feature_names": [], "feature_types": [],
            "gradient_booster": {
                "model": {
                    "gbtree_model_param": {
                        "num_parallel_tree": "1",
                        "num_trees": str(len(trees)),
                    },
                    "iteration_indptr": list(
                        range(0, len(trees) + 1, k)
                    ),
                    "tree_info": tree_info if tree_info is not None
                    else [i % k for i in range(len(trees))],
                    "trees": trees,
                },
                "name": "gbtree",
            },
            "learner_model_param": {
                "base_score": repr(base_score),
                "boost_from_average": "1",
                "num_class": str(num_class),
                "num_feature": str(num_feature),
                "num_target": "1",
            },
            "objective": {"name": objective},
        },
        "version": [2, 0, 0],
    }


@pytest.fixture
def rng_x():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    x[rng.random(x.shape) < 0.15] = np.nan
    return x


def _docs():
    """Documents of every mapping rule: regression, the strict-less boundary,
    NaN default directions, logistic and Poisson base scores in probability
    space, class-shuffled multiclass trees, the quantile objective's name."""
    reg = _model_doc(
        [_split(0, 0.1, _split(1, -0.5, _leaf(1.0), _leaf(2.0)), _leaf(-1.0),
                default_left=False),
         _split(2, 0.7, _leaf(0.25), _split(3, 0.0, _leaf(-0.5), _leaf(0.5)))],
        objective="reg:squarederror", num_feature=4, base_score=1.5)
    return {
        "regression": reg,
        "boundary": _model_doc([_split(0, 0.75, _leaf(-7.0), _leaf(7.0))],
                               objective="reg:squarederror", num_feature=4, base_score=0.0),
        "nan_default": _model_doc(
            [_split(0, 0.0, _leaf(-1.0), _leaf(1.0), default_left=True),
             _split(0, 0.0, _leaf(-10.0), _leaf(10.0), default_left=False)],
            objective="reg:squarederror", num_feature=4, base_score=0.0),
        "logistic": _model_doc([_split(0, 0.0, _leaf(-0.4), _leaf(0.6), gain=2.5)],
                               objective="binary:logistic", num_feature=4, base_score=0.2),
        "poisson": _model_doc([_split(1, 0.3, _leaf(-0.2), _leaf(0.1))],
                              objective="count:poisson", num_feature=4, base_score=1.7),
        "quantile": _model_doc([_split(3, -0.1, _leaf(0.3), _leaf(-0.3))],
                               objective="reg:quantileerror", num_feature=4, base_score=0.4),
        "multiclass": _model_doc(
            [_split(0, 0.0, _leaf(0.1), _leaf(0.2)), _split(1, 0.0, _leaf(0.3), _leaf(0.4)),
             _split(2, 0.0, _leaf(0.5), _leaf(0.6)), _split(3, 0.0, _leaf(0.7), _leaf(0.8)),
             _split(0, 0.5, _leaf(0.9), _leaf(1.0)), _split(1, 0.5, _leaf(1.1), _leaf(1.2))],
            objective="multi:softmax", num_feature=4, base_score=0.5, num_class=3,
            tree_info=[1, 0, 2, 2, 0, 1]),
    }


@pytest.mark.parametrize("name", list(_docs()))
def test_import_matches_reference_and_oracle(name, rng_x):
    doc = _docs()[name]
    tb, jb = import_xgboost_json(doc, device="cpu"), j_import(doc)
    for f in ENSEMBLE_FIELDS:
        np.testing.assert_array_equal(getattr(tb.ensemble, f).numpy(),
                                      np.asarray(getattr(jb.ensemble, f)), err_msg=f)
    assert dataclasses.asdict(tb.cfg) == dataclasses.asdict(jb.cfg)
    assert (tb.base_score, tb.n_rounds_trained, tb.n_features_in_, tb.cuts) == (
        jb.base_score, jb.n_rounds_trained, jb.n_features_in_, None)
    assert tb.ensemble.base_score == jb.ensemble.base_score
    got = tb.predict_margins(rng_x).numpy()
    np.testing.assert_allclose(got, _oracle_margins(doc, rng_x), **TOL)
    np.testing.assert_allclose(got, np.asarray(jb.predict_margins(rng_x)), **TOL)
    np.testing.assert_allclose(tb.predict(rng_x).numpy(), np.asarray(jb.predict(rng_x)), **TOL)


def test_import_strict_less_boundary_and_nan():
    doc = _docs()["boundary"]
    t = np.float32(0.75)
    x = np.zeros((3, 4), np.float32)
    x[:, 0] = [t, np.nextafter(t, np.float32(-np.inf), dtype=np.float32), np.nan]
    got = import_xgboost_json(doc, device="cpu").predict_margins(x).numpy()[:, 0]
    np.testing.assert_array_equal(got, [7.0, -7.0, -7.0])  # NaN: default_left
    np.testing.assert_array_equal(_oracle_margins(doc, x)[:, 0], got)


def test_import_from_string_and_file(tmp_path, rng_x):
    doc = _model_doc([_leaf(2.0)], objective="reg:squarederror", num_feature=4,
                     base_score=0.0)
    path = tmp_path / "model.json"
    path.write_text(json.dumps(doc))
    for src in (doc, json.dumps(doc), str(path)):
        np.testing.assert_allclose(
            import_xgboost_json(src, device="cpu").predict_margins(rng_x[:5]).numpy(), 2.0)


def test_import_rejections_match_reference():
    base = _model_doc([_leaf(1.0)], objective="reg:squarederror", num_feature=2,
                      base_score=0.0)
    dart = json.loads(json.dumps(base))
    dart["learner"]["gradient_booster"]["name"] = "dart"
    forest = json.loads(json.dumps(base))
    forest["learner"]["gradient_booster"]["model"]["gbtree_model_param"][
        "num_parallel_tree"] = "4"
    cat = _model_doc([_split(0, 0.0, _leaf(1.0), _leaf(2.0))],
                     objective="reg:squarederror", num_feature=2, base_score=0.0)
    cat["learner"]["gradient_booster"]["model"]["trees"][0]["split_type"][0] = 1
    alien = json.loads(json.dumps(base))
    alien["learner"]["objective"]["name"] = "survival:cox"
    for doc, match in ((dart, "gbtree"), (forest, "num_parallel_tree"),
                       (cat, "categorical"), (alien, "unsupported objective")):
        with pytest.raises(ValueError, match=match) as mine:
            import_xgboost_json(doc, device="cpu")
        with pytest.raises(ValueError) as theirs:
            j_import(doc)
        assert str(mine.value) == str(theirs.value)


def _train(objective, n_classes=1, seed=0):
    """A reference fit and the port's Booster of the same trees."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(500, 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    z = np.nan_to_num(x)
    if n_classes > 1:
        y = ((z[:, 0] > 0) + (z[:, 1] > 0.5)).astype(np.float32)
    elif objective == "binary:logistic":
        y = (z[:, 0] > 0).astype(np.float32)
    elif objective == "count:poisson":
        y = rng.poisson(np.exp(0.5 * z[:, 0])).astype(np.float32)
    else:
        y = (z[:, 0] + 0.2 * rng.normal(size=500)).astype(np.float32)
    jb = JBooster(n_rounds=4, max_depth=3, max_bins=32, objective=objective,
                  n_classes=n_classes).fit(JDMatrix(x, label=y, max_bins=32))
    state = {**dataclasses.asdict(jb.cfg), "cuts": np.asarray(jb.cuts),
             "base_score": jb.base_score, "n_classes": jb.ensemble.n_classes,
             **{f: np.asarray(getattr(jb.ensemble, f)) for f in ENSEMBLE_FIELDS}}
    return jb, booster_from_numpy(state, device="cpu"), x


MODELS = [("reg:squarederror", 1), ("binary:logistic", 1), ("multi:softmax", 3),
          ("count:poisson", 1), ("reg:quantile", 1)]


@pytest.mark.parametrize("objective,k", MODELS)
def test_export_matches_reference(objective, k):
    jb, tb, x = _train(objective, k)
    doc = export_xgboost_json(tb)
    assert json.dumps(doc) == json.dumps(j_export(jb))
    np.testing.assert_allclose(_oracle_margins(doc, x), tb.predict_margins(x).numpy(), **TOL)


@pytest.mark.parametrize("objective,k", MODELS)
def test_export_import_round_trip_bit_exact(objective, k):
    _, tb, x = _train(objective, k)
    back = import_xgboost_json(export_xgboost_json(tb), device="cpu")
    assert torch.equal(back.predict_margins(x), tb.predict_margins(x))
    d1, d2 = export_xgboost_json(tb), export_xgboost_json(back)
    for t1, t2 in zip(d1["learner"]["gradient_booster"]["model"]["trees"],
                      d2["learner"]["gradient_booster"]["model"]["trees"]):
        assert t1["split_conditions"] == t2["split_conditions"]
        assert t1["left_children"] == t2["left_children"]


def test_export_writes_file_and_refuses_unfitted(tmp_path):
    _, tb, _ = _train("reg:squarederror")
    path = tmp_path / "model.json"
    doc = export_xgboost_json(tb, str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
    with pytest.raises(RuntimeError, match="not fitted"):
        export_xgboost_json(Booster())


def test_imported_model_surface(rng_x, tmp_path):
    """An imported model has no cuts: rows are checked against
    n_features_in_, a DeviceDMatrix is refused (as the reference refuses
    one), importances count its features, and it survives a checkpoint,
    which keeps no feature count: raw rows are refused until it is set."""
    tb = import_xgboost_json(_docs()["regression"], device="cpu")
    with pytest.raises(ValueError, match="4"):
        tb.predict_margins(rng_x[:, :3])
    with pytest.raises(ValueError, match="different cuts"):
        tb.predict_margins(DeviceDMatrix(rng_x, max_bins=16, device="cpu"))
    np.testing.assert_array_equal(tb.feature_importances("weight"), [1, 1, 1, 1])
    tb.save(str(tmp_path / "imported.ckpt"))
    back = Booster.load(str(tmp_path / "imported.ckpt"), device="cpu")
    assert back.cuts is None and back.n_features is None
    with pytest.raises(ValueError, match="n_features_in_"):
        back.predict_margins(rng_x)
    back.n_features_in_ = 4
    assert torch.equal(back.predict_margins(rng_x), tb.predict_margins(rng_x))
    with pytest.raises(ValueError, match="4"):
        back.predict_margins(rng_x[:, :3])
