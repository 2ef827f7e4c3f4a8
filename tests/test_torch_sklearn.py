"""The port's sklearn estimators (`repro_torch.sklearn`) beside the
reference's (`repro.sklearn`), on the CPU.

Every test of tests/test_sklearn.py has its counterpart here. Where the
reference runs, the two estimators fit the same data on the same cuts (the
port's matrices take the reference's cut points, as the other parity tests
do: cut construction may differ by a rank flip, queue 3 item 1 of ROADMAP.md)
and their predictions agree within the fit tolerance of
test_torch_booster.py, rtol 1e-5 and atol 1e-5 (probabilities and ranking
scores too); `chunk_rows=` fits through `ExternalDMatrix` in both. One test
runs the estimators in a subprocess with sklearn blocked, so that the local
base classes run, as on the card's machine.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.sklearn as JSK
import repro_torch.sklearn as TSK
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import quantile as JQ
from repro_torch.core import DeviceDMatrix
from repro_torch.sklearn import HAVE_SKLEARN, XGBClassifier, XGBRanker, XGBRegressor

from torch_parity_readings import QUANTILE_ALPHA, tie_witness

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = {"device": "cpu"}
needs_sklearn = pytest.mark.skipif(not HAVE_SKLEARN, reason="scikit-learn not installed")


@pytest.fixture
def rng():
    """A fresh generator per test: the session-wide `rng` of conftest.py is
    left untouched, so the reference's tests draw what they drew before."""
    return np.random.default_rng(1234)


@pytest.fixture
def shared_cuts(monkeypatch):
    """The port's estimators quantise with the reference's cut points."""

    def with_reference_cuts(x, label=None, *, ref=None, max_bins=256, **kw):
        if ref is None:
            kw["cuts"] = np.asarray(JQ.compute_cuts(np.asarray(x, np.float32), max_bins))
        return DeviceDMatrix(x, label, ref=ref, max_bins=max_bins, **kw)

    monkeypatch.setattr(TSK, "DeviceDMatrix", with_reference_cuts)


@pytest.fixture(scope="module")
def reg_data():
    rng = np.random.default_rng(23)
    n, f = 700, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x @ rng.normal(size=f) + 0.3 * x[:, 0] * x[:, 1]).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def cls_data(reg_data):
    x, y = reg_data
    return x, np.where(y > 0, "spam", "ham")  # string labels round-trip


def _assert_matches_reference(est, ref, x, y_enc, bkw, predict):
    """Predictions within TOL of the reference estimator's; or, where a
    split differs (near-tied gains: test_torch_objectives.py finds them for
    reg:quantile and softmax), every earlier tree within TOL and the two
    splits tied in the reference's own float64 gain."""
    tie = tie_witness(bkw, JDMatrix(x, label=y_enc, max_bins=bkw["max_bins"]),
                      ref.get_booster(), est.get_booster(), y_enc)
    if tie is None:
        np.testing.assert_allclose(predict(est), predict(ref), **TOL)
        return
    np.testing.assert_allclose(est.get_booster().ensemble.leaf_value.numpy()[:tie["tree"]],
                               np.asarray(ref.get_booster().ensemble.leaf_value)[:tie["tree"]],
                               **TOL)
    r, p = tie["ref"], tie["port"]
    assert r is not None and p is not None, tie
    assert abs(r["gain"] - p["gain"]) <= 1e-6 * max(r["terms"], p["terms"]), tie


def test_get_set_params_roundtrip():
    est = XGBRegressor(n_estimators=7, max_depth=3, quantile_alpha=0.8, device="cpu")
    p = est.get_params()
    assert p["n_estimators"] == 7 and p["quantile_alpha"] == 0.8 and p["device"] == "cpu"
    est.set_params(max_depth=5, learning_rate=0.1)
    assert est.get_params()["max_depth"] == 5
    with pytest.raises(ValueError, match="invalid parameter|Invalid parameter"):
        est.set_params(not_a_param=1)
    est2 = XGBRegressor(**est.get_params())  # the clone contract
    assert est2.get_params() == est.get_params()
    # The reference's surface, plus the port's device keyword.
    assert set(p) == set(JSK.XGBRegressor().get_params()) | {"device"}


def test_regressor_fit_predict_score(reg_data, shared_cuts):
    x, y = reg_data
    kw = dict(n_estimators=20, max_depth=4, max_bins=64)
    reg = XGBRegressor(**kw, **CPU)
    assert reg.fit(x, y) is reg
    assert reg.n_features_in_ == x.shape[1]
    pred = reg.predict(x)
    assert isinstance(pred, np.ndarray) and pred.shape == (len(y),)
    assert reg.score(x, y) > 0.8  # R^2 on train
    np.testing.assert_allclose(pred, JSK.XGBRegressor(**kw).fit(x, y).predict(x), **TOL)
    with pytest.raises(RuntimeError, match="not fitted"):
        XGBRegressor(**CPU).predict(x)


def test_regressor_quantile_objective(reg_data, shared_cuts):
    x, y = reg_data
    kw = dict(n_estimators=20, max_depth=3, max_bins=32, objective="reg:quantile",
              quantile_alpha=QUANTILE_ALPHA)
    reg = XGBRegressor(**kw, **CPU).fit(x, y)
    cover = float(np.mean(y <= reg.predict(x)))
    assert 0.8 < cover <= 1.0, cover  # predicts the upper quantile
    bkw = dict(n_rounds=20, max_depth=3, max_bins=32, objective="reg:quantile",
               quantile_alpha=QUANTILE_ALPHA)
    _assert_matches_reference(reg, JSK.XGBRegressor(**kw).fit(x, y), x, y, bkw,
                              lambda e: e.predict(x))


def test_classifier_binary_labels_proba_and_es(cls_data, shared_cuts):
    x, yc = cls_data
    kw = dict(n_estimators=30, max_depth=3, max_bins=32, eval_metric=["logloss", "auc"],
              early_stopping_rounds=5)
    clf = XGBClassifier(**kw, **CPU)
    clf.fit(x[:500], yc[:500], eval_set=[(x[500:], yc[500:])])
    ref = JSK.XGBClassifier(**kw).fit(x[:500], yc[:500], eval_set=[(x[500:], yc[500:])])
    assert list(clf.classes_) == ["ham", "spam"]
    assert set(np.unique(clf.predict(x))) <= {"ham", "spam"}
    proba = clf.predict_proba(x[:40])
    assert proba.shape == (40, 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(proba, ref.predict_proba(x[:40]), **TOL)
    # Column 1 is the booster's own prediction, bit for bit.
    assert np.array_equal(proba[:, 1], clf.get_booster().predict(x[:40]).numpy())
    assert clf.score(x, yc) > 0.85
    assert {"validation_0_logloss", "validation_0_auc"} <= set(clf.evals_result_[-1])
    assert clf.best_iteration_ == ref.best_iteration_ is not None
    assert clf.best_score_ == pytest.approx(ref.best_score_, rel=1e-5, abs=1e-5)
    assert clf.comm_stats_ is None and ref.comm_stats_ is None
    np.testing.assert_allclose(clf.feature_importances_, ref.feature_importances_, rtol=1e-4,
                               atol=1e-6)


def test_classifier_rejects_unseen_eval_labels(cls_data):
    x, yc = cls_data
    clf = XGBClassifier(n_estimators=3, max_depth=2, max_bins=32, **CPU)
    bad = yc[500:].copy()
    bad[0] = "zzz"  # class absent from the training targets
    with pytest.raises(ValueError, match="unseen"):
        clf.fit(x[:500], yc[:500], eval_set=[(x[500:], bad)])


def test_classifier_multiclass(rng, shared_cuts):
    n, f, k = 600, 5, 3
    centers = rng.normal(size=(k, f)) * 2.5
    yi = rng.integers(0, k, size=n)
    x = (centers[yi] + rng.normal(size=(n, f))).astype(np.float32)
    labels = np.array([10, 20, 30])[yi]  # non-contiguous label values
    kw = dict(n_estimators=8, max_depth=3, max_bins=32)
    clf = XGBClassifier(**kw, **CPU)
    clf.fit(x, labels)
    assert list(clf.classes_) == [10, 20, 30]
    proba = clf.predict_proba(x)
    assert proba.shape == (n, k)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)
    assert clf.score(x, labels) > 0.9
    bkw = dict(n_rounds=8, max_depth=3, max_bins=32, objective="multi:softmax", n_classes=k)
    _assert_matches_reference(clf, JSK.XGBClassifier(**kw).fit(x, labels), x,
                              yi.astype(np.float32), bkw, lambda e: e.predict_proba(x))


def _rank_data(rng):
    n_groups, per = 25, 8
    x = rng.normal(size=(n_groups * per, 5)).astype(np.float32)
    rel = np.clip(np.round(x @ rng.normal(size=5) + 2), 0, 4).astype(np.float32)
    return x, rel, np.repeat(np.arange(n_groups), per), n_groups, per


def test_ranker_qid_group_equivalent(rng, shared_cuts):
    x, rel, qid, n_groups, per = _rank_data(rng)
    kw = dict(n_estimators=6, max_depth=3, max_bins=32)
    a = XGBRanker(**kw, **CPU).fit(x, rel, qid=qid)
    b = XGBRanker(**kw, **CPU).fit(x, rel, group=[per] * n_groups)
    np.testing.assert_array_equal(a.predict(x), b.predict(x))
    np.testing.assert_allclose(a.predict(x), JSK.XGBRanker(**kw).fit(x, rel, qid=qid).predict(x),
                               **TOL)
    with pytest.raises(ValueError, match="exactly one"):
        XGBRanker(**kw, **CPU).fit(x, rel)
    with pytest.raises(ValueError, match="exactly one"):
        XGBRanker(**kw, **CPU).fit(x, rel, qid=qid, group=[per] * n_groups)


def test_ranker_eval_qid_history_matches_reference(rng, shared_cuts):
    x, rel, qid, _, _ = _rank_data(rng)
    tr = qid < 20
    kw = dict(n_estimators=5, max_depth=3, max_bins=32, eval_metric=["ndcg@5"])
    fit_kw = dict(qid=qid[tr], eval_set=[(x[~tr], rel[~tr])], eval_qid=[qid[~tr]])
    est = XGBRanker(**kw, **CPU).fit(x[tr], rel[tr], **fit_kw)
    ref = JSK.XGBRanker(**kw).fit(x[tr], rel[tr], **fit_kw)
    assert [list(r) for r in est.evals_result_] == [list(r) for r in ref.evals_result_]
    np.testing.assert_allclose([r["validation_0_ndcg@5"] for r in est.evals_result_],
                               [r["validation_0_ndcg@5"] for r in ref.evals_result_], **TOL)
    with pytest.raises(ValueError, match="eval_qid"):
        XGBRanker(**kw, **CPU).fit(x[tr], rel[tr], qid=qid[tr], eval_set=[(x[~tr], rel[~tr])])


def test_serve_predicts_as_the_booster(cls_data, rng):
    """serve=True goes through PredictEngine, one engine an output mode, and
    answers bit for bit as serve=False."""
    x, yc = cls_data
    clf = XGBClassifier(n_estimators=6, max_depth=3, max_bins=32, **CPU).fit(x, yc)
    proba, labels = clf.predict_proba(x), clf.predict(x)
    clf.set_params(serve=True)
    assert np.array_equal(clf.predict_proba(x), proba)
    assert np.array_equal(clf.predict(x), labels)
    assert set(clf._engines_) == {"margin"}
    xr, rel, qid, _, _ = _rank_data(rng)
    rk = XGBRanker(n_estimators=4, max_depth=3, max_bins=32, **CPU).fit(xr, rel, qid=qid)
    plain = rk.predict(xr)
    rk.set_params(serve=True)
    assert np.array_equal(rk.predict(xr), plain) and set(rk._engines_) == {"value"}


@needs_sklearn
def test_gridsearchcv_smoke(cls_data):
    from sklearn.model_selection import GridSearchCV

    x, yc = cls_data
    gs = GridSearchCV(
        XGBClassifier(n_estimators=8, max_bins=32, **CPU),
        {"max_depth": [2, 3], "learning_rate": [0.3, 0.6]},
        cv=2,
    )
    gs.fit(x, yc)
    assert gs.best_score_ > 0.8
    assert set(gs.best_params_) == {"max_depth", "learning_rate"}
    assert gs.best_estimator_.score(x, yc) > 0.8


@needs_sklearn
def test_cross_val_score_regressor(reg_data):
    from sklearn.model_selection import cross_val_score

    x, y = reg_data
    scores = cross_val_score(XGBRegressor(n_estimators=10, max_depth=3, max_bins=32, **CPU),
                             x, y, cv=3)
    assert scores.shape == (3,) and scores.mean() > 0.5


@needs_sklearn
def test_sklearn_clone_contract():
    from sklearn.base import clone

    est = XGBClassifier(n_estimators=5, max_depth=2, eval_metric=["auc"], **CPU)
    c = clone(est)
    assert c.get_params() == est.get_params()


def test_chunk_rows_raises(cls_data):
    """chunk_rows= fits through ExternalDMatrix.from_arrays, as the
    reference's does: the same sketch cuts (the sketch is the reference's,
    copied), so the probabilities agree within the fit tolerance."""
    from repro.sklearn import XGBClassifier as JClassifier
    from repro_torch.core import Booster, ExternalDMatrix

    x, yc = cls_data
    kw = dict(n_estimators=8, max_depth=3, max_bins=32, chunk_rows=100)
    mine = XGBClassifier(**kw, **CPU).fit(x, yc)
    theirs = JClassifier(**kw).fit(x, yc)
    assert isinstance(mine.booster_.margins, torch.Tensor)
    np.testing.assert_array_equal(mine.booster_.cuts.numpy(), np.asarray(theirs.booster_.cuts))
    np.testing.assert_allclose(mine.predict_proba(x), np.asarray(theirs.predict_proba(x)),
                               **TOL)
    # Streamed paging is ported (test_torch_stream.py): it trains.
    st = ExternalDMatrix.from_arrays(x, (yc == mine.classes_[1]).astype(np.float32),
                                     chunk_rows=100, paging="stream", max_bins=32, device="cpu")
    assert st.resolved_paging() == "stream"
    assert Booster(n_rounds=2, max_bins=32).fit(st).n_rounds_trained == 2


@pytest.mark.parametrize("knob,value", [("on_oom", "external"), ("checkpoint_every", 2),
                                        ("mesh", "a mesh"), ("compression", "f16")])
def test_unported_knobs_raise_by_name(reg_data, knob, value):
    """mesh and compression raise naming themselves; on_oom and
    checkpoint_every are ported and reach the booster (checkpoint_every
    alone raises the reference's ValueError: it needs checkpoint_path)."""
    x, y = reg_data
    est = XGBRegressor(n_estimators=2, max_bins=32, **CPU, **{knob: value})
    if knob == "on_oom":
        assert est.fit(x, y).booster_.resilience_events == []
    elif knob == "checkpoint_every":
        with pytest.raises(ValueError, match="checkpoint_path"):
            est.fit(x, y)
    else:
        with pytest.raises(NotImplementedError, match=knob):
            est.fit(x, y)


def test_estimators_without_sklearn():
    """With sklearn blocked the local base classes run (as on the card's
    machine): params, fit, predict and score of all three estimators."""
    code = """
import sys
sys.modules["sklearn"] = None
import numpy as np
from repro_torch.sklearn import HAVE_SKLEARN, XGBClassifier, XGBRanker, XGBRegressor
assert not HAVE_SKLEARN
assert "sklearn.base" not in sys.modules or sys.modules["sklearn.base"] is None
rng = np.random.default_rng(0)
x = rng.normal(size=(300, 4)).astype(np.float32)
y = x[:, 0] - x[:, 1]
reg = XGBRegressor(n_estimators=10, max_depth=3, max_bins=32, device="cpu")
assert reg.get_params()["max_depth"] == 3 and reg.set_params(max_depth=4) is reg
try:
    reg.set_params(nope=1)
    raise SystemExit("set_params took an unknown parameter")
except ValueError:
    pass
assert reg.fit(x, y).score(x, y) > 0.8
clf = XGBClassifier(n_estimators=10, max_depth=3, max_bins=32, device="cpu").fit(x, y > 0)
assert clf.score(x, y > 0) > 0.9 and clf.predict_proba(x).shape == (300, 2)
rk = XGBRanker(n_estimators=3, max_depth=3, max_bins=32, device="cpu")
rk.fit(x, np.clip(np.round(y + 2), 0, 4), group=[10] * 30)
assert rk.predict(x).shape == (300,)
print("ok")
"""
    env_path = f"{ROOT / 'src'}"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"}, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_port_estimators_take_device(reg_data):
    """The estimator's matrices and booster live on `device`; the default
    is the card, which raises without one."""
    x, y = reg_data
    reg = XGBRegressor(n_estimators=2, max_bins=32, **CPU).fit(x, y)
    assert reg.get_booster().device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            XGBRegressor(n_estimators=2, max_bins=32).fit(x, y)
