"""The port's training and inference surface beside the reference's: fit
with eval sets, metrics and early stopping, `update`, `eval`,
`feature_importances`, `predict(iteration_range=)`, and the model cuts
`concat_ensembles`, `truncate_rounds`, `slice_rounds` (CPU: the kernels'
plain versions, shared cuts).

History values, margins and gains agree to rtol 1e-5, atol 1e-5 (float
sums in another order, as in `test_torch_booster.py`); the early-stopping
fixture's best round leads its runner-up by more than 1e-4, so the same
round wins in both packages, and the test asserts that lead. Structure,
record keys, split counts and round counts match exactly. On the CPU
fit(6) + update(4) is bit for bit fit(10).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import predict as JPR
from repro_torch.core import Booster, DeviceDMatrix
from repro_torch.core import predict as TPR
from repro_torch.dist import make_mesh

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(n_rounds=12, max_depth=4, max_bins=32, objective="binary:logistic",
          learning_rate=0.5)
ES = dict(eval_metric=["logloss", "auc"], early_stopping_rounds=3)


def _xy(rng, n, f=6):
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    sig = z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3] + 0.8 * rng.normal(size=n)
    return x, (sig > 0).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    return _xy(rng, 2000), _xy(rng, 600), _xy(rng, 400)  # train, valid, hold-out


@pytest.fixture(scope="module")
def es_fits(data):
    """The reference and the port, each fitted with two eval sets, two
    metrics and early stopping; the port's matrices on the CPU."""
    (x, y), (xv, yv), (xh, yh) = data
    jd = JDMatrix(x, label=y, max_bins=32)
    jevals = [(JDMatrix(xh, label=yh, ref=jd), "hold"), (JDMatrix(xv, label=yv, ref=jd), "valid")]
    jb = JBooster(**KW).fit(jd, evals=jevals, **ES)
    d = DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts), device="cpu")
    evals = [(DeviceDMatrix(xh, label=yh, ref=d), "hold"), (DeviceDMatrix(xv, label=yv, ref=d),
                                                          "valid")]
    calls = []
    tb = Booster(**KW).fit(d, evals=evals, callback=lambda r, rec: calls.append((r, rec)), **ES)
    return jb, tb, d, {name: dm for dm, name in evals}, calls


def test_history_matches_reference(es_fits):
    jb, tb, _, _, calls = es_fits
    assert len(tb.history) == len(jb.history) == 12  # every trained round is recorded
    for got, want in zip(tb.history, jb.history):
        assert list(got) == list(want) == [
            "round", "train_logloss", "train_auc", "hold_logloss", "hold_auc",
            "valid_logloss", "valid_auc"]
        assert got["round"] == want["round"]
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], **TOL)
    assert [r for r, _ in calls] == list(range(12))
    assert [rec for _, rec in calls] == tb.history


def test_early_stopping_matches_reference(es_fits):
    jb, tb, _, _, _ = es_fits
    auc = np.array([h["valid_auc"] for h in jb.history])  # the last metric of the last set
    best, runner_up = np.sort(auc)[::-1][:2]
    assert best - runner_up > 1e-4  # the same round wins in both packages
    assert tb.best_iteration == jb.best_iteration == int(np.argmax(auc)) == 8
    assert tb.best_score == pytest.approx(jb.best_score, rel=1e-5, abs=1e-5)
    assert tb.n_rounds_trained == jb.n_rounds_trained == tb.num_boosted_rounds() == 9
    assert tb.ensemble.n_trees == jb.ensemble.n_trees == 9
    assert tb.margins is None  # truncated: the 12 rounds' margins would be stale
    for name in ("feature", "split_bin", "default_left", "is_leaf", "threshold"):
        np.testing.assert_array_equal(getattr(tb.ensemble, name).numpy(),
                                      np.asarray(getattr(jb.ensemble, name)), err_msg=name)
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(),
                               np.asarray(jb.ensemble.leaf_value), **TOL)


def test_dense_fit_with_evals_matches_packed(es_fits):
    """`compress_matrix=False`: the eval sets' margins update on their
    dense bins, to the packed fit's history, stop and model."""
    _, tb, d, evals, _ = es_fits
    dense = Booster(**KW, compress_matrix=False).fit(
        d, evals=[(evals["hold"], "hold"), (evals["valid"], "valid")], **ES)
    assert (dense.best_iteration, dense.n_rounds_trained) == (tb.best_iteration,
                                                            tb.n_rounds_trained)
    for got, want in zip(dense.history, tb.history, strict=True):
        assert list(got) == list(want)
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], **TOL)
    for name in ("feature", "split_bin", "default_left", "is_leaf"):
        assert torch.equal(getattr(dense.ensemble, name), getattr(tb.ensemble, name)), name


def test_eval_importances_and_iteration_range_match_reference(data, es_fits):
    jb, tb, d, evals, _ = es_fits
    (xv, yv) = data[1]
    jv = JDMatrix(xv, label=yv, cuts=jb.cuts, max_bins=32)
    got = tb.eval(evals["valid"], "valid", metrics=["auc", "logloss", "error"])
    want = jb.eval(jv, "valid", metrics=["auc", "logloss", "error"])
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), **TOL)
    assert list(tb.eval(evals["valid"])) == ["eval_accuracy"]  # the objective's default
    # the final model's auc is the history's at best_iteration
    assert got["valid_auc"] == pytest.approx(tb.history[tb.best_iteration]["valid_auc"],
                                             abs=1e-5)

    np.testing.assert_array_equal(tb.feature_importances("weight"),
                                  jb.feature_importances("weight"))
    for kind in ("gain", "total_gain"):
        imp = tb.feature_importances(kind)
        assert imp.dtype == np.float64 and imp.shape == (6,)
        np.testing.assert_allclose(imp, jb.feature_importances(kind), rtol=1e-5)
    with pytest.raises(ValueError, match="importance_type"):
        tb.feature_importances("cover")

    for rng_ in ((0, 0), (2, 7), (0, 1), (8, 9), (3, 0)):
        want = np.asarray(jb.predict_margins(xv, iteration_range=rng_))
        np.testing.assert_allclose(tb.predict_margins(xv, iteration_range=rng_).numpy(),
                                   want, **TOL)
        np.testing.assert_allclose(
            tb.predict_margins(evals["valid"], iteration_range=rng_).numpy(), want, **TOL)
    np.testing.assert_allclose(tb.predict(xv, iteration_range=(2, 7)).numpy(),
                               np.asarray(jb.predict(xv, iteration_range=(2, 7))), **TOL)
    for bad in ((5, 5), (0, 10), (-1, 3)):
        with pytest.raises(ValueError, match="iteration_range"):
            tb.predict_margins(xv, iteration_range=bad)


@pytest.mark.parametrize("compress_matrix", [True, False])
def test_update_is_one_longer_fit_bit_for_bit(data, compress_matrix):
    """fit(6) + update(4) on the same matrix continues from the cached
    margins: the model, its packed nodes and the margins equal fit(10)."""
    (x, y), _, _ = data
    kw = dict(KW, n_rounds=6, compress_matrix=compress_matrix)
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    a = Booster(**kw).fit(d).update(d, 4)
    b = Booster(**dict(kw, n_rounds=10)).fit(d)
    assert a.n_rounds_trained == b.n_rounds_trained == 10
    for name in (*TPR.ENSEMBLE_FIELDS, "nodes"):
        assert torch.equal(getattr(a.ensemble, name), getattr(b.ensemble, name)), name
    assert torch.equal(a.margins, b.margins)
    assert torch.equal(a.predict_margins(x), b.predict_margins(x))
    # Another matrix of the same rows: the margins are rebuilt by bin-space
    # prediction, so they agree within float rounding. (On this fixture one
    # later split's default direction flips: its node has no missing value,
    # so both directions tie, and rounding picks one.)
    c = Booster(**kw).fit(d).update(DeviceDMatrix(x, label=y, ref=d), 4)
    assert c.n_rounds_trained == 10
    for name in ("feature", "split_bin", "is_leaf"):
        assert torch.equal(getattr(c.ensemble, name), getattr(b.ensemble, name)), name
    np.testing.assert_allclose(c.margins.numpy(), b.margins.numpy(), **TOL)


def test_update_keeps_history_and_changes_metrics(data):
    (x, y), (xv, yv), _ = data
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    dv = DeviceDMatrix(xv, label=yv, ref=d)
    bst = Booster(**dict(KW, n_rounds=3)).fit(d, evals=[(dv, "valid")])
    assert [h["round"] for h in bst.history] == [0, 1, 2]
    assert set(bst.history[0]) == {"round", "train_accuracy", "valid_accuracy"}
    bst.update(d, 2, evals=[dv], eval_metric="logloss")
    assert [h["round"] for h in bst.history] == [0, 1, 2, 3, 4]
    assert set(bst.history[-1]) == {"round", "train_logloss", "eval0_logloss"}
    np.testing.assert_allclose(bst.history[-1]["eval0_logloss"],
                               bst.eval(dv, metrics="logloss")["eval_logloss"], **TOL)


def test_metrics_are_read_once_a_chunk(data, monkeypatch):
    """12 rounds in chunks of 3 with two eval sets and two metrics: the
    metrics reach the host in 4 reads, one a chunk, and no metric value is
    read alone (`item`, `float`)."""
    (x, y), (xv, yv), _ = data
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    evals = [(DeviceDMatrix(xv, label=yv, ref=d), "a"), (DeviceDMatrix(xv, label=yv, ref=d), "b")]
    reads = {"cpu": 0, "item": 0, "__float__": 0}
    for name in reads:
        real = getattr(torch.Tensor, name)

        def counted(self, *args, _real=real, _name=name, **kw):
            reads[_name] += 1
            return _real(self, *args, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    Booster(**KW).fit(d, evals=evals, **ES)
    assert reads == {"cpu": 4, "item": 0, "__float__": 0}


def test_verbose_every_records_the_cadence_and_the_last_round(data):
    (x, y), _, _ = data
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    bst = Booster(**dict(KW, n_rounds=5)).fit(d, verbose_every=3, eval_metric="logloss")
    assert [h["round"] for h in bst.history] == [0, 3, 4]
    np.testing.assert_allclose(bst.history[-1]["train_logloss"],
                               bst.eval(DeviceDMatrix(x, label=y, ref=d),
                                        metrics="logloss")["eval_logloss"], **TOL)
    assert Booster(**dict(KW, n_rounds=2)).fit(d).history == []  # nothing asked, nothing read


def _model(rng, n_rounds, n_classes, depth=3, f=4):
    a = 2 ** (depth + 1) - 1
    t = n_rounds * n_classes
    is_leaf = rng.random((t, a)) < 0.3
    is_leaf[:, 2**depth - 1:] = True
    gain = rng.random((t, a)).astype(np.float32)
    gain[is_leaf] = -np.inf
    return dict(feature=rng.integers(0, f, (t, a)).astype(np.int32),
                split_bin=rng.integers(0, 30, (t, a)).astype(np.int32),
                threshold=rng.normal(size=(t, a)).astype(np.float32),
                default_left=rng.random((t, a)) < 0.5,
                leaf_value=rng.normal(size=(t, a)).astype(np.float32),
                is_leaf=is_leaf, gain=gain)


@pytest.mark.parametrize("n_classes", [1, 3])
def test_concat_truncate_slice_match_reference(n_classes):
    """Round-robin layout: a round is n_classes trees. The port's cuts take
    the packed nodes along, equal to packing the cut model anew."""
    rng = np.random.default_rng(n_classes)
    a, b = _model(rng, 4, n_classes), _model(rng, 3, n_classes)

    def both(fields):
        return (JPR.Ensemble(**{k: jnp.asarray(v) for k, v in fields.items()},
                             n_classes=n_classes, base_score=0.5),
                TPR.Ensemble(**{k: torch.from_numpy(v) for k, v in fields.items()},
                             n_classes=n_classes, base_score=0.5))

    (ja, ta), (jb, tb) = both(a), both(b)

    def same(got, want):
        assert (got.n_classes, got.base_score) == (want.n_classes, want.base_score)
        for name in TPR.ENSEMBLE_FIELDS:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        fresh = TPR.Ensemble(**{f: getattr(got, f) for f in TPR.ENSEMBLE_FIELDS},
                             n_classes=got.n_classes, base_score=got.base_score)
        assert torch.equal(got.nodes, fresh.nodes)

    joined = TPR.concat_ensembles(ta, tb)
    assert joined.n_trees == 7 * n_classes
    same(joined, JPR.concat_ensembles(ja, jb))
    same(TPR.truncate_rounds(joined, 5), JPR.truncate_rounds(JPR.concat_ensembles(ja, jb), 5))
    for lo, hi in ((0, 0), (1, 3), (2, 0), (6, 7)):
        same(TPR.slice_rounds(joined, lo, hi),
             JPR.slice_rounds(JPR.concat_ensembles(ja, jb), lo, hi))
    for lo, hi in ((3, 3), (0, 5), (-1, 2)):
        with pytest.raises(ValueError, match="iteration_range"):
            TPR.slice_rounds(ta, lo, hi)
        with pytest.raises(ValueError, match="iteration_range"):
            JPR.slice_rounds(ja, lo, hi)
    other = dataclasses.replace(tb, base_score=0.0, nodes=None)
    with pytest.raises(ValueError, match="metadata"):
        TPR.concat_ensembles(ta, other)
    with pytest.raises(ValueError, match="arenas"):
        TPR.concat_ensembles(ta, TPR.Ensemble(**{k: torch.from_numpy(v) for k, v in
                                                 _model(rng, 1, n_classes, depth=2).items()},
                                              n_classes=n_classes, base_score=0.5))


@pytest.mark.parametrize("keyword,value", [
    ("mesh", make_mesh((2,), ("data",), device="cpu")), ("data_axes", ("rows",)),
    ("collective", "ring"), ("compression", "f16"), ("comm_tolerance", 0.1),
    ("checkpoint_every", 2), ("checkpoint_path", "model.ckpt"), ("on_oom", "external"),
])
def test_unported_keywords_raise(data, keyword, value, tmp_path, monkeypatch):
    """Every keyword of the reference's fit is ported. The multi-device
    ones shard the fit over a 2-position CPU mesh, in fit and in update
    (test_torch_dist.py holds the fits against the reference): `mesh`
    alone is a psum fit with the sharded fit's accounting; `data_axes`
    names the mesh's axis (an axis the mesh lacks is the reference's
    KeyError); `collective` and `compression` show in `comm_stats`;
    `comm_tolerance` bounds the compressed error (a negative one is the
    reference's ValueError). checkpoint_every, checkpoint_path and on_oom:
    alone, checkpoint_every raises the reference's ValueError (it needs a
    path), a checkpoint_path gets the completed fit's checkpoint, and
    on_oom="external" fits as usual when nothing runs out of memory."""
    (x, y), _, _ = data
    d = DeviceDMatrix(x[:200], label=y[:200], max_bins=32, device="cpu")
    monkeypatch.chdir(tmp_path)
    sharding = {"mesh", "data_axes", "collective", "compression", "comm_tolerance"}
    if keyword in sharding:
        axis = value[0] if keyword == "data_axes" else "data"
        kw = {"mesh": make_mesh((2,), (axis,), device="cpu"), keyword: value}
        if keyword == "comm_tolerance":
            kw["compression"] = "q16"
        one = Booster(**dict(KW, n_rounds=1)).fit(d)
        bst = Booster(**dict(KW, n_rounds=1)).fit(d, **kw)
        cs = bst.comm_stats
        assert cs["devices"] == 2 and cs["fallback_events"] == 0
        assert cs["collective"] == kw.get("collective", "psum")
        assert cs["compression"] == kw.get("compression")
        if "compression" not in kw:  # exact: the one-device fit's trees
            np.testing.assert_array_equal(bst.ensemble.feature.numpy(),
                                          one.ensemble.feature.numpy())
        bst.update(d, 1, **kw)
        assert bst.n_rounds_trained == 2 and bst.comm_stats == cs
        if keyword == "data_axes":
            with pytest.raises(KeyError, match=value[0]):
                Booster(**dict(KW, n_rounds=1)).fit(d, mesh=make_mesh((2,), ("data",),
                                                                      device="cpu"), **{keyword: value})
        elif keyword == "comm_tolerance":
            with pytest.raises(ValueError, match="tolerance must be >= 0"):
                Booster(**dict(KW, n_rounds=1)).fit(d, **dict(kw, comm_tolerance=-value))
        return
    if keyword == "checkpoint_every":
        with pytest.raises(ValueError, match="checkpoint_path"):
            Booster(**dict(KW, n_rounds=1)).fit(d, **{keyword: value})
    elif keyword == "checkpoint_path":
        bst = Booster(**dict(KW, n_rounds=1)).fit(d, **{keyword: value})
        assert Booster.load(value, device="cpu").n_rounds_trained == 1
        bst.update(d, 1, **{keyword: value})
        assert Booster.load(value, device="cpu").n_rounds_trained == 2
    elif keyword == "on_oom":
        bst = Booster(**dict(KW, n_rounds=1)).fit(d, **{keyword: value})
        assert bst.n_rounds_trained == 1 and bst.resilience_events == []
    if keyword == "checkpoint_every":  # update lacks on_oom
        bst = Booster(**dict(KW, n_rounds=1)).fit(d, data_axes=["data"])  # ignored without a mesh
        with pytest.raises(ValueError, match="checkpoint_path"):
            bst.update(d, 1, **{keyword: value})


def test_fit_and_update_errors(data):
    (x, y), (xv, yv), _ = data
    d = DeviceDMatrix(x[:300], label=y[:300], max_bins=32, device="cpu")
    bst = Booster(**dict(KW, n_rounds=1))
    with pytest.raises(ValueError, match="early_stopping_rounds"):
        bst.fit(d, early_stopping_rounds=2)
    with pytest.raises(ValueError, match="different cuts"):
        bst.fit(d, evals=[(DeviceDMatrix(xv, label=yv, max_bins=32, device="cpu"), "v")])
    with pytest.raises(ValueError, match="no label"):
        bst.fit(d, evals=[(DeviceDMatrix(xv, ref=d), "v")])
    with pytest.raises(TypeError, match="evals"):
        bst.fit(d, evals=[(xv, "v")])
    with pytest.raises(RuntimeError, match="fit"):
        Booster().update(d, 1)
    bst.fit(d)
    with pytest.raises(ValueError, match="n_rounds"):
        bst.update(d, 0)
    with pytest.raises(ValueError, match="different cuts"):
        bst.update(DeviceDMatrix(xv, label=yv, max_bins=32, device="cpu"), 1)
    with pytest.raises(ValueError, match="label"):
        bst.update(DeviceDMatrix(xv, ref=d), 1)
    with pytest.raises(ValueError, match="label"):
        bst.eval(DeviceDMatrix(xv, ref=d))
