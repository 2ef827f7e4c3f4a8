"""Ranking in the port against the reference (CPU): query groups on the
matrix, `ops.query_groups`, `rank:pairwise`'s gradient, grouped `ndcg@k`,
and the groups through `Booster` (fit, eval sets, `update`, `eval`,
`train(group_ids=)`, checkpoints both ways).

Tolerances, from `tests/torch_parity_readings.py` (60 seeds a gradient
case, data seeds 0-9 for the fits):
  * the gradient: rtol 1e-5, atol 1e-6, plus one float32 ulp (2^-24) of
    the row's summed term magnitudes. Groups of up to 30 rows need atol
    4.3e-7 and nothing more; one query of 240 rows (`group_ids=None`) needs
    atol 5.2e-6 alone, 0.80 of that ulp beyond 1e-6: the reference adds
    its terms in float32, the port in float64.
  * ndcg@k: atol 1e-6 (the same float32 gains and discounts; the port sums
    a group in float64).
  * 4-round rank fits: the same structure on every seed and leaves and
    margins within rtol 1e-5, atol 1e-5 (worst reading 2.0e-6, seed 0).
    A split that differs must tie in the reference's own gain
    (`torch_parity_readings.tie_witness`) after trees that all match.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import metrics as JM
from repro.core import objectives as JO
from repro_torch.core import Booster, BoosterConfig, DeviceDMatrix
from repro_torch.core import booster as TB
from repro_torch.core import metrics as M
from repro_torch.core import objectives as O
from repro_torch.kernels import ops, ref

from torch_parity_readings import (
    PAIRWISE_CASES,
    RANK_KW,
    pairwise_inputs,
    pairwise_magnitudes,
    rank_data,
    tie_witness,
)

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
NDCG_ATOL = 1e-6
FIT_TOL = dict(rtol=1e-5, atol=1e-5)
TIE_RTOL = 1e-6
@pytest.fixture
def rng():
    """A fresh generator per test: the session-wide `rng` of conftest.py is
    left untouched, so the reference's tests draw what they drew before."""
    return np.random.default_rng(1234)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# --- the matrix and the grouping ---------------------------------------------

def test_dmatrix_group_ids_storage_nbytes_and_length():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    y = rng.random(50).astype(np.float32)
    gids = rng.integers(0, 7, size=50) * 11  # int64, non-contiguous, unsorted
    d = DeviceDMatrix(x, label=y, group_ids=gids, max_bins=16, device="cpu")
    assert d.group_ids.dtype == torch.int32 and d.group_ids.device.type == "cpu"
    np.testing.assert_array_equal(d.group_ids.numpy(), gids)
    jd = JDMatrix(x, label=y, group_ids=gids, max_bins=16)
    assert d.nbytes == jd.nbytes
    assert d.nbytes == DeviceDMatrix(x, label=y, max_bins=16, device="cpu").nbytes + 50 * 4
    assert DeviceDMatrix(x, max_bins=16, device="cpu").group_ids is None
    with pytest.raises(ValueError, match="group_ids has 49 rows"):
        DeviceDMatrix(x, label=y, group_ids=gids[:49], device="cpu")
    dv = DeviceDMatrix(x[:10], label=y[:10], group_ids=gids[:10], ref=d)
    assert torch.equal(dv.group_ids, d.group_ids[:10])


def _spans_numpy(ids):
    order = np.argsort(ids, kind="stable")
    srt = ids[order]
    start = np.searchsorted(srt, srt, side="left")
    end = np.searchsorted(srt, srt, side="right")
    return order, start, end


@pytest.mark.parametrize("case", ["non_contiguous", "one_group", "singletons"])
def test_query_groups(case):
    rng = np.random.default_rng(3)
    n = 97
    ids = {"non_contiguous": rng.integers(0, 12, size=n) * 9 - 40,
           "one_group": np.full(n, 5),
           "singletons": rng.permutation(n) * 3}[case].astype(np.int32)
    order, start, end = ops.query_groups(torch.from_numpy(ids))
    assert all(t.dtype == torch.int32 and t.shape == (n,) for t in (order, start, end))
    for got, want in zip((order, start, end), _spans_numpy(ids)):
        np.testing.assert_array_equal(got.numpy(), want)


# --- the gradient --------------------------------------------------------------

@pytest.mark.parametrize("case", PAIRWISE_CASES)
def test_pairwise_grad_matches_reference(case):
    """Non-contiguous ids with tied labels ("groups"), singleton groups,
    all-equal relevance (every h at the 1e-6 floor, every g 0) and one
    query (`group_ids=None`)."""
    s, y, ids = pairwise_inputs(np.random.default_rng(11), case)
    want = np.asarray(JO.get_objective("rank:pairwise").grad(_j(s), _j(y), group_ids=_j(ids)))
    got = O.get_objective("rank:pairwise").grad(_t(s), _t(y), group_ids=_t(ids)).numpy()
    assert got.shape == want.shape == (len(y), 1, 2)
    ulp = pairwise_magnitudes(s, y, ids)[:, None, :] * 2.0**-24
    assert np.all(np.abs(got - want) <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(want) + ulp)
    if case in ("singletons", "equal"):
        assert np.all(got[..., 0] == 0.0) and np.all(got[..., 1] == np.float32(1e-6))
    # The objective is ops.pairwise_grad over ops.query_groups.
    g = torch.zeros(len(y), dtype=torch.int32) if ids is None else _t(ids)
    direct = ops.pairwise_grad(_t(s[:, 0]), _t(y), *ops.query_groups(g))
    assert torch.equal(direct, torch.from_numpy(got[:, 0]))


@pytest.mark.parametrize("size", [33, 257, 513, 769])
def test_pairwise_plain_version_at_kernel_sizes(size):
    """The plain version, the card kernel's yardstick, against a literal
    float64 double loop over each query at sizes just above those at which
    the kernel's work changes hands (`kernels/pairwise.py`: a window, a
    block, two and three spread chunks), beside singletons and pairs: within 2^-22
    (1 + the row's summed rho) in g and h (float32 terms and the float32
    result against float64 ones; h's terms lose their precision in 1 - rho
    as rho nears 1, by an ulp of rho)."""
    rng = np.random.default_rng(size)
    sizes = np.concatenate([[size, size - 1, 1, 2], rng.integers(1, 9, size=20)])
    ids = rng.permutation(np.repeat(rng.permutation(len(sizes)) * 5 - 3, sizes)).astype(np.int32)
    s = (rng.normal(size=len(ids)) * 2).astype(np.float32)
    y = rng.integers(0, 5, size=len(ids)).astype(np.float32)
    got = ops.pairwise_grad(_t(s), _t(y), *ops.query_groups(_t(ids))).numpy()
    want, mag = np.zeros((len(ids), 2)), np.zeros(len(ids))
    for q in np.unique(ids):
        rows = np.nonzero(ids == q)[0]
        for i in rows:
            j = rows[y[rows] != y[i]]
            better = y[i] > y[j]
            d = np.where(better, s[j].astype(np.float64) - s[i], s[i].astype(np.float64) - s[j])
            rho = 1.0 / (1.0 + np.exp(-d))
            want[i] = [np.sum(np.where(better, -rho, rho)), np.sum(rho * (1.0 - rho))]
            mag[i] = np.sum(rho)
    want[:, 1] = np.maximum(want[:, 1], 1e-6)
    assert np.all(np.abs(got - want) <= 2.0**-22 * (1 + mag[:, None]))


def test_pairwise_plain_version_tiles_a_large_group(monkeypatch):
    """A group whose pairs outnumber a chunk of the plain version runs over
    several chunks of its rows; the result is that of one chunk."""
    s, y, ids = pairwise_inputs(np.random.default_rng(4), "groups")
    ids = np.where(ids == ids[0], ids, ids[0]).astype(np.int32)  # one group of all rows
    args = (_t(s[:, 0]), _t(y), *ops.query_groups(_t(ids)))
    whole = ref.pairwise_terms_ref(*args)
    monkeypatch.setattr(ref, "PAIR_CHUNK_ELEMENTS", 1000)
    tiled = ref.pairwise_terms_ref(*args)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)


# --- ndcg@k --------------------------------------------------------------------

def _ndcg_numpy(s, y, gids, k):
    """Literal per-group reference (tests/test_metrics.py's): sort by score,
    DCG@k over 2^rel - 1 gains, normalised by the ideal ordering."""
    vals = []
    for g in np.unique(gids):
        sel = gids == g
        sg, yg = s[sel], y[sel]
        order = np.lexsort((np.arange(len(sg)), -sg))
        gains = 2.0 ** yg - 1.0
        disc = 1.0 / np.log2(np.arange(len(sg)) + 2.0)
        dcg = np.sum((gains[order] * disc)[:k])
        ideal = np.lexsort((np.arange(len(yg)), -yg))
        idcg = np.sum((gains[ideal] * disc)[:k])
        vals.append(dcg / idcg if idcg > 0 else 1.0)
    return float(np.mean(vals))


def _ndcg_case(case, rng):
    n = 150
    s = rng.normal(size=n).astype(np.float32)
    y = rng.integers(0, 4, size=n).astype(np.float32)
    ids = rng.permutation(np.repeat(np.arange(15) * 7 + 2, 10)).astype(np.int32)
    if case == "tied_scores":
        s = np.round(s).astype(np.float32)  # a few values, ties in every group
    elif case == "tied_labels":
        y = (y > 1).astype(np.float32)
    elif case == "zero_idcg":
        y[ids == ids[0]] = 0.0  # one group with no relevant row
    elif case == "none":
        ids = None
    return s, y, ids


@pytest.mark.parametrize("case", ["groups", "tied_scores", "tied_labels", "zero_idcg", "none"])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_ndcg_matches_reference(case, k):
    s, y, ids = _ndcg_case(case, np.random.default_rng(21))
    want = float(JM.get_metric(f"ndcg@{k}").fn(_j(s[:, None]), _j(y), group_ids=_j(ids)))
    got = M.get_metric(f"ndcg@{k}").fn(_t(s[:, None]), _t(y), group_ids=_t(ids))
    assert got.ndim == 0 and got.dtype == torch.float32
    assert abs(float(got) - want) <= NDCG_ATOL
    literal = _ndcg_numpy(s, y, np.zeros(len(y)) if ids is None else ids, k)
    assert abs(float(got) - literal) <= NDCG_ATOL


@pytest.mark.parametrize("k", [1, 3, 8])
def test_ndcg_reference_cases(rng, k):
    """tests/test_metrics.py's own ndcg cases, against the reference."""
    n_groups, per = 12, 7
    s = rng.normal(size=n_groups * per).astype(np.float32)
    y = rng.integers(0, 4, size=n_groups * per).astype(np.float32)
    gids = np.repeat(np.arange(n_groups), per).astype(np.int32)
    zero = np.zeros(8, np.float32)
    zero[4:] = [3, 1, 0, 2]
    two = np.repeat(np.arange(2), 4).astype(np.int32)
    for s_, y_, g_, kk in ((s, y, gids, k), (s[:8], zero, two, 4), (s[:20], y[:20], None, 5)):
        want = float(JM.get_metric(f"ndcg@{kk}").fn(_j(s_[:, None]), _j(y_), group_ids=_j(g_)))
        got = float(M.get_metric(f"ndcg@{kk}").fn(_t(s_[:, None]), _t(y_), group_ids=_t(g_)))
        assert abs(got - want) <= NDCG_ATOL


# --- the groups through the booster ---------------------------------------------

def _rank_pair(seed):
    x, rel, gids, x_new = rank_data(seed)
    jd = JDMatrix(x, label=rel, group_ids=gids, max_bins=32)
    d = DeviceDMatrix(x, label=rel, group_ids=gids, max_bins=32, cuts=np.asarray(jd.cuts),
                      device="cpu")
    return x, rel, gids, x_new, jd, d


@pytest.mark.parametrize("seed", range(10))
def test_rank_fit_matches_reference(seed):
    x, rel, gids, x_new, jd, d = _rank_pair(seed)
    jb = JBooster(**RANK_KW).fit(jd)
    tb = Booster(**RANK_KW).fit(d)
    assert tb.base_score == jb.base_score == 0.0
    tie = tie_witness(RANK_KW, jd, jb, tb, rel, gids)
    if tie is not None:  # a split differs: every tree before it matches, and it ties
        np.testing.assert_allclose(tb.ensemble.leaf_value.numpy()[:tie["tree"]],
                                   np.asarray(jb.ensemble.leaf_value)[:tie["tree"]], **FIT_TOL)
        r, p = tie["ref"], tie["port"]
        assert r is not None and p is not None, tie
        assert abs(r["gain"] - p["gain"]) <= TIE_RTOL * max(r["terms"], p["terms"]), tie
        return
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(),
                               np.asarray(jb.ensemble.leaf_value), **FIT_TOL)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **FIT_TOL)
    for rows in (x, x_new):
        np.testing.assert_allclose(tb.predict_margins(rows).numpy(),
                                   np.asarray(jb.predict_margins(rows)), **FIT_TOL)


def _eval_split(seed=2):
    """Training queries 0-29, eval queries 30-39 (ids kept, non-contiguous
    after a row shuffle)."""
    x, rel, gids, _ = rank_data(seed)
    perm = np.random.default_rng(seed).permutation(len(rel))
    x, rel, gids = x[perm], rel[perm], gids[perm]
    tr = gids < 30
    return (x[tr], rel[tr], gids[tr]), (x[~tr], rel[~tr], gids[~tr])


def test_eval_set_with_groups_history_matches_reference():
    (x, y, g), (xv, yv, gv) = _eval_split()
    kw = {**RANK_KW, "n_rounds": 6}
    metrics = ["ndcg@5", "ndcg@10", "pairwise_acc"]
    jd = JDMatrix(x, label=y, group_ids=g, max_bins=32)
    jb = JBooster(**kw).fit(jd, evals=[(JDMatrix(xv, label=yv, group_ids=gv, ref=jd), "valid")],
                            eval_metric=metrics)
    d = DeviceDMatrix(x, label=y, group_ids=g, max_bins=32, cuts=np.asarray(jd.cuts),
                      device="cpu")
    dv = DeviceDMatrix(xv, label=yv, group_ids=gv, ref=d)
    tb = Booster(**kw).fit(d, evals=[(dv, "valid")], eval_metric=metrics)
    assert len(tb.history) == len(jb.history) == 6
    for got, want in zip(tb.history, jb.history):
        assert list(got) == list(want)
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], **FIT_TOL)
    # Default metric: ndcg@10, on the eval set's own groups.
    assert tb.eval(dv)["eval_ndcg@10"] == pytest.approx(tb.history[-1]["valid_ndcg@10"],
                                                        abs=1e-6)
    one_query = DeviceDMatrix(xv, label=yv, ref=d)  # the same rows without groups
    assert tb.eval(one_query)["eval_ndcg@10"] != pytest.approx(tb.eval(dv)["eval_ndcg@10"])


def test_update_and_eval_with_groups():
    (x, y, g), (xv, yv, gv) = _eval_split(3)
    kw = {**RANK_KW, "n_rounds": 3}
    jd = JDMatrix(x, label=y, group_ids=g, max_bins=32)
    jdv = JDMatrix(xv, label=yv, group_ids=gv, ref=jd)
    jb = JBooster(**kw).fit(jd).update(jd, 2)
    d = DeviceDMatrix(x, label=y, group_ids=g, max_bins=32, cuts=np.asarray(jd.cuts),
                      device="cpu")
    dv = DeviceDMatrix(xv, label=yv, group_ids=gv, ref=d)
    tb = Booster(**kw).fit(d).update(d, 2)
    five = Booster(**{**kw, "n_rounds": 5}).fit(d)
    assert torch.equal(tb.margins, five.margins)  # bit for bit one longer fit (CPU)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **FIT_TOL)
    got = tb.eval(dv, "valid", metrics=["ndcg@3", "ndcg@10"])
    want = jb.eval(jdv, "valid", metrics=["ndcg@3", "ndcg@10"])
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), atol=1e-5)


def test_train_group_ids_matches_reference():
    from repro.core.booster import BoosterConfig as JConfig
    from repro.core.booster import train as jtrain

    x, rel, gids, x_new = rank_data(4)
    tb = TB.train(x, rel, BoosterConfig(**RANK_KW), group_ids=gids, device="cpu")
    assert torch.equal(tb._train_dmat.group_ids, torch.from_numpy(gids))
    jb = jtrain(x, rel, JConfig(**RANK_KW), group_ids=gids)
    np.testing.assert_allclose(tb.predict_margins(x_new).numpy(),
                               np.asarray(jb.predict_margins(x_new)), **FIT_TOL)


def test_custom_objective_and_metric_get_group_ids():
    """A custom gradient and metric receive the matrix's `group_ids`, as in
    the reference; a matrix without groups passes none."""
    x, rel, gids, _ = rank_data(5)
    seen = []

    def grad(margins, y, group_ids=None):
        seen.append(("grad", group_ids))
        return O.pairwise_rank.grad(margins, y, group_ids=group_ids)

    def metric(margins, y, group_ids=None):
        seen.append(("metric", group_ids))
        return torch.zeros(())

    d = DeviceDMatrix(x, label=rel, group_ids=gids, max_bins=32, device="cpu")
    tb = Booster(**{**RANK_KW, "n_rounds": 2}).fit(
        d, obj=grad, eval_metric=M.Metric("groups_seen", metric),
        verbose_every=1)
    assert len(seen) == 4 and all(torch.equal(g, d.group_ids) for _, g in seen)
    tb2 = Booster(**RANK_KW).fit(DeviceDMatrix(x, label=rel, max_bins=32, device="cpu"))
    ranked = Booster(**RANK_KW).fit(DeviceDMatrix(x, label=rel, group_ids=np.zeros(
        len(rel), np.int32), max_bins=32, device="cpu"))
    assert torch.equal(tb2.margins, ranked.margins)  # None is one query over all rows


def test_rank_checkpoint_both_ways(tmp_path):
    x, rel, gids, x_new, jd, d = _rank_pair(6)
    tb = Booster(**RANK_KW).fit(d)
    tb.save(str(tmp_path / "port.ckpt"))
    jb = JBooster.load(str(tmp_path / "port.ckpt"))
    assert jb.cfg.objective == "rank:pairwise"
    np.testing.assert_allclose(np.asarray(jb.predict(x_new)), tb.predict(x_new).numpy(),
                               **FIT_TOL)
    # The reference's checkpoint loads in the port and trains on with groups.
    jref = JBooster(**RANK_KW).fit(jd)
    jref.save(str(tmp_path / "ref.ckpt"))
    loaded = Booster.load(str(tmp_path / "ref.ckpt"), device="cpu")
    np.testing.assert_allclose(loaded.predict(x_new).numpy(), np.asarray(jref.predict(x_new)),
                               **FIT_TOL)
    loaded.update(d, 2)
    jref.update(jd, 2)
    assert loaded.num_boosted_rounds() == jref.num_boosted_rounds() == 6
    np.testing.assert_allclose(loaded.predict_margins(x_new).numpy(),
                               np.asarray(jref.predict_margins(x_new)), **FIT_TOL)


def test_rank_model_through_xgboost_json():
    """A rank:pairwise model exported to XGBoost JSON and imported again
    keeps its objective and predicts bit for bit; the reference imports the
    same file to its own rank:pairwise model."""
    from repro.serve import import_xgboost_json as jimport
    from repro_torch.serve import export_xgboost_json, import_xgboost_json

    x, rel, gids, x_new, _, d = _rank_pair(7)
    tb = Booster(**RANK_KW).fit(d)
    model = export_xgboost_json(tb)
    back = import_xgboost_json(model, device="cpu")
    assert back.cfg.objective == "rank:pairwise"
    assert torch.equal(back.predict(x_new), tb.predict(x_new))
    jb = jimport(model)
    assert jb.cfg.objective == "rank:pairwise"
    np.testing.assert_allclose(np.asarray(jb.predict(x_new)), tb.predict(x_new).numpy(),
                               **FIT_TOL)
