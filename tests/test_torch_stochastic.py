"""Stochastic and constrained training in the port against the reference,
on the CPU: the constrained and masked split evaluation, `grow_tree(ctx=)`,
and fits with subsample, each colsample_*, GOSS, monotone constraints and
their mixes (`torch_parity_readings.STOCHASTIC`) on data seeds 0-9.

Both packages draw the reference's uniforms (`_torch_parity.replay_uniform`
replaces `repro_torch.core.sampling.uniform`), so every tree samples the
same rows and features in both. Tolerances, read by
`python tests/torch_parity_readings.py stochastic`:

  * the constrained split gain within 5·B·2⁻²⁴·max(|gain|, 1), the form of
    the unconstrained scan's limit (worst reading 5.5e-5 relative at 256
    bins against a limit of 7.6e-5);
  * fits: tree structure exact, leaves, margins and predictions within
    rtol 1e-5 and the atol of FIT_ATOL. Where a split differs (softmax with
    subsample, data seed 5), every earlier tree matches and the two splits
    tie in the reference's own float64 gain on the tree's sampled rows
    (`tie_witness`); for GOSS a differing selection must sit at the top-|g|
    boundary within one float32 ulp (`goss_witness`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sklearn as JSK
import repro_torch.sklearn as TSK
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import quantile as JQ
from repro.core import sampling as JSMP
from repro.core import split as JS
from repro.core import tree as JT
from repro.core.booster import Booster as JBooster
from repro.kernels import ops as JKO
from repro_torch.core import Booster, DeviceDMatrix
from repro_torch.core import sampling as TSMP
from repro_torch.core import split as TS
from repro_torch.core import tree as TT
from repro_torch.kernels import ops as TKO
from repro_torch.kernels import ref as TR

from _torch_parity import constrained_split_inputs, jax_key, replay_uniform
from torch_parity_readings import (
    CONSTRAINED_SHAPES,
    STOCHASTIC,
    STRUCTURE,
    goss_witness,
    jax_splits,
    per_feature_splits,
    stochastic_fit,
    tie_witness,
    torch_splits,
)

# The worst atol beside rtol 1e-5 over data seeds 0-9 where the structure
# matched, rounded up: 2.4e-6, 1.2e-5, 8.1e-6, 1.3e-5, 8.3e-6, 5.7e-8,
# 1.5e-6 and 5.2e-6.
FIT_ATOL = {"subsample": 5e-6, "colsample_bytree": 2e-5, "colsample_bylevel": 1e-5,
            "colsample_bynode": 2e-5, "goss": 1e-5, "monotone": 1e-6,
            "monotone_subsample": 2e-6, "softmax_subsample": 1e-5}
TIE_RTOL = 1e-6  # two tied candidates' float64 gains agree to this share of their terms
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setattr(TSMP, "uniform", replay_uniform)


@pytest.fixture
def rng():
    return np.random.default_rng(2300)


def _gain64(hist, parent, node, feature, split_bin, default_left, params, mono, bounds):
    """The reference's constrained gain of one split, in float64 from the
    histogram: (gain, the sum of its terms' magnitudes)."""
    lam = params[0]
    h = hist[node, feature].astype(np.float64)
    g_tot, h_tot = parent[node].astype(np.float64)
    gl, hl = h[:split_bin + 1].sum(0) + (h[-1] if default_left else 0.0)
    lo, hi = bounds[node].astype(np.float64)

    def at(a, b):
        w = np.clip(-a / (b + lam), lo, hi)
        return -(2.0 * a * w + (b + lam) * w * w)

    terms = (at(gl, hl), at(g_tot - gl, h_tot - hl), at(g_tot, h_tot))
    return 0.5 * (terms[0] + terms[1] - terms[2]), 0.5 * sum(abs(t) for t in terms)


@pytest.mark.parametrize("shape,params", CONSTRAINED_SHAPES)
def test_evaluate_splits_masked_and_monotone_vs_reference(rng, shape, params):
    """Each (node, feature)'s best constrained gain within the limit; each
    node's best split the reference's, or where the choice differs (exact
    ties under pinched or clipping bounds) a split whose float64 gain ties
    the reference's; the child sums of equal choices within the limit's
    share of the feature's summed magnitudes. Node 0's every feature is
    masked: gain -inf in both."""
    hist, parent, mono, bounds, mask = constrained_split_inputs(rng, *shape)
    limit = 5 * shape[2] * 2.0**-24
    everything = np.ones(shape[:2], bool)
    want = per_feature_splits(jax_splits, hist, parent, params, mono, bounds, everything)
    got = per_feature_splits(torch_splits, hist, parent, params, mono, bounds, everything)
    fin = np.isfinite(want["gain"])
    np.testing.assert_array_equal(np.isfinite(got["gain"]), fin)
    err = np.abs(got["gain"][fin] - want["gain"][fin])
    assert np.all(err <= limit * np.maximum(np.abs(want["gain"][fin]), 1.0))

    w = jax_splits(hist, parent, params, mask, mono, bounds)
    t = torch_splits(hist, parent, params, mask, mono, bounds)
    wg, tg = np.asarray(w.gain), t.gain.numpy()
    np.testing.assert_array_equal(np.isfinite(tg), np.isfinite(wg))
    assert not np.isfinite(tg[0])
    for node in np.flatnonzero(np.isfinite(wg)):
        assert abs(tg[node] - wg[node]) <= limit * max(abs(wg[node]), 1.0)
        mine = (int(t.feature[node]), int(t.split_bin[node]), bool(t.default_left[node]))
        theirs = (int(w.feature[node]), int(w.split_bin[node]), bool(w.default_left[node]))
        if mine == theirs:  # child sums: prefix sums in another order, within the
            # limit's share of the feature's summed |g| and |h|
            mag = np.abs(hist[node, mine[0]]).sum(axis=0)
            for name in ("left_sum", "right_sum"):
                diff = np.abs(getattr(t, name).numpy()[node] - np.asarray(getattr(w, name))[node])
                assert np.all(diff <= limit * np.maximum(mag, 1.0)), (node, name, diff)
            continue
        a, sa = _gain64(hist, parent, node, *mine, params, mono, bounds)
        b, sb = _gain64(hist, parent, node, *theirs, params, mono, bounds)
        assert abs(a - b) <= TIE_RTOL * max(sa, sb, 1.0), (node, mine, theirs, a, b)


def test_evaluate_splits_needs_bounds_with_monotone():
    hist, parent = torch.zeros(1, 2, 8, 2), torch.zeros(1, 2)
    with pytest.raises(ValueError, match="node_bounds"):
        TS.evaluate_splits(hist, parent, monotone=torch.zeros(2, dtype=torch.int8))


def test_gain_at_weight_vs_reference(rng):
    g, h, w = (rng.normal(size=50).astype(np.float32) for _ in range(3))
    h = np.abs(h)
    got = TS._gain_at_weight(torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w), 1.5)
    want = JS._gain_at_weight(jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # at the unconstrained optimum it is G^2 / (H + lam)
    opt = TS._gain_at_weight(torch.tensor(2.0), torch.tensor(3.0), torch.tensor(-0.5), 1.0)
    assert float(opt) == pytest.approx(1.0)


@pytest.fixture(scope="module")
def tree_data():
    rng = np.random.default_rng(77)
    n, f = 1500, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    gh = np.stack([rng.normal(size=n), rng.uniform(0.1, 1.0, n)], axis=1).astype(np.float32)
    jd = JDMatrix(x, max_bins=32)
    td = DeviceDMatrix(x, max_bins=32, cuts=np.asarray(jd.cuts), device="cpu")
    return gh, jd, td


GROW_CASES = {
    "compact_packed": (dict(subsample=0.6, colsample_bynode=0.7), True, {}),
    "dense": (dict(subsample=0.6, colsample_bylevel=0.6), True, {}),
    "masked_kernel_builder": (dict(sampling_method="goss", colsample_bytree=0.5), False, {}),
    "lossguide_monotone": (dict(subsample=0.7, monotone=(1, 0, 0, -1, 0, 0)), True,
                           dict(growth="lossguide", max_leaves=8)),
}


@pytest.mark.parametrize("case", list(GROW_CASES))
def test_grow_tree_with_context_vs_reference(replay, tree_data, case):
    """One tree grown by each package from the reference's own TreeContext
    (the port's made from it: the same row buffer and tree mask, the level
    masks drawn from the same path): compact buffers on packed words, the
    dense bins' gathered rows, masked (g, h) through the kernel builders
    (the reference's Pallas kernel in interpret mode), lossguide with
    monotone bounds. Structure exact, leaves within TOL."""
    gh, jd, td = tree_data
    knobs, compact, grow = GROW_CASES[case]
    path = (5, 2, 0)
    jp, tp = JSMP.StochasticParams(**knobs), TSMP.StochasticParams(**knobs)
    jctx, jgh = JSMP.make_tree_context(jp, jax_key(path), jnp.asarray(gh), 6, compact=compact)
    tctx = TSMP.TreeContext(
        path, None if jctx.row_ids is None else torch.from_numpy(np.array(jctx.row_ids)),
        None if jctx.feature_mask is None else torch.from_numpy(np.array(jctx.feature_mask)),
        tp, torch.device("cpu"))
    tgh = torch.from_numpy(np.array(jgh))
    jbins, tbins = jd.packed_bins(), td.packed_bins()
    jbuild = tbuild = None
    if case == "dense":
        jbins, tbins = jd.matrix.unpack(), td.matrix.unpack()
    elif case == "masked_kernel_builder":
        jbuild, tbuild = JKO.build_histograms_kernel_packed, TKO.build_histograms_kernel_packed
    want = JT.grow_tree(jbins, jgh, jd.cuts, 4, 32, JS.SplitParams(), hist_builder=jbuild,
                        ctx=jctx, **grow)
    got = TT.grow_tree(tbins, tgh, td.cuts, 4, 32, TS.SplitParams(), hist_builder=tbuild,
                       ctx=tctx, **grow)
    for name in STRUCTURE:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.leaf_value.numpy(), np.asarray(want.leaf_value), **TOL)
    assert int(got.is_leaf.sum()) > 3


def test_grow_tree_refuses_a_builder_with_a_row_buffer(tree_data):
    gh, _, td = tree_data
    ctx, gh_c = TSMP.make_tree_context(TSMP.StochasticParams(subsample=0.5), (0, 0, 0),
                                       torch.from_numpy(gh), 6)
    with pytest.raises(NotImplementedError, match="masked-mode"):
        TT.grow_tree(td.packed_bins(), gh_c, td.cuts, 3, 32,
                     hist_builder=TKO.build_histograms_kernel_packed, ctx=ctx)
    bad = TSMP.TreeContext((0, 0, 0), None, None, TSMP.StochasticParams(monotone=(1, 0)), "cpu")
    with pytest.raises(ValueError, match="monotone constraints cover 2 features"):
        TT.grow_tree(td.packed_bins(), torch.from_numpy(gh), td.cuts, 3, 32, ctx=bad)


@pytest.mark.parametrize("knobs", [dict(subsample=0.5), dict(sampling_method="goss"),
                                   dict(subsample=0.5, monotone=(1, 0, 0, -1, 0, 0))])
def test_masked_mode_grows_the_compact_tree(tree_data, knobs):
    """Zeroed (g, h) of the unselected rows grow the tree of the compacted
    buffer: same structure, leaves within TOL (the subtraction trick may
    build the other child, so sums round differently)."""
    gh, _, td = tree_data
    p = TSMP.StochasticParams(**knobs)
    trees = []
    for compact in (True, False):
        ctx, gh_c = TSMP.make_tree_context(p, (21, 0, 0), torch.from_numpy(gh), 6,
                                           compact=compact)
        trees.append(TT.grow_tree(td.packed_bins(), gh_c, td.cuts, 4, 32, ctx=ctx))
    for name in STRUCTURE:
        assert torch.equal(getattr(trees[0], name), getattr(trees[1], name)), name
    np.testing.assert_allclose(trees[0].leaf_value.numpy(), trees[1].leaf_value.numpy(), **TOL)


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("name", list(STOCHASTIC))
def test_stochastic_fit_vs_reference(replay, name, seed):
    kw, x, y, x_new, td, jd, jb, tb = stochastic_fit(seed, name)
    tol = dict(rtol=1e-5, atol=FIT_ATOL[name])
    tie = tie_witness(kw, jd, jb, tb, y)
    if tie is not None:  # a split differs: every tree before it matches, and it ties
        np.testing.assert_allclose(tb.ensemble.leaf_value.numpy()[:tie["tree"]],
                                   np.asarray(jb.ensemble.leaf_value)[:tie["tree"]], **tol)
        if name == "goss":
            witness = goss_witness(kw, td, jd, jb, tb, y, tie["tree"])
            if not witness["selection_same"]:
                assert witness["boundary_ulps"] <= 1 and witness["g_ulps"] <= 1, witness
                return
        ref, port = tie["ref"], tie["port"]
        assert ref is not None and port is not None, tie
        assert abs(ref["gain"] - port["gain"]) <= TIE_RTOL * max(ref["terms"], port["terms"]), tie
        assert min(ref["min_child_hess"], port["min_child_hess"]) >= jb.cfg.min_child_weight, tie
        return
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(), np.asarray(jb.ensemble.leaf_value),
                               **tol)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **tol)
    for rows in (x, x_new):
        np.testing.assert_allclose(tb.predict_margins(rows).numpy(),
                                   np.asarray(jb.predict_margins(rows)), **tol)


def _binary_data(n=3000, f=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x @ rng.normal(size=f) + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return x, y


def _same_model(a, b) -> bool:
    return all(torch.equal(getattr(a.ensemble, k), getattr(b.ensemble, k))
               for k in ("feature", "split_bin", "default_left", "leaf_value", "is_leaf"))


@pytest.mark.parametrize("knobs", [dict(subsample=0.5),
                                   dict(sampling_method="goss", colsample_bynode=0.5)])
def test_update_continues_the_draws(knobs):
    """fit(6) + update(4) is fit(10) exactly: round r of the update draws
    from path (seed, r, class) with r counted from the first fit's start."""
    x, y = _binary_data()
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    kw = dict(max_depth=4, max_bins=32, objective="binary:logistic", seed=4, **knobs)
    long = Booster(n_rounds=10, **kw).fit(d)
    short = Booster(n_rounds=6, **kw).fit(d).update(d, 4)
    assert _same_model(long, short)
    assert torch.equal(long.margins, short.margins)
    other = Booster(n_rounds=10, **{**kw, "seed": 5}).fit(d)
    assert not _same_model(long, other)


def test_seed_alone_changes_nothing():
    x, y = _binary_data()
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    kw = dict(n_rounds=4, max_depth=4, max_bins=32, objective="binary:logistic")
    assert _same_model(Booster(**kw, seed=0).fit(d), Booster(**kw, seed=12345).fit(d))
    zeros = Booster(**kw, seed=7, monotone_constraints=(0,) * 6, subsample=1.0).fit(d)
    assert _same_model(Booster(**kw).fit(d), zeros)


def test_monotone_length_checked_at_fit():
    x, y = _binary_data(n=500, f=4)
    with pytest.raises(ValueError, match="4 features"):
        Booster(n_rounds=2, max_bins=32, monotone_constraints=(1, 0)).fit(
            DeviceDMatrix(x, label=y, max_bins=32, device="cpu"))


@pytest.mark.parametrize("direction,subsample", [(1, 1.0), (-1, 1.0), (1, 0.5), (-1, 0.6)])
def test_monotone_sweep(direction, subsample):
    """Predictions along 64 ascending values of the constrained feature
    never fall (+1) or never rise (-1), exactly, at 200 rows' other values:
    rounding is monotone, so a float sum of monotone trees is too."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, size=(4000, 3)).astype(np.float32)
    y = (direction * (1.5 * x[:, 0] + np.sin(3 * x[:, 0])) + np.sin(2 * x[:, 1])
         + 0.3 * rng.normal(size=4000)).astype(np.float32)
    bst = Booster(n_rounds=15, max_depth=4, max_bins=64, subsample=subsample, seed=6,
                  monotone_constraints=(direction, 0, 0)).fit(
        DeviceDMatrix(x, label=y, max_bins=64, device="cpu"))
    grid = np.linspace(-2.2, 2.2, 64, dtype=np.float32)
    rows = np.repeat(x[:200], 64, axis=0)
    rows[:, 0] = np.tile(grid, 200)
    pred = bst.predict(rows).numpy().reshape(200, 64)
    assert np.all(np.diff(pred, axis=1) * direction >= 0)
    assert np.any(np.diff(pred, axis=1) != 0)


def test_subsampled_model_checkpoints_both_ways(tmp_path):
    """A model fitted with sampling and constraints: save -> load in the
    port predicts bit for bit and gives the knobs back (the constraints as
    a tuple); the reference loads the same file and predicts alike."""
    x, y = _binary_data()
    kw = dict(n_rounds=5, max_depth=4, max_bins=32, objective="binary:logistic", seed=9,
              subsample=0.7, colsample_bytree=0.8, monotone_constraints=(1, 0, 0, 0, 0, -1))
    bst = Booster(**kw).fit(DeviceDMatrix(x, label=y, max_bins=32, device="cpu"))
    path = str(tmp_path / "m.ckpt")
    bst.save(path)
    back = Booster.load(path, device="cpu")
    assert back.cfg == bst.cfg and back.cfg.monotone_constraints == (1, 0, 0, 0, 0, -1)
    assert torch.equal(back.predict(x), bst.predict(x))
    ref = JBooster.load(path)
    assert ref.cfg.monotone_constraints == (1, 0, 0, 0, 0, -1) and ref.cfg.subsample == 0.7
    np.testing.assert_allclose(np.asarray(ref.predict(x)), bst.predict(x).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture
def shared_cuts(monkeypatch):
    """The port's estimators quantise with the reference's cut points."""

    def with_reference_cuts(x, label=None, *, ref=None, max_bins=256, **kw):
        if ref is None:
            kw["cuts"] = np.asarray(JQ.compute_cuts(np.asarray(x, np.float32), max_bins))
        return DeviceDMatrix(x, label, ref=ref, max_bins=max_bins, **kw)

    monkeypatch.setattr(TSK, "DeviceDMatrix", with_reference_cuts)


@pytest.mark.parametrize("estimator", ["XGBRegressor", "XGBClassifier"])
def test_estimators_with_sampling_vs_reference(replay, shared_cuts, estimator):
    """The estimators pass subsample, colsample_bytree, monotone_constraints
    and random_state (the seed) on: predictions as the reference
    estimator's within TOL."""
    x, y = _binary_data(n=700)
    if estimator == "XGBRegressor":
        y = (x[:, 0] - x[:, 5] + 0.2 * x[:, 1] ** 2).astype(np.float32)
    kw = dict(n_estimators=8, max_depth=3, max_bins=32, subsample=0.6, colsample_bytree=0.8,
              monotone_constraints=[1, 0, 0, 0, 0, -1], random_state=13)
    est = getattr(TSK, estimator)(**kw, device="cpu").fit(x, y)
    ref = getattr(JSK, estimator)(**kw).fit(x, y)
    assert est.get_booster().cfg.monotone_constraints == (1, 0, 0, 0, 0, -1)
    assert est.get_booster().cfg.seed == 13
    predict = (lambda e: e.predict(x)) if estimator == "XGBRegressor" else (
        lambda e: e.predict_proba(x))
    np.testing.assert_allclose(predict(est), predict(ref), **TOL)


def test_split_scan_plain_masked_gives_the_masked_record(rng):
    """The plain scan's masked (node, feature): [-inf, 0, 0, 0, 0], also
    where the unmasked gain would be NaN (an all-zero node at lam = 0)."""
    hist, parent, mono, bounds, mask = constrained_split_inputs(rng, 4, 5, 16)
    hist[1] = 0.0
    parent[1] = 0.0
    for kw in (dict(), dict(monotone=torch.from_numpy(mono), node_bounds=torch.from_numpy(bounds))):
        out = TR.split_scan_ref(torch.from_numpy(hist), torch.from_numpy(parent), 0.0, 0.0,
                                feature_mask=torch.from_numpy(mask), **kw).numpy()
        np.testing.assert_array_equal(out[~mask], np.tile([-np.inf, 0, 0, 0, 0], (int((~mask).sum()), 1)))
