"""The port's objective registry against `repro.core.objectives` (CPU).

Gradients, hessians and base scores of every ported objective on the same
seeded inputs: rtol 1e-6, atol 1e-6 (the same float32 formulas; exp, sqrt
and sigmoid may differ by an ulp between XLA and torch). 4-round fits of the
three objectives added in this slice against the reference on shared cuts,
on each of data seeds 0-9: the same tree structure, leaves and margins
within rtol 1e-5 and the atol that `tests/torch_parity_readings.py` reads
for them (worst: FIT_ATOL below). Where a split differs, it must be a tie:
the reference's own gradients give both candidates the same gain (within
TIE_RTOL), and every tree before it matches. A registered copy of a built-in
objective, and a bare callable, train bit for bit as the built-in on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import objectives as JO
from repro_torch.core import Booster, DeviceDMatrix
from repro_torch.core import objectives as O

from torch_parity_readings import QUANTILE_ALPHA, extra_labels, tie_witness

NEW = ("reg:quantile", "reg:pseudohubererror", "count:poisson")
PORTED = ("reg:squarederror", "binary:logistic", "multi:softmax") + NEW
GH_TOL = dict(rtol=1e-6, atol=1e-6)
# The worst atol beside rtol 1e-5 that torch_parity_readings.py read for
# these fits over data seeds 0-9 where the structure matched, rounded up:
# 5.1e-7, 9.4e-5 (seed 7) and 4.3e-5 (seed 6).
FIT_ATOL = {"reg:quantile": 1e-6, "reg:pseudohubererror": 1e-4, "count:poisson": 5e-5}
# A split may differ only where the reference's two candidates tie: their
# gains, summed in float64 from the reference's float32 gradients, agree to
# TIE_RTOL of the gain's terms. The splits that differ on these seeds
# (reg:quantile on 2, 7 and 9, whose gradients take two values, so two
# features can cut a node's rows into equal sums; count:poisson on 5, the
# missing direction of a node with no missing rows) tie exactly.
TIE_RTOL = 1e-6
SEEDS = range(10)


def _margins_and_labels(objective, rng, n=257):
    k = 4 if objective == "multi:softmax" else 1
    m = (rng.normal(size=(n, k)) * 1.5).astype(np.float32)
    if objective == "binary:logistic":
        y = (rng.random(n) < 0.5).astype(np.float32)
    elif objective == "multi:softmax":
        y = rng.integers(0, k, size=n).astype(np.float32)
    elif objective == "count:poisson":
        y = rng.poisson(2.0, size=n).astype(np.float32)
    else:
        y = rng.normal(size=n).astype(np.float32)
    return m, y


@pytest.mark.parametrize("objective", PORTED)
def test_grad_and_base_score_match_reference(objective):
    rng = np.random.default_rng(7)
    m, y = _margins_and_labels(objective, rng)
    extra = {"quantile_alpha": QUANTILE_ALPHA}
    mine, theirs = O.get_objective(objective), JO.get_objective(objective)
    got = mine.grad(torch.from_numpy(m), torch.from_numpy(y), **extra).numpy()
    want = np.asarray(theirs.grad(jnp.asarray(m), jnp.asarray(y), **extra))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **GH_TOL)
    assert mine.init_base_score(torch.from_numpy(y), **extra) == pytest.approx(
        theirs.init_base_score(jnp.asarray(y), **extra), rel=1e-6, abs=1e-7)
    assert mine.default_metric == theirs.default_metric
    assert mine.n_outputs(5) == theirs.n_outputs(5)
    np.testing.assert_allclose(mine.transform(torch.from_numpy(m)).numpy(),
                               np.asarray(theirs.transform(jnp.asarray(m))), **GH_TOL)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9])
def test_quantile_base_score_interpolates_as_reference(alpha):
    y = np.random.default_rng(3).normal(size=1001).astype(np.float32)
    got = O.get_objective("reg:quantile").init_base_score(torch.from_numpy(y),
                                                          quantile_alpha=alpha)
    assert got == float(jnp.quantile(jnp.asarray(y), alpha))


def test_registry_errors_and_resolution():
    with pytest.raises(ValueError, match="binary:logistic"):
        O.get_objective("not:an_objective")
    with pytest.raises(ValueError, match="register_objective"):
        Booster(objective="not:an_objective").obj
    assert O.get_objective("rank:pairwise") is O.pairwise_rank  # ported
    with pytest.raises(ValueError, match="already registered"):
        O.register_objective("reg:squarederror", lambda m, y: (m[:, 0] - y, y * 0 + 1))
    with pytest.raises(TypeError):
        O.as_objective(3)
    assert O.as_objective("count:poisson") is O.poisson
    assert O.as_objective(O.quantile) is O.quantile

    def loss(margins, y):
        return margins[:, 0] - y, torch.ones_like(y)

    wrapped = O.as_objective(loss)
    assert wrapped is O.as_objective(loss)  # cached by identity
    assert wrapped.name == "custom:loss" and wrapped.n_outputs(3) == 3
    gh = wrapped.grad(torch.zeros(4, 1), torch.arange(4.0), quantile_alpha=0.5)
    assert gh.shape == (4, 1, 2)
    np.testing.assert_array_equal(gh[:, 0, 0].numpy(), -np.arange(4.0))


def test_register_objective_keywords_and_overwrite():
    name = "test:torch_registry"
    try:
        obj = O.register_objective(name, lambda m, y, quantile_alpha: (m[:, 0] * quantile_alpha,
                                                                       torch.ones_like(y)),
                                   init_base_score=0.25, n_outputs=1)
        assert obj.init_base_score(torch.zeros(3)) == 0.25
        gh = obj.grad(torch.ones(3, 1), torch.zeros(3), quantile_alpha=0.5, group_ids=None)
        np.testing.assert_array_equal(gh[:, 0, 0].numpy(), [0.5, 0.5, 0.5])
        again = O.register_objective(name, O._sq_grad, overwrite=True,
                                     init_base_score=lambda y: float(y.sum()))
        assert O.get_objective(name) is again
        assert again.init_base_score(torch.ones(4), quantile_alpha=0.5) == 4.0
    finally:
        O.OBJECTIVES.pop(name, None)


def _data(seed):
    """The data of torch_parity_readings.py's fits at `seed` (the fixture
    of test_torch_booster.py at another seed), with the labels of the new
    objectives drawn after its other arrays."""
    rng = np.random.default_rng(seed)
    n, f = 2000, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    sig = z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3]
    regression = (sig + 0.1 * rng.normal(size=n)).astype(np.float32)
    x_new = rng.normal(size=(300, f)).astype(np.float32)
    x_new[rng.random(x_new.shape) < 0.1] = np.nan
    return x, extra_labels(rng, sig, regression), x_new


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("objective", NEW)
def test_new_objective_fit_matches_reference(objective, seed):
    x, labels, x_new = _data(seed)
    y = labels[objective]
    kw = dict(n_rounds=4, max_depth=4, max_bins=32, objective=objective,
              quantile_alpha=QUANTILE_ALPHA)
    jd = JDMatrix(x, label=y, max_bins=32)
    jb = JBooster(**kw).fit(jd)
    tb = Booster(**kw).fit(DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts),
                                         device="cpu"))
    assert tb.base_score == pytest.approx(jb.base_score, rel=1e-6, abs=1e-7)
    tol = dict(rtol=1e-5, atol=FIT_ATOL[objective])
    tie = tie_witness(kw, jd, jb, tb, y)
    if tie is not None:  # a split differs: every tree before it matches, and it ties
        np.testing.assert_allclose(tb.ensemble.leaf_value.numpy()[:tie["tree"]],
                                   np.asarray(jb.ensemble.leaf_value)[:tie["tree"]], **tol)
        ref, port = tie["ref"], tie["port"]
        assert ref is not None and port is not None, tie
        assert abs(ref["gain"] - port["gain"]) <= TIE_RTOL * max(ref["terms"], port["terms"]), tie
        assert min(ref["min_child_hess"], port["min_child_hess"]) >= jb.cfg.min_child_weight, tie
        return
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(),
                               np.asarray(jb.ensemble.leaf_value), **tol)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **tol)
    for rows in (x, x_new):
        np.testing.assert_allclose(tb.predict_margins(rows).numpy(),
                                   np.asarray(jb.predict_margins(rows)), **tol)


def _logistic_pair(margins, y):
    p = torch.sigmoid(margins[:, 0])
    return p - y, p * (1.0 - p)


@pytest.mark.parametrize("how", ["registered", "callable", "name"])
def test_custom_objective_trains_as_builtin(how):
    """fit(obj=) with the logistic gradients, registered, bare or by name,
    grows the built-in binary:logistic model bit for bit on the CPU."""
    x, _, _ = _data(0)
    y = (np.nan_to_num(x[:, 0]) > 0).astype(np.float32)
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    kw = dict(n_rounds=3, max_depth=3, max_bins=32)
    builtin = Booster(**kw, objective="binary:logistic").fit(d)
    name = "test:torch_logistic"
    try:
        spec = {"registered": lambda: O.register_objective(
                    name, _logistic_pair, transform=lambda m: torch.sigmoid(m[:, 0]),
                    default_metric="accuracy"),
                "callable": lambda: _logistic_pair,
                "name": lambda: "binary:logistic"}[how]()
        custom = Booster(**kw).fit(d, obj=spec)
        want_name = {"registered": name, "callable": "custom:_logistic_pair",
                     "name": "binary:logistic"}[how]
        assert custom.cfg.objective == want_name and custom.obj.name == want_name
        for f in ("feature", "split_bin", "default_left", "is_leaf", "leaf_value"):
            assert torch.equal(getattr(custom.ensemble, f), getattr(builtin.ensemble, f)), f
        assert torch.equal(custom.margins, builtin.margins)
    finally:
        O.OBJECTIVES.pop(name, None)
