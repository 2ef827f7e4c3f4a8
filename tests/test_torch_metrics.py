"""The port's metric registry (`repro_torch.core.metrics`) against the JAX
package's (`repro.core.metrics`): every built-in on identical margins and
labels (rtol 1e-5, atol 1e-6), auc on tied scores too, ndcg@3; the
`maximize` flags, the spec forms `get_metric` and `resolve_metrics` accept,
`register_metric`, and the errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as JM
from repro_torch.core import metrics as TM

TOL = dict(rtol=1e-5, atol=1e-6)
BUILTINS = ("rmse", "mae", "quantile", "mphe", "poisson-nloglik", "logloss", "error",
            "accuracy", "auc", "merror", "mlogloss", "pairwise_acc")


def _task(name, rng, n=500):
    """(margins, labels) that the metric reads, as float32 numpy."""
    if name in ("merror", "mlogloss"):
        return (rng.normal(size=(n, 3)).astype(np.float32),
                rng.integers(0, 3, n).astype(np.float32))
    m = rng.normal(size=(n, 1)).astype(np.float32)
    if name in ("logloss", "error", "accuracy", "auc"):
        y = (m[:, 0] + rng.normal(size=n) > 0).astype(np.float32)
    elif name == "poisson-nloglik":
        y = rng.poisson(2.0, n).astype(np.float32)
    elif name in ("pairwise_acc",) or name.startswith("ndcg"):
        y = rng.integers(0, 4, n).astype(np.float32)
    else:
        y = (m[:, 0] + rng.normal(size=n)).astype(np.float32)
    return m, y


def _both(name, m, y, **extra):
    want = float(JM.get_metric(name).fn(jnp.asarray(m), jnp.asarray(y), **extra))
    got = TM.get_metric(name).fn(torch.from_numpy(m), torch.from_numpy(y), **extra)
    assert isinstance(got, torch.Tensor) and got.ndim == 0
    return float(got), want


@pytest.mark.parametrize("name", [*BUILTINS, "ndcg@3"])
def test_builtin_matches_reference(name):
    rng = np.random.default_rng(len(name))
    m, y = _task(name, rng, n=300 if name.startswith("ndcg") else 500)
    got, want = _both(name, m, y)
    np.testing.assert_allclose(got, want, **TOL)
    if name == "quantile":  # the config keyword reaches it
        got, want = _both(name, m, y, quantile_alpha=0.9)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["auc", "accuracy", "ndcg@3", "pairwise_acc"])
def test_ranking_metrics_on_tied_scores(name):
    """Scores on a coarse grid, so many tie: auc averages the ranks of a
    tie, ndcg breaks it by row order, as the reference does."""
    rng = np.random.default_rng(7)
    n = 400
    m = (np.round(rng.normal(size=(n, 1)) * 2) / 2).astype(np.float32)
    y = ((m[:, 0] + rng.normal(size=n) > 0) if name in ("auc", "accuracy")
         else rng.integers(0, 4, n)).astype(np.float32)
    assert len(np.unique(m)) < 20
    got, want = _both(name, m, y)
    np.testing.assert_allclose(got, want, **TOL)


def test_auc_edge_cases():
    """One class only (the reference's max(n_pos * n_neg, 1) guard), and a
    perfect and a reversed ranking."""
    s = np.linspace(-1, 1, 50, dtype=np.float32)[:, None]
    for y in (np.ones(50, np.float32), (s[:, 0] > 0).astype(np.float32),
              (s[:, 0] < 0).astype(np.float32)):
        got, want = _both("auc", s, y)
        np.testing.assert_allclose(got, want, **TOL)


def test_maximize_flags_match_reference():
    for name in (*BUILTINS, "ndcg@5"):
        assert TM.get_metric(name).maximize == JM.get_metric(name).maximize, name
    assert set(BUILTINS) <= set(TM.METRICS)


def test_get_metric_spec_forms():
    m = TM.get_metric("rmse")
    assert TM.get_metric("rmse") is m and TM.get_metric(m) is m
    assert TM.get_metric("ndcg@4") is TM.get_metric("ndcg@4")  # built once, cached
    assert TM.get_metric("ndcg@4").name == "ndcg@4"

    def my_err(margins, y):
        return torch.mean(torch.abs(margins[:, 0] - y))

    by_fn = TM.get_metric(my_err)
    assert (by_fn.name, by_fn.maximize) == ("my_err", False)
    assert TM.get_metric(my_err) is by_fn  # cached by (fn, name, maximize)
    named = TM.get_metric(("gain", my_err, True))
    assert (named.name, named.maximize) == ("gain", True)
    assert TM.get_metric(("gain2", my_err)).maximize is False
    margins, y = torch.tensor([[1.0], [2.0]]), torch.tensor([0.0, 0.0])
    # the wrapper drops the dataset keywords a bare callable does not take
    assert float(by_fn.fn(margins, y, quantile_alpha=0.3, group_ids=None)) == 1.5

    # a Metric whose fn takes only some keywords gets only those
    seen = {}

    def alpha_only(margins, y, quantile_alpha=0.5):
        seen["alpha"] = quantile_alpha
        return margins.sum()

    adapted = TM.get_metric(TM.Metric("alpha_only", alpha_only))
    adapted.fn(margins, y, quantile_alpha=0.25, group_ids="dropped")
    assert seen == {"alpha": 0.25}
    assert TM.get_metric(TM.Metric("alpha_only", alpha_only)) is adapted

    assert TM.resolve_metrics(None) == ()
    assert TM.resolve_metrics("auc") == (TM.get_metric("auc"),)
    assert TM.resolve_metrics(["auc", "logloss"]) == (TM.get_metric("auc"),
                                                      TM.get_metric("logloss"))
    assert TM.resolve_metrics(("gain", my_err, True)) == (named,)
    assert TM.resolve_metrics(my_err) == (by_fn,)


def test_register_metric_and_errors():
    def twice_mae(margins, y, **_):
        return 2.0 * torch.mean(torch.abs(margins[:, 0] - y))

    name = "test_torch_metrics.twice_mae"
    m = TM.register_metric(name, twice_mae, maximize=True)
    try:
        assert TM.get_metric(name) is m and m.maximize
        with pytest.raises(ValueError, match="already registered"):
            TM.register_metric(name, twice_mae)
        assert TM.register_metric(name, twice_mae, overwrite=True).maximize is False
    finally:
        del TM.METRICS[name]
    with pytest.raises(ValueError, match="unknown eval metric"):
        TM.get_metric("no-such-metric")
    with pytest.raises(ValueError, match="unknown eval metric"):
        TM.get_metric("nope@3")
    with pytest.raises(ValueError, match="k >= 1"):
        TM.get_metric("ndcg@0")
    with pytest.raises(ValueError, match="metric tuple"):
        TM.get_metric(("a", twice_mae, True, 1))
    with pytest.raises(TypeError):
        TM.get_metric(3.5)
