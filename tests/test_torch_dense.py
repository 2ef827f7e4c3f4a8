"""The uncompressed-matrix fit (`compress_matrix=False`): the port's
against the JAX package's same setting on shared cuts (CPU: the kernels'
plain versions; the reference's Pallas kernel in interpret mode on its
kernel path), against the port's packed fit, and its pieces (dense
routing, dense traversal, `ops.build_histograms_kernel`) against their
reference functions.

Tree structure and thresholds must match exactly; leaves, margins and
predictions agree to rtol 1e-5, atol 1e-5 (float sums run in another
order, as in `test_torch_booster.py`, whose fixture this is). Integer
outputs (positions, the histogram of dyadic (g, h)) match exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import partition as JP
from repro.core import predict as JPR
from repro.kernels import ops as JO
from repro_torch.core import Booster, DeviceDMatrix
from repro_torch.core import partition as TP
from repro_torch.core import predict as TPR
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)
STRUCTURE = ("feature", "split_bin", "default_left", "is_leaf", "threshold")
# The dense fit beside the packed one, on the binary task. The kernel path
# runs the reference's Pallas kernel in interpret mode, so it fits fewer
# rounds on fewer rows.
VARIANTS = {
    "default": dict(n_rounds=4, rows=2000),
    "kernel": dict(use_kernel_histograms=True, n_rounds=3, rows=1000),
    "lossguide": dict(growth="lossguide", max_leaves=7, n_rounds=4, rows=2000),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    n, f = 2000, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    y = (z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3] > 0).astype(np.float32)
    x_new = rng.normal(size=(300, f)).astype(np.float32)
    x_new[rng.random(x_new.shape) < 0.1] = np.nan
    return x, y, x_new


@pytest.fixture(scope="module")
def fits(data):
    """fits(variant) -> (JAX dense booster, port dense booster, port packed
    booster, port training matrix), one set per variant."""
    cache = {}

    def get(variant):
        if variant not in cache:
            x, y, _ = data
            kw = dict(VARIANTS[variant])
            rows = kw.pop("rows")
            x, y = x[:rows], y[:rows]
            kw.update(max_depth=4, max_bins=32, objective="binary:logistic")
            jd = JDMatrix(x, label=y, max_bins=32)
            jb = JBooster(**kw, compress_matrix=False).fit(jd)
            d = DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts), device="cpu")
            cache[variant] = (jb, Booster(**kw, compress_matrix=False).fit(d),
                              Booster(**kw).fit(d), d)
        return cache[variant]

    return get


def _same_trees(got, want_fields, want_margins, got_margins):
    for name in STRUCTURE:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(want_fields(name)), err_msg=name)
    np.testing.assert_allclose(got.leaf_value.numpy(), np.asarray(want_fields("leaf_value")),
                               **TOL)
    np.testing.assert_allclose(got_margins, want_margins, **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dense_fit_matches_reference(data, fits, variant):
    _, _, x_new = data
    jb, tb, _, _ = fits(variant)
    assert tb.cfg.compress_matrix is False and jb.cfg.compress_matrix is False
    assert tb.ensemble.n_trees == jb.ensemble.n_trees == VARIANTS[variant]["n_rounds"]
    assert int(tb.ensemble.is_leaf.sum()) > 2 * tb.ensemble.n_trees  # real trees
    _same_trees(tb.ensemble, lambda f: getattr(jb.ensemble, f), np.asarray(jb.margins),
                tb.margins.numpy())
    if variant == "lossguide":
        assert int(tb.ensemble.is_leaf.sum(dim=1).max()) == 7  # the budget binds
    np.testing.assert_allclose(tb.predict_margins(x_new).numpy(),
                               np.asarray(jb.predict_margins(x_new)), **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dense_fit_matches_packed_fit(fits, variant):
    """The two representations hold the same bins, so the same trees grow."""
    _, dense, packed, _ = fits(variant)
    _same_trees(dense.ensemble, lambda f: getattr(packed.ensemble, f).numpy(),
                packed.margins.numpy(), dense.margins.numpy())


def test_update_positions_vs_reference():
    rng = np.random.default_rng(11)
    n, f, max_bins = 501, 4, 16
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    na = 15
    positions = rng.integers(-1, 7, size=n).astype(np.int32)  # levels 0..2, -1 = done
    split_mask = rng.random(na) < 0.6
    feature = rng.integers(0, f, size=na).astype(np.int32)
    split_bin = rng.integers(0, max_bins - 2, size=na).astype(np.int32)
    default_left = rng.random(na) < 0.5
    args = (bins, positions, split_mask, feature, split_bin, default_left)
    want = JP.update_positions(*map(jnp.asarray, args), max_bins - 1)
    got = TP.update_positions(*map(torch.from_numpy, args), max_bins - 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_trees(rng, n_trees, depth, f, max_bins):
    a = 2 ** (depth + 1) - 1
    is_leaf = rng.random((n_trees, a)) < 0.2
    is_leaf[:, 2**depth - 1:] = True
    return dict(
        feature=rng.integers(0, f, (n_trees, a)).astype(np.int32),
        split_bin=rng.integers(0, max_bins - 2, (n_trees, a)).astype(np.int32),
        threshold=rng.normal(size=(n_trees, a)).astype(np.float32),
        default_left=rng.random((n_trees, a)) < 0.5,
        leaf_value=rng.normal(size=(n_trees, a)).astype(np.float32),
        is_leaf=is_leaf,
        gain=np.full((n_trees, a), -np.inf, np.float32),
    )


@pytest.mark.parametrize("n_classes", [1, 3])
def test_dense_traversal_vs_reference(n_classes):
    """`traverse_tree_binned` per tree and `predict_binned` over a model,
    missing bins included, exactly (the same leaves, summed in tree order)."""
    rng = np.random.default_rng(12 + n_classes)
    n, f, max_bins, depth = 700, 5, 32, 4
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)  # max_bins - 1 = missing
    trees = _random_trees(rng, 2 * n_classes, depth, f, max_bins)
    jens = JPR.Ensemble(**{k: jnp.asarray(v) for k, v in trees.items()},
                        n_classes=n_classes, base_score=0.25)
    tens = TPR.Ensemble(**{k: torch.from_numpy(v) for k, v in trees.items()},
                        n_classes=n_classes, base_score=0.25)
    for t in range(tens.n_trees):
        fields = ("feature", "split_bin", "default_left", "leaf_value", "is_leaf")
        want = JPR.traverse_tree_binned(*(jnp.asarray(trees[k][t]) for k in fields),
                                        jnp.asarray(bins), max_bins - 1, depth)
        got = TPR.traverse_tree_binned(*(torch.from_numpy(trees[k][t]) for k in fields),
                                       torch.from_numpy(bins), max_bins - 1, depth)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = JPR.predict_binned(jens, jnp.asarray(bins), max_bins - 1, depth)
    got = TPR.predict_binned(tens, torch.from_numpy(bins), max_bins - 1, depth)
    assert got.shape == (n, n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,f,max_bins,n_nodes", [(1000, 6, 32, 1), (777, 3, 16, 4),
                                                  (513, 5, 256, 8)])
def test_build_histograms_kernel_vs_reference(n, f, max_bins, n_nodes):
    """Dense bins packed at bits_needed(max_bins - 1), then #1's contract
    (its plain version here; the reference's Pallas kernel in interpret
    mode). Dyadic (g, h), so every sum is exact in any order."""
    rng = np.random.default_rng(n)
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    gh = np.stack([rng.integers(-8, 9, n) / 4, rng.integers(0, 9, n) / 8],
                  axis=1).astype(np.float32)
    pos = rng.integers(0, n_nodes + 1, size=n).astype(np.int32)  # n_nodes = inactive
    want = JO.build_histograms_kernel(jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(pos),
                                      n_nodes, max_bins)
    got = ops.build_histograms_kernel(torch.from_numpy(bins), torch.from_numpy(gh),
                                      torch.from_numpy(pos), n_nodes, max_bins)
    assert got.shape == (n_nodes, f, max_bins, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_fit_unpacks_once_and_keeps_the_matrix(data, fits):
    """The dense fit trains on `matrix.unpack()` and leaves the matrix as
    it was: bin-space prediction of a ref= matrix reaches the raw rows'
    leaves."""
    _, _, x_new = data
    _, tb, _, d = fits("default")
    assert d.matrix.unpack().shape == (d.n_rows, d.n_features)
    binned = tb.predict_margins(DeviceDMatrix(x_new, ref=d)).numpy()
    np.testing.assert_allclose(binned, tb.predict_margins(x_new).numpy(), rtol=1e-6, atol=1e-6)
