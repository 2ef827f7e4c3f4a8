"""The port's split evaluation, row repartition and tree growth against the
JAX package on the same inputs (CPU: the kernels' plain versions).

Integer outputs (split feature and bin, default direction, leaf flags,
positions) must match exactly; sums, histograms and leaf values agree to
1e-5 — float sums in another order. The fixtures are chosen without
near-tied gains, so that the same splits win on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as JC
from repro.core import histogram as JH
from repro.core import partition as JP
from repro.core import quantile as JQ
from repro.core import split as JS
from repro.core import tree as JT
from repro.kernels import ops as JO
from repro_torch.core import compress as TC
from repro_torch.core import histogram as TH
from repro_torch.core import partition as TP
from repro_torch.core import split as TS
from repro_torch.core import tree as TT
from repro_torch.kernels import ops as TO


@pytest.fixture
def rng():
    """A fresh generator per test: the session-wide `rng` of conftest.py is
    left untouched, so the reference's tests draw what they drew before."""
    return np.random.default_rng(1234)


def _hist(rng, n_nodes, f, b, n_rows=400):
    """A histogram built from real rows, so node sums are consistent."""
    bins = rng.integers(0, b, size=(n_rows, f))
    pos = rng.integers(0, n_nodes, size=n_rows)
    gh = np.stack([rng.normal(size=n_rows), rng.random(n_rows)], 1).astype(np.float32)
    hist = np.zeros((n_nodes, f, b, 2), np.float32)
    for j in range(f):
        np.add.at(hist[:, j], (pos, bins[:, j]), gh)
    parent = np.zeros((n_nodes, 2), np.float32)
    np.add.at(parent, pos, gh)
    return hist, parent


@pytest.mark.parametrize("params", [
    JS.SplitParams(), JS.SplitParams(reg_lambda=0.5, gamma=0.7, min_child_weight=3.0),
    JS.SplitParams(gamma=2.0, min_child_weight=0.0),
])
@pytest.mark.parametrize("shape", [(1, 4, 16), (6, 5, 32), (3, 2, 256)])
def test_evaluate_splits_vs_reference(rng, params, shape):
    hist, parent = _hist(rng, *shape)
    want = JS.evaluate_splits(jnp.asarray(hist), jnp.asarray(parent), params)
    got = TS.evaluate_splits(torch.from_numpy(hist), torch.from_numpy(parent),
                             TS.SplitParams(*params))
    for name in ("feature", "split_bin", "default_left"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(np.isfinite(got.gain.numpy()), np.isfinite(np.asarray(want.gain)))
    fin = np.isfinite(np.asarray(want.gain))
    np.testing.assert_allclose(got.gain.numpy()[fin], np.asarray(want.gain)[fin],
                               rtol=1e-5, atol=1e-5)
    for name in ("left_sum", "right_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_leaf_value_vs_reference(rng):
    s = rng.normal(size=(9, 2)).astype(np.float32)
    s[:, 1] = np.abs(s[:, 1])
    np.testing.assert_allclose(TS.leaf_value(torch.from_numpy(s), 1.5).numpy(),
                               np.asarray(JS.leaf_value(jnp.asarray(s), 1.5)), rtol=1e-6)


def test_update_positions_packed_vs_reference(rng):
    n, f, max_bins, bits = 501, 4, 16, 4
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    packed = np.asarray(JC.pack(jnp.asarray(bins), bits))
    na = 15
    positions = rng.integers(-1, 7, size=n).astype(np.int32)  # levels 0..2, -1 = done
    split_mask = rng.random(na) < 0.6
    feature = rng.integers(0, f, size=na).astype(np.int32)
    split_bin = rng.integers(0, max_bins - 2, size=na).astype(np.int32)
    default_left = rng.random(na) < 0.5
    want = JP.update_positions_packed(
        jnp.asarray(packed), jnp.asarray(positions), jnp.asarray(split_mask),
        jnp.asarray(feature), jnp.asarray(split_bin), jnp.asarray(default_left),
        max_bins - 1, bits)
    got = TP.update_positions_packed(
        torch.from_numpy(packed.copy().view(np.int32)), torch.from_numpy(positions),
        torch.from_numpy(split_mask), torch.from_numpy(feature),
        torch.from_numpy(split_bin), torch.from_numpy(default_left), max_bins - 1, bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def tree_data():
    rng = np.random.default_rng(4)
    n, f, max_bins = 2000, 6, 32
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    y = z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3]
    gh = np.stack([0.3 - y + 0.1 * rng.normal(size=n), 0.5 + rng.random(n)],
                  1).astype(np.float32)
    cuts = np.array(JQ.compute_cuts(jnp.asarray(x), max_bins))
    bins = np.asarray(JQ.quantize(jnp.asarray(x), jnp.asarray(cuts)))
    cm = JC.compress(jnp.asarray(bins), jnp.asarray(cuts), max_bins)
    return gh, cuts, cm, max_bins


def _port_bins(cm):
    return TC.PackedBins(torch.from_numpy(np.asarray(cm.packed).view(np.int32).copy()),
                         cm.bits, cm.n_rows)


def _assert_same_tree(got, want):
    """Structure and thresholds exact, leaves 1e-5, gains 1e-5 rel / 1e-4 abs."""
    assert got.n_arena == want.n_arena
    for name in ("feature", "split_bin", "default_left", "is_leaf"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.threshold.numpy(), np.asarray(want.threshold))
    np.testing.assert_allclose(got.leaf_value.numpy(), np.asarray(want.leaf_value),
                               rtol=1e-5, atol=1e-5)
    wg, gg = np.asarray(want.gain), got.gain.numpy()
    np.testing.assert_array_equal(np.isfinite(gg), np.isfinite(wg))
    np.testing.assert_allclose(gg[np.isfinite(wg)], wg[np.isfinite(wg)], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("builder", ["subtraction", "kernel", "full"])
def test_grow_tree_vs_reference(tree_data, builder):
    """subtraction: both packages' default growth; kernel: a given
    hist_builder (subtraction off, the privatised kernel every level), in
    both; full: the port's full-level builder against the reference's
    full XLA build (hist_subtraction=False)."""
    gh, cuts, cm, max_bins = tree_data
    depth = 4
    params = JS.SplitParams(reg_lambda=1.0, gamma=0.1, min_child_weight=1.0)
    j_kw, t_kw = {}, {}
    if builder != "subtraction":
        t_kw["hist_builder"] = TO.build_histograms_kernel_packed
    if builder == "kernel":
        j_kw["hist_builder"] = JO.build_histograms_kernel_packed
    elif builder == "full":
        j_kw["hist_subtraction"] = False
    want = JT.grow_tree(cm.as_packed_bins(), jnp.asarray(gh), jnp.asarray(cuts), depth,
                        max_bins, params, **j_kw)
    got = TT.grow_tree(_port_bins(cm), torch.from_numpy(gh), torch.from_numpy(cuts), depth,
                       max_bins, TS.SplitParams(*params), **t_kw)
    assert got.n_arena == TT.arena_size(depth)
    assert int(got.is_leaf.sum()) > 4  # a real tree, not a stump
    _assert_same_tree(got, want)


@pytest.mark.parametrize("max_leaves", [5, 8])
def test_grow_tree_lossguide_vs_reference(tree_data, max_leaves):
    """Lossguide: only the top-k gains of a level split, k = the leaf budget
    left. The budget runs out inside a level, so the rank order matters."""
    gh, cuts, cm, max_bins = tree_data
    depth = 4
    params = JS.SplitParams(reg_lambda=1.0, gamma=0.1, min_child_weight=1.0)
    want = JT.grow_tree(cm.as_packed_bins(), jnp.asarray(gh), jnp.asarray(cuts), depth,
                        max_bins, params, growth="lossguide", max_leaves=max_leaves)
    got = TT.grow_tree(_port_bins(cm), torch.from_numpy(gh), torch.from_numpy(cuts), depth,
                       max_bins, TS.SplitParams(*params), growth="lossguide",
                       max_leaves=max_leaves)
    assert int(got.is_leaf.sum()) == max_leaves  # the budget is spent exactly
    _assert_same_tree(got, want)


@pytest.mark.parametrize("n_nodes,layout", [(2, "random"), (8, "random"), (8, "ties"),
                                            (16, "random")])
def test_histograms_by_subtraction_vs_reference(tree_data, n_nodes, layout):
    """One level below the root: the smaller child's histogram over the
    compacted buffer, the sibling as parent - child. "ties": every parent's
    children hold the same number of rows, so the left child is built."""
    gh, _, cm, max_bins = tree_data
    n = cm.n_rows
    rng = np.random.default_rng(n_nodes)
    if layout == "ties":
        local = (np.arange(n) % n_nodes).astype(np.int32)
    else:
        local = rng.integers(0, n_nodes + 1, size=n).astype(np.int32)  # n_nodes = inactive
    parent = np.where(local < n_nodes, local // 2, n_nodes // 2).astype(np.int32)
    hist_prev = JH.build_histograms_packed(cm.packed, jnp.asarray(gh), jnp.asarray(parent),
                                           n_nodes // 2, max_bins, cm.bits, n)
    want = np.asarray(JT._histograms_by_subtraction(
        cm.as_packed_bins(), jnp.asarray(gh), jnp.asarray(local), hist_prev, n_nodes,
        max_bins, 65536))
    got = TT._histograms_by_subtraction(
        _port_bins(cm), torch.from_numpy(gh), torch.from_numpy(local),
        torch.from_numpy(np.array(hist_prev)), n_nodes, max_bins).numpy()
    assert got.shape == (n_nodes, cm.packed.shape[0], max_bins, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the level's full histogram, which subtraction stands in for
    full = TH.build_histograms_packed(_port_bins(cm).packed, torch.from_numpy(gh),
                                      torch.from_numpy(local), n_nodes, max_bins, cm.bits)
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-5, atol=1e-5)


def test_grow_tree_refuses_unported_growth(tree_data):
    gh, cuts, cm, max_bins = tree_data
    pb = TC.PackedBins(torch.zeros(6, 1, dtype=torch.int32), 8, 4)
    with pytest.raises(ValueError, match="growth"):
        TT.grow_tree(pb, torch.zeros(4, 2), torch.from_numpy(cuts), 2, max_bins,
                     growth="bestfirst")
