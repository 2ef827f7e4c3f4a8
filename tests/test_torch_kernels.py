"""The plain PyTorch versions of the CUDA kernels (`repro_torch.kernels.ref`,
reached through `kernels.ops` on CPU tensors) against the JAX package's
functions as its own tests run them on the CPU (Pallas in interpret mode).

Tolerances and their reasons:
  * privatised and row-id histograms: rtol 1e-5, atol 2e-5 — float sums
    in another order.
  * histogram_packed: exact, on dyadic (g, h) whose partial sums are exact
    in any order.
  * decompress: exact (integers).
  * split scan: bin and direction exact; hl 1e-6. The gain to
    5·B·2⁻²⁴ of max(|gain|, 1) for B bins, not 1e-6: the prefix sums are
    taken in another order (strictly left to right here, a log-depth scan in
    the reference), their rounding grows with B, and HR = H − HL cancels
    when the right child is light, which the gain's terms amplify. Worst
    readings over 60 seeds: 6.8e-5 at B=256, 1.0e-5 at 64, 2.7e-6 at 33,
    0 at 8; the limit is 7.6e-5 at 256.
  * cut selection and `compute_cuts_op`: +inf pattern exact, values by the
    rank-flip model (the reference's jitted rank fractions are not true
    division); the finite cuts ascend once the +inf tail is masked.
  * packed nodes: exact round trip; the walk over them bit-identical to the
    walk over the arena fields (the same comparisons, leaves summed per
    class in the same order).
  * `quantize_op`: exact, given the reference's cuts.
  * traversal: 1e-5 — leaves summed per class in another order.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as JC
from repro.core import histogram as JH
from repro.kernels import ops as JO
from repro.kernels.quantile_cuts import quantile_cuts_from_sorted as j_cuts_from_sorted
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import DeviceLimits
from repro_torch.kernels.decompress import decompress
from repro_torch.kernels.ensemble_traversal import (
    BARRIER_BYTES,
    KREG,
    NODE_BYTES,
    ROW_TILE_TREES,
    SMEM_TARGET,
    THREADS,
    WALK_TREES,
    ensemble_margins_kernel,
    node_fields,
    pack_nodes,
    traversal_plan,
)
from repro_torch.kernels.histogram import (
    BIN_BYTES,
    FLUSH_ROWS,
    PRIVATE_BLOCKS_PER_SM,
    PRIVATE_NARROW_BLOCKS_PER_SM,
    PRIVATE_THREADS,
    build_histograms_packed_kernel,
    build_histograms_rows_kernel,
    histogram_packed,
    launch_plan,
    private_bytes,
    private_plan,
)
from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
from repro_torch.kernels.split_scan import split_scan

from _torch_parity import assert_cuts_close, tied_split_histogram


@pytest.fixture
def rng():
    """A fresh generator per test: the session-wide `rng` of conftest.py is
    left untouched, so the reference's tests draw what they drew before."""
    return np.random.default_rng(1234)

H100_SMEM = 232448  # opt-in shared memory per block on an H100
# An H100 SXM: SMs, opt-in shared memory per block, per SM, reserved per
# block, threads per SM.
H100 = DeviceLimits(132, H100_SMEM, 233_472, 1_024, 2_048)


def _hist_inputs(rng, n, f, max_bins, n_nodes, words="uniform"):
    """Bins spread over all values; `words="skewed"` moves 80% of them to the
    missing bin, `"constant"` puts every row's feature 0 in value bin 1."""
    bits = JC.bits_needed(max_bins - 1)
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    if words == "skewed":
        bins[rng.random((n, f)) < 0.8] = max_bins - 1
    elif words == "constant":
        bins[:, 0] = 1
    gh = np.stack([rng.normal(size=n), rng.random(n)], axis=1).astype(np.float32)
    pos = rng.integers(0, n_nodes + 1, size=n).astype(np.int32)  # n_nodes = inactive
    packed = np.asarray(JC.pack(jnp.asarray(bins), bits))
    return packed, gh, pos, bits


def _words(packed: np.ndarray) -> np.ndarray:
    """The reference's uint32 words as the port's int32 bit patterns."""
    return packed.copy().view(np.int32)


@pytest.mark.parametrize("n,f,max_bins,n_nodes,words", [
    (257, 4, 16, 1, "uniform"),    # ragged last word
    (1000, 7, 64, 3, "uniform"),
    (513, 3, 256, 8, "uniform"),
    (64, 1, 8, 2, "uniform"),
    (301, 5, 32, 8, "uniform"),
    (1000, 5, 256, 8, "skewed"),   # most lanes of a warp in one bin
    (999, 4, 256, 32, "constant"),
], ids=["257-4-16-1", "1000-7-64-3", "513-3-256-8", "64-1-8-2", "301-5-32-8",
        "skewed-1000-5-256-8", "constant-999-4-256-32"])
def test_histogram_plain_vs_reference(rng, n, f, max_bins, n_nodes, words):
    packed, gh, pos, bits = _hist_inputs(rng, n, f, max_bins, n_nodes, words)
    want = np.asarray(JO.histogram_private_op(
        jnp.asarray(packed), jnp.asarray(gh), jnp.asarray(pos), n_nodes, max_bins, bits))
    got = ops.histogram_private_op(torch.from_numpy(_words(packed)), torch.from_numpy(gh),
                                   torch.from_numpy(pos), n_nodes, max_bins, bits)
    assert got.shape == (n_nodes, f, max_bins, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("n,f,max_bins,n_nodes", [
    (1000, 5, 16, 1),
    (777, 3, 32, 3),   # odd row count, nodes not a multiple of the TPU's 8
    (1501, 9, 16, 12),  # two node blocks and two feature blocks there
])
def test_histogram_packed_plain_vs_reference(rng, n, f, max_bins, n_nodes):
    """Inactive rows carry n_nodes or -1; the reference's node blocks of 8
    put n_nodes into padding rows of its output, -1 nowhere."""
    packed, _, pos, bits = _hist_inputs(rng, n, f, max_bins, n_nodes)
    pos[rng.random(n) < 0.1] = -1
    gh = np.stack([rng.integers(-8, 9, n) / 4, rng.integers(0, 5, n) / 4],
                  axis=1).astype(np.float32)  # dyadic: every sum exact
    want = np.asarray(JO.histogram_packed_op(
        jnp.asarray(packed), jnp.asarray(gh), jnp.asarray(pos), n_nodes, max_bins, bits))
    got = ops.histogram_packed_op(torch.from_numpy(_words(packed)), torch.from_numpy(gh),
                                  torch.from_numpy(pos), n_nodes, max_bins, bits).numpy()
    assert got.shape == (n_nodes, f, max_bins, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,f,max_bins,n_nodes,m", [
    (1000, 4, 16, 1, 500),
    (999, 7, 64, 4, 499),   # odd rows: a ragged last word
    (513, 3, 256, 16, 256),
])
def test_histogram_rows_plain_vs_reference(rng, n, f, max_bins, n_nodes, m):
    """A compacted buffer as the subtraction trick makes it: selected rows
    in row order, some at the dump position, then padding slots whose ids
    are >= n (n itself, past the last word, far past)."""
    packed, gh, _, bits = _hist_inputs(rng, n, f, max_bins, n_nodes)
    k = m - m // 5
    rid = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
    pad = np.array([n, n + 1, n + 64, 10 * n], np.int32)
    rid = np.concatenate([rid, np.resize(pad, m - k)])
    pos = rng.integers(0, n_nodes + 1, size=m).astype(np.int32)  # n_nodes = dump
    pos[k:] = n_nodes
    gh_sel = gh[np.minimum(rid, n - 1)]
    want = np.asarray(JH.build_histograms_packed_rows(
        jnp.asarray(packed), jnp.asarray(gh_sel), jnp.asarray(pos), jnp.asarray(rid),
        n_nodes, max_bins, bits))
    got = ops.histogram_rows(torch.from_numpy(_words(packed)), torch.from_numpy(gh_sel),
                             torch.from_numpy(pos), torch.from_numpy(rid), n_nodes,
                             max_bins, bits).numpy()
    assert got.shape == (n_nodes, f, max_bins, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("bits,n,f", [(4, 1001, 5), (8, 777, 11), (8, 2048, 3), (5, 333, 2),
                                      (1, 1001, 3), (9, 1000, 7), (16, 333, 4), (32, 65, 2)])
def test_decompress_plain_vs_reference(rng, bits, n, f):
    """At 32 bits the symbols span every uint32; int32 holds their bit
    patterns on both sides."""
    bins = rng.integers(0, 2**bits, size=(n, f)).astype(np.int32)
    packed = np.asarray(JC.pack(jnp.asarray(bins), bits))
    want = np.asarray(JO.decompress_op(jnp.asarray(packed), bits, n))
    got = ops.decompress_op(torch.from_numpy(_words(packed)), bits, n).numpy()
    assert got.dtype == np.int32 and got.shape == (n, f)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bins)


def _split_inputs(rng, n_nodes, f, b, with_missing=True):
    g = rng.normal(size=(n_nodes, f, b))
    h = rng.random((n_nodes, f, b)) * 2
    if not with_missing:
        g[..., -1] = h[..., -1] = 0
    hist = np.stack([g, h], axis=-1).astype(np.float32)
    parent = hist[:, 0].sum(axis=1)  # every feature sees every row
    return hist, parent


@pytest.mark.parametrize("shape,lam,mcw", [
    ((1, 3, 8), 1.0, 0.5), ((3, 17, 64), 1.0, 1.0), ((8, 5, 256), 0.5, 2.0),
    ((2, 4, 33), 2.0, 0.0),
])
def test_split_scan_plain_vs_reference(rng, shape, lam, mcw):
    """`ops.split_scan_op` (the reference's four fields) against
    `repro.kernels.ops.split_scan_op`, and the gl field of `ops.split_scan`."""
    hist, parent = _split_inputs(rng, *shape)
    want = np.asarray(JO.split_scan_op(jnp.asarray(hist), jnp.asarray(parent), lam, mcw))
    got = ops.split_scan(torch.from_numpy(hist), torch.from_numpy(parent), lam, mcw).numpy()
    assert got.shape == shape[:2] + (5,)
    mine = ops.split_scan_op(torch.from_numpy(hist), torch.from_numpy(parent), lam,
                             mcw).numpy()
    assert mine.shape == want.shape == shape[:2] + (4,)
    np.testing.assert_array_equal(mine, got[..., [0, 1, 2, 4]])
    np.testing.assert_array_equal(mine[..., 1:3], want[..., 1:3])
    np.testing.assert_array_equal(np.isfinite(mine[..., 0]), np.isfinite(want[..., 0]))
    fin = np.isfinite(want[..., 0])
    gain_err = np.abs(mine[..., 0] - want[..., 0])[fin]
    limit = 5 * shape[2] * 2.0**-24 * np.maximum(np.abs(want[..., 0][fin]), 1.0)
    assert np.all(gain_err <= limit)
    np.testing.assert_allclose(mine[..., 3], want[..., 3], rtol=1e-6, atol=1e-6)
    # gl is the left prefix sum at the winner, missing mass added when it goes left
    b = got[..., 1].astype(int)
    gl = np.cumsum(hist[..., :-1, 0], axis=-1, dtype=np.float64)
    gl = np.take_along_axis(gl, b[..., None], -1)[..., 0] + got[..., 2] * hist[..., -1, 0]
    np.testing.assert_allclose(got[..., 3], gl, rtol=1e-5, atol=1e-5)


def test_split_scan_ties_go_to_the_lowest_bin():
    hist = np.zeros((1, 1, 10, 2), np.float32)
    hist[0, 0, [2, 5], 0] = [-1.0, 1.0]  # thresholds 2, 3, 4 score the same
    hist[0, 0, :9, 1] = 1.0
    hist[0, 0, 3:5, 1] = 0.0  # ... because bins 3 and 4 hold nothing
    parent = hist[:, 0].sum(axis=1)
    got = ops.split_scan(torch.from_numpy(hist), torch.from_numpy(parent), 1.0, 0.0).numpy()
    assert got[0, 0, 1] == 2.0
    none = ops.split_scan(torch.zeros(1, 1, 10, 2), torch.zeros(1, 2), 1.0, 1.0).numpy()
    assert none[0, 0, 0] == -np.inf and none[0, 0, 1] == 0.0
    # 256 bins, thresholds tied from 7 on (over bins 8..12) and from 31 on
    # (32..36): the ties straddle the bins 7/8 and 31/32; missing values
    # absent, then going left. Bin and direction as the reference's.
    for missing_g, left in ((0.0, 0.0), (-1.0, 1.0)):
        hist, parent = tied_split_histogram((8, 32), 3, 256, missing_g=missing_g)
        want = np.asarray(JO.split_scan_op(jnp.asarray(hist), jnp.asarray(parent), 1.0, 1.0))
        got = ops.split_scan(torch.from_numpy(hist), torch.from_numpy(parent), 1.0,
                             1.0).numpy()
        np.testing.assert_array_equal(got[..., 1:3], want[..., 1:3])
        np.testing.assert_array_equal(got[..., 1], [[7.0] * 3, [31.0] * 3])
        assert np.all(got[..., 2] == left)


@pytest.mark.parametrize("n,f,max_bins", [(1000, 7, 16), (513, 3, 256), (64, 1, 256),
                                          (333, 11, 64)])
def test_cut_selection_plain_vs_reference(rng, n, f, max_bins):
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.1] = np.nan
    srt = np.sort(np.where(np.isnan(x), np.inf, x), axis=0)
    n_valid = np.isfinite(srt).sum(axis=0).astype(np.int32)
    want = np.asarray(j_cuts_from_sorted(jnp.asarray(srt), jnp.asarray(n_valid), max_bins))
    got = ref.quantile_cuts_ref(torch.from_numpy(srt), torch.from_numpy(n_valid),
                                max_bins).numpy()
    assert got.shape == (f, max_bins - 2)
    assert_cuts_close(got, want, x)


@pytest.mark.parametrize("n,max_bins", [(1000, 16), (513, 256), (64, 256), (2000, 64)])
def test_cut_selection_plain_returns_the_reference_cuts(rng, n, max_bins):
    """The plain version returns what the reference's function returns, the
    ascending cuts with a +inf tail, with no sort after it: on a
    low-cardinality column (duplicate candidates become +inf markers inside
    the row before the sort), a constant column, an all-missing column and a
    column with one valid value."""
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, 1] = np.round(x[:, 1])  # low cardinality
    x[:, 2] = 0.5  # constant
    x[:, 3] = np.nan  # all missing
    x[:, 4] = np.nan
    x[n // 2, 4] = 1.25  # n_valid = 1
    srt = np.sort(np.where(np.isnan(x), np.inf, x), axis=0)
    n_valid = np.isfinite(srt).sum(axis=0).astype(np.int32)
    assert n_valid[3] == 0 and n_valid[4] == 1
    want = np.asarray(j_cuts_from_sorted(jnp.asarray(srt), jnp.asarray(n_valid), max_bins))
    got = ref.quantile_cuts_ref(torch.from_numpy(srt), torch.from_numpy(n_valid),
                                max_bins).numpy()
    assert got.shape == want.shape == (6, max_bins - 2)
    assert_cuts_close(got, want, x)
    assert np.isfinite(got[1]).sum() > 1  # several cuts, deduplicated
    for row in got:  # ascending, then the +inf tail
        fin = np.isfinite(row)
        assert not np.any(fin[1:] & ~fin[:-1])
        assert np.all(np.diff(row[fin]) > 0)
    np.testing.assert_array_equal(got[2][:2], [0.5, np.inf])
    assert np.all(np.isinf(got[3]))
    np.testing.assert_array_equal(got[4][:2], [1.25, np.inf])


def _cuts_data(rng, n, f):
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.1] = np.nan
    x[:, 1] = np.round(x[:, 1])  # a low-cardinality column: duplicate cuts
    x[:, 2] = 0.5  # constant: one cut
    return x


@pytest.mark.parametrize("n,f,max_bins", [(1000, 5, 16), (777, 4, 64), (513, 3, 256)])
def test_compute_cuts_op_vs_reference(rng, n, f, max_bins):
    x = _cuts_data(rng, n, f)
    want = np.asarray(JO.compute_cuts_op(jnp.asarray(x), max_bins))
    got = ops.compute_cuts_op(torch.from_numpy(x), max_bins).numpy()
    assert got.shape == want.shape == (f, max_bins - 2)
    assert_cuts_close(got, want, x)
    for row in got:  # ascending once the +inf tail is masked
        fin = row[np.isfinite(row)]
        assert np.all(np.diff(fin) > 0)
    assert np.isfinite(got[2]).sum() == 1 and got[2, 0] == 0.5


@pytest.mark.parametrize("n,f,max_bins", [(1000, 5, 16), (513, 3, 256)])
def test_quantize_op_vs_reference(rng, n, f, max_bins):
    x = _cuts_data(rng, n, f)
    cuts = np.array(JO.compute_cuts_op(jnp.asarray(x), max_bins))  # writable
    x_new = rng.normal(size=(n // 2, f)).astype(np.float32) * 2  # values past the cuts
    x_new[rng.random(x_new.shape) < 0.1] = np.nan
    x_new[:5] = x[:5]  # values equal to a cut's neighbours
    for rows in (x, x_new):
        want = np.asarray(JO.quantize_op(jnp.asarray(rows), jnp.asarray(cuts)))
        got = ops.quantize_op(torch.from_numpy(rows), torch.from_numpy(cuts)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _random_ensemble(rng, n_trees, depth, n_features):
    a = 2 ** (depth + 1) - 1
    is_leaf = rng.random((n_trees, a)) < 0.2
    is_leaf[:, 2**depth - 1:] = True  # the last level is all leaves
    threshold = rng.normal(size=(n_trees, a)).astype(np.float32)
    threshold[is_leaf] = np.inf
    return (rng.integers(0, n_features, (n_trees, a)).astype(np.int32), threshold,
            rng.random((n_trees, a)) < 0.5,
            rng.normal(size=(n_trees, a)).astype(np.float32), is_leaf)


@pytest.mark.parametrize("n,f,n_trees,depth,k", [
    (300, 5, 6, 3, 1), (129, 4, 9, 4, 3), (50, 2, 1, 1, 1), (257, 7, 40, 6, 2),
])
def test_traversal_plain_vs_reference(rng, n, f, n_trees, depth, k):
    arena = _random_ensemble(rng, n_trees, depth, f)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.2] = np.nan
    want = np.asarray(JO.ensemble_margins_op(*map(jnp.asarray, arena), jnp.asarray(x),
                                             k, depth))
    got = ops.ensemble_margins_op(*map(torch.from_numpy, arena), torch.from_numpy(x), k,
                                  depth).numpy()
    assert got.shape == (n, k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,f,n_trees,depth,k", [
    (300, 5, 6, 3, 1), (129, 4, 9, 4, 3), (50, 2, 1, 1, 1), (257, 7, 40, 6, 2),
    (100, 3, 7, 0, 7),
])
def test_packed_nodes_round_trip_and_walk(rng, n, f, n_trees, depth, k):
    """`pack_nodes` keeps every field the traversal reads, bit for bit, in
    the layout the kernel reads, and `node_fields` gives them back; odd
    arenas are padded with an unreached leaf. A walk over the packed words
    alone, as the kernel walks them (one node's two words a level, each
    class summed in tree order), equals the plain version over the arena
    fields bit for bit, and so does `ops` on the CPU."""
    arena = _random_ensemble(rng, n_trees, depth, f)
    feature, threshold, dl, leaf, is_leaf = arena
    nodes = pack_nodes(*map(torch.from_numpy, arena))
    a = feature.shape[1]
    assert nodes.dtype == torch.int32 and nodes.shape == (n_trees, a + a % 2, 2)
    words = nodes.numpy().view(np.uint32)
    meta = words[:, :a, 1]
    np.testing.assert_array_equal(meta >> 31, is_leaf)
    np.testing.assert_array_equal((meta >> 30) & 1, dl)
    np.testing.assert_array_equal(meta & (2**30 - 1), np.where(is_leaf, 0, feature))
    np.testing.assert_array_equal(words[:, :a, 0],
                                  np.where(is_leaf, leaf, threshold).view(np.uint32))
    if a % 2:
        np.testing.assert_array_equal(words[:, a], [[0, 2**31]] * n_trees)
    value, feat, left, leaf_flag = (t[:, :a].numpy() for t in node_fields(nodes))
    np.testing.assert_array_equal(leaf_flag, is_leaf)
    np.testing.assert_array_equal(left, dl)
    np.testing.assert_array_equal(feat, np.where(is_leaf, 0, feature))
    np.testing.assert_array_equal(value.view(np.uint32),
                                  np.where(is_leaf, leaf, threshold).view(np.uint32))
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.2] = np.nan
    got = np.zeros((n, k), np.float32)
    rows = np.arange(n)
    for t in range(n_trees):
        node = np.zeros(n, np.int64)
        for _ in range(depth):
            m = words[t, node, 1]
            v = x[rows, m & (2**30 - 1)]
            left = np.where(np.isnan(v), ((m >> 30) & 1) == 1,
                            v <= words[t, node, 0].view(np.float32))
            node = np.where((m >> 31) == 0, 2 * node + np.where(left, 1, 2), node)
        got[:, t % k] += words[t, node, 0].view(np.float32)
    xt = torch.from_numpy(x)
    want = ref.ensemble_margins_ref(*map(torch.from_numpy, arena), xt, k, depth)
    np.testing.assert_array_equal(got, want.numpy())
    assert torch.equal(ops.ensemble_margins_nodes_op(nodes, xt, k, depth), want)


@pytest.mark.parametrize("n,f,n_trees,depth,max_depth,k", [
    (200, 5, 6, 5, 2, 1), (129, 4, 9, 4, 0, 3), (100, 3, 8, 6, 3, 2),
])
def test_traversal_truncated_walk_vs_reference(rng, n, f, n_trees, depth, max_depth, k):
    """Arenas deeper than `max_depth`: as in the reference, a walk that has
    not reached a leaf after `max_depth` levels takes the leaf value of the
    node it stands on (`ensemble_margins_op` cuts the model there; the
    random arenas hold leaf values on internal nodes too). Packed
    arenas deeper than `max_depth` raise, since a packed internal node holds
    no leaf value."""
    arena = _random_ensemble(rng, n_trees, depth, f)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.2] = np.nan
    want = np.asarray(JO.ensemble_margins_op(*map(jnp.asarray, arena), jnp.asarray(x),
                                             k, max_depth))
    got = ops.ensemble_margins_op(*map(torch.from_numpy, arena), torch.from_numpy(x), k,
                                  max_depth).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    nodes = pack_nodes(*map(torch.from_numpy, arena))
    with pytest.raises(ValueError, match="deeper than max_depth"):
        ops.ensemble_margins_nodes_op(nodes, torch.from_numpy(x), k, max_depth)


def test_pack_nodes_rejects_wide_feature_indices():
    """An internal node's feature index takes 30 bits of the node word; a
    leaf's is not stored."""
    feature = torch.tensor([[2**30, 0, 0]], dtype=torch.int32)
    fields = (torch.zeros(1, 3), torch.zeros(1, 3, dtype=torch.bool), torch.ones(1, 3))
    with pytest.raises(ValueError, match="2\\*\\*30"):
        pack_nodes(feature, *fields, torch.tensor([[False, True, True]]))
    with pytest.raises(ValueError, match="2\\*\\*30"):
        pack_nodes(-feature, *fields, torch.tensor([[False, True, True]]))
    leaves = pack_nodes(feature, *fields, torch.ones(1, 3, dtype=torch.bool))
    assert int(leaves[0, 0, 1]) == -(2**31)  # leaf bit, feature 0


def test_wrappers_take_only_cuda_tensors():
    """On a CPU tensor a wrapper raises; only ops picks the plain version."""
    cpu = torch.zeros(4, 2)
    words, pos = torch.zeros(1, 1, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    for hist_kernel in (build_histograms_packed_kernel, histogram_packed):
        with pytest.raises(ValueError, match="CUDA"):
            hist_kernel(words, cpu, pos, 1, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        build_histograms_rows_kernel(words, cpu, pos, pos, 1, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        decompress(words, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        split_scan(torch.zeros(1, 1, 8, 2), torch.zeros(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        quantile_cuts_from_sorted(cpu, torch.zeros(2, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="CUDA"):
        ensemble_margins_kernel(torch.zeros(1, 4, 2, dtype=torch.int32), cpu, 1, 1)


@pytest.mark.parametrize("n_nodes,max_bins", [(1, 256), (8, 256), (32, 256), (200, 256),
                                              (5, 16), (64, 1024)])
def test_histogram_launch_plan_fits_shared_memory(n_nodes, max_bins):
    """The plan caps a block's private histogram (max_bins - 1 bins a
    feature and node, 16 bytes a bin, and its share of the node totals) so
    that three blocks fit on an SM, and covers every node, feature and
    word."""
    plan = launch_plan(250_000, 28, n_nodes, max_bins, H100)
    cap = H100.smem_sm // 3 - H100.smem_reserved
    assert plan.smem_bytes == private_bytes(plan.feat_group, plan.node_tile, max_bins)
    assert plan.smem_bytes == (plan.feat_group * plan.node_tile * (max_bins - 1)
                               + plan.node_tile) * BIN_BYTES
    assert plan.smem_bytes <= cap and plan.blocks_per_sm >= 3
    assert plan.blocks_per_sm * (plan.smem_bytes + H100.smem_reserved) <= H100.smem_sm
    assert 1 <= plan.node_tile <= n_nodes and 1 <= plan.feat_group <= 28
    if private_bytes(1, n_nodes, max_bins) <= cap:  # one feature at every node fits
        assert plan.node_tile == n_nodes
    assert plan.words_per_block * -(-250_000 // plan.words_per_block) >= 250_000
    if (n_nodes, max_bins) == (32, 256):  # two node tiles of one feature
        assert (plan.node_tile, plan.feat_group, plan.smem_bytes) == (16, 1, 65536)
    if (n_nodes, max_bins) == (1, 256):
        assert (plan.node_tile, plan.feat_group, plan.smem_bytes) == (1, 14, 57136)


@pytest.mark.parametrize("n_nodes", [1, 8, 32, 64])
def test_private_histogram_launch_plan(n_nodes):
    """The privatised kernel's own plan at the main path's widths (28
    features, 256 bins, 8-bit symbols) fits an H100's shared memory, holds
    its target of blocks per SM (one of 1024 threads), and gives a block as
    many of a level's nodes, then features, as its share of an SM holds,
    split evenly: 32 nodes take one node tile. Its stripes keep at least
    FLUSH_ROWS rows a flushed bin, or make one wave. Narrower symbols keep
    two 512-thread blocks an SM."""
    plan = private_plan(250_000, 28, n_nodes, 256, 8, H100)
    per_node = private_bytes(1, 1, 256)
    share = H100.smem_sm // PRIVATE_BLOCKS_PER_SM - H100.smem_reserved
    assert plan.threads == PRIVATE_THREADS
    assert plan.smem_bytes == private_bytes(plan.feat_group, plan.node_tile, 256)
    assert plan.smem_bytes <= min(share, H100.smem_block)
    assert plan.blocks_per_sm * (plan.smem_bytes + H100.smem_reserved) <= H100.smem_sm
    assert plan.blocks_per_sm >= PRIVATE_BLOCKS_PER_SM
    assert plan.node_tile == -(-n_nodes // -(-n_nodes // (share // per_node)))
    if plan.feat_group < 28:  # one feature more would not fit the share
        assert private_bytes(plan.feat_group + 1, plan.node_tile, 256) > share
    groups = -(-28 // plan.feat_group)
    assert -(-28 // groups) == plan.feat_group  # split evenly
    if groups > 1:  # one group fewer would not fit the share
        assert private_bytes(-(-28 // (groups - 1)), plan.node_tile, 256) > share
    assert 1 <= plan.node_tile <= n_nodes and 1 <= plan.feat_group <= 28
    assert plan.words_per_block * -(-250_000 // plan.words_per_block) >= 250_000
    stripes = -(-250_000 // plan.words_per_block)
    a_stripe = groups * -(-n_nodes // plan.node_tile)
    assert (plan.words_per_block * 4 >= FLUSH_ROWS * plan.feat_group * plan.node_tile * 255
            or stripes <= -(-H100.n_sm * PRIVATE_BLOCKS_PER_SM // a_stripe))
    if n_nodes == 32:
        assert (plan.node_tile, plan.feat_group) == (32, 1)
    assert private_plan(250_000, 28, n_nodes, 64, 6, H100) == launch_plan(
        250_000, 28, n_nodes, 64, H100, PRIVATE_NARROW_BLOCKS_PER_SM)


def test_traversal_trees_per_block():
    """Stages of a multiple of four packed arenas (1 KB at depth 6, 4 KB at
    depth 8) beside the 28-feature row tile, within the target; few trees
    read the rows from global memory, and so do rows too wide for a tile."""
    row_tile = THREADS * 28 * 4
    fit = (SMEM_TARGET - BARRIER_BYTES - row_tile) // (2 * 128 * NODE_BYTES)
    assert fit == 13
    assert traversal_plan(10, 128, 1, 28, H100_SMEM) == (1, 10, 0)
    assert traversal_plan(1000, 128, 1, 28, H100_SMEM) == (1, 12, 1)
    assert traversal_plan(30, 128, 3, 28, H100_SMEM) == (3, 12, 1)
    assert traversal_plan(700, 128, 7, 28, H100_SMEM) == (7, 12, 1)  # sums in registers
    # Depth 8: three arenas a stage fit the target, four (a whole walk) are taken.
    assert traversal_plan(500, 512, 1, 28, H100_SMEM) == (1, WALK_TREES, 1)
    assert traversal_plan(ROW_TILE_TREES - 1, 128, 1, 28, H100_SMEM)[2] == 0
    assert traversal_plan(ROW_TILE_TREES, 128, 1, 28, H100_SMEM)[2] == 1
    # Rows too wide for a tile beside two arenas: read from global memory.
    assert traversal_plan(1000, 128, 1, 1000, H100_SMEM) == (1, 24, 0)


@pytest.mark.parametrize("depth,n_classes", [
    (14, 1), (13, 4), (6, 300), (6, 226), (13, 1), (20, 3), (6, 1), (4, 1000),
])
@pytest.mark.parametrize("rounds", [2, 40])
def test_traversal_plan_serves_every_model(depth, n_classes, rounds):
    """Models the staged route cannot hold (an arena of depth 13 or more,
    226 or more classes): the plan tiles the classes and reads arenas
    through L2, within a block's shared memory, and never raises."""
    arena = 2 ** (depth + 1)  # packed, padded to even
    n_trees = rounds * n_classes

    def sums(tile):
        return 0 if tile <= KREG else tile * THREADS * 4

    tile, trees_blk, row_tile = traversal_plan(n_trees, arena, n_classes, 28, H100_SMEM)
    assert 1 <= tile <= n_classes
    assert BARRIER_BYTES + sums(tile) + 2 * trees_blk * arena * NODE_BYTES \
        + row_tile * THREADS * 28 * 4 <= H100_SMEM
    assert 0 <= trees_blk <= rounds * tile
    if trees_blk == 0:  # arenas read through L2 only where two would not fit
        assert BARRIER_BYTES + sums(tile) + 2 * arena * NODE_BYTES > H100_SMEM
    if row_tile:
        assert rounds * tile >= ROW_TILE_TREES
    if BARRIER_BYTES + sums(n_classes) + 2 * arena * NODE_BYTES <= H100_SMEM:
        assert tile == n_classes  # all classes in one block while they fit
    if (depth, n_classes) in ((14, 1), (13, 4)):
        assert (tile, trees_blk, row_tile) == (n_classes, 0, int(rounds * n_classes >= 16))
    if (depth, n_classes) == (6, 300):
        assert trees_blk >= WALK_TREES and row_tile == 1
        assert tile * THREADS * 4 <= SMEM_TARGET // 2
