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
    NODE_BYTES,
    THREADS,
    ensemble_margins_kernel,
    traversal_plan,
)
from repro_torch.kernels.histogram import (
    build_histograms_packed_kernel,
    build_histograms_rows_kernel,
    histogram_packed,
    launch_plan,
)
from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
from repro_torch.kernels.split_scan import split_scan

from _torch_parity import assert_cuts_close


@pytest.fixture
def rng():
    """A fresh generator per test: the session-wide `rng` of conftest.py is
    left untouched, so the reference's tests draw what they drew before."""
    return np.random.default_rng(1234)

H100_SMEM = 232448  # opt-in shared memory per block on an H100
# An H100 SXM: SMs, opt-in shared memory per block, per SM, reserved per
# block, threads per SM.
H100 = DeviceLimits(132, H100_SMEM, 233_472, 1_024, 2_048)


def _hist_inputs(rng, n, f, max_bins, n_nodes):
    bits = JC.bits_needed(max_bins - 1)
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    gh = np.stack([rng.normal(size=n), rng.random(n)], axis=1).astype(np.float32)
    pos = rng.integers(0, n_nodes + 1, size=n).astype(np.int32)  # n_nodes = inactive
    packed = np.asarray(JC.pack(jnp.asarray(bins), bits))
    return packed, gh, pos, bits


def _words(packed: np.ndarray) -> np.ndarray:
    """The reference's uint32 words as the port's int32 bit patterns."""
    return packed.copy().view(np.int32)


@pytest.mark.parametrize("n,f,max_bins,n_nodes", [
    (257, 4, 16, 1),    # ragged last word
    (1000, 7, 64, 3),
    (513, 3, 256, 8),
    (64, 1, 8, 2),
    (301, 5, 32, 8),
])
def test_histogram_plain_vs_reference(rng, n, f, max_bins, n_nodes):
    packed, gh, pos, bits = _hist_inputs(rng, n, f, max_bins, n_nodes)
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


@pytest.mark.parametrize("bits,n,f", [(4, 1001, 5), (8, 777, 11), (8, 2048, 3), (5, 333, 2)])
def test_decompress_plain_vs_reference(rng, bits, n, f):
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


@pytest.mark.parametrize("n,f,max_bins", [(1000, 7, 16), (513, 3, 256), (64, 1, 256),
                                          (333, 11, 64)])
def test_cut_selection_plain_vs_reference(rng, n, f, max_bins):
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.1] = np.nan
    srt = np.sort(np.where(np.isnan(x), np.inf, x), axis=0)
    n_valid = np.isfinite(srt).sum(axis=0).astype(np.int32)
    want = np.asarray(j_cuts_from_sorted(jnp.asarray(srt), jnp.asarray(n_valid), max_bins))
    cand = ref.quantile_cuts_ref(torch.from_numpy(srt), torch.from_numpy(n_valid), max_bins)
    got = torch.sort(cand, dim=-1).values.numpy()  # ascending, as compute_cuts_op
    assert got.shape == (f, max_bins - 2)
    assert_cuts_close(got, want, x)


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
        ensemble_margins_kernel(torch.zeros(1, 3, dtype=torch.int32), torch.zeros(1, 3),
                                torch.zeros(1, 3, dtype=torch.bool), torch.zeros(1, 3),
                                torch.ones(1, 3, dtype=torch.bool), cpu, 1, 1)


@pytest.mark.parametrize("n_nodes,max_bins", [(1, 256), (8, 256), (32, 256), (200, 256),
                                              (5, 16), (64, 1024)])
def test_histogram_launch_plan_fits_shared_memory(n_nodes, max_bins):
    """The plan caps a block's private histogram so that three blocks fit on
    an SM, and covers every node, feature and word."""
    plan = launch_plan(250_000, 28, n_nodes, max_bins, H100)
    cap = H100.smem_sm // 3 - H100.smem_reserved
    assert plan.smem_bytes == plan.feat_group * plan.node_tile * max_bins * 8  # (g, h) f32
    assert plan.smem_bytes <= cap and plan.blocks_per_sm >= 3
    assert plan.blocks_per_sm * (plan.smem_bytes + H100.smem_reserved) <= H100.smem_sm
    assert 1 <= plan.node_tile <= n_nodes and 1 <= plan.feat_group <= 28
    if n_nodes * max_bins * 8 <= cap:  # one feature at every node fits
        assert plan.node_tile == n_nodes
    assert plan.words_per_block * -(-250_000 // plan.words_per_block) >= 250_000
    if (n_nodes, max_bins) == (32, 256):
        assert (plan.node_tile, plan.feat_group, plan.smem_bytes) == (32, 1, 65536)
    if (n_nodes, max_bins) == (1, 256):
        assert (plan.node_tile, plan.feat_group, plan.smem_bytes) == (1, 28, 57344)


def test_traversal_trees_per_block():
    """Small models stage all classes and as many arenas as fit the target."""
    assert traversal_plan(10, 127, 1, H100_SMEM) == (1, 10)
    assert traversal_plan(1000, 127, 1, H100_SMEM) == (1, (48 * 1024 - 1024) // (127 * 14))
    assert traversal_plan(30, 127, 3, H100_SMEM) == (3, (48 * 1024 - 3 * 1024) // (127 * 14))


@pytest.mark.parametrize("depth,n_classes", [
    (14, 1), (13, 4), (6, 300), (6, 226), (13, 1), (20, 3), (6, 1), (4, 1000),
])
def test_traversal_plan_serves_every_model(depth, n_classes):
    """Models the staged route could not hold (an arena of depth 14, depth 13
    beside 4 classes, 226 or more classes): the plan tiles the classes and
    reads arenas from global memory, within a block's shared memory, and
    never raises."""
    arena = 2 ** (depth + 1) - 1
    n_trees = 2 * n_classes
    tile, trees_blk = traversal_plan(n_trees, arena, n_classes, H100_SMEM)
    assert 1 <= tile <= n_classes
    acc = tile * THREADS * 4
    assert acc + trees_blk * arena * NODE_BYTES <= H100_SMEM
    assert 0 <= trees_blk <= n_trees // n_classes * tile
    if trees_blk == 0:  # arenas read through L2 only where one would not fit
        assert acc + arena * NODE_BYTES > H100_SMEM
    if n_classes * THREADS * 4 + arena * NODE_BYTES <= H100_SMEM:
        assert tile == n_classes  # all classes in one block while they fit
    if (depth, n_classes) in ((14, 1), (13, 4)):
        assert (tile, trees_blk) == (n_classes, 0)
    if (depth, n_classes) == (6, 300):
        assert trees_blk > 0 and tile * THREADS * 4 <= 48 * 1024
