"""Each CUDA kernel against its plain PyTorch version on the card, and the
CUDA path end to end at a small size. Every test is marked `cuda`, decides
inside itself whether there is a card and skips without one. This file
imports no JAX, so it runs where the card is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: split scan, cut selection, traversal and decompress do the
same operations in the same order as their plain versions, so they must
agree bit for bit; the histogram kernels add with atomics in no fixed order
(rtol 1e-5, atol 2e-5 on real-valued (g, h), exact on dyadic (g, h), whose
partial sums are exact in any order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compress as TC
from repro_torch.core import quantile as TQ
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decompress import decompress
from repro_torch.kernels.ensemble_traversal import ensemble_margins_kernel
from repro_torch.kernels.histogram import (
    build_histograms_packed_kernel,
    build_histograms_rows_kernel,
    histogram_packed,
)
from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
from repro_torch.kernels.split_scan import split_scan


@pytest.fixture
def rng():
    """A fresh generator per test: the session-wide `rng` of conftest.py is
    left untouched, so the reference's tests draw what they drew before."""
    return np.random.default_rng(1234)


def _hist_inputs(rng, n, f, max_bins, n_nodes):
    bits = TC.bits_needed(max_bins - 1)
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    gh = np.stack([rng.normal(size=n), rng.random(n)], axis=1).astype(np.float32)
    pos = rng.integers(0, n_nodes + 1, size=n).astype(np.int32)  # n_nodes = inactive
    return TC.pack(torch.from_numpy(bins), bits), gh, pos, bits


def _split_inputs(rng, n_nodes, f, b):
    hist = np.stack([rng.normal(size=(n_nodes, f, b)), rng.random((n_nodes, f, b)) * 2],
                    axis=-1).astype(np.float32)
    hist[..., 5:9, :] = 0.0  # empty bins: thresholds that tie exactly
    return hist, hist[:, 0].sum(axis=1)


def _random_ensemble(rng, n_trees, depth, n_features):
    a = 2 ** (depth + 1) - 1
    is_leaf = rng.random((n_trees, a)) < 0.2
    is_leaf[:, 2**depth - 1:] = True  # the last level is all leaves
    threshold = rng.normal(size=(n_trees, a)).astype(np.float32)
    threshold[is_leaf] = np.inf
    return (rng.integers(0, n_features, (n_trees, a)).astype(np.int32), threshold,
            rng.random((n_trees, a)) < 0.5,
            rng.normal(size=(n_trees, a)).astype(np.float32), is_leaf)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_histogram_kernel_on_card(rng):
    dev = _cuda()
    for n, f, max_bins, n_nodes in [(1001, 5, 256, 1), (4096, 28, 256, 32),
                                    (777, 3, 16, 3), (300, 2, 1024, 130)]:
        packed, gh, pos, bits = _hist_inputs(rng, n, f, max_bins, n_nodes)
        args = (packed.to(dev), torch.from_numpy(gh).to(dev),
                torch.from_numpy(pos).to(dev), n_nodes, max_bins, bits)
        got = build_histograms_packed_kernel(*args)
        want = ref.histogram_ref(*args)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=2e-5)


@pytest.mark.cuda
def test_histogram_packed_kernel_on_card(rng):
    dev = _cuda()
    for n, f, max_bins, n_nodes in [(1001, 5, 256, 1), (4096, 28, 256, 32),
                                    (777, 3, 16, 3), (300, 2, 1024, 12)]:
        packed, _, pos, bits = _hist_inputs(rng, n, f, max_bins, n_nodes)
        pos[rng.random(n) < 0.1] = -1  # inactive as the reference pads: -1
        gh = np.stack([rng.integers(-8, 9, n) / 4, rng.integers(0, 5, n) / 4],
                      axis=1).astype(np.float32)  # dyadic: exact in any order
        args = (packed.to(dev), torch.from_numpy(gh).to(dev),
                torch.from_numpy(pos).to(dev), n_nodes, max_bins, bits)
        got = histogram_packed(*args)
        want = ref.histogram_packed_ref(*args)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_histogram_rows_kernel_on_card(rng):
    dev = _cuda()
    for n, f, max_bins, n_nodes in [(1001, 5, 256, 1), (4096, 28, 256, 16),
                                    (777, 3, 16, 3), (300, 2, 1024, 130)]:
        packed, gh, _, bits = _hist_inputs(rng, n, f, max_bins, n_nodes)
        m = n // 2
        k = m - m // 5
        rid = np.sort(rng.choice(n, size=k, replace=False))
        rid = np.concatenate([rid, np.full(m - k, n)]).astype(np.int32)
        rid[-1] = 10 * n  # far past the words: must not be read
        pos = rng.integers(0, n_nodes + 1, size=m).astype(np.int32)
        pos[k:] = n_nodes  # padding slots sit at the dump position
        gh_sel = gh[np.minimum(rid, n - 1)]
        args = (packed.to(dev), torch.from_numpy(gh_sel).to(dev),
                torch.from_numpy(pos).to(dev), torch.from_numpy(rid).to(dev),
                n_nodes, max_bins, bits)
        got = build_histograms_rows_kernel(*args)
        want = ref.histogram_rows_ref(*args)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=2e-5)


@pytest.mark.cuda
def test_histograms_by_subtraction_on_card(rng):
    """The subtraction trick's device path (lane-spread counts, scatter
    compaction, sibling = parent - child) against a full build of the same
    level, exact on dyadic (g, h)."""
    from repro_torch.core import tree as TT

    dev = _cuda()
    for n, f, max_bins, n_nodes in [(1001, 5, 256, 2), (4096, 28, 256, 32),
                                    (777, 3, 16, 8)]:
        packed, _, local, bits = _hist_inputs(rng, n, f, max_bins, n_nodes)
        gh = np.stack([rng.integers(-8, 9, n) / 4, rng.integers(0, 5, n) / 4],
                      axis=1).astype(np.float32)
        gh_d, local_d = torch.from_numpy(gh).to(dev), torch.from_numpy(local).to(dev)
        parent = torch.where(local_d < n_nodes, local_d // 2, n_nodes // 2)
        packed = packed.to(dev)
        hist_prev = build_histograms_packed_kernel(packed, gh_d, parent.to(torch.int32),
                                                   n_nodes // 2, max_bins, bits)
        got = TT._histograms_by_subtraction(TC.PackedBins(packed, bits, n), gh_d,
                                            local_d, hist_prev, n_nodes, max_bins)
        want = build_histograms_packed_kernel(packed, gh_d, local_d, n_nodes, max_bins, bits)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [0.0, 0.9])
def test_histograms_past_the_plan_cap_on_card(rng, skew):
    """The three histogram kernels at 64 nodes, whose one-feature histogram
    (128 KB at 256 bins) exceeds the plan's cap of a third of an SM's shared
    memory, so the nodes take two tiles; with `skew`, that share of the
    symbols sits in the missing bin, where warp aggregation sums many lanes
    into one add. Exact on dyadic (g, h)."""
    dev = _cuda()
    n, f, max_bins, n_nodes = 20_000, 5, 256, 64
    bits = TC.bits_needed(max_bins - 1)
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    bins[rng.random((n, f)) < skew] = max_bins - 1
    packed = TC.pack(torch.from_numpy(bins), bits).to(dev)
    gh = torch.from_numpy(np.stack([rng.integers(-8, 9, n) / 4, rng.integers(0, 5, n) / 4],
                                   axis=1).astype(np.float32)).to(dev)
    pos = rng.integers(0, n_nodes + 1, size=n).astype(np.int32)
    pos[rng.random(n) < 0.1] = -1
    pos = torch.from_numpy(pos).to(dev)
    args = (packed, gh, pos, n_nodes, max_bins, bits)
    want = ref.histogram_ref(*args).cpu().numpy()
    for kernel in (build_histograms_packed_kernel, histogram_packed):
        np.testing.assert_array_equal(kernel(*args).cpu().numpy(), want)
    m = n // 2
    rid = np.sort(rng.choice(n, size=m, replace=False)).astype(np.int32)
    rid[-10:] = n  # padding ids at the dump position
    pos_sel = rng.integers(0, n_nodes + 1, size=m).astype(np.int32)
    pos_sel[-10:] = n_nodes
    rargs = (packed, gh[torch.from_numpy(np.minimum(rid, n - 1)).to(dev)].contiguous(),
             torch.from_numpy(pos_sel).to(dev), torch.from_numpy(rid).to(dev),
             n_nodes, max_bins, bits)
    np.testing.assert_array_equal(build_histograms_rows_kernel(*rargs).cpu().numpy(),
                                  ref.histogram_rows_ref(*rargs).cpu().numpy())


@pytest.mark.cuda
def test_decompress_kernel_on_card(rng):
    dev = _cuda()
    for n, f, bits in [(1001, 5, 4), (777, 28, 8), (4096, 3, 8), (333, 2, 5), (65, 1, 32)]:
        bins = torch.from_numpy(rng.integers(0, 2**min(bits, 31), size=(n, f)).astype(np.int32))
        packed = TC.pack(bins, bits).to(dev)
        got = decompress(packed, bits, n)
        np.testing.assert_array_equal(got.cpu().numpy(), ref.decompress_ref(packed, bits, n)
                                      .cpu().numpy())
        np.testing.assert_array_equal(got.cpu().numpy(), bins.numpy())


@pytest.mark.cuda
def test_split_scan_kernel_on_card(rng):
    dev = _cuda()
    for shape in [(1, 3, 8), (32, 28, 256), (3, 5, 1024), (2, 4, 33)]:
        hist, parent = _split_inputs(rng, *shape)
        hist_t, parent_t = torch.from_numpy(hist).to(dev), torch.from_numpy(parent).to(dev)
        got = split_scan(hist_t, parent_t, 1.0, 1.0).cpu().numpy()
        want = ref.split_scan_ref(hist_t, parent_t, 1.0, 1.0).cpu().numpy()
        np.testing.assert_array_equal(got, want)  # same operations, same order


@pytest.mark.cuda
def test_cut_selection_kernel_on_card(rng):
    dev = _cuda()
    for n, f, max_bins in [(1000, 7, 16), (5000, 28, 256), (3, 2, 256)]:
        x = rng.normal(size=(n, f)).astype(np.float32)
        x[rng.random((n, f)) < 0.1] = np.nan
        x[:, 0] = np.round(x[:, 0])
        srt = np.sort(np.where(np.isnan(x), np.inf, x), axis=0)
        srt_t = torch.from_numpy(srt).to(dev)
        nv = torch.from_numpy(np.isfinite(srt).sum(axis=0).astype(np.int32)).to(dev)
        got = quantile_cuts_from_sorted(srt_t, nv, max_bins).cpu().numpy()
        want = ref.quantile_cuts_ref(srt_t, nv, max_bins).cpu().numpy()
        np.testing.assert_array_equal(got, want)  # same operations, same order


@pytest.mark.cuda
def test_traversal_kernel_on_card(rng):
    dev = _cuda()
    for n, f, n_trees, depth, k in [(1000, 5, 6, 3, 1), (333, 4, 30, 6, 3),
                                    (70, 28, 500, 6, 1)]:
        arena = [torch.from_numpy(a).to(dev) for a in _random_ensemble(rng, n_trees, depth, f)]
        x = rng.normal(size=(n, f)).astype(np.float32)
        x[rng.random((n, f)) < 0.2] = np.nan
        xt = torch.from_numpy(x).to(dev)
        got = ensemble_margins_kernel(*arena, xt, k, depth).cpu().numpy()
        want = ref.ensemble_margins_ref(*arena, xt, k, depth).cpu().numpy()
        np.testing.assert_array_equal(got, want)  # each class summed in tree order


@pytest.mark.cuda
def test_traversal_kernel_any_depth_on_card(rng):
    """Models past the staged route: a depth-14 arena (459 KB) and depth 13
    beside 4 classes read the arenas through L2; 300 classes tile over the
    grid. Bit-identical to the plain version, as the staged route is."""
    dev = _cuda()
    for n, f, n_trees, depth, k in [(2000, 6, 4, 14, 1), (1000, 6, 8, 13, 4),
                                    (500, 6, 600, 6, 300)]:
        arena = [torch.from_numpy(a).to(dev) for a in _random_ensemble(rng, n_trees, depth, f)]
        x = rng.normal(size=(n, f)).astype(np.float32)
        x[rng.random((n, f)) < 0.2] = np.nan
        xt = torch.from_numpy(x).to(dev)
        got = ensemble_margins_kernel(*arena, xt, k, depth).cpu().numpy()
        want = ref.ensemble_margins_ref(*arena, xt, k, depth).cpu().numpy()
        assert got.shape == (n, k)
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_compute_cuts_and_fit_on_card(rng):
    """The CUDA path end to end at a small size: same cuts as the CPU path,
    a default fit (subtraction) that launches the privatised histogram at
    the root and the row-id histogram below it, and raw-row margins that
    agree with its bin-space margins."""
    from repro_torch.core import Booster, DeviceDMatrix

    _cuda()
    x = rng.normal(size=(3000, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.nan_to_num(x[:, 1]) > 0).astype(np.float32)
    ops.reset_launches()
    d = DeviceDMatrix(x, label=y, max_bins=64)
    np.testing.assert_array_equal(d.cuts.cpu().numpy(),
                                  TQ.compute_cuts(torch.from_numpy(x), 64).numpy())
    np.testing.assert_array_equal(d.matrix.packed.cpu().numpy(),
                                  TC.pack(TQ.quantize(torch.from_numpy(x), d.cuts.cpu()),
                                          d.bits).numpy())
    bst = Booster(n_rounds=3, max_depth=4, max_bins=64, objective="binary:logistic").fit(d)
    raw = bst.predict_margins(x)
    assert ops.launches() == {
        "histogram_private": 3, "histogram_rows": 9, "histogram_packed": 0,
        "split_scan": 12, "quantile_cuts": 1, "ensemble_traversal": 1, "decompress": 0}
    binned = bst.predict_margins(DeviceDMatrix(x, ref=d))
    np.testing.assert_allclose(raw.cpu().numpy(), binned.cpu().numpy(), atol=1e-5)
