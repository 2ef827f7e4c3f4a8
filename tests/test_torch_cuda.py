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
from repro_torch.kernels import fixed as FX
from repro_torch.kernels import ops, pairwise, ref
from repro_torch.kernels.decompress import decompress
from repro_torch.kernels.ensemble_traversal import ensemble_margins_kernel, pack_nodes
from repro_torch.kernels.histogram import (
    build_histograms_packed_kernel,
    build_histograms_rows_kernel,
    histogram_packed,
)
from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
from repro_torch.kernels.split_scan import split_scan

from _torch_parity import EXPONENT_EDGES, constrained_split_inputs, tied_split_histogram


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


def _random_ensemble(rng, n_trees, depth, n_features, leaf_share=0.2):
    a = 2 ** (depth + 1) - 1
    is_leaf = rng.random((n_trees, a)) < leaf_share
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
@pytest.mark.parametrize("skew,constant", [(0.0, False), (0.9, False), (1.0, False),
                                           (0.0, True)],
                         ids=["0.0", "0.9", "1.0", "constant"])
def test_histograms_past_the_plan_cap_on_card(rng, skew, constant):
    """The three histogram kernels at 64 nodes, whose one-feature histogram
    (128 KB at 256 bins) exceeds the plans' caps (a half or a third of an
    SM's shared memory), so the nodes take two tiles; with `skew`, that
    share of the symbols sits in the missing bin (all of them at 1.0), and
    with `constant` feature 0 sits in one value bin: many lanes add to one
    (node, bin), which the three kernels sum by warp before they add. Exact
    on dyadic (g, h)."""
    dev = _cuda()
    n, f, max_bins, n_nodes = 20_000, 5, 256, 64
    bits = TC.bits_needed(max_bins - 1)
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    bins[rng.random((n, f)) < skew] = max_bins - 1
    if constant:
        bins[:, 0] = 7
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
@pytest.mark.parametrize("n,f,bits,n_packed", [
    (1001, 5, 4, 1001), (777, 28, 8, 777), (4096, 3, 8, 4096), (333, 2, 5, 333),
    (65, 1, 32, 65),
    # rows not a multiple of a tile (32 * spw rows), F across the feature
    # tiles (33: the second 32 features' shifted shared rows; 65 and 130:
    # tiles of 64 features and a ragged last one), F % 4 != 0 (element by
    # element), bits 1, 3, 9, 17 and 32
    (3001, 1, 1, 3001), (2000, 33, 3, 2000), (1500, 65, 9, 1500), (999, 130, 17, 999),
    (517, 64, 32, 517), (1000, 968, 8, 1000),
    # fewer rows than the words hold: the words past them are never read
    (870, 7, 8, 1000),
    # more tiles than the persistent grid has blocks (132 SMs x 8 blocks)
    (40_001, 3, 32, 40_001), (200_003, 28, 8, 200_003),
])
def test_decompress_kernel_on_card(rng, n, f, bits, n_packed):
    """Bit for bit against the plain version and against the bins packed;
    at 32 bits the symbols span every uint32 (int32 bit patterns)."""
    dev = _cuda()
    bins = torch.from_numpy(rng.integers(0, 2**bits, size=(n_packed, f), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    packed = TC.pack(bins, bits).to(dev)
    got = decompress(packed, bits, n)
    assert got.shape == (n, f) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.decompress_ref(packed, bits, n).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), bins[:n].numpy())


@pytest.mark.cuda
def test_compressed_matrix_unpack_launches_decompress(rng):
    """`CompressedMatrix.unpack()` on the card is one decompress launch, and
    gives the bins that quantising with the matrix's cuts gives."""
    from repro_torch.core import DeviceDMatrix

    _cuda()
    x = rng.normal(size=(3001, 7)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    d = DeviceDMatrix(x, max_bins=64)
    ops.reset_launches()
    got = d.matrix.unpack()
    assert ops.launches()["decompress"] == 1
    want = TQ.quantize(torch.from_numpy(x), d.cuts.cpu())
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_split_scan_kernel_on_card(rng):
    """Random histograms from 3 to 1025 bins, then thresholds tied over
    empty runs that cross lanes' candidates (lane c % 32 scores threshold c;
    ties from bin 7, 31, 32 and 100 on, the run from 31 wrapping from lane
    31 to lane 0), with missing values absent and going left."""
    dev = _cuda()
    inputs = [_split_inputs(rng, *shape) for shape in [
        (1, 3, 8), (32, 28, 256), (3, 5, 1024), (2, 4, 33), (4, 3, 3), (2, 5, 257),
        (2, 3, 1025)]]
    inputs += [tied_split_histogram((8, 32, 33, 101), 28, 256, missing_g=m)
               for m in (0.0, -1.0)]
    for hist, parent in inputs:
        hist_t, parent_t = torch.from_numpy(hist).to(dev), torch.from_numpy(parent).to(dev)
        got = split_scan(hist_t, parent_t, 1.0, 1.0).cpu().numpy()
        want = ref.split_scan_ref(hist_t, parent_t, 1.0, 1.0).cpu().numpy()
        np.testing.assert_array_equal(got, want)  # same operations, same order


@pytest.mark.cuda
def test_split_scan_masked_and_monotone_on_card(rng):
    """The extended scan bit for bit against its plain version: monotone
    constraints of every sign with bounds that clip and bounds at ±inf,
    an (F,) and an (n, F) feature mask (node 0 wholly masked), both
    together, and tied thresholds across lane boundaries under
    constraints and masks."""
    dev = _cuda()
    cases = []
    for shape in [(1, 3, 8), (8, 28, 256), (32, 28, 256), (5, 7, 1025), (3, 4, 3)]:
        hist, parent, mono, bounds, mask = constrained_split_inputs(rng, *shape)
        cases.append((hist, parent, mono, bounds, mask))
    hist, parent = tied_split_histogram((8, 32, 33, 101), 28, 256, missing_g=-1.0)
    _, _, mono, bounds, mask = constrained_split_inputs(rng, 4, 28, 256)
    cases.append((hist, parent, mono, bounds, mask))
    for hist, parent, mono, bounds, mask in cases:
        t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
            hist=hist, parent=parent, mono=mono, bounds=bounds, mask=mask).items()}
        for kw in (dict(monotone=t["mono"], node_bounds=t["bounds"]),
                   dict(feature_mask=t["mask"][-1]), dict(feature_mask=t["mask"]),
                   dict(feature_mask=t["mask"], monotone=t["mono"], node_bounds=t["bounds"])):
            got = split_scan(t["hist"], t["parent"], 1.0, 1.0, **kw).cpu().numpy()
            want = ref.split_scan_ref(t["hist"], t["parent"], 1.0, 1.0, **kw).cpu().numpy()
            np.testing.assert_array_equal(got, want)
            if "feature_mask" in kw:
                off = ~np.broadcast_to(kw["feature_mask"].cpu().numpy(), got.shape[:2])
                assert np.all(got[off] == np.array([-np.inf, 0, 0, 0, 0], np.float32))


@pytest.mark.cuda
def test_sampling_draws_on_card(monkeypatch):
    """The card's draws are a function of their path: the same path twice
    gives the same selections bit for bit, another seed others. Selections
    made on the card from uniforms drawn on the CPU (copied over) equal the
    CPU's own."""
    from repro_torch.core import sampling as SMP

    dev = _cuda()
    g_abs = torch.rand(50_000, device=dev).round(decimals=2)  # tied |g|

    def selections(seed, device, ga):
        ctx = SMP.TreeContext((seed, 3, 0), None, None,
                              SMP.StochasticParams(colsample_bylevel=0.5,
                                                   colsample_bynode=0.5), device)
        return (SMP.row_selection_mask((seed, 3, 0), 50_000, 25_000, device),
                *SMP.goss_selection((seed, 3, 0), ga, 10_000, 5_000),
                SMP.level_feature_mask(ctx, 2, 4, 28))

    first, again, other = (selections(s, dev, g_abs) for s in (7, 7, 8))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not any(torch.equal(a, b) for a, b in zip(first, other))
    cpu_draw = SMP.uniform
    monkeypatch.setattr(SMP, "uniform",
                        lambda path, shape, device: cpu_draw(path, shape, "cpu").to(device))
    on_card = selections(7, dev, g_abs)
    on_cpu = selections(7, "cpu", g_abs.cpu())
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    ids = SMP.compact_row_ids(on_card[0], 25_000)
    assert torch.equal(ids.cpu(), SMP.compact_row_ids(on_cpu[0], 25_000))


@pytest.mark.cuda
@pytest.mark.parametrize("knobs,want", [
    (dict(subsample=0.5), (0, 12, 12)),
    (dict(sampling_method="goss"), (0, 12, 12)),
    (dict(colsample_bynode=0.5), (3, 9, 12)),
    (dict(monotone_constraints=(1, -1, 0, 0, 0, 0)), (3, 9, 12)),
    (dict(subsample=0.5, use_kernel_histograms=True), (12, 0, 12)),
])
def test_stochastic_fit_launches_on_card(rng, knobs, want):
    """A subsampled or GOSS fit grows over the compacted buffer: the row-id
    kernel at every level, the root included, and no privatised build;
    column sampling and monotone constraints keep the default growth's
    launches; the kernel path's subsample (masked mode) builds every level
    with #1. Each fits the task."""
    from repro_torch.core import Booster, DeviceDMatrix

    _cuda()
    x = rng.normal(size=(3000, 6)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] > 0).astype(np.float32)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    ops.reset_launches()
    bst = Booster(n_rounds=3, max_depth=4, max_bins=64, objective="binary:logistic",
                  **knobs).fit(d)
    got = ops.launches()
    assert (got["histogram_private"], got["histogram_rows"], got["split_scan"]) == want
    assert float(((bst.predict(x) > 0.5).cpu().numpy() == y).mean()) > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("subsample", [1.0, 0.5])
def test_monotone_sweep_on_card(rng, subsample):
    """A model fitted on the card with monotone_constraints=(+1, -1, 0):
    predictions along 64 ascending values of feature 0 never decrease, of
    feature 1 never increase, exactly, at every row's other values."""
    from repro_torch.core import Booster, DeviceDMatrix

    _cuda()
    x = rng.uniform(-2, 2, size=(4000, 3)).astype(np.float32)
    y = (1.5 * x[:, 0] - np.sin(2 * x[:, 1]) + 0.3 * rng.normal(size=4000)).astype(np.float32)
    bst = Booster(n_rounds=10, max_depth=4, max_bins=64, subsample=subsample,
                  monotone_constraints=(1, -1, 0)).fit(DeviceDMatrix(x, label=y, max_bins=64))
    grid = np.linspace(-2.2, 2.2, 64, dtype=np.float32)
    for feat, sign in ((0, 1), (1, -1)):
        rows = np.repeat(x[:200], 64, axis=0)
        rows[:, feat] = np.tile(grid, 200)
        pred = bst.predict(rows).cpu().numpy().reshape(200, 64)
        assert np.all(np.diff(pred, axis=1) * sign >= 0)


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


def _check_traversal(rng, dev, shapes, leaf_share=0.2):
    """The kernel on packed nodes against the plain walk over the arena
    fields, bit for bit (each class summed in tree order)."""
    for n, f, n_trees, depth, k in shapes:
        arena = [torch.from_numpy(a).to(dev)
                 for a in _random_ensemble(rng, n_trees, depth, f, leaf_share)]
        x = rng.normal(size=(n, f)).astype(np.float32)
        x[rng.random((n, f)) < 0.2] = np.nan
        xt = torch.from_numpy(x).to(dev)
        got = ensemble_margins_kernel(pack_nodes(*arena), xt, k, depth).cpu().numpy()
        want = ref.ensemble_margins_ref(*arena, xt, k, depth).cpu().numpy()
        assert got.shape == (n, k)
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cut_selection_kernel_sorts_on_card(rng):
    """The kernel's in-order compaction of the deduplicated candidates is bit
    for bit `torch.sort` of the plain candidates (+inf markers in place), on
    tied, constant and all-missing columns and one with one valid value."""
    dev = _cuda()
    for n, max_bins in [(5000, 256), (777, 64), (20, 1024)]:
        x = rng.normal(size=(n, 11)).astype(np.float32)
        x[rng.random(x.shape) < 0.1] = np.nan
        x[:, 1] = np.round(x[:, 1])  # ties
        x[:, 2] = np.round(x[:, 2] * 20) / 4  # ties, more values
        x[:, 3] = 0.5  # constant
        x[:, 4] = np.nan  # all missing
        x[:, 5] = np.nan
        x[n // 3, 5] = -2.0  # one valid value
        srt = torch.from_numpy(np.sort(np.where(np.isnan(x), np.inf, x), axis=0)).to(dev)
        nv = torch.isfinite(srt).sum(dim=0, dtype=torch.int32)
        got = quantile_cuts_from_sorted(srt, nv, max_bins)
        cand = ref.quantile_cuts_ref(srt, nv, max_bins)  # candidates, then torch.sort
        assert torch.equal(got, cand)
        assert torch.equal(got, torch.sort(got, dim=-1).values)


@pytest.mark.cuda
def test_traversal_kernel_on_card(rng):
    """Staged arenas with the rows read from global memory (few trees) and
    from the row tile; tree counts that leave a short group of the four
    trees a thread walks at once; 1000 features, whose rows do not fit a
    tile."""
    _check_traversal(rng, _cuda(), [(1000, 5, 6, 3, 1), (333, 4, 30, 6, 3),
                                    (70, 28, 500, 6, 1), (300, 1000, 41, 5, 1)])


@pytest.mark.cuda
def test_traversal_kernel_any_depth_on_card(rng):
    """Models past the staged route: a depth-14 arena (256 KB packed) and
    depth 13 beside 4 classes read the arenas through L2, with the rows
    from global memory or, at 20 trees, from the row tile; 300 classes tile
    over the grid. Bit-identical to the plain version, as the staged route
    is."""
    _check_traversal(rng, _cuda(), [(2000, 6, 4, 14, 1), (1000, 6, 8, 13, 4),
                                    (700, 6, 20, 14, 1), (500, 6, 600, 6, 300)])


@pytest.mark.cuda
def test_traversal_kernel_served_size_on_card(rng):
    """A served model's tree counts: 500 trees at depth 8 (four 4 KB arenas
    a stage, many tree blocks double-buffered), 7 classes x 100 rounds at
    depth 6 (per-class sums in registers), and 500 trees at depth 6 whose
    every walk goes the full depth (leaves only at the last level)."""
    dev = _cuda()
    _check_traversal(rng, dev, [(3000, 28, 500, 8, 1), (2000, 54, 700, 6, 7)])
    _check_traversal(rng, dev, [(3000, 28, 500, 6, 1)], leaf_share=0.0)


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
        "split_scan": 12, "quantile_cuts": 1, "ensemble_traversal": 1, "decompress": 0,
        "pairwise_grad": 0, "fixed_exponent": 12}
    binned = bst.predict_margins(DeviceDMatrix(x, ref=d))
    np.testing.assert_allclose(raw.cpu().numpy(), binned.cpu().numpy(), atol=1e-5)


@pytest.mark.cuda
def test_build_histograms_kernel_on_card(rng):
    """`ops.build_histograms_kernel` (dense bins packed at
    bits_needed(max_bins - 1), then #1) against the dense scatter
    `core.histogram.build_histograms` on the same bins: exact on dyadic
    (g, h), within the atomics' tolerance on real-valued ones."""
    from repro_torch.core.histogram import build_histograms

    dev = _cuda()
    for n, f, max_bins, n_nodes in [(1001, 5, 256, 1), (4096, 28, 256, 32), (777, 3, 16, 4)]:
        bins = torch.from_numpy(rng.integers(0, max_bins, size=(n, f)).astype(np.int32)).to(dev)
        pos = torch.from_numpy(rng.integers(0, n_nodes + 1, size=n).astype(np.int32)).to(dev)
        dyadic = np.stack([rng.integers(-8, 9, n) / 4, rng.integers(0, 9, n) / 8], axis=1)
        real = np.stack([rng.normal(size=n), rng.random(n)], axis=1)
        for gh, tol in ((dyadic, dict(rtol=0, atol=0)), (real, dict(rtol=1e-5, atol=2e-5))):
            gh = torch.from_numpy(gh.astype(np.float32)).to(dev)
            ops.reset_launches()
            got = ops.build_histograms_kernel(bins, gh, pos, n_nodes, max_bins)
            assert ops.launches()["histogram_private"] == 1
            want = build_histograms(bins, gh, pos, n_nodes, max_bins)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


@pytest.mark.parametrize("use_kernel_histograms", [False, True])
@pytest.mark.cuda
def test_dense_fit_on_card(rng, use_kernel_histograms):
    """`compress_matrix=False` on the card: one decompress a fit, before the
    first round; the default growth's histograms are plain-torch scatters
    (no #1, no row-id kernel), the kernel path's #1 at every level; the
    split scan every level. Both fits, dense and packed, fit the task."""
    from repro_torch.core import Booster, DeviceDMatrix

    _cuda()
    x = rng.normal(size=(3000, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.nan_to_num(x[:, 1]) > 0).astype(np.float32)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    kw = dict(n_rounds=3, max_depth=4, max_bins=64, objective="binary:logistic",
              use_kernel_histograms=use_kernel_histograms)
    ops.reset_launches()
    dense = Booster(**kw, compress_matrix=False).fit(d)
    got = ops.launches()
    assert (got["decompress"], got["histogram_private"], got["histogram_rows"],
            got["split_scan"]) == (1, 12 if use_kernel_histograms else 0, 0, 12)
    for bst in (dense, Booster(**kw).fit(d)):
        assert float(((bst.predict(x) > 0.5).cpu().numpy() == y).mean()) > 0.9


@pytest.mark.cuda
def test_iteration_range_on_card(rng):
    """`predict(iteration_range=)` on the card slices the model's packed
    nodes with it and is bit for bit the plain traversal of the sliced
    arenas; `eval` reads the same margins as `predict_margins`."""
    from repro_torch.core import Booster, DeviceDMatrix
    from repro_torch.core.predict import slice_rounds

    dev = _cuda()
    x = rng.normal(size=(2000, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 2]) > 0).astype(np.float32)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    bst = Booster(n_rounds=8, max_depth=4, max_bins=64, objective="binary:logistic").fit(d)
    xd = torch.from_numpy(x).to(dev)
    for lo, hi in ((2, 7), (0, 1), (5, 0)):
        ens = slice_rounds(bst.ensemble, lo, hi)
        plain = ref.ensemble_margins_ref(ens.feature, ens.threshold, ens.default_left,
                                         ens.leaf_value, ens.is_leaf, xd, 1, 4) + ens.base_score
        ops.reset_launches()
        got = bst.predict_margins(x, iteration_range=(lo, hi))
        assert ops.launches()["ensemble_traversal"] == 1
        assert torch.equal(got, plain)
    dv = DeviceDMatrix(x, label=y, ref=d)
    auc = bst.eval(dv, metrics="auc")["eval_auc"]
    assert auc > 0.9


def _binary_data(rng, n=3000, f=6):
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.nan_to_num(x[:, 1]) > 0).astype(np.float32)
    return x, y


@pytest.mark.cuda
def test_early_stopping_fires_on_card(rng):
    """A fit whose held-out logloss turns (learning rate 1.0 and depth 6
    overfit 2,000 rows; on the CPU it stops after 15 rounds, best 9) stops
    on the card: the model keeps best_iteration + 1 rounds with their packed
    nodes, drops its margins, and predicts bit for bit as the plain
    traversal of the truncated model."""
    from repro_torch.core import Booster, DeviceDMatrix

    dev = _cuda()
    x, y = _binary_data(rng)
    d = DeviceDMatrix(x[:2000], label=y[:2000], max_bins=64)
    dv = DeviceDMatrix(x[2000:], label=y[2000:], ref=d)
    bst = Booster(n_rounds=30, learning_rate=1.0, max_depth=6, max_bins=64,
                  objective="binary:logistic").fit(d, evals=[(dv, "valid")],
                                                   eval_metric="logloss",
                                                   early_stopping_rounds=3)
    kept, ens = bst.num_boosted_rounds(), bst.ensemble
    assert kept == bst.best_iteration + 1 < len(bst.history) < 30
    assert ens.n_trees == ens.nodes.shape[0] == kept and bst.margins is None
    xd = torch.from_numpy(x).to(dev)
    plain = ref.ensemble_margins_ref(ens.feature, ens.threshold, ens.default_left,
                                     ens.leaf_value, ens.is_leaf, xd, 1, 6) + ens.base_score
    assert torch.equal(bst.predict_margins(x), plain)
    assert torch.equal(bst.predict(x), torch.sigmoid(plain[:, 0]))


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["reg:quantile", "reg:pseudohubererror",
                                       "count:poisson", "custom"])
def test_objectives_fit_on_card(rng, objective):
    """Each new objective trains through the default growth's kernels and
    beats its constant baseline (the base score) on its metric for held-out
    rows; a registered copy of binary:logistic's gradient runs the same
    launches as the built-in and reaches its accuracy."""
    from repro_torch.core import Booster, DeviceDMatrix
    from repro_torch.core import metrics as M
    from repro_torch.core import objectives as O

    dev = _cuda()
    x, yb = _binary_data(rng, n=4000)
    z = np.nan_to_num(x)
    signal = z[:, 0] - 0.5 * z[:, 1] + 0.3 * z[:, 2] * z[:, 3]
    kw = dict(n_rounds=5, max_depth=4, max_bins=64)
    if objective == "custom":
        name = "test:card_logistic"
        try:
            obj = O.register_objective(name, lambda m, y: (torch.sigmoid(m[:, 0]) - y,
                                                           torch.sigmoid(m[:, 0])
                                                           * (1 - torch.sigmoid(m[:, 0]))),
                                       transform=lambda m: torch.sigmoid(m[:, 0]),
                                       default_metric="accuracy")
            d = DeviceDMatrix(x[:3000], label=yb[:3000], max_bins=64)
            ops.reset_launches()
            custom = Booster(**kw).fit(d, obj=obj)
            got = ops.launches()
            ops.reset_launches()
            builtin = Booster(**kw, objective="binary:logistic").fit(d)
            assert ops.launches() == got
            accs = [float(((b.predict(x[3000:]) > 0.5).cpu().numpy() == yb[3000:]).mean())
                    for b in (custom, builtin)]
            assert abs(accs[0] - accs[1]) <= 0.01 and accs[0] > 0.9
        finally:
            O.OBJECTIVES.pop(name, None)
        return
    y = {"reg:quantile": signal + rng.normal(size=len(z)),
         "reg:pseudohubererror": signal + rng.standard_t(2, size=len(z)),
         "count:poisson": rng.poisson(np.exp(0.5 * signal))}[objective].astype(np.float32)
    d = DeviceDMatrix(x[:3000], label=y[:3000], max_bins=64)
    ops.reset_launches()
    bst = Booster(**kw, objective=objective, quantile_alpha=0.8).fit(d)
    assert ops.launches()["histogram_private"] == 5 and ops.launches()["split_scan"] == 20
    metric = M.get_metric(bst.obj.default_metric)
    held = bst.predict_margins(x[3000:])
    yt = torch.from_numpy(y[3000:]).to(dev)
    extra = O.config_kwargs(bst.cfg)
    assert float(metric.fn(held, yt, **extra)) < float(
        metric.fn(torch.full_like(held, bst.base_score), yt, **extra))


@pytest.mark.cuda
def test_save_load_on_card(rng, tmp_path):
    """A model saved on the card loads onto the card and predicts bit for
    bit; save -> load -> save gives the same bytes; loaded onto the CPU it
    predicts the same margins through the plain traversal."""
    from repro_torch.core import Booster, DeviceDMatrix

    _cuda()
    x, y = _binary_data(rng)
    bst = Booster(n_rounds=4, max_depth=4, max_bins=64, objective="binary:logistic").fit(
        DeviceDMatrix(x, label=y, max_bins=64))
    bst.save(str(tmp_path / "a.ckpt"))
    back = Booster.load(str(tmp_path / "a.ckpt"))
    assert back.ensemble.nodes.is_cuda and back.cuts.is_cuda
    assert torch.equal(back.predict(x), bst.predict(x))
    back.save(str(tmp_path / "b.ckpt"))
    assert (tmp_path / "a.ckpt").read_bytes() == (tmp_path / "b.ckpt").read_bytes()
    on_cpu = Booster.load(str(tmp_path / "a.ckpt"), device="cpu")
    assert torch.equal(on_cpu.predict_margins(x), bst.predict_margins(x).cpu())


@pytest.mark.cuda
def test_reference_checkpoint_on_card():
    """The checkpoint the JAX package wrote (tests/data, by
    tools/make_reference_checkpoint.py) loads onto the card, with no JAX and
    no msgpack, and predicts its stored rows within atol 1e-6 (float32
    rounding of the leaf sums and the sigmoid)."""
    from pathlib import Path

    from repro_torch.core import Booster

    _cuda()
    data = Path(__file__).resolve().parent / "data"
    bst = Booster.load(str(data / "repro_booster_v2.ckpt"))
    rows = np.load(data / "repro_booster_v2_rows.npy")
    pred = np.load(data / "repro_booster_v2_pred.npy")
    ops.reset_launches()
    got = bst.predict(rows).cpu().numpy()
    assert ops.launches()["ensemble_traversal"] == 1
    np.testing.assert_allclose(got, pred, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_engine_on_card(rng):
    """PredictEngine on the card: one CUDA graph a bucket, captured once
    (the traversal kernel's launches count at capture), replays only after
    warmup, and every output bit for bit `Booster.predict`."""
    from repro_torch.core import Booster, DeviceDMatrix
    from repro_torch.serve import PredictEngine

    _cuda()
    x, y = _binary_data(rng, n=2500)
    yk = (np.nan_to_num(x[:, 0]) > 0).astype(np.float32) + (np.nan_to_num(x[:, 1]) > 0.5)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    for bst in (Booster(n_rounds=6, max_depth=5, max_bins=64,
                        objective="binary:logistic").fit(d),
                Booster(n_rounds=3, max_depth=3, max_bins=64, objective="multi:softmax",
                        n_classes=3).fit(DeviceDMatrix(x, label=yk, ref=d))):
        want = {n: bst.predict(x[:n]).cpu().numpy() for n in (1, 31, 32, 33, 300, 2500)}
        ops.reset_launches()
        eng = PredictEngine(bst, buckets=(32, 64, 256)).warmup()
        assert ops.launches()["ensemble_traversal"] == 3 == eng.trace_count
        ops.reset_launches()
        for _ in range(2):
            for n, w in want.items():
                assert np.array_equal(eng.predict(x[:n]), w), n
        assert ops.launches()["ensemble_traversal"] == 0 and eng.trace_count == 3
    margin = PredictEngine(bst, output_margin=True, iteration_range=(1, 3), buckets=(64,))
    assert np.array_equal(margin.predict(x[:100]), bst.predict(
        x[:100], output_margin=True, iteration_range=(1, 3)).cpu().numpy())
    unstaged = PredictEngine(bst, host_staging=False, buckets=(64,))
    assert np.array_equal(unstaged.predict(x[:200]), want[300][:200])
    bad = x[:4].copy()
    bad[1, 2] = np.inf
    with pytest.raises(ValueError, match="infinite feature values"):
        eng.predict(bad)


@pytest.mark.cuda
def test_imported_json_model_on_card(rng):
    """A model exported to XGBoost JSON and imported onto the card predicts
    bit for bit as the original, through the traversal kernel."""
    from repro_torch.core import Booster, DeviceDMatrix
    from repro_torch.serve import export_xgboost_json, import_xgboost_json

    _cuda()
    x, y = _binary_data(rng)
    bst = Booster(n_rounds=4, max_depth=4, max_bins=64, objective="binary:logistic").fit(
        DeviceDMatrix(x, label=y, max_bins=64))
    imported = import_xgboost_json(export_xgboost_json(bst))
    assert imported.ensemble.nodes.is_cuda and imported.cuts is None
    ops.reset_launches()
    assert torch.equal(imported.predict(x), bst.predict(x))
    assert ops.launches()["ensemble_traversal"] == 2


def _pairwise_case(rng, sizes, n_labels=5, tied_scores=False):
    """Scores, labels and shuffled non-contiguous ids of groups of `sizes`."""
    ids = np.repeat(np.arange(len(sizes)) * 3 + 1, sizes).astype(np.int32)
    perm = rng.permutation(len(ids))
    s = rng.normal(size=len(ids)).astype(np.float32) * 2
    if tied_scores:
        s = np.round(s)
    y = rng.integers(0, n_labels, size=len(ids)).astype(np.float32)
    return s[perm], y[perm], ids[perm]


# Queries just above each size at which the pairwise kernel's work changes
# hands (a window's warp, a block, a spread query of three chunks).
PAIRWISE_ABOVE = {"above_window": pairwise.WINDOW_ROWS + 1,
                  "above_block": pairwise.BLOCK_ROWS + 1,
                  "above_three_chunks": 3 * pairwise.CHUNK_ROWS + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["groups_1", "groups_2", "groups_120", "groups_1251",
                                  "one_5000", "all_rows", "equal_relevance", "tied_scores",
                                  *PAIRWISE_ABOVE, "tiny_shared_warps", "mixed_sizes"])
def test_pairwise_kernel_on_card(rng, case):
    """The pairwise kernel against its plain version at chip_smoke.py's
    group shapes, just above each size at which its work changes hands, on
    queries of 1-8 rows that share warps and on sizes of 1-700 rows mixed:
    g and h within 2e-6 * (1 + the row's summed term magnitudes) (float32
    terms summed in another order); h exactly the 1e-6 floor where no pair
    is comparable."""
    dev = _cuda()
    sizes = {"groups_1": [1] * 3000, "groups_2": [2] * 1500, "groups_120": [120] * 40,
             "groups_1251": [1251, 1251, 7], "one_5000": [5000], "all_rows": [20_000],
             "equal_relevance": [100] * 30, "tied_scores": [300] * 10,
             "tiny_shared_warps": rng.integers(1, 9, size=2000),
             "mixed_sizes": rng.integers(1, 701, size=200),
             **{k: [v] * (12_000 // v) for k, v in PAIRWISE_ABOVE.items()}}[case]
    s, y, ids = _pairwise_case(rng, sizes, n_labels=1 if case == "equal_relevance" else 5,
                               tied_scores=case == "tied_scores")
    args = [torch.from_numpy(a).to(dev) for a in (s, y)]
    grouping = ops.query_groups(torch.from_numpy(ids).to(dev))
    ops.reset_launches()
    got = ops.pairwise_grad(*args, *grouping)
    assert ops.launches()["pairwise_grad"] == 1
    terms = ref.pairwise_terms_ref(*args, *grouping)
    want = ref.pairwise_grad_ref(*args, *grouping)
    mag = torch.stack([terms[:, 0] + terms[:, 1], terms[:, 2]], dim=1)
    assert bool(((got - want).abs() <= 2e-6 * (1 + mag)).all())
    if case in ("groups_1", "equal_relevance"):
        assert bool((got[:, 0] == 0).all()) and bool((got[:, 1] == np.float32(1e-6)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[20_000], [1251, 90, 3, 700, 1, 257] * 20])
def test_pairwise_kernel_same_bits_every_call(rng, sizes):
    """Two calls on the same inputs give the same bits: the kernel has no
    float atomics and sums in an order fixed by the shapes (one query of all
    rows, and a mix of sizes that runs both of its kernels)."""
    dev = _cuda()
    s, y, ids = _pairwise_case(rng, sizes)
    args = [torch.from_numpy(a).to(dev) for a in (s, y)]
    grouping = ops.query_groups(torch.from_numpy(ids).to(dev))
    first = ops.pairwise_grad(*args, *grouping)
    for _ in range(3):
        assert torch.equal(ops.pairwise_grad(*args, *grouping), first)


@pytest.mark.cuda
def test_query_groups_and_ndcg_on_card(rng):
    """The grouping on the card equals the CPU's; ndcg@k on the card is the
    CPU's within 1e-6."""
    from repro_torch.core import metrics as M

    dev = _cuda()
    s, y, ids = _pairwise_case(rng, rng.integers(1, 200, size=300))
    cpu = ops.query_groups(torch.from_numpy(ids))
    card = ops.query_groups(torch.from_numpy(ids).to(dev))
    assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card))
    for k in (1, 3, 10):
        fn = M.get_metric(f"ndcg@{k}").fn
        on_cpu = float(fn(torch.from_numpy(s)[:, None], torch.from_numpy(y),
                          group_ids=torch.from_numpy(ids)))
        on_card = float(fn(torch.from_numpy(s)[:, None].to(dev), torch.from_numpy(y).to(dev),
                           group_ids=torch.from_numpy(ids).to(dev)))
        assert abs(on_card - on_cpu) <= 1e-6


@pytest.mark.cuda
def test_rank_fit_on_card(rng):
    """rank:pairwise on the card: one pairwise launch a round, held-out
    ndcg@10 above the all-zero model's, the history's last reading equal to
    `eval` of the model within 1e-5."""
    from repro_torch.core import Booster, DeviceDMatrix
    from repro_torch.core import metrics as M

    dev = _cuda()
    s, y, ids = _pairwise_case(rng, rng.integers(20, 150, size=120))
    x = rng.normal(size=(len(y), 8)).astype(np.float32)
    y = np.clip(np.round(x[:, 0] + 0.5 * x[:, 1] + 2 + 0.3 * rng.normal(size=len(y))),
                0, 4).astype(np.float32)
    held = ids % 5 == 1  # a fifth of the queries held out
    d = DeviceDMatrix(x[~held], label=y[~held], group_ids=ids[~held], max_bins=64)
    dv = DeviceDMatrix(x[held], label=y[held], group_ids=ids[held], ref=d)
    ops.reset_launches()
    bst = Booster(n_rounds=6, max_depth=5, max_bins=64, objective="rank:pairwise").fit(
        d, evals=[(dv, "valid")], eval_metric=["ndcg@10"])
    got = ops.launches()
    assert got["pairwise_grad"] == 6 and got["histogram_private"] == 6
    assert got["split_scan"] == 30
    model = bst.eval(dv, "valid")["valid_ndcg@10"]
    assert abs(bst.history[-1]["valid_ndcg@10"] - model) <= 1e-5
    zero = float(M.get_metric("ndcg@10").fn(torch.zeros((int(held.sum()), 1), device=dev),
                                            dv.label, group_ids=dv.group_ids))
    assert model > zero


@pytest.mark.cuda
def test_classifier_serve_on_card(rng):
    """XGBClassifier on the card: predict_proba is bit for bit its booster's
    prediction, and the same with serve=True (through PredictEngine)."""
    from repro_torch.sklearn import XGBClassifier

    _cuda()
    x, y = _binary_data(rng)
    clf = XGBClassifier(n_estimators=5, max_depth=4, max_bins=64).fit(x, y)
    proba, labels = clf.predict_proba(x), clf.predict(x)
    assert np.array_equal(proba[:, 1], clf.get_booster().predict(x).cpu().numpy())
    clf.set_params(serve=True)
    assert np.array_equal(clf.predict_proba(x), proba)
    assert np.array_equal(clf.predict(x), labels)


def _chunk_stack(rng, n, f, max_bins, chunk_rows, skew=0.0):
    """(flat words, chunk stack, bits) of random bins: `skew` of the
    symbols in the missing bin, the stack's last chunk short unless n is a
    multiple of chunk_rows."""
    bits = TC.bits_needed(max_bins - 1)
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    bins[rng.random((n, f)) < skew] = max_bins - 1
    bins = torch.from_numpy(bins)
    spw = 32 // bits
    wpc = -(-chunk_rows // spw)
    stack = torch.zeros((-(-n // chunk_rows), f, wpc), dtype=torch.int32)
    for i, s in enumerate(range(0, n, chunk_rows)):
        words = TC.pack(bins[s:s + chunk_rows], bits)
        stack[i, :, :words.shape[1]] = words
    return TC.pack(bins, bits), stack, bits


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_rows", [256, 1000, 333])
def test_chunked_histogram_kernels_on_card(rng, chunk_rows):
    """Both histogram kernels on the chunk stack (chunk_rows a multiple of
    the symbols a word and not, a short last chunk, skewed words) against
    their chunked plain versions and against the flat kernels on the same
    rows: exact on dyadic (g, h), which sum exactly in any order."""
    dev = _cuda()
    for n, f, max_bins, n_nodes, skew in [(2999, 5, 256, 1, 0.0), (4096, 28, 256, 8, 0.8),
                                          (1500, 3, 16, 3, 0.0)]:
        flat, stack, bits = _chunk_stack(rng, n, f, max_bins, chunk_rows, skew)
        gh = torch.from_numpy(np.stack([rng.integers(-8, 9, n) / 4, rng.integers(0, 5, n) / 4],
                                       axis=1).astype(np.float32))
        pos = torch.from_numpy(rng.integers(0, n_nodes + 1, size=n).astype(np.int32))
        args = (gh.to(dev), pos.to(dev), n_nodes, max_bins, bits)
        got = build_histograms_packed_kernel(stack.to(dev), *args, chunk_rows)
        want = ref.histogram_chunked_ref(stack.to(dev), *args, chunk_rows)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        np.testing.assert_array_equal(
            got.cpu().numpy(), build_histograms_packed_kernel(flat.to(dev), *args).cpu().numpy())
        m = n // 2
        k = m - m // 5
        rid = np.sort(rng.choice(n, size=k, replace=False))
        rid = np.concatenate([rid, np.full(m - k, n)]).astype(np.int32)
        rid[-1] = 10 * n  # past the stack's rows: must not be read
        pos_sel = rng.integers(0, n_nodes + 1, size=m).astype(np.int32)
        pos_sel[k:] = n_nodes
        rargs = (gh[np.minimum(rid, n - 1)].to(dev), torch.from_numpy(pos_sel).to(dev),
                 torch.from_numpy(rid).to(dev), n_nodes, max_bins, bits)
        got = build_histograms_rows_kernel(stack.to(dev), *rargs, chunk_rows)
        want = ref.histogram_rows_chunked_ref(stack.to(dev), *rargs, chunk_rows)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        np.testing.assert_array_equal(
            got.cpu().numpy(), build_histograms_rows_kernel(flat.to(dev), *rargs).cpu().numpy())


@pytest.mark.cuda
def test_external_fit_on_card(rng):
    """A fit on an ExternalDMatrix (ref= the flat matrix, a short last
    chunk) launches the flat fit's kernels, as often, and predicts as the
    flat matrix does for the same model, bit for bit."""
    from repro_torch.core import Booster, DeviceDMatrix, ExternalDMatrix

    _cuda()
    x, y = _binary_data(rng)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=700, ref=d)
    kw = dict(n_rounds=3, max_depth=4, max_bins=64, objective="binary:logistic")
    ops.reset_launches()
    Booster(**kw).fit(d)
    flat = ops.launches()
    ops.reset_launches()
    bst = Booster(**kw).fit(e)
    assert ops.launches() == flat
    assert flat["histogram_private"] == 3 and flat["histogram_rows"] == 9
    assert torch.equal(bst.predict_margins(e), bst.predict_margins(d))


@pytest.mark.cuda
def test_nan_grad_policy_on_card(rng):
    """NaN gradients at round 2 grow a root-only tree on the card (the
    split scan ranks NaN first, in range, and nothing splits on it):
    warn_skip zeroes that round and keeps the margins finite."""
    from repro_torch.core import Booster, DeviceDMatrix
    from repro_torch.testing import faults

    _cuda()
    x, y = _binary_data(rng)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    with faults.inject("nan_grad", round=2), pytest.warns(UserWarning, match="round"):
        bst = Booster(n_rounds=4, max_depth=4, max_bins=64, objective="binary:logistic",
                      numeric_check="warn_skip").fit(d)
    assert bst.skipped_rounds == [2]
    assert bool((bst.ensemble.leaf_value[2] == 0).all())
    assert bool(torch.isfinite(bst.margins).all())


@pytest.mark.cuda
def test_resume_on_card(rng, tmp_path):
    """A fit stopped after its snapshot at round 3 resumes on the card to
    10 rounds; the snapshot's 3 rounds stay bit for bit."""
    from repro_torch.core import Booster, DeviceDMatrix

    _cuda()
    x, y = _binary_data(rng)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    path = str(tmp_path / "run.ckpt")
    kw = dict(n_rounds=10, max_depth=4, max_bins=64, objective="binary:logistic")

    class Stop(Exception):
        pass

    def stop(r, rec):
        if r >= 4:
            raise Stop

    with pytest.raises(Stop):
        Booster(**kw).fit(d, checkpoint_every=3, checkpoint_path=path, callback=stop)
    snap = Booster.load(path)
    got = Booster.resume(path, d)
    assert got.n_rounds_trained == 10
    assert torch.equal(got.ensemble.feature[:3], snap.ensemble.feature)
    assert torch.equal(got.ensemble.leaf_value[:3], snap.ensemble.leaf_value)
    assert bool(torch.isfinite(got.predict(x)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [2, 0])
def test_stream_pager_round_trip_on_card(rng, prefetch):
    """The streamed pager on the card: prefetch + 1 device slots (1 at 0),
    and each chunk read back equals its host words, also when the
    consumer's stream is held up by a sleeping kernel before it reads each
    chunk (a slot overwritten before its reader ran would show here)."""
    from repro_torch.core import DeviceDMatrix, ExternalDMatrix

    dev = _cuda()
    x, y = _binary_data(rng)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=333, ref=d, paging="stream",
                                    prefetch_chunks=prefetch)
    for sleep in (0, 1_000_000):
        pager = e.chunk_pager()
        assert pager.device_slots == prefetch + 1
        got = []
        for i, words in pager:
            assert words.device.type == "cuda"
            if sleep:
                torch.cuda._sleep(sleep)
            got.append((i, words.clone()))
        torch.cuda.synchronize(dev)
        assert [i for i, _ in got] == list(range(e.n_chunks))
        for i, words in got:
            assert np.array_equal(words.cpu().numpy().view(np.uint32), e._host_packed[i])
    assert e.nbytes_device == 0


@pytest.mark.cuda
def test_slab_accumulation_on_card(rng):
    """Both histogram kernels with out=: each chunk of a stack added into
    one slab, against one flat launch over the same rows (real-valued
    (g, h): atomics in another order, rtol 1e-5, atol 2e-5)."""
    from repro_torch.core import histogram as TH

    dev = _cuda()
    n, f, max_bins, n_nodes, chunk_rows = 4096, 28, 256, 8, 1000
    flat, stack, bits = _chunk_stack(rng, n, f, max_bins, chunk_rows, 0.0)
    gh = torch.from_numpy(np.stack([rng.normal(size=n), rng.random(n)], 1).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, n_nodes + 1, size=n).astype(np.int32))
    gh, pos, flat, stack = gh.to(dev), pos.to(dev), flat.to(dev), stack.to(dev)
    slab = TH.new_slab(n_nodes, f, max_bins, dev)
    for c in range(stack.shape[0]):
        s, t = c * chunk_rows, min((c + 1) * chunk_rows, n)
        TH.histogram_chunk_update(slab, stack[c], gh[s:t], pos[s:t], n_nodes, max_bins, bits)
    want = build_histograms_packed_kernel(flat, gh, pos, n_nodes, max_bins, bits)
    np.testing.assert_allclose(TH.finalize_slab_histogram(slab, n_nodes, max_bins).cpu().numpy(),
                               want.cpu().numpy(), rtol=1e-5, atol=2e-5)
    rid = torch.from_numpy(np.sort(rng.choice(n, n // 2, replace=False)).astype(np.int32)).to(dev)
    sel = pos[rid.long()] % n_nodes
    slab = TH.new_slab(n_nodes, f, max_bins, dev)
    for c in range(stack.shape[0]):
        m = (rid >= c * chunk_rows) & (rid < (c + 1) * chunk_rows)
        TH.histogram_rows_chunk_update(slab, stack[c], gh[rid.long()][m], sel[m],
                                       rid[m] - c * chunk_rows, n_nodes, max_bins, bits)
    want = build_histograms_rows_kernel(flat, gh[rid.long()], sel, rid, n_nodes, max_bins, bits)
    np.testing.assert_allclose(TH.finalize_slab_histogram(slab, n_nodes, max_bins).cpu().numpy(),
                               want.cpu().numpy(), rtol=1e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [2, 0])
def test_streamed_fit_on_card(rng, prefetch):
    """A streamed fit against the resident chunked fit: #1 once a chunk a
    round, the row-id kernel once a paged row segment, the split scan once
    a level; training accuracy within 0.003; the stack never on the card;
    predict on the streamed matrix bit for bit the flat predict."""
    from repro_torch.core import Booster, DeviceDMatrix, ExternalDMatrix

    _cuda()
    x, y = _binary_data(rng)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    kw = dict(n_rounds=3, max_depth=4, max_bins=64, objective="binary:logistic")
    res = Booster(**kw).fit(ExternalDMatrix.from_arrays(x, y, chunk_rows=700, ref=d,
                                                        paging="resident"))
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=700, ref=d, paging="stream",
                                    prefetch_chunks=prefetch)
    ops.reset_launches()
    bst = Booster(**kw).fit(e)
    got = ops.launches()
    st = e.stream_stats
    assert got["histogram_private"] == 3 * e.n_chunks
    assert got["histogram_rows"] == st.row_segments <= 9 * e.n_chunks
    assert got["split_scan"] == 12 and st.device_slots == prefetch + 1
    assert e.nbytes_device == 0

    def acc(b):
        return float(((b.predict(x) > 0.5).cpu().numpy() == y).mean())

    assert abs(acc(bst) - acc(res)) <= 0.003
    assert torch.equal(bst.predict_margins(e), bst.predict_margins(d))
    assert e.nbytes_device == 0


@pytest.mark.cuda
def test_auto_paging_streams_on_a_small_card(rng, monkeypatch):
    """"auto" resolves from the card's memory: a stack above half of
    `torch.cuda.mem_get_info`'s total streams."""
    from repro_torch.core import DeviceDMatrix, ExternalDMatrix

    _cuda()
    x, y = _binary_data(rng)
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=700, ref=DeviceDMatrix(x, label=y))
    assert e.resolved_paging() == "resident"
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1024, 2 * 1024))
    assert e.nbytes_host > 1024 and e.resolved_paging() == "stream"


# --- multi-device training (repro_torch.dist) on one card ----------------------------

def _shard_hists(rng, p, shape=(4, 6, 16, 2)):
    """Each shard's histogram: g signed, h positive, magnitudes by shard."""
    g = rng.normal(size=(p, *shape[:-1])) * (1 + np.arange(p))[:, None, None, None]
    h = rng.random((p, *shape[:-1])) * 3
    return np.stack([g, h], axis=-1).astype(np.float32)


def _allreduce(mesh, name, comp, tol, xs, axes=("data",)):
    """Each position's allreduce_hist of its input and its fallback count."""
    from repro_torch import dist as D

    c = D.get_collective(name, mesh, axes, compression=comp, tolerance=tol)
    dev = mesh.device(0)

    def body(x):
        c.begin_round()
        return c.allreduce_hist(x), c.fallback_count()

    out = D.spmd(mesh, body, [torch.from_numpy(x).to(dev) for x in xs])
    return torch.stack([o[0] for o in out]).cpu(), [int(o[1]) for o in out]


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_collectives_on_card(rng, shards):
    """The collectives on cuda:0 against the CPU's: q16 psum, ring and hier
    equal and the CPU's bit for bit; f32 and f16 rings the CPU's bit for
    bit (IEEE adds and casts in the same order), f16 within 2^-10 of the
    exact sum; tolerance 0 the exact result with the tally counted."""
    from repro_torch import dist as D

    _cuda()
    xs = _shard_hists(rng, shards)
    card = D.make_mesh((shards,), ("data",), device="cuda")
    cpu = D.make_mesh((shards,), ("data",), device="cpu")
    q = [_allreduce(card, n, "q16", 0.05, xs)[0] for n in ("psum", "ring", "hier")]
    for other in q[1:]:
        assert torch.equal(other, q[0])
    assert torch.equal(q[0], _allreduce(cpu, "psum", "q16", 0.05, xs)[0])
    exact = torch.from_numpy(xs.sum(axis=0, dtype=np.float64).astype(np.float32))
    for comp in (None, "f16"):
        ring, fb = _allreduce(card, "ring", comp, 0.05, xs)
        assert torch.equal(ring, _allreduce(cpu, "ring", comp, 0.05, xs)[0]) and fb == [0] * shards
        torch.testing.assert_close(ring, exact.expand_as(ring), rtol=2 ** -10,
                                   atol=2 ** -10 * float(np.abs(xs).max()))
    tight, fb = _allreduce(card, "ring", "f16", 0.0, xs)
    assert fb == [1] * shards
    assert torch.equal(tight, _allreduce(card, "ring", None, 0.05, xs)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 8])
def test_launch_counts_exact_across_shard_threads(rng, shards):
    """Shard threads launching at once lose no count: 5 repeats of every
    shard launching #1 and the split scan 40 times each."""
    from repro_torch import dist as D

    dev = _cuda()
    packed, gh, pos, bits = _hist_inputs(rng, 4096, 28, 256, 4)
    args = (packed.to(dev), torch.from_numpy(gh).to(dev), torch.from_numpy(pos).to(dev))
    hist, parent = _split_inputs(rng, 4, 28, 256)
    hist, parent = torch.from_numpy(hist).to(dev), torch.from_numpy(parent).to(dev)
    mesh = D.make_mesh((shards,), ("data",), device="cuda")

    def body(_):
        for _ in range(40):
            build_histograms_packed_kernel(*args, 4, 256, bits)
            split_scan(hist, parent)

    for _ in range(5):
        ops.reset_launches()
        D.spmd(mesh, body, list(range(shards)))
        got = ops.launches()
        assert got["histogram_private"] == got["split_scan"] == 40 * shards, got


@pytest.mark.cuda
def test_sharded_fit_on_card(rng):
    """A 2-shard fit on cuda:0: #1 every level on each shard (rounds x
    depth x 2), no row-id launch, the split scan on each shard; every
    shard's trees the same; accuracy within 0.003 of the one-device fit;
    save -> load -> predict bit for bit."""
    from repro_torch import dist as D
    from repro_torch.core import Booster, DeviceDMatrix

    _cuda()
    x, y = _binary_data(rng)
    n = len(x) // 2 * 2
    x, y = x[:n], y[:n]
    d = DeviceDMatrix(x, label=y, max_bins=64)
    kw = dict(n_rounds=3, max_depth=4, max_bins=64, objective="binary:logistic")
    mesh = D.make_mesh((2,), ("data",), device="cuda")
    ops.reset_launches()
    bst = Booster(**kw).fit(d, mesh=mesh)
    got = ops.launches()
    assert got["histogram_private"] == got["split_scan"] == 3 * 4 * 2, got
    assert got["histogram_rows"] == 0
    assert bst.comm_stats["devices"] == 2

    def acc(b):
        return float(((b.predict(x) > 0.5).cpu().numpy() == y).mean())

    assert abs(acc(bst) - acc(Booster(**kw).fit(d))) <= 0.003
    runner = D.make_chunk_runner(Booster(**kw).cfg, Booster(**kw).obj, d, mesh)
    margins = torch.zeros((n, 1), device=d.device)
    out = runner.round_fn([D.RoundInputs(runner.bins[p], margins[p * n // 2:(p + 1) * n // 2],
                                         runner.y[p], runner.cuts[p]) for p in range(2)])
    for a, b in zip(out[0][0][0], out[1][0][0]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_shards_on_two_cards(rng):
    """With two cards each shard launches on its own: the device guard
    makes a shard thread's card current, so #1 on cuda:1 from a thread whose
    current card was cuda:0 matches its plain version."""
    from repro_torch import dist as D

    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    packed, gh, pos, bits = _hist_inputs(rng, 4096, 28, 256, 4)
    mesh = D.make_mesh((2,), ("data",))
    want = ref.histogram_ref(packed, torch.from_numpy(gh), torch.from_numpy(pos), 4, 256, bits)

    def body(p):
        dev = mesh.device(p)
        return build_histograms_packed_kernel(packed.to(dev), torch.from_numpy(gh).to(dev),
                                              torch.from_numpy(pos).to(dev), 4, 256, bits).cpu()

    torch.cuda.set_device(0)
    for got in D.spmd(mesh, body, [0, 1]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.cuda
def test_fixed_point_histogram_on_two_cards(rng):
    """The exponent kernel (a cluster launch) and #1 on each of two cards
    from shard threads started together, so that cuda:1's first launches
    come from a thread whose current card was cuda:0: k `torch.equal` to
    `fixed.exponent` and the histogram to its fixed-point plain version on
    both cards."""
    from repro_torch import dist as D
    from repro_torch.kernels.histogram import fixed_exponent

    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    packed, gh, pos, bits = _hist_inputs(rng, 4096, 28, 256, 4)
    gh_t, pos_t = torch.from_numpy(gh), torch.from_numpy(pos)
    want = ref.histogram_fixed_ref(packed, gh_t, pos_t, 4, 256, bits)
    mesh = D.make_mesh((2,), ("data",))

    def body(p):
        dev = mesh.device(p)
        k = fixed_exponent(gh_t.to(dev)).cpu()
        return k, build_histograms_packed_kernel(packed.to(dev), gh_t.to(dev),
                                                 pos_t.to(dev), 4, 256, bits).cpu()

    torch.cuda.set_device(0)
    for k, got in D.spmd(mesh, body, [0, 1]):
        assert torch.equal(k, FX.exponent(gh_t))
        assert torch.equal(got, want)


def _feature_sharded_trees(rng, hist_builder=None, ctx=None):
    """Every position's depth-3 tree of a (2, 2) ("data", "model") mesh of
    cuda:0 positions, grown with `grow_tree(feature_axis="model")`, and the
    launches of the growth."""
    from repro_torch import dist as D
    from repro_torch.core import tree as TT

    dev = _cuda()
    n, f, max_bins = 4096, 8, 64
    bins = torch.from_numpy(rng.integers(0, max_bins, (n, f)).astype(np.int32)).to(dev)
    cuts = torch.from_numpy(np.sort(rng.normal(size=(f, max_bins - 2)), axis=1)
                            .astype(np.float32)).to(dev)
    x = rng.normal(size=n).astype(np.float32)
    gh = torch.from_numpy(np.stack([x, np.full(n, 0.25, np.float32)], axis=1)).to(dev)
    gh[:, 0] += bins[:, 5].float() / max_bins - 0.5  # a signal on feature 5 (shard 1)
    mesh = D.make_mesh((2, 2), ("data", "model"), device="cuda")
    coll = D.PsumCollective(mesh, ("data",))
    parts = D.shard_features(bins, cuts, mesh, ("data",), "model")
    _, shard_of, _ = mesh.shards(("data",))

    def body(part, g):
        return TT.grow_tree(part[0], g, part[1], 3, max_bins, hist_builder=hist_builder,
                            ctx=ctx, collective=coll, feature_axis="model")

    ops.reset_launches()
    trees = D.spmd(mesh, body, parts, [gh[s * n // 2:(s + 1) * n // 2] for s in shard_of])
    torch.cuda.synchronize()
    return trees, ops.launches()


@pytest.mark.cuda
@pytest.mark.parametrize("builder", ["default", "kernel"])
def test_feature_sharded_tree_on_card(rng, builder):
    """A (2, 2) feature-sharded tree on cuda:0 positions: every position's
    tree the same bit for bit; the split scan 3 levels x 4 positions, #1
    never with the default builder (index_add_) and 3 x 4 times with the
    kernel builder (pack + #1), the row-id kernel never."""
    kernel = builder == "kernel"
    trees, got = _feature_sharded_trees(
        rng, hist_builder=ops.build_histograms_kernel if kernel else None)
    assert got["split_scan"] == 3 * 4, got
    assert got["histogram_private"] == (3 * 4 if kernel else 0), got
    assert got["histogram_rows"] == 0, got
    assert int((~trees[0].is_leaf & torch.isfinite(trees[0].gain)).sum()) > 0
    for t in trees[1:]:
        for a, b in zip(trees[0], t):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_feature_sharded_monotone_refused_on_card(rng):
    """Monotone constraints under feature_axis raise before any launch."""
    from repro_torch.core import sampling as TSMP

    ctx = TSMP.TreeContext(key=(0, 0, 0), row_ids=None, feature_mask=None,
                           params=TSMP.StochasticParams(monotone=(1, 0, 0, -1)),
                           device=_cuda())
    with pytest.raises(NotImplementedError, match="tree.py:322"):
        _feature_sharded_trees(rng, ctx=ctx)
    assert not any(ops.launches().values()), ops.launches()


# --- the LM substrate on the card ----------------------------------------------
# A reduced architecture of each family (dense GQA, MoE, MLA, VLM prefix, SSM,
# hybrid, enc-dec). Weights are drawn on the CPU from the seed and copied to
# the card, so both devices run the same weights. The card's bf16 GEMMs
# (cuBLAS, allow_bf16_reduced_precision_reduction as torch sets it) sum in
# another order than the CPU's float32 upcast, and a sum that turns one bf16
# rounding the other way carries on through the later layers: LM_CARD_RTOL
# is the reference's own bf16 limit (decode against forward,
# test_arch_smoke.py), max |diff| / max |cpu|.
LM_FAMILIES = ["yi-6b", "llama4-scout-17b-a16e", "minicpm3-4b", "phi-3-vision-4.2b",
               "mamba2-2.7b", "zamba2-7b", "seamless-m4t-medium"]
LM_CARD_RTOL = 2e-2


def _lm_case(arch, seed=0):
    import test_torch_lm_common as C
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = C.small(get_arch(arch))
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in C.batch(cfg, seed).items()}
    return cfg, model, model.init_params(seed, "cpu"), batch


def _to(tree, dev):
    from repro_torch.pytree import tree_map

    return tree_map(lambda t: t.to(dev), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_forward_on_card_matches_cpu(arch):
    from repro_torch.models import NO_SHARDING

    dev = _cuda()
    cfg, model, params, batch = _lm_case(arch)
    with torch.no_grad():
        cpu = model.forward_logits(params, batch, NO_SHARDING)
        card = model.forward_logits(_to(params, dev), _to(batch, dev), NO_SHARDING)
    assert card.device.type == "cuda" and card.shape == cpu.shape
    assert bool(torch.isfinite(card).all())
    gap = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
    assert gap <= LM_CARD_RTOL, gap


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "minicpm3-4b", "mamba2-2.7b", "zamba2-7b",
                                  "seamless-m4t-medium", "glm4-9b:int8"])
def test_lm_decode_matches_forward_on_card(arch):
    """Twelve decode steps from an empty cache on the card against the
    card's forward: within 2e-2 (0.05 with the int8 cache), the reference's
    own limits."""
    import dataclasses

    import test_torch_lm_common as C
    from repro_torch.configs import get_arch
    from repro_torch.models import NO_SHARDING, build_model

    dev = _cuda()
    name, _, kv = arch.partition(":")
    cfg = C.small(get_arch(name))
    if kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    model = build_model(cfg)
    params = model.init_params(3, dev)
    batch = _to({k: torch.from_numpy(v) for k, v in C.batch(cfg, 3).items()}, dev)
    steps = C.DECODE_STEPS
    with torch.no_grad():
        full = model.forward_logits(params, {**batch, "tokens": batch["tokens"][:, :steps]},
                                    NO_SHARDING)
        cache = model.init_cache(C.BATCH, steps, device=dev)
        outs = []
        for t in range(steps):
            db = {"tokens": batch["tokens"][:, t:t + 1]}
            if "src_embeds" in batch:
                db["src_embeds"] = batch["src_embeds"]
            logits, cache = model.decode_fn(params, db, cache, t, NO_SHARDING)
            outs.append(logits[:, 0])
    gap = float((torch.stack(outs, 1) - full).abs().max() / full.abs().max())
    assert gap < (0.05 if kv else 2e-2), gap


@pytest.mark.cuda
def test_lm_train_loop_on_card(capsys):
    """`train_loop` on the card at a reduced size: finite losses; then eight
    AdamW steps on one batch at lr 5e-3, no decay (the reference's
    test_one_opt_step_reduces_loss): the last loss below the first."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as LT
    from repro_torch.models import NO_SHARDING, build_model
    from repro_torch.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro_torch.pytree import leaves, unflatten_like

    dev = _cuda()
    cfg = get_arch("yi-6b").reduced()
    params, hist = LT.train_loop(cfg, 5, 2, 32, log_every=1, device=dev)
    assert all(np.isfinite(h["loss"]) for h in hist) and len(hist) == 5
    assert all(p.device.type == "cuda" for p in leaves(params))
    model = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    batch = {"tokens": toks, "targets": toks}
    state, losses = adamw_init(params), []
    for _ in range(8):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = model.loss_fn(unflatten_like(params, flat), batch, NO_SHARDING)
        grads = unflatten_like(params, list(torch.autograd.grad(loss, flat)))
        params, state = adamw_update(params, grads, state, AdamWConfig(lr=5e-3, weight_decay=0.0))
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses
    capsys.readouterr()


# --- the LM's dry run on the card ------------------------------------------------


@pytest.mark.cuda
def test_lm_dryrun_position_arguments_on_card():
    """A position's local arguments (mamba2-2.7b decode_32k on 16x16: the
    leaves the step reads, as XLA counts them) allocated on the card take
    the record's argument_bytes, within the caching allocator's 512-byte
    rounding a tensor."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import SHAPES

    dev = _cuda()
    rec = D.run_one("mamba2-2.7b", "decode_32k", False, "", device=dev)
    assert rec["status"] == "ok", rec.get("error")
    shape = SHAPES["decode_32k"]
    cfg = SP.cfg_for_shape(get_arch("mamba2-2.7b"), shape)
    mesh = make_production_mesh(device=dev)
    _, structs, specs = D.build_step(build_model(cfg), cfg, shape, mesh)
    read = D.partition_of(cfg, shape, mesh)["arguments_read"]
    want = rec["memory_analysis"]["argument_bytes"]
    assert D.argument_bytes(structs, specs, mesh, read) == want
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    ts = D.local_arguments(structs, specs, mesh, dev, read)
    got = torch.cuda.memory_allocated(dev) - base
    assert 0 <= got - want < 512 * len(ts), (got, want, len(ts))
    del ts


@pytest.mark.cuda
def test_lm_constrain_raises_on_card_outside_a_trace():
    from repro_torch.models import NO_SHARDING, ShardingRules
    from repro_torch.models import transformer as TF

    x = torch.zeros(2, 4, 8, device=_cuda())
    with pytest.raises(ValueError, match="needs a mesh"):
        TF._constrain(x, ShardingRules().act(), ShardingRules())
    assert TF._constrain(x, ShardingRules().act(), NO_SHARDING) is x


# --- 64-bit fixed-point histograms: the same bits every call ------------------------

def _fixed_cases(rng, dev, chunk_rows=333):
    """Real-valued (g, h) on uniform and skewed words at 1 and 8 nodes:
    (name, kernel call, fixed-point plain call) for each of the five
    histogram instantiations (#1 flat and chunked, the row-id kernel flat
    and chunked, `histogram_packed`)."""
    for n, f, max_bins, n_nodes, skew in [(2999, 5, 256, 1, 0.0), (4096, 28, 256, 8, 0.8),
                                          (1500, 3, 16, 3, 0.0)]:
        flat, stack, bits = _chunk_stack(rng, n, f, max_bins, chunk_rows, skew)
        flat, stack = flat.to(dev), stack.to(dev)
        gh = torch.from_numpy(np.stack([rng.normal(size=n) * 3, rng.random(n)], 1)
                              .astype(np.float32)).to(dev)
        pos = rng.integers(0, n_nodes + 1, size=n).astype(np.int32)
        pos[rng.random(n) < 0.05] = -1
        pos = torch.from_numpy(pos).to(dev)
        m = n // 2
        rid = np.sort(rng.choice(n, size=m - 7, replace=False))
        rid = torch.from_numpy(np.concatenate([rid, np.full(7, n)]).astype(np.int32)).to(dev)
        sel = torch.where(torch.arange(m, device=dev) < m - 7, pos[rid.long().clamp(max=n - 1)]
                          .clamp(min=0), n_nodes).to(torch.int32)
        gh_sel = gh[rid.long().clamp(max=n - 1)].contiguous()
        a = (gh, pos, n_nodes, max_bins, bits)
        r = (gh_sel, sel, rid, n_nodes, max_bins, bits)
        yield (f"private-{n}", lambda: build_histograms_packed_kernel(flat, *a),
               lambda: ref.histogram_fixed_ref(flat, *a))
        yield (f"private-chunked-{n}",
               lambda: build_histograms_packed_kernel(stack, *a, chunk_rows),
               lambda: ref.histogram_chunked_fixed_ref(stack, *a, chunk_rows))
        yield (f"rows-{n}", lambda: build_histograms_rows_kernel(flat, *r),
               lambda: ref.histogram_rows_fixed_ref(flat, *r))
        yield (f"rows-chunked-{n}", lambda: build_histograms_rows_kernel(stack, *r, chunk_rows),
               lambda: ref.histogram_rows_chunked_fixed_ref(stack, *r, chunk_rows))
        yield (f"packed-{n}", lambda: histogram_packed(flat, *a),
               lambda: ref.histogram_packed_fixed_ref(flat, *a))


@pytest.mark.cuda
def test_fixed_point_kernels_equal_their_plain_versions_on_card(rng):
    """Every histogram instantiation `torch.equal` to its fixed-point plain
    version on real-valued (g, h), and the same bits on a second call."""
    dev = _cuda()
    for name, kernel, plain in _fixed_cases(rng, dev):
        got = kernel()
        assert torch.equal(got, plain()), name
        assert torch.equal(kernel(), got), name


@pytest.mark.cuda
def test_fixed_point_non_finite_gh_gives_nan_on_card(rng):
    """One NaN (g, h) anywhere in a call, an inactive row's too, makes the
    whole histogram NaN, in the kernels as in their plain versions."""
    dev = _cuda()
    packed, gh, pos, bits = _hist_inputs(rng, 1001, 5, 256, 4)
    gh[7, 0] = np.nan
    pos[7] = 4  # inactive
    args = (packed.to(dev), torch.from_numpy(gh).to(dev), torch.from_numpy(pos).to(dev),
            4, 256, bits)
    for kernel in (build_histograms_packed_kernel, histogram_packed):
        assert bool(torch.isnan(kernel(*args)).all())
    assert bool(torch.isnan(ref.histogram_fixed_ref(*args)).all())


@pytest.mark.cuda
def test_fixed_point_slab_is_one_call_on_card(rng):
    """Chunk after chunk into one int64 slab at the pass's exponent
    (`core.histogram.slab_exponent`) is `torch.equal` to one flat call over
    the same rows, for both private kernels."""
    from repro_torch.core import histogram as TH

    dev = _cuda()
    n, f, max_bins, n_nodes, chunk_rows = 4096, 28, 256, 8, 1000
    flat, stack, bits = _chunk_stack(rng, n, f, max_bins, chunk_rows, 0.3)
    gh = torch.from_numpy(np.stack([rng.normal(size=n), rng.random(n)], 1)
                          .astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.integers(0, n_nodes + 1, size=n).astype(np.int32)).to(dev)
    flat, stack = flat.to(dev), stack.to(dev)
    slab = TH.new_slab(n_nodes, f, max_bins, dev)
    assert slab.dtype == torch.int64
    k = TH.slab_exponent(slab, gh)
    for c in range(stack.shape[0]):
        s, t = c * chunk_rows, min((c + 1) * chunk_rows, n)
        TH.histogram_chunk_update(slab, stack[c], gh[s:t], pos[s:t], n_nodes, max_bins, bits,
                                  exponent=k)
    assert torch.equal(TH.finalize_slab_histogram(slab, n_nodes, max_bins, exponent=k),
                       build_histograms_packed_kernel(flat, gh, pos, n_nodes, max_bins, bits))
    rid = torch.from_numpy(np.sort(rng.choice(n, n // 2, replace=False)).astype(np.int32)).to(dev)
    sel = (pos[rid.long()] % n_nodes).to(torch.int32)
    gh_sel = gh[rid.long()].contiguous()
    slab = TH.new_slab(n_nodes, f, max_bins, dev)
    k = TH.slab_exponent(slab, gh_sel)
    for c in range(stack.shape[0]):
        m = (rid >= c * chunk_rows) & (rid < (c + 1) * chunk_rows)
        TH.histogram_rows_chunk_update(slab, stack[c], gh_sel[m], sel[m], rid[m] - c * chunk_rows,
                                       n_nodes, max_bins, bits, exponent=k)
    assert torch.equal(TH.finalize_slab_histogram(slab, n_nodes, max_bins, exponent=k),
                       build_histograms_rows_kernel(flat, gh_sel, sel, rid, n_nodes, max_bins,
                                                    bits))


def _shaped_words(rng, kind, n, f, max_bins, chunk_rows):
    """(flat words, chunk stack, bits) of Higgs-shaped (spread), skewed
    (80% of the symbols in the missing bin) or constant-feature (feature 0
    all in bin 7) bins."""
    flat, stack, bits = _chunk_stack(rng, n, f, max_bins, chunk_rows,
                                     0.8 if kind == "skewed" else 0.0)
    if kind == "constant":
        bins = TC.unpack(flat, bits, n)
        bins[:, 0] = 7
        flat = TC.pack(bins, bits)
        for i, s in enumerate(range(0, n, chunk_rows)):
            words = TC.pack(bins[s:s + chunk_rows], bits)
            stack[i, :, :words.shape[1]] = words
    return flat, stack, bits


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spread", "skewed", "constant"])
def test_private_kernels_equal_fixed_plain_at_every_level_on_card(rng, kind):
    """#1 at 1 / 8 / 32 / 64 nodes and the row-id kernel at 1 / 4 / 16
    parents, flat and chunked, without and with `out=` (an int64 slab
    holding earlier sums): `torch.equal` to the fixed-point plain versions.
    The kernels skip the missing bin and derive it from node totals at the
    flush, which the feature groups of a stripe split between them (28
    groups of one feature at 32 and 64 nodes and 16 parents)."""
    dev = _cuda()
    n, f, max_bins, chunk_rows = 20_011, 28, 256, 4_999
    flat, stack, bits = (t.to(dev) if torch.is_tensor(t) else t
                         for t in _shaped_words(rng, kind, n, f, max_bins, chunk_rows))
    gh = torch.from_numpy(np.stack([rng.normal(size=n) * 3, rng.random(n)], 1)
                          .astype(np.float32)).to(dev)
    k = torch.tensor(FX.exponent(gh.cpu()).item(), dtype=torch.int32, device=dev)
    for n_nodes in (1, 8, 32, 64):
        pos = rng.integers(0, n_nodes + 1, size=n).astype(np.int32)
        pos[rng.random(n) < 0.05] = -1
        pos = torch.from_numpy(pos).to(dev)
        a = (gh, pos, n_nodes, max_bins, bits)
        want = ref.histogram_fixed_ref(flat, *a)
        assert torch.equal(build_histograms_packed_kernel(flat, *a), want), n_nodes
        assert torch.equal(build_histograms_packed_kernel(stack, *a, chunk_rows), want), n_nodes
        slab = torch.randint(-2**40, 2**40, (n_nodes + 1, f, max_bins, 2), device=dev)
        mine = slab[:n_nodes].clone()
        ref.histogram_fixed_ref(flat, *a, exponent=k, out=slab)
        build_histograms_packed_kernel(stack, *a, chunk_rows, out=mine, exponent=k)
        assert torch.equal(mine, slab[:n_nodes]), n_nodes
    for n_par in (1, 4, 16):
        rid = np.sort(rng.choice(n, size=n // 2 - 9, replace=False))
        rid = torch.from_numpy(np.concatenate([rid, np.full(9, n)]).astype(np.int32)).to(dev)
        sel = torch.from_numpy(rng.integers(0, n_par + 1, size=n // 2).astype(np.int32))
        sel = torch.where(rid.cpu() < n, sel, n_par).to(torch.int32).to(dev)
        r = (gh[rid.long().clamp(max=n - 1)].contiguous(), sel, rid, n_par, max_bins, bits)
        want = ref.histogram_rows_fixed_ref(flat, *r)
        assert torch.equal(build_histograms_rows_kernel(flat, *r), want), n_par
        assert torch.equal(build_histograms_rows_kernel(stack, *r, chunk_rows), want), n_par
        kr = torch.tensor(FX.exponent(r[0].cpu()).item(), dtype=torch.int32, device=dev)
        slab = torch.randint(-2**40, 2**40, (n_par + 1, f, max_bins, 2), device=dev)
        mine = slab[:n_par].clone()
        ref.histogram_rows_fixed_ref(flat, *r, exponent=kr, out=slab)
        build_histograms_rows_kernel(flat, *r, out=mine, exponent=kr)
        assert torch.equal(mine, slab[:n_par]), n_par


@pytest.mark.cuda
@pytest.mark.parametrize("edge", sorted(EXPONENT_EDGES))
def test_fixed_exponent_kernel_on_card(rng, edge):
    """The exponent kernel's k `torch.equal` to `fixed.exponent` (its plain
    version) on the edge inputs, on a large input, and the accumulator it
    was handed zeroed."""
    from repro_torch.kernels.histogram import fixed_exponent

    dev = _cuda()
    for gh in (EXPONENT_EDGES[edge],
               np.concatenate([rng.normal(size=(300_001, 2)).astype(np.float32),
                               EXPONENT_EDGES[edge]])):
        g = torch.from_numpy(np.ascontiguousarray(gh)).to(dev)
        acc = torch.full((3, 5, 7, 2), -1, dtype=torch.int64, device=dev)
        k = fixed_exponent(g, zero=acc)
        assert k.dtype == torch.int32 and k.shape == ()
        assert torch.equal(k.cpu(), FX.exponent(torch.from_numpy(gh))), edge
        assert not bool(acc.any())
        assert torch.equal(fixed_exponent(g).cpu(), k.cpu())


@pytest.mark.cuda
def test_histogram_call_is_three_launches_on_card(rng):
    """A wrapper call without `out=`: the exponent kernel (which zeroes the
    accumulator), the histogram kernel, the conversion pass, by the launch
    counters (one each of the counted two) and by the device's own record
    (the call captured into a CUDA graph: exactly those three kernel nodes,
    in that order, and no other node)."""
    from repro_torch.kernels.histogram import device_kernels, fixed_exponent

    dev = _cuda()
    n, f, max_bins = 4096, 28, 256
    flat, _, bits = _chunk_stack(rng, n, f, max_bins, 1000)
    flat = flat.to(dev)
    gh = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.integers(0, 5, size=n).astype(np.int32)).to(dev)
    rid = torch.arange(0, n, 2, dtype=torch.int32, device=dev)
    gh_sel, pos_sel = gh[::2].contiguous(), pos[::2].contiguous()
    calls = {"histogram_private_kernel": lambda: build_histograms_packed_kernel(
                 flat, gh, pos, 4, max_bins, bits),
             "histogram_rows_kernel": lambda: build_histograms_rows_kernel(
                 flat, gh_sel, pos_sel, rid, 4, max_bins, bits),
             "histogram_global_kernel": lambda: histogram_packed(flat, gh, pos, 4, max_bins,
                                                                 bits)}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        ops.reset_launches()
        call()
        torch.cuda.synchronize()
        assert sum(ops.launches().values()) == 2 and fixed_exponent.launches == 1, name
        assert device_kernels(call, dev) == [
            "fixed_exponent_kernel", name, "histogram_dequantise_kernel"], name


def _assert_same_fit(a, b) -> None:
    from repro_torch.core.predict import ENSEMBLE_FIELDS

    for fld in ENSEMBLE_FIELDS:
        assert torch.equal(getattr(a.ensemble, fld), getattr(b.ensemble, fld)), fld
    assert torch.equal(a.margins, b.margins)


@pytest.mark.cuda
def test_fits_same_bits_twice_on_card(rng):
    """A default fit, a dense one and a streamed one, each twice: trees and
    margins `torch.equal`; the streamed fit and the resident chunked one
    equal the flat fit, and the dense fit the packed one."""
    from repro_torch.core import Booster, DeviceDMatrix, ExternalDMatrix

    _cuda()
    x, y = _binary_data(rng)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    kw = dict(n_rounds=3, max_depth=4, max_bins=64, objective="binary:logistic")
    flat = Booster(**kw).fit(d)
    _assert_same_fit(flat, Booster(**kw).fit(d))
    dense = Booster(**kw, compress_matrix=False).fit(d)
    _assert_same_fit(dense, Booster(**kw, compress_matrix=False).fit(d))
    _assert_same_fit(dense, flat)
    res = Booster(**kw).fit(ExternalDMatrix.from_arrays(x, y, chunk_rows=700, ref=d,
                                                        paging="resident"))
    _assert_same_fit(res, flat)
    for _ in range(2):
        e = ExternalDMatrix.from_arrays(x, y, chunk_rows=700, ref=d, paging="stream",
                                        prefetch_chunks=2)
        _assert_same_fit(Booster(**kw).fit(e), flat)


@pytest.mark.cuda
def test_update_is_one_longer_fit_on_card(rng):
    """fit(2) + update(2) on the card is fit(4) bit for bit, as on the CPU."""
    from repro_torch.core import Booster, DeviceDMatrix

    _cuda()
    x, y = _binary_data(rng)
    d = DeviceDMatrix(x, label=y, max_bins=64)
    kw = dict(max_depth=4, max_bins=64, objective="binary:logistic")
    _assert_same_fit(Booster(n_rounds=2, **kw).fit(d).update(d, 2),
                     Booster(n_rounds=4, **kw).fit(d))
