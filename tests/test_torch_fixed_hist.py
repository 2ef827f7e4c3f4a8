"""The card's histogram arithmetic on the CPU: 64-bit fixed-point (g, h)
(`repro_torch.kernels.fixed`), through the fixed-point plain versions of
the histogram kernels (`kernels/ref.py`, `*_fixed_ref`) and, with
`ops.fixed_point_histograms` monkeypatched to true, through whole fits.

Bit for bit (`torch.equal`): a fixed-point histogram under any order of its
rows, in its flat, chunked (333 and 500 rows a chunk) and running-slab
forms; fits twice, chunked = streamed = flat, dense = packed, update = one
longer fit. Within bounds: each bin within count 2^-(k + 1) of the exact
sum of its float32 inputs plus one float32 rounding; the reference's
histograms within the port's histogram tolerance (rtol 1e-5, atol 2e-5, as
`test_torch_kernels.py`); the fits within the fit tolerance against the
reference (rtol 1e-5, atol 1e-5, as `test_torch_booster.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import compress as JC
from repro.core import histogram as JH
from repro_torch.core import Booster, DeviceDMatrix, ExternalDMatrix
from repro_torch.core import compress as TC
from repro_torch.core import histogram as TH
from repro_torch.core.predict import ENSEMBLE_FIELDS
from repro_torch.kernels import fixed as FX
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import DeviceLimits
from repro_torch.kernels.histogram import BIN_BYTES, PRIVATE_BLOCKS_PER_SM, launch_plan

from _torch_parity import EXPONENT_EDGES

HIST_TOL = dict(rtol=1e-5, atol=2e-5)
FIT_TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKS = (333, 500)
# An H100 SXM: SMs, opt-in shared memory per block, per SM, reserved per
# block, threads per SM (as test_torch_kernels.py).
H100 = DeviceLimits(132, 232448, 233_472, 1_024, 2_048)


@pytest.fixture
def rng():
    return np.random.default_rng(4321)


@pytest.fixture
def fixed_point(monkeypatch):
    """Every histogram of the port in the card's arithmetic, on the CPU."""
    monkeypatch.setattr(ops, "fixed_point_histograms", lambda device: True)


def _inputs(rng, n=1000, f=5, max_bins=32, n_nodes=4, skew=0.0):
    """(bins (n, f) int32 numpy, gh (n, 2) float32 numpy, positions, bits):
    real-valued g of both signs and h >= 0; a twentieth of the rows
    inactive (n_nodes or -1)."""
    bits = TC.bits_needed(max_bins - 1)
    bins = rng.integers(0, max_bins, size=(n, f)).astype(np.int32)
    bins[rng.random((n, f)) < skew] = max_bins - 1
    gh = np.stack([rng.normal(size=n) * 3, rng.random(n)], axis=1).astype(np.float32)
    pos = rng.integers(0, n_nodes + 1, size=n).astype(np.int32)
    pos[rng.random(n) < 0.05] = -1
    return bins, gh, pos, bits


def _pack(bins: np.ndarray, bits: int) -> torch.Tensor:
    return TC.pack(torch.from_numpy(bins), bits)


def _stack(bins: np.ndarray, bits: int, chunk_rows: int) -> torch.Tensor:
    """The (n_chunks, F, words_per_chunk) chunk stack, each chunk packed on
    its own and padded with zero words."""
    n, f = bins.shape
    wpc = -(-chunk_rows // (32 // bits))
    stack = torch.zeros((-(-n // chunk_rows), f, wpc), dtype=torch.int32)
    for c, s in enumerate(range(0, n, chunk_rows)):
        words = _pack(bins[s:s + chunk_rows], bits)
        stack[c, :, :words.shape[1]] = words
    return stack


def _buffer(rng, n, n_nodes, pos):
    """A compacted row buffer as the subtraction trick makes it: ascending
    selected rows, some at the dump position, then padding ids n."""
    m = n // 2
    k = m - 9
    rid = np.concatenate([np.sort(rng.choice(n, size=k, replace=False)),
                          np.full(m - k, n)]).astype(np.int32)
    sel = np.where(np.arange(m) < k, np.clip(pos[np.minimum(rid, n - 1)], 0, None), n_nodes)
    return rid, sel.astype(np.int32)


# --- the arithmetic ---------------------------------------------------------------

def test_exponent_leaves_room_for_every_sum():
    """k = 62 - ceil(log2 n) - e with max < 2^e: at 2^31 rows of |g| near
    float32's largest value a row quantises below 2^31 and 2^31 of them sum
    below 2^62; at |g| = 1e-30 the rows keep 2^-30-relative precision; zero
    gradients take e = 0."""
    top = torch.tensor(np.finfo(np.float32).max)
    k = FX.exponent_from_max(top, 2**31)
    assert int(k) == 62 - 31 - 128
    q = FX.quantise(torch.tensor([[-top, top]]), k)
    assert int(q.abs().max()) <= 2**31 and int(q.abs().max()) * 2**31 <= 2**62
    assert torch.equal(FX.dequantise(q, k), torch.tensor([[-top, top]]))

    tiny = torch.full((1000, 2), 1e-30)
    k = FX.exponent(tiny)
    assert int(k) == 62 - 10 - int(torch.frexp(torch.tensor(1e-30)).exponent)
    got = FX.dequantise(FX.quantise(tiny, k).sum(0), k)
    np.testing.assert_allclose(got.numpy(), np.float32(1e-27), rtol=2**-23)

    assert int(FX.exponent(torch.zeros(7, 2))) == 62 - 3
    bins, _, pos, bits = _inputs(np.random.default_rng(0), n=100)
    zero = ref.histogram_fixed_ref(_pack(bins, bits), torch.zeros(100, 2),
                                   torch.from_numpy(pos), 4, 32, bits)
    assert torch.equal(zero, torch.zeros_like(zero))
    assert int(FX.exponent(torch.tensor([[1.0, float("inf")]]))) == FX.NONFINITE


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_non_finite_row_makes_the_histogram_nan(rng, bad):
    """A non-finite (g, h) anywhere in a call, an inactive row's too, makes
    every entry NaN, in every plain version (the kernels' behaviour)."""
    bins, gh, pos, bits = _inputs(rng)
    gh[17, 1] = bad
    pos[17] = -1
    packed, ght, post = _pack(bins, bits), torch.from_numpy(gh), torch.from_numpy(pos)
    assert bool(torch.isnan(ref.histogram_fixed_ref(packed, ght, post, 4, 32, bits)).all())
    rid, sel = _buffer(rng, 1000, 4, pos)
    rows = ref.histogram_rows_fixed_ref(packed, ght[np.minimum(rid, 999)], torch.from_numpy(sel),
                                        torch.from_numpy(rid), 4, 32, bits)
    assert bool(torch.isnan(rows).all())


@pytest.mark.parametrize("n,f,max_bins,n_nodes,skew", [
    (1000, 5, 32, 4, 0.0), (999, 3, 256, 8, 0.8), (257, 4, 16, 1, 0.0)])
def test_fixed_histogram_is_one_function_of_its_rows(rng, n, f, max_bins, n_nodes, skew):
    """The same bits under a permutation of the rows (the private and
    global kernels' plain version) or of the slots (the row-id kernel's),
    for the flat words, the chunk stack at 333 and 500 rows a chunk, and
    chunk after chunk into one int64 slab at the pass's exponent."""
    bins, gh, pos, bits = _inputs(rng, n, f, max_bins, n_nodes, skew)
    ghT, posT = torch.from_numpy(gh), torch.from_numpy(pos)
    packed = _pack(bins, bits)
    want = ref.histogram_fixed_ref(packed, ghT, posT, n_nodes, max_bins, bits)
    assert want.dtype == torch.float32
    perm = rng.permutation(n)
    assert torch.equal(ref.histogram_fixed_ref(_pack(bins[perm], bits), ghT[perm], posT[perm],
                                               n_nodes, max_bins, bits), want)
    assert torch.equal(ref.histogram_packed_fixed_ref(packed, ghT, posT, n_nodes, max_bins, bits),
                       want)
    rid, sel = _buffer(rng, n, n_nodes, pos)
    ridT, selT = torch.from_numpy(rid), torch.from_numpy(sel)
    gh_sel = ghT[np.minimum(rid, n - 1)]
    want_rows = ref.histogram_rows_fixed_ref(packed, gh_sel, selT, ridT, n_nodes, max_bins, bits)
    slots = rng.permutation(rid.shape[0])
    assert torch.equal(ref.histogram_rows_fixed_ref(packed, gh_sel[slots], selT[slots],
                                                    ridT[slots], n_nodes, max_bins, bits),
                       want_rows)
    for chunk_rows in CHUNKS:
        stack = _stack(bins, bits, chunk_rows)
        assert torch.equal(ref.histogram_chunked_fixed_ref(stack, ghT, posT, n_nodes, max_bins,
                                                           bits, chunk_rows), want)
        assert torch.equal(ref.histogram_rows_chunked_fixed_ref(
            stack, gh_sel, selT, ridT, n_nodes, max_bins, bits, chunk_rows), want_rows)
        # The slab forms: each chunk's flat words, at the pass's exponent.
        slab = torch.zeros((n_nodes + 1, f, max_bins, 2), dtype=torch.int64)
        k = FX.exponent(ghT)
        for c, s in enumerate(range(0, n, chunk_rows)):
            e = min(n, s + chunk_rows)
            ref.histogram_fixed_ref(stack[c], ghT[s:e], posT[s:e], n_nodes, max_bins, bits,
                                    exponent=k, out=slab)
        assert torch.equal(FX.dequantise(slab[:n_nodes], k), want)
        slab.zero_()
        k = FX.exponent(gh_sel)
        for c, s in enumerate(range(0, n, chunk_rows)):
            seg = (ridT >= s) & (ridT < s + chunk_rows)
            ref.histogram_rows_fixed_ref(stack[c], gh_sel[seg], selT[seg], ridT[seg] - s,
                                         n_nodes, max_bins, bits, exponent=k, out=slab)
        assert torch.equal(FX.dequantise(slab[:n_nodes], k), want_rows)


@pytest.mark.parametrize("n,max_bins,n_nodes,skew", [(1000, 32, 4, 0.0), (999, 256, 8, 0.8)])
def test_fixed_histogram_within_its_bound_and_the_reference(rng, n, max_bins, n_nodes, skew):
    """Each bin within count 2^-(k + 1) of the float64 sum of its float32
    inputs plus one float32 rounding; the reference's histograms
    (`repro.core.histogram.build_histograms` on the bins,
    `build_histograms_packed_rows` on the words) within the port's
    histogram tolerance."""
    f = 5
    bins, gh, pos, bits = _inputs(rng, n, f, max_bins, n_nodes, skew)
    ghT, posT = torch.from_numpy(gh), torch.from_numpy(pos)
    packed = _pack(bins, bits)
    got = ref.histogram_fixed_ref(packed, ghT, posT, n_nodes, max_bins, bits)
    exact = ref.histogram_ref(packed, ghT.double(), posT, n_nodes, max_bins, bits)
    count = ref.histogram_ref(packed, torch.ones(n, 2, dtype=torch.float64), posT, n_nodes,
                              max_bins, bits)
    k = int(FX.exponent(ghT))
    bound = count * 2.0 ** -(k + 1) + exact.abs() * 2.0**-24
    assert bool(((got.double() - exact).abs() <= bound).all())
    # The reference treats position -1 as it treats n_nodes: inactive.
    jpos = np.where(pos < 0, n_nodes, pos)
    want = np.asarray(JH.build_histograms(jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(jpos),
                                          n_nodes, max_bins))
    np.testing.assert_allclose(got.numpy(), want, **HIST_TOL)

    rid, sel = _buffer(rng, n, n_nodes, pos)
    gh_sel = gh[np.minimum(rid, n - 1)]
    got_rows = ref.histogram_rows_fixed_ref(packed, torch.from_numpy(gh_sel),
                                            torch.from_numpy(sel), torch.from_numpy(rid),
                                            n_nodes, max_bins, bits)
    jpacked = JC.pack(jnp.asarray(bins), bits)
    want_rows = np.asarray(JH.build_histograms_packed_rows(
        jpacked, jnp.asarray(gh_sel), jnp.asarray(sel), jnp.asarray(rid), n_nodes, max_bins,
        bits))
    np.testing.assert_allclose(got_rows.numpy(), want_rows, **HIST_TOL)


def test_ops_and_dense_scatter_take_the_fixed_point(rng, fixed_point):
    """Patched, every histogram op and the dense scatter give the fixed-point
    plain versions' bits, and a slab is int64; unpatched (the CPU), the
    float plain versions'."""
    bins, gh, pos, bits = _inputs(rng)
    ghT, posT = torch.from_numpy(gh), torch.from_numpy(pos)
    packed = _pack(bins, bits)
    want = ref.histogram_fixed_ref(packed, ghT, posT, 4, 32, bits)
    assert torch.equal(ops.histogram_private_op(packed, ghT, posT, 4, 32, bits), want)
    assert torch.equal(ops.histogram_packed_op(packed, ghT, posT, 4, 32, bits), want)
    assert torch.equal(TH.build_histograms(torch.from_numpy(bins), ghT, posT, 4, 32), want)
    assert torch.equal(ops.build_histograms_kernel(torch.from_numpy(bins), ghT, posT, 4, 32),
                       want)
    assert TH.new_slab(4, 5, 32, "cpu").dtype == torch.int64
    with pytest.raises(ValueError, match="flat="):
        TH.build_histograms(torch.from_numpy(bins), ghT, posT, 4, 32,
                            flat=torch.zeros(5, 5, 32, 2))


def test_cpu_histograms_stay_float(rng):
    """Unpatched, the CPU keeps the reference's arithmetic: the ops are the
    float plain versions, the slab float32."""
    assert not ops.fixed_point_histograms("cpu") and ops.fixed_point_histograms("cuda")
    bins, gh, pos, bits = _inputs(rng)
    ghT, posT = torch.from_numpy(gh), torch.from_numpy(pos)
    packed = _pack(bins, bits)
    assert torch.equal(ops.histogram_private_op(packed, ghT, posT, 4, 32, bits),
                       ref.histogram_ref(packed, ghT, posT, 4, 32, bits))
    assert TH.new_slab(4, 5, 32, "cpu").dtype == torch.float32


def test_slab_without_a_pass_exponent_keeps_its_own(rng, fixed_point):
    """Chunk updates into an int64 slab given no exponent add at the slab's
    own (made for 2^31 rows), rescaled when a later chunk holds larger
    values: within the histogram tolerance of one call; with the pass's
    exponent, bit for bit one call."""
    n, f, max_bins, n_nodes = 1000, 5, 32, 4
    bins, gh, pos, bits = _inputs(rng, n, f, max_bins, n_nodes)
    gh[600:] *= 1000.0  # the later chunks need a smaller exponent
    ghT, posT = torch.from_numpy(gh), torch.from_numpy(pos)
    want = ref.histogram_fixed_ref(_pack(bins, bits), ghT, posT, n_nodes, max_bins, bits)
    for exact in (False, True):
        slab = TH.new_slab(n_nodes, f, max_bins, "cpu")
        k = TH.slab_exponent(slab, ghT) if exact else None
        for s in range(0, n, 333):
            e = min(n, s + 333)
            TH.histogram_chunk_update(slab, _pack(bins[s:e], bits), ghT[s:e], posT[s:e],
                                      n_nodes, max_bins, bits, exponent=k)
        got = TH.finalize_slab_histogram(slab, n_nodes, max_bins, exponent=k)
        if exact:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **HIST_TOL)
    fresh = TH.new_slab(n_nodes, f, max_bins, "cpu")
    assert torch.equal(TH.finalize_slab_histogram(fresh, n_nodes, max_bins),
                       torch.zeros((n_nodes, f, max_bins, 2)))


@pytest.mark.parametrize("n_nodes", [1, 8, 32])
def test_fixed_point_launch_plan(n_nodes):
    """The wrappers' plan (two int64 a bin, max_bins - 1 bins a feature and
    node, the missing bin never added, and a share of the node totals) fits
    an H100's shared memory at its targets of blocks per SM, at the main
    path's widths (28 features, 256 bins)."""
    for target in (PRIVATE_BLOCKS_PER_SM, 3):
        plan = launch_plan(250_000, 28, n_nodes, 256, H100, target)
        share = H100.smem_sm // target - H100.smem_reserved
        assert plan.smem_bytes == (plan.feat_group * plan.node_tile * 255
                                   + plan.node_tile) * BIN_BYTES
        assert plan.smem_bytes <= min(share, H100.smem_block)
        assert plan.blocks_per_sm >= target
        assert plan.blocks_per_sm * (plan.smem_bytes + H100.smem_reserved) <= H100.smem_sm


# --- the kernels' missing bin: node totals less the other bins --------------------
#
# The private kernels never add a symbol of the missing bin (max_bins - 1).
# Each block adds its other bins and minus their sum into the missing entry
# of each of its (node, feature)s, and its share of its stripe's node totals
# into the missing entry of every feature: with one feature group a block
# sums its whole stripe's totals (T_block - its other bins), with G groups
# the block of group g sums the rows of its loop's passes p with p % G == g.
# A plain-torch model of that arithmetic, over rows (or slots) cut into
# arbitrary blocks, must give the fixed-point plain version's int64
# accumulator bit for bit.

MISSING_CASES = ["spread", "skewed", "constant_feature", "all_missing_feature",
                 "empty_node", "ragged_words", "chunk_stack_100003", "running_slab",
                 "nonfinite"]
ODD_CHUNK = 100_003  # the smoke's odd chunk size: padding in every chunk


def _missing_case(rng, case):
    """(bins, gh, positions, n_nodes, max_bins, bits) of one case."""
    n, f, max_bins, n_nodes, skew = 1000, 5, 32, 4, 0.0
    if case == "skewed":
        n, f, max_bins, n_nodes, skew = 999, 3, 256, 8, 0.8
    elif case == "ragged_words":
        n = 1001  # 5-bit symbols, 6 a word: the last word holds 5 rows
    elif case == "chunk_stack_100003":
        n, f = 150_000, 3
    bins, gh, pos, bits = _inputs(rng, n, f, max_bins, n_nodes, skew)
    if case == "constant_feature":
        bins[:, 0] = 7
    elif case == "all_missing_feature":
        bins[:, 1] = max_bins - 1
    elif case == "empty_node":
        pos[pos == 2] = 3
    elif case == "nonfinite":
        gh[17, 0] = np.nan
    elif case == "running_slab":
        gh[n // 2:] *= 1000.0  # the second chunk rescales the slab
    return bins, gh, pos, n_nodes, max_bins, bits


def _block_terms(bins, q, node, n_nodes, max_bins, feats, share):
    """One block's int64 (n_nodes, F, max_bins, 2) contribution: its
    features' non-missing bins and minus their sum in the missing bin, and
    the node totals of its `share` of the rows in every feature's missing
    bin. Rows whose node lies outside [0, n_nodes) count in neither."""
    f = bins.shape[1]
    live = (node >= 0) & (node < n_nodes)
    out = torch.zeros((n_nodes, f, max_bins, 2), dtype=torch.int64)
    b, r = bins[live][:, feats], q[live]
    hist = torch.zeros((n_nodes * len(feats) * max_bins, 2), dtype=torch.int64)
    i, c = torch.nonzero(b < max_bins - 1, as_tuple=True)
    hist.index_add_(0, (node[live][i] * len(feats) + c) * max_bins + b[i, c], r[i])
    hist = hist.view(n_nodes, len(feats), max_bins, 2)
    hist[:, :, -1] = -hist[:, :, :-1].sum(2)
    out[:, feats] = hist
    mine = live & share
    total = torch.zeros((n_nodes, 2), dtype=torch.int64).index_add_(0, node[mine], q[mine])
    out[:, :, -1] += total[:, None]
    return out


def _by_blocks(rng, bins, q, node, n_nodes, max_bins, unit=1, groups=1):
    """The model's accumulator: the rows cut into random stripes (at
    multiples of `unit`, a word of symbols; one stripe may be empty), each
    stripe's rows read by `groups` blocks, one a group of the features; a
    pass of a block's loop is 7 units of rows."""
    n, f = bins.shape
    inner = np.minimum(rng.integers(0, n // unit + 1, 7) * unit, n)
    cuts = np.sort(np.concatenate([[0, n], inner, inner[:1]]))  # inner[0] twice: empty
    acc = torch.zeros((n_nodes, f, max_bins, 2), dtype=torch.int64)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        passes = torch.arange(hi - lo) // (7 * unit) % groups
        for g, feats in enumerate(np.array_split(np.arange(f), groups)):
            acc += _block_terms(bins[lo:hi], q[lo:hi], node[lo:hi], n_nodes, max_bins,
                                torch.from_numpy(feats), passes == g)
    return acc


def _stack_symbols(stack, bins_t, gh, pos, bits, chunk_rows):
    """Every symbol of the chunk stack in the privatised kernel's walk
    order (chunk by chunk, padding included): its bins, and the quantised
    (g, h) rows and nodes there, padding at node -1."""
    n_chunks, f, wpc = stack.shape
    per = wpc * (32 // bits)
    off = torch.arange(n_chunks * per) % per
    row = torch.arange(n_chunks * per) // per * chunk_rows + off
    real = (off < chunk_rows) & (row < bins_t.shape[0])
    row = torch.where(real, row, 0)
    sym = torch.cat([TC.unpack(stack[c], bits, per) for c in range(n_chunks)])
    return sym, row, real


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("case", MISSING_CASES)
def test_private_kernel_missing_bin_is_totals_less_bins(rng, case, groups):
    """The privatised kernel's arithmetic: the rows (or, on the chunk stack,
    its symbols, padding included) cut into arbitrary blocks of whole words,
    each adding its non-missing bins and its node totals less them, sum to
    `histogram_fixed_ref`'s int64 accumulator bit for bit, into a fresh or a
    running slab, and convert to its float32 histogram."""
    bins, gh, pos, n_nodes, max_bins, bits = _missing_case(rng, case)
    n, f = bins.shape
    spw = 32 // bits
    ghT, posT, bins_t = torch.from_numpy(gh), torch.from_numpy(pos), torch.from_numpy(bins)
    packed = _pack(bins, bits)
    k = FX.exponent(ghT)
    want = torch.zeros((n_nodes + 1, f, max_bins, 2), dtype=torch.int64)
    ref.histogram_fixed_ref(packed, ghT, posT, n_nodes, max_bins, bits, exponent=k, out=want)
    want = want[:n_nodes]
    q = FX.quantise(ghT, k)
    if case == "running_slab":
        # Two chunks into one slab given no pass exponent: each at the
        # slab's own, the slab rescaled before the second.
        a = torch.zeros((n_nodes + 1, f, max_bins, 2), dtype=torch.int64)
        b = a.clone()
        ks = []
        for lo, hi in ((0, n // 2 // spw * spw), (n // 2 // spw * spw, n)):
            ka = FX.running_exponent(a, ghT[lo:hi])
            ref.histogram_fixed_ref(_pack(bins[lo:hi], bits), ghT[lo:hi], posT[lo:hi], n_nodes,
                                    max_bins, bits, exponent=ka, out=a)
            kb = FX.running_exponent(b, ghT[lo:hi])
            assert torch.equal(ka, kb)
            b[:n_nodes] += _by_blocks(rng, bins_t[lo:hi], FX.quantise(ghT[lo:hi], kb),
                                      posT[lo:hi].long(), n_nodes, max_bins, spw, groups)
            ks.append(int(kb))
        assert ks[1] < ks[0]  # the slab was rescaled for the second chunk
        assert torch.equal(a[:n_nodes], b[:n_nodes])
        return
    if case == "chunk_stack_100003":
        stack = _stack(bins, bits, ODD_CHUNK)
        sym, row, real = _stack_symbols(stack, bins_t, ghT, posT, bits, ODD_CHUNK)
        node = torch.where(real, posT.long()[row], -1)
        got = _by_blocks(rng, sym, torch.where(real[:, None], q[row], 0), node, n_nodes,
                         max_bins, spw, groups)
        assert torch.equal(FX.dequantise(got, k), ref.histogram_chunked_fixed_ref(
            stack, ghT, posT, n_nodes, max_bins, bits, ODD_CHUNK))
    else:
        got = _by_blocks(rng, bins_t, q, posT.long(), n_nodes, max_bins, spw, groups)
    assert torch.equal(got, want)
    plain = ref.histogram_fixed_ref(packed, ghT, posT, n_nodes, max_bins, bits)
    if case == "nonfinite":
        assert int(k) == FX.NONFINITE and not bool(got.any())
        assert bool(torch.isnan(FX.dequantise(got, k)).all() and torch.isnan(plain).all())
    else:
        assert torch.equal(FX.dequantise(got, k), plain)
    if case == "empty_node":
        assert not bool(got[2].any())
    if case == "all_missing_feature":
        assert not bool(got[:, 1, :-1].any()) and bool(got[:, 1, -1].any())


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("case", MISSING_CASES)
def test_rows_kernel_missing_bin_is_totals_less_bins(rng, case, groups):
    """The row-id kernel's arithmetic: a compacted buffer's slots cut into
    arbitrary blocks, each adding its slots' non-missing bins and its node
    totals less them (dump and padding slots in neither), sum to
    `histogram_rows_fixed_ref`'s int64 accumulator bit for bit, flat or over
    the chunk stack's global row ids, into a fresh or a running slab."""
    bins, gh, pos, n_nodes, max_bins, bits = _missing_case(rng, case)
    n, f = bins.shape
    ghT, bins_t = torch.from_numpy(gh), torch.from_numpy(bins)
    rid, sel = _buffer(rng, n, n_nodes, pos)
    ridT, selT = torch.from_numpy(rid), torch.from_numpy(sel)
    gh_sel = ghT[np.minimum(rid, n - 1)]
    if case == "nonfinite":  # a slot's own (g, h), whichever rows were selected
        gh_sel[5, 1] = np.nan
    packed = _pack(bins, bits)
    k = FX.exponent(gh_sel)
    slot_bins = bins_t[ridT.long().clamp(max=n - 1)]
    node = torch.where(ridT < n, selT.long(), n_nodes)
    want = torch.zeros((n_nodes + 1, f, max_bins, 2), dtype=torch.int64)
    ref.histogram_rows_fixed_ref(packed, gh_sel, selT, ridT, n_nodes, max_bins, bits,
                                 exponent=k, out=want)
    want = want[:n_nodes]
    if case == "running_slab":
        a = torch.zeros((n_nodes + 1, f, max_bins, 2), dtype=torch.int64)
        b = a.clone()
        half = rid.shape[0] // 2
        for lo, hi in ((0, half), (half, rid.shape[0])):
            ka = FX.running_exponent(a, gh_sel[lo:hi])
            ref.histogram_rows_fixed_ref(packed, gh_sel[lo:hi], selT[lo:hi], ridT[lo:hi],
                                         n_nodes, max_bins, bits, exponent=ka, out=a)
            kb = FX.running_exponent(b, gh_sel[lo:hi])
            b[:n_nodes] += _by_blocks(rng, slot_bins[lo:hi], FX.quantise(gh_sel[lo:hi], kb),
                                      node[lo:hi], n_nodes, max_bins, 1, groups)
        assert torch.equal(a[:n_nodes], b[:n_nodes])
        return
    got = _by_blocks(rng, slot_bins, FX.quantise(gh_sel, k), node, n_nodes, max_bins, 1, groups)
    assert torch.equal(got, want)
    plain = ref.histogram_rows_fixed_ref(packed, gh_sel, selT, ridT, n_nodes, max_bins, bits)
    if case == "chunk_stack_100003":
        assert torch.equal(plain, ref.histogram_rows_chunked_fixed_ref(
            _stack(bins, bits, ODD_CHUNK), gh_sel, selT, ridT, n_nodes, max_bins, bits,
            ODD_CHUNK))
    if case == "nonfinite":
        assert int(k) == FX.NONFINITE and not bool(got.any())
        assert bool(torch.isnan(FX.dequantise(got, k)).all() and torch.isnan(plain).all())
    else:
        assert torch.equal(FX.dequantise(got, k), plain)


def _exponent_by_bits(gh: torch.Tensor) -> int:
    """The exponent kernel's arithmetic (csrc/histogram.cu exponent_of) in
    plain integers: the largest |g| or |h| as the bits of a non-negative
    float32, frexp's exponent read from those bits, then k."""
    bits = gh.contiguous().view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    top = int(bits.max()) if bits.numel() else 0
    if top >= 0x7F800000:
        return FX.NONFINITE
    e = 0 if top == 0 else top.bit_length() - 149 if top < 0x00800000 else (top >> 23) - 126
    n = gh.shape[0]
    return min(max(62 - ((n - 1).bit_length() if n > 1 else 0) - e, -1022), 1022)


@pytest.mark.parametrize("edge", sorted(EXPONENT_EDGES))
def test_exponent_kernel_contract_is_fixed_exponent(rng, edge):
    """The exponent kernel's arithmetic on the bits gives `fixed.exponent`
    (its plain version) on each edge input, alone and beside 300,001 normal
    rows, whose maximum the edge value may or may not exceed."""
    for gh in (EXPONENT_EDGES[edge],
               np.concatenate([rng.normal(size=(300_001, 2)).astype(np.float32),
                               EXPONENT_EDGES[edge]])):
        ghT = torch.from_numpy(np.ascontiguousarray(gh))
        assert _exponent_by_bits(ghT) == int(FX.exponent(ghT)), edge


# --- whole fits in the card's arithmetic -------------------------------------------

@pytest.fixture(scope="module")
def data():
    """test_torch_booster.py's fixture (seed 5): 2000 x 6, 5% missing, a
    binary target; 300 new rows."""
    rng = np.random.default_rng(5)
    n, f = 2000, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    y = (z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3] > 0).astype(np.float32)
    x_new = rng.normal(size=(300, f)).astype(np.float32)
    x_new[rng.random(x_new.shape) < 0.1] = np.nan
    jd = JDMatrix(x, label=y, max_bins=32)
    return x, y, x_new, jd


KW = dict(n_rounds=4, max_depth=4, max_bins=32, objective="binary:logistic")


def _same(a: Booster, b: Booster, x_new) -> None:
    for fld in ENSEMBLE_FIELDS:
        assert torch.equal(getattr(a.ensemble, fld), getattr(b.ensemble, fld)), fld
    assert torch.equal(a.margins, b.margins)
    assert torch.equal(a.predict(x_new), b.predict(x_new))


def _matrix(data):
    x, y, _, jd = data
    return DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts), device="cpu")


def test_fixed_point_fits_are_one_function_of_their_rows(data, fixed_point, monkeypatch):
    """Twice the same fit; the chunked (resident) and the streamed fit at 333
    and 500 rows a chunk, prefetch 2, equal to the flat fit; the dense fit
    equal to the packed one, on both growths. The fits quantise."""
    x, y, x_new, _ = data
    calls = []
    quantise = FX.quantise
    monkeypatch.setattr(FX, "quantise", lambda gh, k: calls.append(1) or quantise(gh, k))
    d = _matrix(data)
    flat = Booster(**KW).fit(d)
    assert calls
    _same(flat, Booster(**KW).fit(d), x_new)
    for chunk_rows in CHUNKS:
        for paging in ("resident", "stream"):
            e = ExternalDMatrix.from_arrays(x, y, chunk_rows=chunk_rows, ref=d, paging=paging,
                                            prefetch_chunks=2)
            _same(flat, Booster(**KW).fit(e), x_new)
    _same(flat, Booster(**KW, compress_matrix=False).fit(d), x_new)
    kernel = Booster(**KW, use_kernel_histograms=True).fit(d)
    _same(kernel, Booster(**KW, use_kernel_histograms=True, compress_matrix=False).fit(d), x_new)


def test_fixed_point_update_is_one_longer_fit(data, fixed_point):
    _, _, x_new, _ = data
    d = _matrix(data)
    _same(Booster(**{**KW, "n_rounds": 2}).fit(d).update(d, 2), Booster(**KW).fit(d), x_new)


def test_fixed_point_fit_matches_reference(data, fixed_point):
    """The fit in the card's arithmetic against the reference's on its cuts:
    the same structure and thresholds, leaves and margins within the fit
    tolerance of `test_torch_booster.py`."""
    x, y, x_new, jd = data
    jb = JBooster(**KW).fit(jd)
    tb = Booster(**KW).fit(_matrix(data))
    for name in ("feature", "split_bin", "default_left", "is_leaf", "threshold"):
        np.testing.assert_array_equal(getattr(tb.ensemble, name).numpy(),
                                      np.asarray(getattr(jb.ensemble, name)), err_msg=name)
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(),
                               np.asarray(jb.ensemble.leaf_value), **FIT_TOL)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **FIT_TOL)
    np.testing.assert_allclose(tb.predict_margins(x_new).numpy(),
                               np.asarray(jb.predict_margins(x_new)), **FIT_TOL)
