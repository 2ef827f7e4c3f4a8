"""External memory in the port beside the reference's, on the CPU: the
streaming sketch, `DeviceDMatrix.from_batches`, `ExternalDMatrix`
(resident paging) with its page-in faults, the chunked histogram builders,
routing and prediction, chunked fits, `fit(on_oom="external")` and the
estimators' `chunk_rows=`.

Two kinds of check:
  * against the reference: the sketch's summaries and cuts, the host
    stack's words (as uint32) and CRCs, the error messages and the chunked
    histograms bit for bit; chunked fits within the fit tolerance of
    test_torch_booster.py (structure exact, rtol 1e-5, atol 1e-5), both
    packages on the reference's cuts and, for the sampled fits, its
    uniforms (`_torch_parity.replay_uniform`);
  * chunked against resident in the port: `torch.equal`, since the plain
    versions add in row order whatever the layout.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import ExternalDMatrix as JExternal
from repro.core import histogram as JH
from repro.core import quantile as JQ
from repro.testing import faults as JF
from repro_torch.core import Booster, DeviceDMatrix, ExternalDMatrix
from repro_torch.core import compress as TC
from repro_torch.core import histogram as TH
from repro_torch.core import quantile as TQ
from repro_torch.core import resilience as TRES
from repro_torch.core import sampling as TSMP
from repro_torch.core.predict import ENSEMBLE_FIELDS
from repro_torch.testing import faults as TF

from _torch_parity import replay_uniform

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(n_rounds=4, max_depth=4, max_bins=32, objective="binary:logistic")
STRUCTURE = ("feature", "split_bin", "default_left", "is_leaf")
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    TF.reset()
    JF.reset()
    yield
    TF.reset()
    JF.reset()


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setattr(TSMP, "uniform", replay_uniform)


@pytest.fixture(scope="module")
def data():
    """test_torch_booster.py's fixture: 2000 rows, 6 features, 5% missing,
    a binary target; 300 held-out rows."""
    rng = np.random.default_rng(5)
    n, f = 2000, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    y = (z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3] > 0).astype(np.float32)
    xv = rng.normal(size=(300, f)).astype(np.float32)
    yv = (np.nan_to_num(xv[:, 0]) - np.nan_to_num(xv[:, 3]) > 0).astype(np.float32)
    jd = JDMatrix(x, label=y, max_bins=32)
    return x, y, xv, yv, jd, np.asarray(jd.cuts)


# --- the streaming sketch ------------------------------------------------------

def _summaries_equal(a, b):
    for sa, sb in zip(a._summaries, b._summaries):
        for u, v in zip(sa, sb):
            np.testing.assert_array_equal(u, v)
    assert a.n_pushed == b.n_pushed


@pytest.mark.parametrize("capacity", [8, 16, 1024])
def test_sketch_push_merge_and_cuts_bit_for_bit(capacity):
    """push (with weights), push_sorted and merge, pruned at small
    capacities: the same summaries and the same cuts as the reference's."""
    rng = np.random.default_rng(capacity)
    chunks = [rng.normal(size=(300, 4)).astype(np.float32) for _ in range(3)]
    chunks[1][rng.random((300, 4)) < 0.1] = np.nan
    chunks[2][:, 3] = np.round(chunks[2][:, 3])  # ties
    w = rng.random(300) + 0.5
    mine = TQ.StreamingQuantileSketch(4, 32, capacity=capacity)
    theirs = JQ.StreamingQuantileSketch(4, 32, capacity=capacity)
    for sk in (mine, theirs):
        sk.push(chunks[0])
        sk.push(chunks[1], weights=w)
        cols = np.sort(np.where(np.isnan(chunks[2]), np.inf, chunks[2]), axis=0)
        sk.push_sorted(cols, np.isfinite(cols).sum(axis=0))
    _summaries_equal(mine, theirs)
    other_m = TQ.StreamingQuantileSketch(4, 32, capacity=capacity).push(chunks[0][::-1])
    other_t = JQ.StreamingQuantileSketch(4, 32, capacity=capacity).push(chunks[0][::-1])
    mine.merge(other_m)
    theirs.merge(other_t)
    _summaries_equal(mine, theirs)
    assert mine.n_valid(1) == theirs.n_valid(1)
    got = mine.get_cuts("cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(theirs.get_cuts()))
    with pytest.raises(ValueError, match="capacity"):
        TQ.StreamingQuantileSketch(4, 32, capacity=4)
    with pytest.raises(ValueError, match="disagree"):
        mine.merge(TQ.StreamingQuantileSketch(5, 32))


# --- batches ---------------------------------------------------------------------

def test_from_batches_is_the_concatenated_matrix(data):
    x, y, *_ = data
    batches = [(x[:700], y[:700]), (x[700:1301], y[700:1301]), (x[1301:], y[1301:])]
    got = DeviceDMatrix.from_batches(iter(batches), max_bins=32, **CPU)
    want = DeviceDMatrix(x, label=y, max_bins=32, **CPU)
    assert torch.equal(got.matrix.packed, want.matrix.packed)
    assert torch.equal(got.cuts, want.cuts) and torch.equal(got.label, want.label)
    assert got.bits == want.bits and got.n_rows == want.n_rows


@pytest.mark.parametrize("bad", ["features", "label", "empty", "inf", "dtype", "none"])
def test_batch_validation_messages_are_the_reference_s(data, bad):
    x, y, *_ = data
    batches = {
        "features": [x[:10], x[10:20, :4]],
        "label": [(x[:10], y[:10]), x[10:20]],
        "empty": [x[:0]],
        "inf": [np.where(np.arange(6) == 2, np.inf, x[:3])],
        "dtype": [x[:10], x[10:20].astype(np.float64)],
        "none": [],
    }[bad]
    with pytest.raises(ValueError) as theirs:
        JDMatrix.from_batches(iter(batches), max_bins=32)
    with pytest.raises(ValueError) as mine:
        DeviceDMatrix.from_batches(iter(batches), max_bins=32, **CPU)
    assert str(mine.value) == str(theirs.value)


# --- the host stack ------------------------------------------------------------

@pytest.mark.parametrize("cuts", ["shared", "sketch"])
@pytest.mark.parametrize("chunk_rows", [512, 333])
def test_host_stack_bits_and_crcs_are_the_reference_s(data, chunk_rows, cuts):
    """The same chunks (batches of other sizes, re-chunked) packed into the
    same uint32 stack: the port's stack seen as uint32 is the reference's
    `_host_packed`, and the CRCs are equal ints. The sketch's cuts (each
    chunk's columns sorted by torch here, by numpy there) are equal too."""
    x, y, _, _, _, jcuts = data
    batches = [(x[:100], y[:100]), (x[100:1250], y[100:1250]), (x[1250:], y[1250:])]
    kw = dict(chunk_rows=chunk_rows, max_bins=32)
    if cuts == "shared":
        kw["cuts"] = jcuts
    mine = ExternalDMatrix(iter(batches), **kw, **CPU)
    theirs = JExternal(iter(batches), **kw)
    np.testing.assert_array_equal(mine.cuts.numpy(), np.asarray(theirs.cuts))
    assert mine._host_packed.dtype == np.uint32
    np.testing.assert_array_equal(mine._host_packed, np.asarray(theirs._host_packed))
    assert mine._chunk_crcs == tuple(theirs._chunk_crcs)
    assert (mine.n_chunks, mine.n_features, mine.bits, mine.nbytes_host) == (
        theirs.n_chunks, theirs.n_features, theirs.bits, theirs.nbytes_host)
    assert mine.nbytes_device == 0
    cpb = mine.packed_bins()
    assert mine.nbytes_device == mine.nbytes_host
    assert isinstance(cpb, TC.ChunkedPackedBins)
    assert cpb.packed.dtype == torch.int32 and cpb.words_per_chunk == mine._host_packed.shape[2]
    np.testing.assert_array_equal(cpb.packed.numpy().view(np.uint32), mine._host_packed)
    mine.unload()
    assert mine.nbytes_device == 0


def test_from_dmatrix_rechunk_and_from_arrays(data):
    """from_dmatrix (bins recovered on the host, a chunk at a time), rechunk
    and from_arrays give the stack the reference's give, and the bins of
    the in-memory matrix."""
    x, y, _, _, jd, jcuts = data
    d = DeviceDMatrix(x, label=y, max_bins=32, cuts=jcuts, **CPU)
    for chunk_rows in (500, 777, 2000):
        mine = ExternalDMatrix.from_dmatrix(d, chunk_rows=chunk_rows)
        theirs = JExternal.from_dmatrix(jd, chunk_rows=chunk_rows)
        np.testing.assert_array_equal(mine._host_packed, np.asarray(theirs._host_packed))
        assert torch.equal(mine._decode_host_bins(), d.matrix.unpack())
        assert mine.label.data_ptr() == d.label.data_ptr() and mine.cuts is d.cuts
    again = mine.rechunk(300)
    np.testing.assert_array_equal(again._host_packed,
                                  np.asarray(theirs.rechunk(300)._host_packed))
    arrays = ExternalDMatrix.from_arrays(x, y, chunk_rows=300, max_bins=32, cuts=jcuts, **CPU)
    np.testing.assert_array_equal(arrays._host_packed, again._host_packed)
    with pytest.raises(ValueError, match="chunk_rows"):
        ExternalDMatrix.from_dmatrix(d, chunk_rows=0)


def test_unported_paging_and_sharded_sketch_raise(data):
    x, y, *_ = data
    # Streamed paging is ported (test_torch_stream.py): it trains.
    st = ExternalDMatrix.from_arrays(x, y, chunk_rows=500, paging="stream", max_bins=32,
                                     **CPU)
    assert st.resolved_paging() == "stream"
    assert Booster(**KW).fit(st).n_rounds_trained == KW["n_rounds"] and st.nbytes_device == 0
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        ExternalDMatrix.from_arrays(x, y, chunk_rows=500, sketch_shards=2, **CPU)
    # One chunk makes one shard: the sequential sketch, as in the reference.
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=2000, sketch_shards=8,
                                    paging="auto", max_bins=32, **CPU)
    assert e.resolved_paging() == "resident"
    with pytest.raises(ValueError, match="paging"):
        ExternalDMatrix.from_arrays(x, y, chunk_rows=500, paging="disk", **CPU)
    with pytest.raises(NotImplementedError, match="use_kernel_histograms"):
        Booster(**KW, use_kernel_histograms=True).fit(e)


# --- page-in faults --------------------------------------------------------------

def _page_in_outcome(E, F, x, y, arm, **kw):
    """(error message or None, warnings' messages, spec.fired) of one
    packed_bins() with `arm` = (site, arm keywords)."""
    e = E.from_arrays(x, y, chunk_rows=500, max_bins=32, load_backoff=0.0,
                      **kw)
    site, akw = arm
    with warnings.catch_warnings(record=True) as seen, F.inject(site, **akw) as spec:
        warnings.simplefilter("always")
        try:
            e.packed_bins()
            err = None
        except Exception as exc:
            err = f"{type(exc).__name__}: {exc}"
    return err, [str(w.message) for w in seen], spec.fired


@pytest.mark.parametrize("case", ["corrupt_once", "corrupt_always", "load_twice",
                                  "load_always", "verify_never"])
def test_page_in_faults_match_the_reference(data, case):
    """chunk_corrupt once: the retry succeeds, with a warning; always: a
    ChunkIntegrityError naming the chunk; chunk_load twice: two retries;
    always: the load error; verify_chunks="never": no crc. Messages equal
    the reference's."""
    x, y, _, _, _, jcuts = data
    arm = {
        "corrupt_once": ("chunk_corrupt", dict(times=1, chunk=2, index=5, bit=3)),
        "corrupt_always": ("chunk_corrupt", dict(times=None, chunk=1, index=7, bit=3)),
        "load_twice": ("chunk_load", dict(error=None, times=2)),
        "load_always": ("chunk_load", dict(error=None, times=None)),
        "verify_never": ("chunk_corrupt", dict(times=None, chunk=0)),
    }[case]
    kw = {"verify_chunks": False} if case == "verify_never" else {}
    site, akw = arm
    out = []
    for E, F, extra in ((JExternal, JF, {}), (ExternalDMatrix, TF, CPU)):
        a = dict(akw)
        if site == "chunk_load":
            a["error"] = F.TransientLoadError
        out.append(_page_in_outcome(E, F, x, y, (site, a), cuts=jcuts, **kw, **extra))
    assert out[0] == out[1]
    err, seen, fired = out[1]
    if case == "corrupt_always":
        assert "ChunkIntegrityError" in err and "chunk(s) [1]" in err
    elif case == "load_always":
        assert "TransientLoadError" in err
    else:
        assert err is None
    if case in ("corrupt_once", "load_twice"):
        assert fired == len(seen) == akw["times"] and "retry" in seen[0]


def test_iter_device_chunks_and_pager(data):
    """Chunks one at a time, through the prefetching worker or
    synchronously, equal the stack's; a corrupted chunk's error crosses the
    worker thread."""
    x, y, _, _, _, jcuts = data
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=300, max_bins=32, cuts=jcuts, **CPU)
    stack = torch.from_numpy(e._host_packed.view(np.int32))
    for prefetch in (0, 2):
        got = [c for _, c in e.chunk_pager(prefetch=prefetch)]
        assert len(got) == e.n_chunks
        assert all(torch.equal(g, stack[i]) for i, g in enumerate(got))
    assert e.nbytes_device == 0
    bad = ExternalDMatrix.from_arrays(x, y, chunk_rows=300, max_bins=32, cuts=jcuts,
                                      load_retries=0, **CPU)
    with TF.inject("chunk_corrupt", times=None, index=3):
        with pytest.raises(TRES.ChunkIntegrityError, match="chunk 0"):
            list(bad.iter_device_chunks())


# --- the chunked builders -----------------------------------------------------

@pytest.mark.parametrize("chunk_rows", [256, 300, 1999])
def test_chunked_histograms_match_the_reference(data, chunk_rows):
    """build_histograms_chunked(_rows) against the reference's on the same
    stack (chunk_rows a multiple of the symbols a word, 256, and not),
    exact on dyadic (g, h), and equal to the flat builders on the same
    rows."""
    x, y, _, _, jd, jcuts = data
    rng = np.random.default_rng(chunk_rows)
    n = x.shape[0]
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=chunk_rows, max_bins=32, cuts=jcuts, **CPU)
    je = JExternal.from_arrays(x, y, chunk_rows=chunk_rows, max_bins=32, cuts=jcuts)
    d = DeviceDMatrix(x, label=y, max_bins=32, cuts=jcuts, **CPU)
    stack, jstack = e.packed_bins().packed, je.packed_bins().packed
    gh = np.stack([rng.integers(-8, 9, n) / 4, rng.integers(0, 5, n) / 4], 1).astype(np.float32)
    pos = rng.integers(0, 9, n).astype(np.int32)  # 8 nodes, 8 = inactive
    got = TH.build_histograms_chunked(stack, torch.from_numpy(gh), torch.from_numpy(pos), 8,
                                      32, e.bits, chunk_rows, n)
    want = JH.build_histograms_chunked(jstack, gh, pos, 8, 32, e.bits, chunk_rows, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = TH.build_histograms_packed(d.matrix.packed, torch.from_numpy(gh),
                                      torch.from_numpy(pos), 8, 32, d.bits)
    assert torch.equal(got, flat)
    m = n // 2
    rid = np.concatenate([np.sort(rng.choice(n, m - 40, replace=False)),
                          np.full(40, n)]).astype(np.int32)
    pos_sel = rng.integers(0, 4, m).astype(np.int32)
    pos_sel[m - 40:] = 4
    got = TH.build_histograms_chunked_rows(stack, torch.from_numpy(gh[np.minimum(rid, n - 1)]),
                                           torch.from_numpy(pos_sel), torch.from_numpy(rid),
                                           4, 32, e.bits, chunk_rows)
    want = JH.build_histograms_chunked_rows(jstack, gh[np.minimum(rid, n - 1)], pos_sel, rid,
                                            4, 32, e.bits, chunk_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- fits -----------------------------------------------------------------------

FITS = {
    "default": {},
    "lossguide": {"growth": "lossguide", "max_leaves": 6},
    "subsample": {"subsample": 0.5, "seed": 11},
    "goss": {"sampling_method": "goss", "seed": 11},
}


def _fit_pair(data, knobs, chunk_rows=333):
    x, y, _, _, _, jcuts = data
    kw = dict(KW, **knobs)
    je = JExternal.from_arrays(x, y, chunk_rows=chunk_rows, max_bins=32, cuts=jcuts)
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=chunk_rows, max_bins=32, cuts=jcuts,
                                    **CPU)
    return JBooster(**kw).fit(je), Booster(**kw).fit(e), e


@pytest.mark.parametrize("name", list(FITS))
def test_chunked_fit_matches_the_reference_s(replay, data, name):
    x, *_ = data
    jb, tb, e = _fit_pair(data, FITS[name])
    for f in STRUCTURE:
        np.testing.assert_array_equal(getattr(tb.ensemble, f).numpy(),
                                      np.asarray(getattr(jb.ensemble, f)), err_msg=f)
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(),
                               np.asarray(jb.ensemble.leaf_value), **TOL)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **TOL)
    np.testing.assert_allclose(tb.predict_margins(e).numpy(),
                               np.asarray(jb.predict_margins(x)), **TOL)


@pytest.mark.parametrize("name", list(FITS))
@pytest.mark.parametrize("chunk_rows", [512, 333])
def test_chunked_fit_is_the_resident_fit_bit_for_bit(data, name, chunk_rows):
    """On the CPU the chunked fit is torch.equal to the in-memory fit on the
    same cuts (every field of every tree, the margins, the predictions),
    with an ExternalDMatrix eval set beside a DeviceDMatrix one."""
    x, y, xv, yv, _, jcuts = data
    kw = dict(KW, **FITS[name])
    d = DeviceDMatrix(x, label=y, max_bins=32, cuts=jcuts, **CPU)
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=chunk_rows, ref=d)
    flat = Booster(**kw).fit(d, evals=[(DeviceDMatrix(xv, label=yv, ref=d), "v")])
    ev = ExternalDMatrix.from_arrays(xv, yv, chunk_rows=100, ref=d)
    chunked = Booster(**kw).fit(e, evals=[(ev, "v")])
    for f in ENSEMBLE_FIELDS:
        assert torch.equal(getattr(flat.ensemble, f), getattr(chunked.ensemble, f)), f
    assert torch.equal(flat.margins, chunked.margins)
    assert flat.history == chunked.history
    assert torch.equal(chunked.predict_margins(e), flat.predict_margins(d))
    assert torch.equal(chunked.predict(x), flat.predict(x))
    assert chunked.eval(ev, "v") == flat.eval(DeviceDMatrix(xv, label=yv, ref=d), "v")


def test_chunked_update_and_early_stopping(data):
    """update on an ExternalDMatrix continues from its cached margins (and
    from predicted margins on another matrix of the same rows), bit for
    bit the in-memory update; early stopping with an external eval set
    truncates as the in-memory fit does."""
    x, y, xv, yv, _, jcuts = data
    d = DeviceDMatrix(x, label=y, max_bins=32, cuts=jcuts, **CPU)
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=400, ref=d)
    a = Booster(**KW).fit(d).update(d, 3)
    b = Booster(**KW).fit(e).update(e, 3)
    c = Booster(**KW).fit(d).update(e, 3)  # margins predicted on the chunks
    for f in STRUCTURE + ("leaf_value",):
        assert torch.equal(getattr(a.ensemble, f), getattr(b.ensemble, f))
        assert torch.equal(getattr(a.ensemble, f), getattr(c.ensemble, f))
    kw = dict(KW, n_rounds=30, learning_rate=1.0, max_depth=5)
    es = dict(eval_metric="logloss", early_stopping_rounds=3)
    fa = Booster(**kw).fit(d, evals=[(DeviceDMatrix(xv, label=yv, ref=d), "v")], **es)
    fb = Booster(**kw).fit(e, evals=[(ExternalDMatrix.from_arrays(xv, yv, chunk_rows=64,
                                                                  ref=d), "v")], **es)
    assert fa.best_iteration == fb.best_iteration and fa.n_rounds_trained < 30
    assert torch.equal(fa.ensemble.leaf_value, fb.ensemble.leaf_value)


def test_both_packed_layouts_answer_alike(data):
    """PackedBins and the chunk stack of the same rows give the same bins
    (all rows, and a buffer's row ids), the same level histogram and the
    same row-buffer histogram: growth and traversal call these and never
    ask which layout they read."""
    x, y, _, _, _, jcuts = data
    d = DeviceDMatrix(x, label=y, max_bins=32, cuts=jcuts, **CPU)
    flat = d.packed_bins()
    g = torch.Generator().manual_seed(0)
    n, f = d.n_rows, d.n_features
    feat = torch.randint(0, f, (n,), generator=g)
    rid = torch.randperm(n, generator=g)[:700]
    gh = torch.randn((n, 2), generator=g)
    pos = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32)  # 4 = inactive
    for chunk_rows in (512, 333):
        st = ExternalDMatrix.from_arrays(x, y, chunk_rows=chunk_rows, ref=d).packed_bins()
        assert (st.n_rows, st.n_features) == (flat.n_rows, flat.n_features)
        assert torch.equal(st.feature_bins(feat), flat.feature_bins(feat))
        assert torch.equal(st.feature_bins(feat[:700], rid), flat.feature_bins(feat[:700], rid))
        assert torch.equal(st.histograms(gh, pos, 4, 32), flat.histograms(gh, pos, 4, 32))
        sel = pos[rid]
        assert torch.equal(st.histograms_rows(gh[rid], sel, rid.to(torch.int32), 4, 32),
                           flat.histograms_rows(gh[rid], sel, rid.to(torch.int32), 4, 32))


def test_predicted_margins_do_not_depend_on_the_rows_in_the_call(data):
    """Bin-space margins add each class's trees in tree order, so a row's
    margin is the same whichever rows share the call: a 3-class model's
    margins on row ranges are the whole matrix's rows, fold_classes of all
    leaves equals the per-tree sum, and predict on an ExternalDMatrix
    (one chunk's margins at a time) is bit for bit the flat predict."""
    from repro_torch.core import predict as TPR

    x, _, _, _, _, jcuts = data
    y3 = (np.nan_to_num(x[:, 0]) > 0).astype(np.float32) + (np.nan_to_num(x[:, 1]) > 0.5)
    d = DeviceDMatrix(x, label=y3, max_bins=32, cuts=jcuts, **CPU)
    b = Booster(**dict(KW, objective="multi:softmax", n_classes=3)).fit(d)
    ens, mb, depth = b.ensemble, 31, KW["max_depth"]
    whole = TPR.predict_binned_on(ens, d.packed_bins(), mb, depth)
    for lo, hi in ((0, 1), (0, 333), (333, 1200), (1999, 2000)):
        part = DeviceDMatrix(x[lo:hi], ref=d)
        assert torch.equal(TPR.predict_binned_on(ens, part.packed_bins(), mb, depth),
                           whole[lo:hi])
    pb = d.packed_bins()
    leaves = TPR.traverse_trees_on(pb, ens.feature, ens.split_bin, ens.default_left,
                                   ens.leaf_value, ens.is_leaf, mb, depth)
    assert torch.equal(TPR.fold_classes(leaves, ens), whole)
    e = ExternalDMatrix.from_arrays(x, y3, chunk_rows=333, ref=d)
    assert torch.equal(b.predict_margins(e), b.predict_margins(d))


# --- OOM fallback and estimators -------------------------------------------------

def test_on_oom_external_matches_the_reference(data):
    """The oom site armed once: one oom_fallback event at n_rows // 2, as in
    the reference, and the fit completes through the chunk stack, bit for
    bit the in-memory fit; armed twice, the chunks halve again. Without
    on_oom the fit raises SimulatedOOM."""
    x, y, _, _, jd, jcuts = data
    d = DeviceDMatrix(x, label=y, max_bins=32, cuts=jcuts, **CPU)
    base = Booster(**KW).fit(d)
    for times in (1, 2):
        events = []
        for B, F, m in ((JBooster, JF, jd), (Booster, TF, d)):
            with F.inject("oom", error=F.SimulatedOOM, times=times), \
                    pytest.warns(UserWarning, match="on_oom='external'"):
                b = B(**KW).fit(m, on_oom="external")
            events.append(b.resilience_events)
        assert events[0] == events[1]
        assert [ev["chunk_rows"] for ev in events[1]] == [1000, 500][:times]
        assert torch.equal(b.ensemble.leaf_value, base.ensemble.leaf_value)
        assert b.n_rounds_trained == KW["n_rounds"]
    with TF.inject("oom", error=TF.SimulatedOOM), pytest.raises(TF.SimulatedOOM):
        Booster(**KW).fit(d)


def test_oom_fallback_unloads_the_failed_stack(data):
    """An OOM in a fit on an ExternalDMatrix: the fallback pages the failed
    matrix's stack out before it re-chunks, so one stack at a time sits on
    the device, and the retry trains at half the chunk rows."""
    x, y, _, _, _, jcuts = data
    e = ExternalDMatrix.from_arrays(x, y, chunk_rows=800, max_bins=32, cuts=jcuts, **CPU)
    with TF.inject("oom", error=TF.SimulatedOOM, times=1), \
            pytest.warns(UserWarning, match="on_oom='external'"):
        b = Booster(**KW).fit(e, on_oom="external")
    assert e.nbytes_device == 0
    assert [ev["chunk_rows"] for ev in b.resilience_events] == [400]
    assert b.n_rounds_trained == KW["n_rounds"]


def test_estimators_with_chunk_rows(data):
    """XGBRegressor and XGBRanker fit through ExternalDMatrix.from_arrays;
    on the reference's cuts (its sketch's, equal to the port's) their
    predictions agree with the reference estimators' within the fit
    tolerance."""
    from repro.sklearn import XGBRanker as JRanker
    from repro.sklearn import XGBRegressor as JRegressor
    from repro_torch.sklearn import XGBRanker, XGBRegressor

    x, y, *_ = data
    target = np.nan_to_num(x[:, 0]) * 2 + np.nan_to_num(x[:, 1])
    kw = dict(n_estimators=4, max_depth=3, max_bins=32, chunk_rows=300)
    mine = XGBRegressor(**kw, **CPU).fit(x, target)
    theirs = JRegressor(**kw).fit(x, target)
    np.testing.assert_allclose(mine.predict(x), np.asarray(theirs.predict(x)), **TOL)
    qid = np.repeat(np.arange(100), 20)
    mine = XGBRanker(**kw, **CPU).fit(x, y, qid=qid)
    theirs = JRanker(**kw).fit(x, y, qid=qid)
    np.testing.assert_allclose(mine.predict(x), np.asarray(theirs.predict(x)), **TOL)
