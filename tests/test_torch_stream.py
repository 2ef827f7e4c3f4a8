"""Streamed external memory in the port (`paging="stream"`, `core/stream.py`)
beside the resident and the in-memory fit and beside the reference's, on
the CPU.

Two kinds of check:
  * streamed against resident and flat in the port: `torch.equal` (trees,
    margins, predictions), at `prefetch_chunks` 2 and 0 and two chunk sizes,
    since the plain versions add each histogram slot's terms in row order
    whichever way the rows arrive;
  * against the reference: its streamed fit in structure, with floats
    within the external fits' tolerance (ROADMAP queue 3 item 7: rtol 1e-5,
    atol 1e-5; both packages on the reference's cuts and uniforms,
    `_torch_parity.replay_uniform`), its counters `rows_touched` and
    `chunks_paged` equal; its per-chunk histogram units bit for bit on
    dyadic (g, h); its chunked traversals; its page-in messages.
"""
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import ExternalDMatrix as JExternal
from repro.core import histogram as JH
from repro.core import predict as JPR
from repro.serve import traversal as JTV
from repro.testing import faults as JF
from repro_torch.core import Booster, DeviceDMatrix, ExternalDMatrix
from repro_torch.core import histogram as TH
from repro_torch.core import resilience as TRES
from repro_torch.core import sampling as TSMP
from repro_torch.core.dmatrix import ChunkPager
from repro_torch.core.predict import ENSEMBLE_FIELDS
from repro_torch.serve import traversal as TV
from repro_torch.testing import faults as TF

from _torch_parity import replay_uniform

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(n_rounds=4, max_depth=4, max_bins=32, objective="binary:logistic")
STRUCTURE = ("feature", "split_bin", "default_left", "is_leaf")
CHUNKS = (333, 500)
FITS = {
    "default": {},
    "lossguide": {"growth": "lossguide", "max_leaves": 6},
    "multiclass": {"objective": "multi:softmax", "n_classes": 3, "max_depth": 3},
    "subsample": {"subsample": 0.6, "colsample_bytree": 0.8, "seed": 3},
    "goss": {"sampling_method": "goss", "seed": 11},
}


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    TF.reset()
    JF.reset()
    yield
    TF.reset()
    JF.reset()


@pytest.fixture(scope="module")
def data():
    """test_torch_external.py's rows: 2000 x 6, 5% missing, a binary and a
    3-class target; 300 held-out rows; the flat CPU matrix (the reference's
    cuts)."""
    rng = np.random.default_rng(5)
    n, f = 2000, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    y = (z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3] > 0).astype(np.float32)
    y3 = (z[:, 0] > 0).astype(np.float32) + (z[:, 1] > 0.5)
    xv = rng.normal(size=(300, f)).astype(np.float32)
    yv = (np.nan_to_num(xv[:, 0]) - np.nan_to_num(xv[:, 3]) > 0).astype(np.float32)
    d = DeviceDMatrix(x, label=y, max_bins=32, device="cpu")
    return x, y, y3, xv, yv, d


def _ext(x, y, d, paging="stream", chunk_rows=500, prefetch=2, **kw):
    return ExternalDMatrix.from_arrays(x, y, chunk_rows=chunk_rows, ref=d, paging=paging,
                                       prefetch_chunks=prefetch, **kw)


def _assert_same(a: Booster, b: Booster) -> None:
    for f in ENSEMBLE_FIELDS:
        assert torch.equal(getattr(a.ensemble, f), getattr(b.ensemble, f)), f
    assert torch.equal(a.margins, b.margins)


# --- streamed = resident = flat ----------------------------------------------------

@pytest.mark.parametrize("prefetch", [2, 0])
@pytest.mark.parametrize("name", list(FITS))
def test_streamed_fit_is_resident_and_flat_bit_for_bit(data, name, prefetch):
    """Trees, margins and predictions torch.equal at two chunk sizes (333:
    chunks whose words do not line up with the flat words, a short last
    chunk), with the prefetching worker on and off; the stack never on the
    device, after the fit and after predict."""
    x, y, y3, *_, d = data
    kw = dict(KW, **FITS[name])
    lab = y3 if name == "multiclass" else y
    dm = DeviceDMatrix(x, label=lab, ref=d)
    flat = Booster(**kw).fit(dm)
    for chunk_rows in CHUNKS:
        res = Booster(**kw).fit(_ext(x, lab, d, "resident", chunk_rows))
        e = _ext(x, lab, d, "stream", chunk_rows, prefetch)
        assert e.resolved_paging() == "stream"
        got = Booster(**kw).fit(e)
        assert e.nbytes_device == 0
        _assert_same(flat, got)
        _assert_same(res, got)
        assert torch.equal(got.predict(x), flat.predict(x))
        assert torch.equal(got.predict_margins(e), flat.predict_margins(dm))
        assert e.nbytes_device == 0
        st = e.stream_stats
        assert st.chunks_paged > 0 and st.rows_touched > 0 and st.device_slots == 0


def test_streamed_fit_matches_the_reference_s(data):
    """The default fit (the root in full, the subtraction trick's row
    buffers below, their padding slots dropped from the segments) on the
    reference's cuts: structure equal, floats within the external
    tolerance, and the counters equal the reference's integers."""
    x, y, *_, d = data
    kw = dict(KW, max_depth=3)
    je = JExternal.from_arrays(x, y, chunk_rows=500, max_bins=32, cuts=d.cuts.numpy(),
                               paging="stream")
    e = _ext(x, y, d)
    jb, tb = JBooster(**kw).fit(je), Booster(**kw).fit(e)
    for f in STRUCTURE:
        np.testing.assert_array_equal(getattr(tb.ensemble, f).numpy(),
                                      np.asarray(getattr(jb.ensemble, f)), err_msg=f)
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(),
                               np.asarray(jb.ensemble.leaf_value), **TOL)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **TOL)
    assert (e.stream_stats.rows_touched, e.stream_stats.chunks_paged) == (
        je.stream_stats.rows_touched, je.stream_stats.chunks_paged)


def test_sampled_row_ids_reach_the_segments_as_the_reference_s(monkeypatch, data):
    """GOSS grows over compacted rows from the root down; a padding slot of
    its subtraction buffer maps to the buffer's last row, as in the
    reference, so the segments and `rows_touched` are the reference's
    count (the whole buffer, every level) on the reference's uniforms."""
    monkeypatch.setattr(TSMP, "uniform", replay_uniform)
    x, y, *_, d = data
    kw = dict(KW, max_depth=3, n_rounds=2, sampling_method="goss", seed=11)
    e = _ext(x, y, d)
    Booster(**kw).fit(e)
    m = round(0.2 * 2000) + round(0.1 * 2000)  # top_rate and other_rate of the rows
    assert e.stream_stats.rows_touched == kw["n_rounds"] * (m + 2 * (m // 2))


def test_chunk_update_units_match_the_reference_s(data):
    """histogram_chunk_update, histogram_rows_chunk_update and
    finalize_slab_histogram over the chunks of a stack, bit for bit the
    reference's units (dyadic (g, h): exact in any order), and equal to the
    flat builders on the same rows."""
    x, y, *_, d = data
    rng = np.random.default_rng(7)
    n, f, cr = d.n_rows, d.n_features, 333
    e = _ext(x, y, d, chunk_rows=cr)
    gh = np.stack([rng.integers(-8, 9, n) / 4, rng.integers(0, 5, n) / 4], 1).astype(np.float32)
    pos = rng.integers(0, 9, n).astype(np.int32)  # 8 nodes, 8 = inactive
    slab = TH.new_slab(8, f, 32, "cpu")
    jslab = np.zeros((f, 9 * 32, 2), np.float32)
    for i in range(e.n_chunks):
        s, t = i * cr, min((i + 1) * cr, n)
        words = e._load_chunk(i)
        TH.histogram_chunk_update(slab, words, torch.from_numpy(gh[s:t]),
                                  torch.from_numpy(pos[s:t]), 8, 32, e.bits)
        jslab = JH.histogram_chunk_update(jslab, e._host_packed[i], gh[s:t], pos[s:t], 8, 32,
                                          e.bits)
    got = TH.finalize_slab_histogram(slab, 8, 32)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JH.finalize_slab_histogram(jslab, 8, 32)))
    assert torch.equal(got, d.packed_bins().histograms(torch.from_numpy(gh),
                                                       torch.from_numpy(pos), 8, 32))
    rid = np.sort(rng.choice(n, 700, replace=False)).astype(np.int32)
    sel = rng.integers(0, 5, 700).astype(np.int32)  # 4 parents, 4 = dump
    slab = TH.new_slab(4, f, 32, "cpu")
    jflat = np.zeros((5 * f * 32, 2), np.float32)
    for i in range(e.n_chunks):
        m = (rid >= i * cr) & (rid < (i + 1) * cr)
        loc = rid[m] - i * cr
        TH.histogram_rows_chunk_update(slab, e._load_chunk(i), torch.from_numpy(gh[rid[m]]),
                                       torch.from_numpy(sel[m]), torch.from_numpy(loc), 4,
                                       32, e.bits)
        jflat = JH.histogram_rows_chunk_update(jflat, e._host_packed[i], gh[rid[m]], sel[m],
                                               loc, 4, 32, e.bits)
    got = TH.finalize_slab_histogram(slab, 4, 32)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jflat).reshape(5, f, 32, 2)[:4])
    assert torch.equal(got, d.packed_bins().histograms_rows(
        torch.from_numpy(gh[rid]), torch.from_numpy(sel), torch.from_numpy(rid), 4, 32))


# --- continuing, evaluating, resuming --------------------------------------------

def test_streamed_update_evals_and_resume(tmp_path, data):
    """update on a streamed matrix is one longer fit; a streamed eval set
    with early stopping gives the resident fit's best_iteration and
    history; checkpoint_every then resume is the uninterrupted fit."""
    x, y, _, xv, yv, d = data
    e = _ext(x, y, d)
    long = Booster(**dict(KW, n_rounds=7)).fit(e)
    short = Booster(**KW).fit(e).update(e, 3)
    _assert_same(long, short)
    again = Booster(**KW).fit(_ext(x, y, d)).update(_ext(x, y, d, chunk_rows=333), 3)
    for f in ENSEMBLE_FIELDS:  # margins predicted chunk by chunk on another stack
        assert torch.equal(getattr(long.ensemble, f), getattr(again.ensemble, f)), f

    kw = dict(KW, n_rounds=30, learning_rate=1.0, max_depth=5)
    es = dict(eval_metric="logloss", early_stopping_rounds=3)
    res = Booster(**kw).fit(_ext(x, y, d, "resident"),
                            evals=[(DeviceDMatrix(xv, label=yv, ref=d), "v")], **es)
    ev = ExternalDMatrix.from_arrays(xv, yv, chunk_rows=64, ref=d, paging="stream")
    got = Booster(**kw).fit(e, evals=[(ev, "v")], **es)
    assert got.best_iteration == res.best_iteration and got.n_rounds_trained < 30
    assert got.history == res.history
    assert torch.equal(got.ensemble.leaf_value, res.ensemble.leaf_value)
    assert ev.nbytes_device == 0 and ev.stream_stats.chunks_paged > 0

    class Killed(Exception):
        pass

    def kill(rnd, rec):
        if rnd >= 4:
            raise Killed

    path = str(tmp_path / "stream.ckpt")
    kw = dict(KW, n_rounds=7, subsample=0.7, seed=2)
    whole = Booster(**kw).fit(_ext(x, y, d))
    with pytest.raises(Killed):
        Booster(**kw).fit(_ext(x, y, d), checkpoint_every=3, checkpoint_path=path,
                          verbose_every=1, callback=kill)
    resumed = Booster.resume(path, _ext(x, y, d, prefetch=0))
    _assert_same(whole, resumed)


# --- the pager --------------------------------------------------------------------

def test_pager_slots_errors_and_break(data):
    """prefetch_chunks + 1 slots (1 at prefetch 0, never more than the
    chunks); each chunk the host's words; a loader's exception reaches the
    consumer in its chunk's turn, nothing past it is loaded; a break loads
    nothing more than the chunks issued ahead."""
    x, y, *_, d = data
    e = _ext(x, y, d, chunk_rows=300)
    stack = torch.from_numpy(e._host_packed.view(np.int32))
    for prefetch, slots in ((2, 3), (0, 1), (1, 2), (20, e.n_chunks)):
        pager = e.chunk_pager(prefetch=prefetch)
        assert pager.slots == slots and pager.device_slots == 0
        got = [(i, c.clone()) for i, c in pager]
        assert [i for i, _ in got] == list(range(e.n_chunks))
        assert all(torch.equal(c, stack[i]) for i, c in got)

    calls = []

    def load(i):
        calls.append(i)
        if i == 3:
            raise OSError("disk gone at chunk 3")
        return torch.full((2,), i)

    for depth in (2, 0):
        seen, calls[:] = [], []
        with pytest.raises(OSError, match="chunk 3"):
            for i, _ in ChunkPager(load, range(6), depth):
                seen.append(i)
        assert seen == [0, 1, 2] and calls == [0, 1, 2, 3]
        calls[:] = []
        for _ in ChunkPager(load, range(6), depth):
            break
        assert calls == list(range(depth + 1))


def test_page_in_faults_through_a_streamed_fit(data):
    """chunk_load once: one retry warning (the reference's text), the fit
    completes as without the fault; chunk_corrupt always: the reference's
    ChunkIntegrityError naming the chunk."""
    x, y, *_, d = data
    je = JExternal.from_arrays(x, y, chunk_rows=500, max_bins=32, cuts=d.cuts.numpy(),
                               load_backoff=0.0)
    base = Booster(**KW).fit(_ext(x, y, d))
    msgs = []
    for F, run in ((JF, lambda: list(je.iter_device_chunks())),
                   (TF, lambda: Booster(**KW).fit(_ext(x, y, d, load_backoff=0.0)))):
        with warnings.catch_warnings(record=True) as seen, \
                F.inject("chunk_load", error=F.TransientLoadError, times=1):
            warnings.simplefilter("always")
            out = run()
        msgs.append([str(w.message) for w in seen])
    assert msgs[0] == msgs[1] and len(msgs[1]) == 1 and "retry 1/2" in msgs[1][0]
    _assert_same(base, out)
    errs = []
    for F, run in ((JF, lambda: list(JExternal.from_arrays(
            x, y, chunk_rows=500, max_bins=32, cuts=d.cuts.numpy(), load_retries=0
    ).iter_device_chunks())), (TF, lambda: Booster(**KW).fit(_ext(x, y, d, load_retries=0)))):
        with F.inject("chunk_corrupt", times=None, index=3), pytest.raises(Exception) as exc:
            run()
        errs.append((type(exc.value).__name__, str(exc.value)))
    assert errs[0] == errs[1] and errs[1][0] == "ChunkIntegrityError"
    assert "chunk 0" in errs[1][1]
    assert issubclass(TRES.ChunkIntegrityError, TRES.TrainingFault)


def test_on_oom_external_keeps_streaming(data):
    """The oom site armed once on a streamed matrix: one fallback at half
    its chunk rows, still streamed, bit for bit a streamed fit at that
    chunk size; the failed matrix holds nothing on the device."""
    x, y, *_, d = data
    e = _ext(x, y, d, chunk_rows=800)
    with TF.inject("oom", error=TF.SimulatedOOM, times=1), \
            pytest.warns(UserWarning, match="on_oom='external'"):
        b = Booster(**KW).fit(e, on_oom="external")
    assert [ev["chunk_rows"] for ev in b.resilience_events] == [400]
    assert b._train_dmat.resolved_paging() == "stream" and b._train_dmat.chunk_rows == 400
    assert e.nbytes_device == 0 and b._train_dmat.nbytes_device == 0
    _assert_same(Booster(**KW).fit(_ext(x, y, d, chunk_rows=400)), b)


def test_paging_resolution(data, monkeypatch):
    """"stream" stays; "auto" on the CPU is resident; bad knobs raise."""
    x, y, *_, d = data
    assert _ext(x, y, d).resolved_paging() == "stream"
    assert _ext(x, y, d, "auto").resolved_paging() == "resident"
    assert _ext(x, y, d, "resident").resolved_paging() == "resident"
    with pytest.raises(ValueError, match="prefetch_chunks"):
        _ext(x, y, d, prefetch=-1)
    with pytest.raises(NotImplementedError, match="use_kernel_histograms"):
        Booster(**KW, use_kernel_histograms=True).fit(_ext(x, y, d))


# --- chunked traversals ------------------------------------------------------------

@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softmax"])
def test_chunked_traversals_match_the_reference_s(data, objective):
    """ensemble_leaves_chunk and predict_margins_fused_chunked on the same
    trees in both packages: leaves bit for bit the reference's, margins bit
    for bit predict_binned_on over the same rows and within float tolerance
    of the reference's (its fold compiles with another rounding)."""
    x, y, y3, *_, d = data
    kw = dict(n_rounds=3, max_depth=3, max_bins=32, objective=objective)
    if objective == "multi:softmax":
        kw["n_classes"], y = 3, y3
    e = _ext(x, y, d, chunk_rows=333)
    ens = Booster(**kw).fit(e).ensemble
    jens = JPR.Ensemble(**{f: jnp.asarray(getattr(ens, f).numpy()) for f in ENSEMBLE_FIELDS},
                        n_classes=ens.n_classes, base_score=ens.base_score)
    je = JExternal.from_arrays(x, y, chunk_rows=333, max_bins=32, cuts=d.cuts.numpy())
    stack = e.packed_bins().packed
    jstack = je.packed_bins().packed
    for c in (0, e.n_chunks - 1):
        got = TV.ensemble_leaves_chunk(ens, stack[c], e.bits, 333, e.n_rows, 31, 3)
        want = JTV.ensemble_leaves_chunk(jens, jstack[c], e.bits, 333, e.n_rows, 31, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = TV.predict_margins_fused_chunked(ens, stack, e.bits, 333, e.n_rows, 31, 3)
    from repro_torch.core.predict import predict_binned_on

    assert torch.equal(got, predict_binned_on(ens, e.packed_bins(), 31, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(JTV.predict_margins_fused_chunked(
        jens, jstack, e.bits, 333, e.n_rows, 31, 3)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(JPR.predict_binned_chunked(
        jens, jstack, e.bits, 333, e.n_rows, 31, 3)), rtol=1e-6, atol=1e-6)


# --- the command-line trainer --------------------------------------------------------

def test_train_gbdt_on_the_cpu(capsys):
    """The reference's flags and final line (its keys, in order), on the
    CPU; `--devices 2` shards the fit over two CPU positions (its accuracy
    within 0.003 of one device's, test_torch_dist.py)."""
    from repro_torch.launch import train_gbdt

    train_gbdt.main(["--device", "cpu", "--rows", "4000", "--rounds", "3",
                     "--max-bins", "32"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"dataset=higgs rows=4000 rounds=3 devices=1 dmatrix=\d+\.\ds "
                        r"fit=\d+\.\ds valid_accuracy=0\.\d{4}", last), last
    assert float(last.rsplit("=", 1)[1]) > 0.7
    train_gbdt.main(["--device", "cpu", "--rows", "4000", "--rounds", "3",
                     "--max-bins", "32", "--devices", "2"])
    two = capsys.readouterr().out.strip().splitlines()[-1]
    assert " devices=2 " in two and float(two.rsplit("=", 1)[1]) > 0.7
