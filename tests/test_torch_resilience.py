"""The port's resilience layer beside the reference's, on the CPU: the
fault harness (`repro_torch.testing.faults`), the primitives of
`core/resilience.py`, the `checkpoint_write` site, and the numeric
sentinel's policies in `Booster.fit`.

The same fault on the same fixture in both packages: the same error types
and rounds, equal `skipped_rounds` and `resilience_events`, and trees
within the fit tolerance of test_torch_booster.py (structure exact, rtol
1e-5 and atol 1e-5 on leaves and margins; `torch_parity_readings.py
resilience` reads what they need over data seeds 0-9).
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import resilience as JRES
from repro.checkpoint import io as JIO
from repro.testing import faults as JF
from repro_torch.checkpoint import io as TIO
from repro_torch.core import Booster, DeviceDMatrix
from repro_torch.core import resilience as TRES
from repro_torch.testing import faults as TF

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(n_rounds=6, max_depth=3, max_bins=32, objective="binary:logistic")
STRUCTURE = ("feature", "split_bin", "default_left", "is_leaf")


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    TF.reset()
    JF.reset()
    yield
    TF.reset()
    JF.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    n, f = 2000, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    y = (z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3] > 0).astype(np.float32)
    xv = rng.normal(size=(400, f)).astype(np.float32)
    yv = (xv[:, 0] - xv[:, 3] > 0).astype(np.float32)
    jd = JDMatrix(x, label=y, max_bins=32)
    td = DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts), device="cpu")
    return x, y, xv, yv, jd, td


# --- the harness -------------------------------------------------------------

def test_fault_sites_and_errors_are_the_reference_s():
    assert TF.SITES == JF.SITES
    assert "RESOURCE_EXHAUSTED" in str(TF.SimulatedOOM())
    assert str(TF.SimulatedOOM()) == str(JF.SimulatedOOM())
    assert issubclass(TF.TransientLoadError, IOError)
    with pytest.raises(ValueError, match="unknown fault site"):
        TF.arm("no_such_site")


@pytest.mark.parametrize("times,after", [(1, 0), (2, 1), (None, 2)])
def test_arming_after_and_times_fire_as_the_reference(times, after):
    fired = {}
    for name, F in (("jax", JF), ("torch", TF)):
        seen = []
        with F.inject("chunk_load", error=F.TransientLoadError, times=times,
                      after=after) as spec:
            for _ in range(6):
                try:
                    F.check("chunk_load")
                    seen.append(False)
                except F.TransientLoadError:
                    seen.append(True)
            fired[name] = (seen, spec.hits, spec.fired)
        assert F.active("chunk_load") is None  # disarmed on exit
        F.check("chunk_load")  # unarmed: a no-op
    assert fired["jax"] == fired["torch"]


def test_trace_key_and_unarmed_corrupt_array():
    arr = np.arange(12, dtype=np.uint32).reshape(3, 4)
    assert TF.corrupt_array("chunk_corrupt", arr) is arr  # nothing armed: no copy
    assert TF.trace_key("nan_grad") is None
    with TF.inject("nan_grad", round=3, value=1.0):
        with JF.inject("nan_grad", round=3, value=1.0):
            assert TF.trace_key("nan_grad") == JF.trace_key("nan_grad")


@pytest.mark.parametrize("chunk,index,bit", [(0, 0, 0), (1, 7, 3), (2, 13, 31), (5, 100, 40)])
def test_corrupt_array_flips_the_reference_s_bit(chunk, index, bit):
    arr = np.random.default_rng(0).integers(0, 2**32, size=(3, 2, 5), dtype=np.uint32)
    with TF.inject("chunk_corrupt", chunk=chunk % 3, index=index, bit=bit):
        got = TF.corrupt_array("chunk_corrupt", arr)
    with JF.inject("chunk_corrupt", chunk=chunk % 3, index=index, bit=bit):
        want = JF.corrupt_array("chunk_corrupt", arr)
    np.testing.assert_array_equal(got, want)
    assert got is not arr and int((got != arr).sum()) == 1


# --- the primitives ------------------------------------------------------------

def test_crc32_chunks_equal_the_reference_s():
    stack = np.random.default_rng(1).integers(0, 2**32, size=(5, 3, 17), dtype=np.uint32)
    assert TRES.crc32_chunks(stack) == JRES.crc32_chunks(stack)
    assert all(isinstance(c, int) for c in TRES.crc32_chunks(stack))
    bad = stack.copy()
    bad[2, 1, 4] ^= 1
    with pytest.raises(TRES.ChunkIntegrityError) as mine:
        TRES.verify_chunk_crcs(bad, TRES.crc32_chunks(stack), context="ctx")
    with pytest.raises(JRES.ChunkIntegrityError) as theirs:
        JRES.verify_chunk_crcs(bad, JRES.crc32_chunks(stack), context="ctx")
    assert str(mine.value) == str(theirs.value)
    assert "chunk(s) [2]" in str(mine.value)


def test_clamp_gradients_and_finite_flags_match_the_reference():
    gh = np.array([[np.nan, 1.0], [np.inf, -np.inf], [3e12, -2e11], [0.5, -0.25],
                   [-np.inf, np.nan]], dtype=np.float32)
    np.testing.assert_array_equal(TRES.clamp_gradients(torch.from_numpy(gh)).numpy(),
                                  np.asarray(JRES.clamp_gradients(gh)))
    cases = [(gh,), (gh[3:4],), (gh[3:4], gh[:1]), (np.ones(3, np.float32), gh[2:4])]
    for arrays in cases:
        got = TRES.finite_flags(*(torch.from_numpy(a) for a in arrays))
        assert got.ndim == 0 and got.dtype == torch.bool
        assert bool(got) == bool(JRES.finite_flags(*arrays))


def test_is_oom_and_with_retries():
    assert TRES.is_oom(TF.SimulatedOOM()) and JRES.is_oom(TF.SimulatedOOM())
    assert TRES.is_oom(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"))
    assert TRES.is_oom(RuntimeError("CUDA out of memory."))
    assert not TRES.is_oom(RuntimeError("shape mismatch"))
    calls, retried = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    assert TRES.with_retries(flaky, retries=2, on_retry=lambda n, e: retried.append(n)) == "done"
    assert retried == [0, 1]
    calls.clear()
    with pytest.raises(OSError):
        TRES.with_retries(flaky, retries=1)
    assert TRES.NUMERIC_POLICIES == JRES.NUMERIC_POLICIES
    assert TRES.CLAMP_LIMIT == JRES.CLAMP_LIMIT


def test_checkpoint_write_fault_leaves_the_file_unchanged(tmp_path):
    """The fault fires before any byte is written, in both packages: the
    file on disk keeps its earlier bytes and no temporary file is left."""
    for io, F in ((TIO, TF), (JIO, JF)):
        path = tmp_path / f"{io.__name__}.ckpt"
        io.save_pytree(str(path), {"a": np.arange(4, dtype=np.float32)})
        before = path.read_bytes()
        with F.inject("checkpoint_write", error=OSError):
            with pytest.raises(OSError):
                io.save_pytree(str(path), {"a": np.zeros(9, dtype=np.float32)})
        assert path.read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [f"{TIO.__name__}.ckpt", f"{JIO.__name__}.ckpt"])


def test_checkpoint_write_retries_then_warns(tmp_path, data):
    """Armed once, the snapshot's retry succeeds; armed always, the fit
    completes with a warning and the reference's `checkpoint_write_failed`
    events."""
    _, _, _, _, jd, td = data
    path = str(tmp_path / "run.ckpt")
    with TF.inject("checkpoint_write", error=OSError, times=1) as spec:
        bst = Booster(**KW).fit(td, checkpoint_every=2, checkpoint_path=path)
    assert spec.fired == 1 and bst.resilience_events == []
    assert Booster.load(path, device="cpu").n_rounds_trained == KW["n_rounds"]
    events = {}
    for name, F, B, d in (("torch", TF, Booster, td), ("jax", JF, JBooster, jd)):
        with F.inject("checkpoint_write", error=lambda: OSError("disk full"), times=None), \
                pytest.warns(UserWarning, match="checkpoint write"):
            b = B(**KW).fit(d, checkpoint_every=2, checkpoint_path=str(tmp_path / name))
        assert b.n_rounds_trained == KW["n_rounds"]
        events[name] = [{k: v for k, v in e.items() if k != "path"}
                        for e in b.resilience_events]
    assert events["torch"] == events["jax"]
    assert [e["round"] for e in events["torch"]] == [2, 4, 6]


# --- the numeric sentinel ---------------------------------------------------

def _policy_fits(data, policy, round_=3, value=float("nan")):
    """The same armed nan_grad fault in both packages: (reference booster
    or its error, port booster or its error)."""
    _, _, _, _, jd, td = data
    out = []
    for F, B, d in ((JF, JBooster, jd), (TF, Booster, td)):
        with F.inject("nan_grad", round=round_, value=value), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                out.append(B(**KW, numeric_check=policy).fit(d))
            except Exception as exc:  # the policy's error is the result
                out.append(exc)
    return out


def _assert_trees_close(jb, tb):
    for f in STRUCTURE:
        np.testing.assert_array_equal(getattr(tb.ensemble, f).numpy(),
                                      np.asarray(getattr(jb.ensemble, f)), err_msg=f)
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(),
                               np.asarray(jb.ensemble.leaf_value), **TOL)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **TOL)


def test_numeric_check_raise_names_the_round(data):
    jerr, terr = _policy_fits(data, "raise")
    assert type(jerr).__name__ == type(terr).__name__ == "NumericError"
    assert isinstance(terr, TRES.NumericError) and isinstance(terr, TRES.TrainingFault)
    # The NaN margins of round 3 poison the chunk's later rounds too.
    assert str(terr) == str(jerr) and "round(s) [3, 4, 5]" in str(terr)


def test_numeric_check_warn_skip_matches_reference(data):
    jb, tb = _policy_fits(data, "warn_skip")
    assert tb.skipped_rounds == jb.skipped_rounds == [3]
    assert tb.resilience_events == jb.resilience_events
    assert bool((tb.ensemble.leaf_value[3] == 0).all())
    assert bool(torch.isinf(tb.ensemble.gain[3]).all())
    assert bool(torch.isfinite(tb.margins).all())
    _assert_trees_close(jb, tb)


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_numeric_check_clamp_matches_reference(data, value):
    """NaN clamps to zero gradients (a root-only tree of leaf 0); +inf to
    CLAMP_LIMIT on every row, whose splits all gain rounding noise, so
    there only the events and finite margins are compared."""
    jb, tb = _policy_fits(data, "clamp", value=value)
    assert tb.resilience_events == jb.resilience_events == [
        {"event": "gradients_clamped", "rounds": [3]}]
    assert tb.skipped_rounds == []
    assert bool(torch.isfinite(tb.margins).all())
    if value != value:  # NaN
        assert bool((tb.ensemble.is_leaf[3, 0]))
        _assert_trees_close(jb, tb)


def test_numeric_check_off_lets_nan_through_and_clean_fits_are_unchanged(data):
    """Off: the armed fault's NaN reaches the margins, as in the reference.
    With no fault every policy trains the model of the default fit, bit
    for bit (the sentinel observes, it does not perturb)."""
    _, _, _, _, _, td = data
    with TF.inject("nan_grad", round=0):
        b = Booster(**KW).fit(td)
    assert not bool(torch.isfinite(b.margins).all())
    base = Booster(**KW).fit(td)
    for policy in ("raise", "warn_skip", "clamp"):
        b = Booster(**KW, numeric_check=policy).fit(td)
        assert torch.equal(b.ensemble.leaf_value, base.ensemble.leaf_value)
        assert b.skipped_rounds == [] and b.resilience_events == []


def test_sentinel_reads_flags_once_a_chunk(data, monkeypatch):
    """12 rounds with an eval set in chunks of 4 (early stopping): the
    finite flags ride with the metrics, one host read a chunk. The one
    `bool` is the model's node check when the Ensemble is built, once."""
    x, y, xv, yv, _, td = data
    dv = DeviceDMatrix(xv, label=yv, ref=td)
    reads = {"cpu": 0, "item": 0, "__float__": 0, "__bool__": 0}
    for name in reads:
        real = getattr(torch.Tensor, name)

        def counted(self, *args, _real=real, _name=name, **kw):
            reads[_name] += 1
            return _real(self, *args, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    Booster(**dict(KW, n_rounds=12), numeric_check="raise").fit(
        td, evals=[(dv, "valid")], early_stopping_rounds=4)
    assert reads == {"cpu": 3, "item": 0, "__float__": 0, "__bool__": 1}


@pytest.mark.parametrize("policy", ["warn_skip", "raise"])
def test_divergence_matches_reference(data, policy):
    """An eval label of 3e38 overflows logloss's y * margin once the
    margins leave 0: the reference's divergence event (warn_skip) or
    DivergenceError (raise), at the same round."""
    _, _, xv, yv, jd, td = data
    yb = yv.copy()
    yb[:5] = 3e38
    out = []
    for B, D, d in ((JBooster, JDMatrix, jd), (Booster, DeviceDMatrix, td)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                out.append(B(**KW, numeric_check=policy).fit(
                    d, evals=[(D(xv, label=yb, ref=d), "valid")], eval_metric="logloss"))
            except Exception as exc:
                out.append(exc)
    jb, tb = out
    if policy == "raise":
        assert type(tb).__name__ == type(jb).__name__ == "DivergenceError"
        assert str(tb) == str(jb)
    else:
        assert tb.resilience_events == jb.resilience_events
        assert tb.resilience_events[0]["event"] == "divergence"
