"""The port's packed matrix (`repro_torch.core.{quantile,compress,dmatrix}`)
against the JAX package on the same inputs.

Bins and packed words are integers: exact. Cuts are floats and are compared
with the rank-flip model of tests/test_kernels_cuts.py: the reference's jitted
`arange(1, nvb) / nvb` is not true division in every entry, so a rank
position may sit one float step off and, at an exact integer rank, select
the neighbouring order statistic — one rank-unit of interpolation drift
times the largest adjacent-value gap in the sorted column, plus ulp slack.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as JC
from repro.core import quantile as JQ
from repro.core.dmatrix import DeviceDMatrix as JDMatrix
from repro_torch.core import compress as TC
from repro_torch.core import quantile as TQ
from repro_torch.core.dmatrix import DeviceDMatrix

from _torch_parity import assert_cuts_close


@pytest.fixture
def rng():
    """A fresh generator per test: the session-wide `rng` of conftest.py is
    left untouched, so the reference's tests draw what they drew before."""
    return np.random.default_rng(1234)


def _data(rng, n=1203, f=7, nan_frac=0.1):
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < nan_frac] = np.nan
    x[:, 2] = np.round(x[:, 2])  # a low-cardinality column: duplicate cuts
    return x


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("max_bins", [16, 64, 256])
def test_compute_cuts_close_to_reference(rng, max_bins):
    x = _data(rng)
    got = TQ.compute_cuts(torch.from_numpy(x), max_bins).numpy()
    want = np.asarray(JQ.compute_cuts(jnp.asarray(x), max_bins))
    assert got.shape == want.shape == (x.shape[1], max_bins - 2)
    assert_cuts_close(got, want, x)
    for row in got:  # ascending once the +inf tail is masked
        fin = row[np.isfinite(row)]
        assert np.all(np.diff(fin) > 0)


def test_compute_cuts_degenerate_columns(rng):
    x = _data(rng, n=300, f=4)
    x[:, 1] = 3.25  # constant: one cut
    x[:, 3] = np.nan  # all missing: no cut
    got = TQ.compute_cuts(torch.from_numpy(x), 32).numpy()
    want = np.asarray(JQ.compute_cuts(jnp.asarray(x), 32))
    assert np.isfinite(got[1]).sum() == 1 and got[1, 0] == 3.25
    assert not np.isfinite(got[3]).any()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))


@pytest.mark.parametrize("max_bins", [16, 256])
def test_bins_exact_given_same_cuts(rng, max_bins):
    x = _data(rng)
    cuts = np.array(JQ.compute_cuts(jnp.asarray(x), max_bins))
    got = TQ.quantize(torch.from_numpy(x), torch.from_numpy(cuts)).numpy()
    want = np.asarray(JQ.quantize(jnp.asarray(x), jnp.asarray(cuts)))
    np.testing.assert_array_equal(got, want)
    assert got[np.isnan(x)].tolist() == [max_bins - 1] * int(np.isnan(x).sum())


@pytest.mark.parametrize("bits", [1, 3, 5, 7, 8, 10, 16, 32])
def test_packed_words_bit_exact(rng, bits):
    n, f = 333, 5  # 333 rows: a ragged last word for every bits < 32
    hi = min(2**bits, 2**31)
    bins = rng.integers(0, hi, size=(n, f)).astype(np.int64)
    got = _words(TC.pack(torch.from_numpy(bins), bits))
    want = np.asarray(JC.pack(jnp.asarray(bins.astype(np.uint32)), bits))
    np.testing.assert_array_equal(got, want)
    back = TC.unpack(TC.pack(torch.from_numpy(bins), bits), bits, n).numpy()
    np.testing.assert_array_equal(back, bins.astype(np.int32))


@pytest.mark.parametrize("bits", [2, 8])
def test_gather_feature_bins(rng, bits):
    n, f = 101, 6
    bins = rng.integers(0, 2**bits, size=(n, f)).astype(np.int32)
    feat = rng.integers(0, f, size=n).astype(np.int32)
    packed = TC.pack(torch.from_numpy(bins), bits)
    got = TC.gather_feature_bins(packed, bits, torch.from_numpy(feat)).numpy()
    np.testing.assert_array_equal(got, bins[np.arange(n), feat])


def test_dmatrix_matches_reference_with_shared_cuts(rng):
    x = _data(rng)
    y = rng.normal(size=x.shape[0]).astype(np.float32)
    jd = JDMatrix(x, label=y, max_bins=64)
    d = DeviceDMatrix(x, label=y, max_bins=64, cuts=np.asarray(jd.cuts), device="cpu")
    assert (d.bits, d.n_rows, d.n_features) == (jd.bits, jd.n_rows, jd.n_features)
    np.testing.assert_array_equal(_words(d.matrix.packed), np.asarray(jd.matrix.packed))
    np.testing.assert_array_equal(d.label.numpy(), y)
    assert d.compression_ratio() == pytest.approx(jd.compression_ratio())


def test_dmatrix_ref_shares_cuts(rng):
    x = _data(rng)
    xv = _data(rng, n=257)
    jd = JDMatrix(x, max_bins=32)
    jv = JDMatrix(xv, ref=jd)
    d = DeviceDMatrix(x, max_bins=32, cuts=np.asarray(jd.cuts), device="cpu")
    v = DeviceDMatrix(xv, ref=d)
    assert v.cuts is d.cuts and v.same_cuts(d) and v.max_bins == 32
    assert v.device == d.device
    np.testing.assert_array_equal(_words(v.matrix.packed), np.asarray(jv.matrix.packed))
    own = DeviceDMatrix(x, max_bins=32, device="cpu")  # its own cuts
    assert_cuts_close(own.cuts.numpy(), np.asarray(jd.cuts), x)


@pytest.mark.parametrize("bad", ["inf", "empty", "no_features", "label_nan",
                                 "label_len", "cuts_shape", "ref_and_cuts", "1d"])
def test_dmatrix_validation(rng, bad):
    x = _data(rng, n=50, f=3)
    kw = {"device": "cpu"}
    if bad == "inf":
        x[0, 0] = np.inf
    elif bad == "empty":
        x = x[:0]
    elif bad == "no_features":
        x = x[:, :0]
    elif bad == "label_nan":
        kw["label"] = np.full(50, np.nan, np.float32)
    elif bad == "label_len":
        kw["label"] = np.zeros(49, np.float32)
    elif bad == "cuts_shape":
        kw["cuts"] = np.zeros((3, 7), np.float32)
    elif bad == "ref_and_cuts":
        kw["ref"] = DeviceDMatrix(x, device="cpu")
        kw["cuts"] = kw["ref"].cuts
    elif bad == "1d":
        x = x[:, 0]
    with pytest.raises(ValueError):
        DeviceDMatrix(x, **kw)


def test_dmatrix_runs_on_the_card_unless_asked_for_the_cpu(rng):
    """No device= means cuda; without a card that raises, never carries on
    on the CPU."""
    x = _data(rng, n=40, f=3)
    if torch.cuda.is_available():
        assert DeviceDMatrix(x).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceDMatrix(x)
    assert DeviceDMatrix(x, device="cpu").device.type == "cpu"
