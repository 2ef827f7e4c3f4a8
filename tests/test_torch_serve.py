"""The port's serving (`repro_torch.serve`) against `repro.serve` (CPU).

One model per fixture, trained by the reference and carried across with
`booster_from_numpy`, so both packages serve the same trees. Per-tree leaves
(`traverse_ensemble_raw`, `traverse_ensemble_packed`) are selected leaf
values and must be equal to the reference's exactly; margins and served
predictions sum the leaves, the reference in XLA's order, so they agree
within rtol 1e-5, atol 1e-6. Within the port, `PredictEngine` must give
`Booster.predict` bit for bit (each row's walk is independent of its batch),
and the fused packed margins `predict_binned_packed` bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.serve import PredictEngine as JEngine
from repro.serve import traversal as JTV
from repro_torch.core import Booster, DeviceDMatrix, booster_from_numpy
from repro_torch.core.predict import ENSEMBLE_FIELDS, predict_binned_packed, predict_raw
from repro_torch.serve import PredictEngine
from repro_torch.serve import traversal as TV
from repro_torch.serve.engine import DEFAULT_BUCKETS

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(x, y, **kw):
    """(reference booster, port booster of the same trees on the CPU)."""
    jd = JDMatrix(x, label=y, max_bins=kw["max_bins"])
    jb = JBooster(**kw).fit(jd)
    state = {**dataclasses.asdict(jb.cfg), "cuts": np.asarray(jb.cuts),
             "base_score": jb.base_score, "n_classes": jb.ensemble.n_classes,
             **{f: np.asarray(getattr(jb.ensemble, f)) for f in ENSEMBLE_FIELDS}}
    return jb, booster_from_numpy(state, device="cpu")


@pytest.fixture(scope="module")
def binary():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(600, 7)).astype(np.float32)
    x[rng.random(x.shape) < 0.12] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.nan_to_num(x[:, 2])
         + 0.3 * rng.normal(size=600) > 0).astype(np.float32)
    jb, tb = _pair(x, y, n_rounds=7, max_depth=4, max_bins=64, objective="binary:logistic")
    return jb, tb, x


@pytest.fixture(scope="module")
def multiclass():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(500, 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    y = ((np.nan_to_num(x[:, 0]) > 0).astype(np.float32)
         + (np.nan_to_num(x[:, 1]) > 0.5)).astype(np.float32)
    jb, tb = _pair(x, y, n_rounds=5, max_depth=3, max_bins=32, objective="multi:softmax",
                   n_classes=3)
    return jb, tb, x


def _fields(ens, names):
    return [getattr(ens, f) for f in names]


@pytest.mark.parametrize("model", ["binary", "multiclass"])
def test_traverse_ensemble_raw_matches_reference(request, model):
    jb, tb, x = request.getfixturevalue(model)
    names = ("feature", "threshold", "default_left", "leaf_value", "is_leaf")
    got = TV.traverse_ensemble_raw(*_fields(tb.ensemble, names), torch.from_numpy(x),
                                   tb.cfg.max_depth)
    want = JTV.traverse_ensemble_raw(*_fields(jb.ensemble, names), jnp.asarray(x),
                                     jb.cfg.max_depth)
    assert got.shape == (tb.ensemble.n_trees, x.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(TV.predict_margins_fused(tb.ensemble, torch.from_numpy(x),
                                                        tb.cfg.max_depth).numpy(),
                               np.asarray(JTV.predict_margins_fused(
                                   jb.ensemble, jnp.asarray(x), jb.cfg.max_depth)), **TOL)


@pytest.mark.parametrize("model", ["binary", "multiclass"])
def test_traverse_ensemble_packed_matches_reference(request, model):
    jb, tb, x = request.getfixturevalue(model)
    md, mb = tb.cfg.max_depth, tb.cfg.max_bins - 1
    d = DeviceDMatrix(x, max_bins=tb.cfg.max_bins, cuts=tb.cuts, device="cpu")
    jd = JDMatrix(x, max_bins=jb.cfg.max_bins, cuts=np.asarray(jb.cuts))
    names = ("feature", "split_bin", "default_left", "leaf_value", "is_leaf")
    got = TV.traverse_ensemble_packed(*_fields(tb.ensemble, names), d.matrix.packed, d.bits,
                                      d.n_rows, mb, md)
    want = JTV.traverse_ensemble_packed(*_fields(jb.ensemble, names), jd.matrix.packed,
                                        jd.bits, jd.n_rows, mb, md)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fused = TV.predict_margins_fused_packed(tb.ensemble, d.matrix.packed, d.bits, d.n_rows,
                                            mb, md)
    assert torch.equal(fused, predict_binned_packed(tb.ensemble, d.matrix.packed, d.bits,
                                                    d.n_rows, mb, md))
    assert torch.equal(tb.predict_margins(d), fused)  # Booster routes through it
    np.testing.assert_allclose(fused.numpy(), np.asarray(JTV.predict_margins_fused_packed(
        jb.ensemble, jd.matrix.packed, jd.bits, jd.n_rows, mb, md)), **TOL)
    # More trees than one block of TREES_BLOCK: the blocks join in order.
    many = dataclasses.replace(tb.ensemble, nodes=None, **{
        f: getattr(tb.ensemble, f).repeat(7, 1) for f in ENSEMBLE_FIELDS})
    assert many.n_trees > TV.TREES_BLOCK
    assert torch.equal(TV.traverse_ensemble_packed(*_fields(many, names), d.matrix.packed,
                                                   d.bits, d.n_rows, mb, md),
                       got.repeat(7, 1))


def test_predict_raw_is_the_fused_traversal(binary):
    _, tb, x = binary
    xt = torch.from_numpy(x)
    assert torch.equal(predict_raw(tb.ensemble, xt, tb.cfg.max_depth),
                       TV.predict_margins_fused(tb.ensemble, xt, tb.cfg.max_depth))


def test_engine_matches_reference_engine_and_booster(binary):
    jb, tb, x = binary
    eng, jeng = PredictEngine(tb), JEngine(jb)
    for n in (1, 5, 300, 600):
        got = eng.predict(x[:n])
        assert isinstance(got, np.ndarray) and got.shape == (n,)
        np.testing.assert_array_equal(got, tb.predict(x[:n]).numpy())
        np.testing.assert_allclose(got, jeng.predict(x[:n]), **TOL)


def test_engine_builds_one_program_a_bucket(binary):
    _, tb, x = binary
    eng = PredictEngine(tb, buckets=(128, 32, 512)).warmup()
    assert eng.trace_count == 3  # one program per bucket
    for n in (1, 7, 32, 33, 100, 128, 129, 300, 512, 600, 1300):
        rows = x[:n] if n <= len(x) else np.vstack([x, x, x])[:n]
        np.testing.assert_array_equal(eng.predict(rows), tb.predict(rows).numpy())
    assert eng.trace_count == 3, "mixed batch sizes built new programs"
    assert not any(c["compiled"] for c in eng.calls)


def test_engine_oversize_slicing_and_nan_padding(binary):
    _, tb, x = binary
    big = np.vstack([x, x])  # 1200 rows > top bucket 256
    np.testing.assert_array_equal(PredictEngine(tb, buckets=(64, 256)).predict(big),
                                  tb.predict(big).numpy())
    # Padding rows are NaN: a 5-row call in a 512-row bucket is the direct
    # unpadded predict, bit for bit.
    np.testing.assert_array_equal(PredictEngine(tb, buckets=(512,)).predict(x[:5]),
                                  tb.predict(x[:5]).numpy())
    unstaged = PredictEngine(tb, buckets=(64,), host_staging=False)
    np.testing.assert_array_equal(unstaged.predict(x[:100]), tb.predict(x[:100]).numpy())


def test_engine_multiclass_margins_and_range(multiclass):
    jb, tb, x = multiclass
    np.testing.assert_array_equal(PredictEngine(tb).predict(x), tb.predict(x).numpy())
    np.testing.assert_array_equal(PredictEngine(tb).predict(x), JEngine(jb).predict(x))
    eng = PredictEngine(tb, output_margin=True, iteration_range=(1, 4))
    got = eng.predict(x)
    assert got.shape == (x.shape[0], 3)
    np.testing.assert_array_equal(
        got, tb.predict(x, output_margin=True, iteration_range=(1, 4)).numpy())
    np.testing.assert_allclose(
        got, JEngine(jb, output_margin=True, iteration_range=(1, 4)).predict(x), **TOL)


def test_engine_validation_and_stats(binary):
    jb, tb, x = binary
    eng = PredictEngine(tb, buckets=(64,))
    with pytest.raises(ValueError, match="2-D"):
        eng.predict(x[0])
    with pytest.raises(ValueError, match="features"):
        eng.predict(x[:, :3])
    with pytest.raises(ValueError, match="0 rows"):
        eng.predict(x[:0])
    bad = x[:4].copy()
    bad[0, 0] = -np.inf
    with pytest.raises(ValueError, match="infinite feature values"):
        eng.predict(bad)
    ok = x[:4].copy()
    ok[0, 0] = np.nan  # NaN stays the legal missing marker
    assert eng.predict(ok).shape == (4,)
    eng.reset_stats()
    assert eng.stats() == {"n_calls": 0}
    fresh = PredictEngine(tb, buckets=(64,))
    fresh.predict(x[:10])  # builds the program
    for _ in range(5):
        fresh.predict(x[:10])
    s = fresh.stats()
    jeng = JEngine(jb, buckets=(64,))
    for _ in range(2):
        jeng.predict(x[:10])
    assert set(s) == set(jeng.stats())
    assert s["n_calls"] == 5 and s["rows"] == 50
    assert s["p50_ms"] > 0 and s["p99_ms"] >= s["p50_ms"] and s["rows_per_s"] > 0
    assert fresh.stats(include_warmup=True)["n_calls"] == 6
    assert [c["compiled"] for c in fresh.calls] == [True] + [False] * 5
    with pytest.raises(RuntimeError, match="fitted"):
        PredictEngine(Booster())
    with pytest.raises(ValueError, match="positive"):
        PredictEngine(tb, buckets=(0, 16))
    assert DEFAULT_BUCKETS == JEngine(jb)._buckets
