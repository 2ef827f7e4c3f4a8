"""The port's checkpoints against `repro.checkpoint` (CPU).

The codec (`repro_torch/checkpoint/_msgpack.py`) against `msgpack` itself:
equal bytes when packing, equal values when unpacking, over a Hypothesis
strategy of the subset and at every format's edges. Checkpoints cross
between the packages: a model saved by either loads in the other with its
arrays bit for bit and predicts within rtol 1e-5, atol 1e-6 of the original
(float32 leaf sums in another order), and for the same model (carried across
by `booster_from_numpy`) both write the same bytes. Every file is written
under pytest's `tmp_path`.
"""
import dataclasses
import importlib.util
import struct
import zlib
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro_torch.checkpoint import _msgpack as MP
from repro_torch.checkpoint import io as TIO
from repro_torch.core import Booster, DeviceDMatrix, booster_from_numpy
from repro_torch.core import objectives as O
from repro_torch.core.predict import ENSEMBLE_FIELDS

from _hypothesis_compat import given, settings, st

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
PREDICT_TOL = dict(rtol=1e-5, atol=1e-6)
# The committed reference checkpoint's stored predictions against the
# port's: float32 rounding of the leaf sums and the sigmoid (chip_smoke.py's
# persist phase holds the card to the same).
REFERENCE_ATOL = 1e-6


def _same_as_msgpack(obj):
    packed = MP.packb(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    assert MP.unpackb(packed) == msgpack.unpackb(packed, raw=False, strict_map_key=False)


EDGES = [2**7, 2**8, 2**16, 2**32, 2**63]


@pytest.mark.parametrize("edge", EDGES)
def test_codec_int_edges(edge):
    for n in (edge - 1, edge, edge + 1, -edge - 1, -edge, -edge + 1):
        if -2**63 <= n < 2**64:
            _same_as_msgpack(n)
        else:
            with pytest.raises(OverflowError):
                MP.packb(n)
            with pytest.raises(OverflowError):
                msgpack.packb(n, use_bin_type=True)
    for n in (-32, -33, 0, 127, 2**64 - 1, -2**63):
        _same_as_msgpack(n)


@pytest.mark.parametrize("size", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_codec_length_edges(size):
    _same_as_msgpack("é" * (size // 2) + "a" * (size % 2))
    _same_as_msgpack("a" * size)
    _same_as_msgpack(b"\x00" * size)
    _same_as_msgpack(list(range(size)))
    _same_as_msgpack({str(i): i for i in range(size)})
    _same_as_msgpack((1.5, None, True, False, [size]))


_scalars = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary())
_trees = st.recursive(_scalars, lambda inner: st.lists(inner, max_size=20)
                      | st.dictionaries(st.text(max_size=10), inner, max_size=20),
                      max_leaves=60)


@given(_trees)
@settings(max_examples=200, deadline=None)
def test_codec_matches_msgpack_property(obj):
    _same_as_msgpack(obj)


def test_codec_rejects_what_lies_outside_the_subset():
    for bad in (np.int64(1), np.bool_(True), {1, 2}, object(), 1j):
        with pytest.raises(TypeError):
            MP.packb(bad)
    ext = msgpack.packb(msgpack.ExtType(3, b"xyz"))
    for raw in (ext, b"\xc1", MP.packb([1, 2, 3])[:-1], MP.packb("abc") + b"\x00",
                b"\xd9\x02\xff\xfe", b""):
        with pytest.raises(MP.UnpackError):
            MP.unpackb(raw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(900, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.06] = np.nan
    z = np.nan_to_num(x)
    labels = {"binary:logistic": (z[:, 0] - z[:, 2] > 0).astype(np.float32),
              "multi:softmax": np.digitize(z[:, 0] + z[:, 1], [-0.6, 0.6]).astype(np.float32),
              "reg:pseudohubererror": (z[:, 1] + 0.3 * rng.normal(size=900)).astype(np.float32)}
    return x, labels


def _kw(objective):
    return dict(n_rounds=4, max_depth=3, max_bins=32, objective=objective,
                n_classes=3 if objective == "multi:softmax" else 1)


def _reference_state(jb) -> dict:
    """A reference Booster's config and arrays as booster_from_numpy takes them."""
    return {**dataclasses.asdict(jb.cfg), "cuts": np.asarray(jb.cuts),
            "base_score": jb.base_score, "n_classes": jb.ensemble.n_classes,
            **{f: np.asarray(getattr(jb.ensemble, f)) for f in ENSEMBLE_FIELDS}}


def _assert_arrays_equal(tb, jb):
    for f in ENSEMBLE_FIELDS:
        np.testing.assert_array_equal(getattr(tb.ensemble, f).cpu().numpy(),
                                      np.asarray(getattr(jb.ensemble, f)), err_msg=f)
        assert getattr(tb.ensemble, f).numpy().dtype == np.asarray(getattr(jb.ensemble, f)).dtype
    np.testing.assert_array_equal(tb.cuts.cpu().numpy(), np.asarray(jb.cuts))
    assert tb.cuts.dtype == torch.float32
    assert tb.base_score == jb.base_score and tb.cfg == type(tb.cfg)(**dataclasses.asdict(jb.cfg))
    assert (tb.n_rounds_trained, tb.best_iteration, tb.best_score, tb.history) == (
        jb.n_rounds_trained, jb.best_iteration, jb.best_score, jb.history)


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softmax",
                                       "reg:pseudohubererror"])
def test_reference_checkpoint_loads_in_port_and_back(data, objective, tmp_path):
    x, labels = data
    jd = JDMatrix(x[:700], label=labels[objective][:700], max_bins=32)
    dv = JDMatrix(x[700:], label=labels[objective][700:], ref=jd)
    jb = JBooster(**_kw(objective)).fit(jd, evals=[(dv, "valid")])
    jb.save(str(tmp_path / "ref.ckpt"))
    tb = Booster.load(str(tmp_path / "ref.ckpt"), device="cpu")
    _assert_arrays_equal(tb, jb)
    np.testing.assert_allclose(tb.predict(x).numpy(), np.asarray(jb.predict(x)), **PREDICT_TOL)
    # The port's file of the loaded model is the reference's file.
    tb.save(str(tmp_path / "port.ckpt"))
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "ref.ckpt").read_bytes()
    # The same model carried across by booster_from_numpy (which takes no
    # history: a fit without evals has none) writes the same bytes.
    fresh = JBooster(**_kw(objective)).fit(jd)
    fresh.save(str(tmp_path / "fresh.ckpt"))
    booster_from_numpy(_reference_state(fresh), device="cpu").save(str(tmp_path / "np.ckpt"))
    assert (tmp_path / "np.ckpt").read_bytes() == (tmp_path / "fresh.ckpt").read_bytes()


def test_port_checkpoint_loads_in_reference(data, tmp_path):
    """A port fit that stopped early (history, best_iteration, a truncated
    ensemble) loads in the reference with everything bit for bit."""
    x, labels = data
    y = labels["binary:logistic"]
    d = DeviceDMatrix(x[:700], label=y[:700], max_bins=32, device="cpu")
    noise = (np.random.default_rng(2).random(200) < 0.5).astype(np.float32)
    dv = DeviceDMatrix(x[700:], label=noise, ref=d)
    tb = Booster(n_rounds=30, max_depth=3, max_bins=32, learning_rate=0.6,
                 objective="binary:logistic").fit(d, evals=[(dv, "valid")],
                                                  eval_metric="logloss",
                                                  early_stopping_rounds=3)
    assert tb.n_rounds_trained == tb.best_iteration + 1 < len(tb.history)
    tb.save(str(tmp_path / "port.ckpt"))
    jb = JBooster.load(str(tmp_path / "port.ckpt"))
    _assert_arrays_equal(tb, jb)
    np.testing.assert_allclose(np.asarray(jb.predict(x)), tb.predict(x).numpy(), **PREDICT_TOL)
    back = Booster.load(str(tmp_path / "port.ckpt"), device="cpu")
    assert torch.equal(back.predict(x), tb.predict(x))
    assert back.margins is None and back.ensemble.nodes.shape[0] == tb.n_rounds_trained


def test_checkpoint_errors(data, tmp_path):
    x, labels = data
    d = DeviceDMatrix(x, label=labels["binary:logistic"], max_bins=32, device="cpu")
    path = tmp_path / "m.ckpt"
    Booster(**_kw("binary:logistic")).fit(d).save(str(path))
    raw = path.read_bytes()
    for name, blob, match in (
            ("truncated_header", raw[:10], "truncated"),
            ("truncated", raw[:-5], "checksum"),
            ("flipped", raw[:40] + bytes([raw[40] ^ 0x10]) + raw[41:], "checksum"),
            ("garbage", b"\xc1\xc1\xc1", "msgpack")):
        (tmp_path / name).write_bytes(blob)
        with pytest.raises(TIO.CheckpointError, match=match):
            Booster.load(str(tmp_path / name), device="cpu")
    with pytest.raises(TIO.CheckpointError, match="cannot read"):
        Booster.load(str(tmp_path / "missing.ckpt"), device="cpu")
    tree = TIO.load_pytree(str(path), device="cpu")
    for key, value, match in (("format", "other", "not a repro.booster"),
                              ("version", 3, "unsupported")):
        TIO.save_pytree(str(tmp_path / key), {**tree, key: value})
        with pytest.raises(TIO.CheckpointError, match=match):
            Booster.load(str(tmp_path / key), device="cpu")
        with pytest.raises(JIO.CheckpointError, match=match):
            JBooster.load(str(tmp_path / key))
    # A file of version 1 without the frame (raw msgpack) still loads.
    (tmp_path / "v1").write_bytes(MP.packb(TIO._encode(TIO._host({**tree, "version": 1}))))
    assert torch.equal(Booster.load(str(tmp_path / "v1"), device="cpu").predict(x),
                       Booster.load(str(path), device="cpu").predict(x))
    assert raw[:8] == TIO.MAGIC and struct.unpack(">I", raw[8:12])[0] == zlib.crc32(raw[12:])


def _hand_logistic(margins, y):
    p = torch.sigmoid(margins[:, 0])
    return p - y, p * (1.0 - p)


def test_registered_objective_round_trips_and_bare_callable_raises(data, tmp_path):
    x, labels = data
    d = DeviceDMatrix(x, label=labels["binary:logistic"], max_bins=32, device="cpu")
    name = "test:torch_ckpt_logistic"
    try:
        obj = O.register_objective(name, _hand_logistic,
                                   transform=lambda m: torch.sigmoid(m[:, 0]),
                                   default_metric="accuracy")
        bst = Booster(n_rounds=3, max_depth=3, max_bins=32).fit(d, obj=obj)
        bst.save(str(tmp_path / "plugin.ckpt"))
        loaded = Booster.load(str(tmp_path / "plugin.ckpt"), device="cpu")
        assert loaded.cfg.objective == name and loaded.obj is obj
        assert torch.equal(loaded.predict(x), bst.predict(x))
    finally:
        O.OBJECTIVES.pop(name, None)
    with pytest.raises(TIO.CheckpointError, match="register_objective"):
        Booster.load(str(tmp_path / "plugin.ckpt"), device="cpu")
    bare = Booster(n_rounds=2, max_depth=2, max_bins=32).fit(d, obj=_hand_logistic)
    with pytest.raises(ValueError, match="register_objective"):
        bare.save(str(tmp_path / "nope.ckpt"))
    assert not (tmp_path / "nope.ckpt").exists()


def test_pytree_ensemble_and_resume_sections_cross(data, tmp_path):
    x, labels = data
    jd = JDMatrix(x, label=labels["multi:softmax"], max_bins=32)
    jb = JBooster(**_kw("multi:softmax")).fit(jd)
    # Ensembles, both ways, and a gain-less file backfilled with -inf.
    JIO.save_ensemble(str(tmp_path / "j.ens"), jb.ensemble)
    te = TIO.load_ensemble(str(tmp_path / "j.ens"), device="cpu")
    TIO.save_ensemble(str(tmp_path / "t.ens"), te)
    assert (tmp_path / "t.ens").read_bytes() == (tmp_path / "j.ens").read_bytes()
    fields = {f: getattr(te, f) for f in ENSEMBLE_FIELDS if f != "gain"}
    TIO.save_pytree(str(tmp_path / "old.ens"), {"fields": fields, "n_classes": 3,
                                                "base_score": te.base_score})
    old = TIO.load_ensemble(str(tmp_path / "old.ens"), device="cpu")
    assert old.gain.dtype == torch.float32 and bool(torch.isneginf(old.gain).all())
    # A resume section (none of the port's code writes one yet) reads back
    # in both packages, tuples as tuples.
    resume = {"margins": np.arange(6, dtype=np.float32).reshape(3, 2), "round": 4,
              "rng": (1, 2), "es": {"best": None, "history": [0.5, 0.25]}}
    tb = booster_from_numpy(_reference_state(jb), device="cpu")
    TIO.save_booster(str(tmp_path / "r.ckpt"), tb, resume=resume)
    _, got = JIO.load_booster_with_resume(str(tmp_path / "r.ckpt"))
    _, mine = TIO.load_booster_with_resume(str(tmp_path / "r.ckpt"), device="cpu")
    for back in (got, mine):
        np.testing.assert_array_equal(np.asarray(back["margins"]), resume["margins"])
        assert back["rng"] == (1, 2) and back["es"] == resume["es"] and back["round"] == 4
    assert TIO.load_booster_with_resume(str(tmp_path / "r.ckpt"), device="cpu")[0].ensemble \
        .n_trees == 12
    JIO.save_booster(str(tmp_path / "jr.ckpt"), jb, resume=resume)
    assert (tmp_path / "jr.ckpt").read_bytes() == (tmp_path / "r.ckpt").read_bytes()


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "make_reference_checkpoint", ROOT / "tools" / "make_reference_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_checkpoint_script_reproduces_committed_files(tmp_path):
    written = _reference_script().write(tmp_path)
    for path in written.values():
        assert path.read_bytes() == (DATA / path.name).read_bytes(), path.name


def test_committed_reference_checkpoint_predicts_on_cpu():
    name = _reference_script().NAME
    bst = Booster.load(str(DATA / f"{name}.ckpt"), device="cpu")
    rows = np.load(DATA / f"{name}_rows.npy")
    pred = np.load(DATA / f"{name}_pred.npy")
    assert bst.n_rounds_trained == 4 and len(bst.history) == 4
    np.testing.assert_allclose(bst.predict(rows).numpy(), pred, rtol=0, atol=REFERENCE_ATOL)
