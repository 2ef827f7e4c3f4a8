"""Boosting end to end: the port's `Booster.fit`/`predict` against the JAX
package's on shared cuts (CPU: the kernels' plain versions), and a JAX-trained
model carried across with `booster_from_numpy`. The default config grows by
the subtraction trick in both packages; the variants are the kernel path
(`use_kernel_histograms=True`, every level in full) and lossguide growth.

Tree structure must match exactly. Leaves, training margins and predictions
agree to rtol 1e-5, atol 1e-5. They differ because float sums run in
another order, and a child's (G, H) is parent minus sibling at the scale of
the root sums (~1e3 here), so leaves inherit a few float32 ulps of that
scale times the learning rate over (H + λ). On this fixture (seed 5, 2000
rows) the worst reading is 3.9e-6; over seeds 0-9 squared error and
binary stay below 1e-5, while 3-class softmax reaches 2.4e-5. The fixture
has no near-tied gains, so the same splits win.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro_torch.core import Booster, BoosterConfig, DeviceDMatrix, booster_from_numpy
from repro_torch.core.predict import ENSEMBLE_FIELDS

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
OBJECTIVES = {"reg:squarederror": 1, "binary:logistic": 1, "multi:softmax": 3}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    n, f = 2000, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    sig = z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3]
    labels = {
        "reg:squarederror": (sig + 0.1 * rng.normal(size=n)).astype(np.float32),
        "binary:logistic": (sig > 0).astype(np.float32),
        "multi:softmax": np.digitize(sig, [-0.5, 0.5]).astype(np.float32),
    }
    x_new = rng.normal(size=(300, f)).astype(np.float32)
    x_new[rng.random(x_new.shape) < 0.1] = np.nan
    return x, labels, x_new


@pytest.fixture(scope="module")
def fits(data):
    """fits(objective) -> (JAX booster, port booster, port training matrix):
    one fit of each per objective, shared by the tests of this module."""
    cache = {}

    def get(objective):
        if objective not in cache:
            x, labels, _ = data
            y = labels[objective]
            kw = dict(n_rounds=4, max_depth=4, max_bins=32, objective=objective,
                      n_classes=OBJECTIVES[objective])
            jd = JDMatrix(x, label=y, max_bins=32)
            jb = JBooster(**kw).fit(jd)
            d = DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts),
                              device="cpu")
            cache[objective] = (jb, Booster(**kw).fit(d), d)
        return cache[objective]

    return get


@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_fit_matches_reference(fits, objective):
    jb, tb, _ = fits(objective)
    assert tb.base_score == pytest.approx(jb.base_score, rel=1e-6, abs=1e-7)
    assert tb.ensemble.n_trees == jb.ensemble.n_trees == 4 * OBJECTIVES[objective]
    assert tb.ensemble.n_classes == jb.ensemble.n_classes
    for name in ("feature", "split_bin", "default_left", "is_leaf"):
        np.testing.assert_array_equal(getattr(tb.ensemble, name).numpy(),
                                      np.asarray(getattr(jb.ensemble, name)), err_msg=name)
    np.testing.assert_array_equal(tb.ensemble.threshold.numpy(),
                                  np.asarray(jb.ensemble.threshold))
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(),
                               np.asarray(jb.ensemble.leaf_value), **TOL)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **TOL)


# Config variants beside the default, on the binary task. The kernel path
# runs the reference's Pallas kernel in interpret mode, so it fits fewer
# rounds on fewer rows.
VARIANTS = {
    "kernel": dict(use_kernel_histograms=True, n_rounds=3, rows=1000),
    "lossguide": dict(growth="lossguide", max_leaves=7, n_rounds=4, rows=2000),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fit_variants_match_reference(data, variant):
    x, labels, x_new = data
    kw = dict(VARIANTS[variant])
    rows = kw.pop("rows")
    x, y = x[:rows], labels["binary:logistic"][:rows]
    kw.update(max_depth=4, max_bins=32, objective="binary:logistic")
    jd = JDMatrix(x, label=y, max_bins=32)
    jb = JBooster(**kw).fit(jd)
    tb = Booster(**kw).fit(DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts),
                                         device="cpu"))
    for name in ("feature", "split_bin", "default_left", "is_leaf"):
        np.testing.assert_array_equal(getattr(tb.ensemble, name).numpy(),
                                      np.asarray(getattr(jb.ensemble, name)), err_msg=name)
    if variant == "lossguide":
        leaves = tb.ensemble.is_leaf.numpy().sum(axis=1)
        assert leaves.max() == 7 and leaves.min() > 1  # the budget binds
    np.testing.assert_allclose(tb.ensemble.leaf_value.numpy(),
                               np.asarray(jb.ensemble.leaf_value), **TOL)
    np.testing.assert_allclose(tb.margins.numpy(), np.asarray(jb.margins), **TOL)
    np.testing.assert_allclose(tb.predict_margins(x_new).numpy(),
                               np.asarray(jb.predict_margins(x_new)), **TOL)
    # the growth knobs travel with a model carried across
    state = {**dataclasses.asdict(jb.cfg), "cuts": np.asarray(jb.cuts),
             "base_score": jb.base_score, "n_classes": jb.ensemble.n_classes,
             **{f: np.asarray(getattr(jb.ensemble, f)) for f in ENSEMBLE_FIELDS}}
    assert booster_from_numpy(state, device="cpu").cfg == tb.cfg


@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_predict_matches_reference(data, fits, objective):
    x, _, x_new = data
    jb, tb, d = fits(objective)
    for rows in (x, x_new):  # training rows and new rows, NaNs in both
        want = np.asarray(jb.predict_margins(rows))
        got = tb.predict_margins(rows).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    pred, want = tb.predict(x_new).numpy(), np.asarray(jb.predict(x_new))
    if objective == "multi:softmax":
        m = np.sort(tb.predict_margins(x_new).numpy(), axis=1)
        clear = m[:, -1] - m[:, -2] > 1e-3  # class ids where no two margins tie
        np.testing.assert_array_equal(pred[clear], want[clear])
    else:
        np.testing.assert_allclose(pred, want, **TOL)
    # bin-space traversal of a ref= matrix reaches the same leaves
    binned = tb.predict_margins(DeviceDMatrix(x_new, ref=d)).numpy()
    np.testing.assert_allclose(binned, tb.predict_margins(x_new).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softmax"])
def test_booster_from_numpy_predicts_like_reference(data, fits, objective):
    """Carry a JAX-trained model across: one model, both packages."""
    _, _, x_new = data
    jb, _, _ = fits(objective)
    state = {**dataclasses.asdict(jb.cfg), "cuts": np.asarray(jb.cuts),
             "base_score": jb.base_score, "n_classes": jb.ensemble.n_classes,
             **{f: np.asarray(getattr(jb.ensemble, f)) for f in ENSEMBLE_FIELDS}}
    bst = booster_from_numpy(state, device="cpu")
    assert bst.n_rounds_trained == 4
    np.testing.assert_allclose(bst.predict_margins(x_new).numpy(),
                               np.asarray(jb.predict_margins(x_new)), rtol=1e-6, atol=1e-6)
    if objective == "binary:logistic":
        np.testing.assert_allclose(bst.predict(x_new).numpy(), np.asarray(jb.predict(x_new)),
                                   rtol=1e-6, atol=1e-6)


def test_predict_at_depth_14_matches_reference():
    """A depth-14 model (32,767-node arenas, more than a block's shared memory
    holds on the card) carried across with `booster_from_numpy` predicts like
    the reference."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(600, 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    z = np.nan_to_num(x)
    y = (z[:, 0] + z[:, 1] * z[:, 2] > 0).astype(np.float32)
    jb = JBooster(n_rounds=2, max_depth=14, max_bins=16,
                  objective="binary:logistic").fit(JDMatrix(x, label=y, max_bins=16))
    state = {**dataclasses.asdict(jb.cfg), "cuts": np.asarray(jb.cuts),
             "base_score": jb.base_score, "n_classes": jb.ensemble.n_classes,
             **{f: np.asarray(getattr(jb.ensemble, f)) for f in ENSEMBLE_FIELDS}}
    bst = booster_from_numpy(state, device="cpu")
    assert bst.ensemble.feature.shape == (2, 2**15 - 1)
    x_new = rng.normal(size=(300, 5)).astype(np.float32)
    x_new[rng.random(x_new.shape) < 0.1] = np.nan
    for rows in (x, x_new):
        np.testing.assert_allclose(bst.predict_margins(rows).numpy(),
                                   np.asarray(jb.predict_margins(rows)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bst.predict(rows).numpy(), np.asarray(jb.predict(rows)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("knob,value", [("numeric_check", "raise")])
def test_unported_knobs_raise(knob, value):
    """numeric_check is ported: its policies build a config, and a value
    outside them raises the reference's ValueError naming the knob."""
    from repro_torch.core.resilience import NUMERIC_POLICIES

    assert getattr(BoosterConfig(**{knob: value}), knob) == value
    assert value in NUMERIC_POLICIES
    with pytest.raises(ValueError, match=knob):
        BoosterConfig(**{knob: "no-such-policy"})


def test_config_keeps_reference_fields_and_defaults():
    from repro.core.booster import BoosterConfig as JConfig

    mine = {f.name: f.default for f in dataclasses.fields(BoosterConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert mine == theirs
    Booster(use_kernel_histograms=True, growth="lossguide", max_leaves=8)  # ported


def test_fit_and_predict_errors(data):
    x, labels, _ = data
    with pytest.raises(ValueError, match="on_oom"):
        Booster().fit(DeviceDMatrix(x, label=labels["reg:squarederror"], device="cpu"),
                      on_oom="retry")
    with pytest.raises(ValueError):
        Booster(objective="no:such").fit(
            DeviceDMatrix(x, label=labels["reg:squarederror"], device="cpu"))
    with pytest.raises(ValueError, match="label"):
        Booster().fit(DeviceDMatrix(x, device="cpu"))
    with pytest.raises(ValueError, match="max_bins"):
        Booster(max_bins=64).fit(DeviceDMatrix(x, label=labels["reg:squarederror"],
                                               max_bins=32, device="cpu"))
    with pytest.raises(RuntimeError, match="fit"):
        Booster().predict(x)


def test_deprecated_shims_match_the_booster(data):
    """The reference's module-level names: `train` is `Booster.fit` on a
    fresh matrix (with its eval set as "valid"), `predict_margins` and
    `predict` the booster's raw-row predictions, `TrainState` the Booster."""
    from repro_torch.core import booster as TB

    x, labels, x_new = data
    y = labels["binary:logistic"]
    cfg = BoosterConfig(n_rounds=3, max_depth=3, max_bins=32, objective="binary:logistic")
    bst = TB.train(x[:1500], y[:1500], cfg, eval_set=(x[1500:], y[1500:]), device="cpu")
    direct = Booster(cfg).fit(DeviceDMatrix(x[:1500], label=y[:1500], max_bins=32,
                                            device="cpu"))
    assert torch.equal(bst.ensemble.leaf_value, direct.ensemble.leaf_value)
    assert [sorted(r) for r in bst.history[:1]] == [["round", "train_accuracy",
                                                     "valid_accuracy"]]
    assert torch.equal(TB.predict_margins(bst.ensemble, x_new, 3), bst.predict_margins(x_new))
    assert torch.equal(TB.predict(bst.ensemble, x_new, 3, "binary:logistic"),
                       bst.predict(x_new))
    assert TB.TrainState is Booster
    # group_ids become the training matrix's query groups (rank:pairwise).
    gids = np.arange(len(x), dtype=np.int32) // 10
    rank_cfg = dataclasses.replace(cfg, objective="rank:pairwise")
    ranked = TB.train(x, y, rank_cfg, group_ids=gids, device="cpu")
    direct = Booster(rank_cfg).fit(DeviceDMatrix(x, label=y, group_ids=gids, max_bins=32,
                                                 device="cpu"))
    assert torch.equal(ranked.ensemble.leaf_value, direct.ensemble.leaf_value)


def test_port_imports_no_jax():
    """Every module of the port (the LM substrate's too), and chip_smoke.py,
    import without JAX, any module of the JAX package, or msgpack (the
    card's machine lacks it: checkpoints go through the port's own codec)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "lm = ['repro_torch.models.' + m for m in ('config', 'layers', 'moe', 'transformer',\n"
        "      'ssm', 'ssm_model', 'hybrid', 'encdec', 'api', 'convert')]\n"
        "lm += ['repro_torch.optimizer.' + m for m in ('adamw', 'sgd', 'util')]\n"
        "lm += ['repro_torch.configs.' + m for m in ('glm4', 'llama4_maverick', 'llama4_scout',\n"
        "       'mamba2', 'minicpm3', 'phi3_vision', 'seamless_m4t', 'stablelm12b', 'yi6b',\n"
        "       'zamba2')]\n"
        "lm += ['repro_torch.data.tokens', 'repro_torch.launch.train', 'repro_torch.pytree']\n"
        "assert not [m for m in lm if m not in sys.modules], lm\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')\n"
        "       or m == 'msgpack' or m.startswith('msgpack.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50
