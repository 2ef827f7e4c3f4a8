"""The port's sampling module (`repro_torch.core.sampling`) against the
reference's (`repro.core.sampling`) on the CPU.

With the reference's uniforms replayed (`_torch_parity.replay_uniform`,
JAX's uniforms at the same fold path) every selection the port builds from
them — row masks, compacted row ids, GOSS's top-|g| and rest, feature
masks per tree, level and node, the tree context in both modes — equals
the reference's bit for bit. The port's own generator is only held to its
contract: deterministic per path, distinct across paths. BoosterConfig's
validation of the knobs raises the reference's errors with its messages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as JS
from repro.core.booster import BoosterConfig as JConfig
from repro_torch.core import BoosterConfig
from repro_torch.core import sampling as TS

from _torch_parity import jax_key, replay_uniform


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setattr(TS, "uniform", replay_uniform)


@pytest.fixture
def rng():
    return np.random.default_rng(2323)


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("n,m,path", [(1000, 500, (0, 0, 0)), (1001, 1, (3, 2, 1)),
                                      (5000, 4321, (7, 11, 0)), (777, 777, (1, 0, 2))])
def test_row_selection_and_compaction(replay, n, m, path):
    want = JS.row_selection_mask(jax_key(path), n, m)
    got = TS.row_selection_mask(path, n, m, "cpu")
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert int(got.sum()) == m
    ids = TS.compact_row_ids(got, m)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), _np(JS.compact_row_ids(want, m)))


@pytest.mark.parametrize("n,m_top,m_other", [(2000, 400, 200), (999, 1, 998), (500, 250, 0),
                                             (3000, 2999, 1)])
def test_goss_selection_with_tied_gradients(replay, rng, n, m_top, m_other):
    """|g| on a coarse grid (many ties, zeros among them): ties at the top-k
    boundary go to the lower row, as the reference's double argsort."""
    g_abs = (rng.integers(0, 20, n) / 4).astype(np.float32)
    path = (4, 5, 1)
    want = JS.goss_selection(jax_key(path), jnp.asarray(g_abs), m_top, m_other)
    got = TS.goss_selection(path, torch.from_numpy(g_abs), m_top, m_other)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert int(got[0].sum()) == m_top + m_other and int(got[1].sum()) == m_other


@pytest.mark.parametrize("k,f,n_nodes,with_base", [(3, 10, None, False), (4, 10, 6, True),
                                                   (2, 10, None, True), (1, 28, 32, True),
                                                   (28, 28, 3, False)])
def test_feature_sample_mask(replay, rng, k, f, n_nodes, with_base):
    path = (9, 1, 0, TS.TAG_COLS_NODE, 2)
    base = rng.random(f) < 0.6 if with_base else None
    if base is not None:
        base[:k] = True  # at least k allowed
    want = JS.feature_sample_mask(jax_key(path), k, f,
                                  None if base is None else jnp.asarray(base), n_nodes)
    got = TS.feature_sample_mask(path, k, f, None if base is None else torch.from_numpy(base),
                                 n_nodes, device="cpu")
    np.testing.assert_array_equal(got.numpy(), _np(want))


KNOBS = [dict(colsample_bytree=0.5), dict(colsample_bylevel=0.5), dict(colsample_bynode=0.5),
         dict(colsample_bytree=0.7, colsample_bylevel=0.6),
         dict(colsample_bylevel=0.8, colsample_bynode=0.5),
         dict(colsample_bytree=0.8, colsample_bylevel=0.8, colsample_bynode=0.8),
         dict(subsample=0.5)]


@pytest.mark.parametrize("knobs", KNOBS)
def test_level_feature_mask(replay, knobs):
    """Tree ∩ level ∩ node masks at levels 0-4 (1 to 16 nodes), 13 features."""
    f, path = 13, (2, 7, 1)
    jp, tp = JS.StochasticParams(**knobs), TS.StochasticParams(**knobs)
    key = jax_key(path)
    jctx = JS.TreeContext(key=key, row_ids=None, feature_mask=JS.tree_feature_mask(key, f, jp),
                          params=jp)
    tctx = TS.TreeContext(path, None, TS.tree_feature_mask(path, f, tp, "cpu"), tp, "cpu")
    assert TS.level_feature_counts(f, tp) == JS.level_feature_counts(f, jp)
    for level in range(5):
        want = JS.level_feature_mask(jctx, level, 2**level, f)
        got = TS.level_feature_mask(tctx, level, 2**level, f)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("knobs", [dict(subsample=0.5), dict(subsample=0.3, colsample_bytree=0.5),
                                   dict(sampling_method="goss"),
                                   dict(sampling_method="goss", top_rate=0.3, other_rate=0.4,
                                        colsample_bynode=0.5),
                                   dict(monotone=(1, 0, -1, 0, 0))])
def test_make_tree_context(replay, rng, compact, knobs):
    """Both modes: the row buffer, the tree's feature mask and the gh view
    (gathered, or zeroed outside the sample; GOSS's rest scaled by
    float32((1 - a) / b)) bit for bit."""
    n, f, path = 1500, 5, (6, 3, 0)
    gh = np.stack([rng.normal(size=n), rng.random(n)], axis=1).astype(np.float32)
    gh[::7, 0] = gh[1::7, 0]  # tied |g|
    jp, tp = JS.StochasticParams(**knobs), TS.StochasticParams(**knobs)
    jctx, jgh = JS.make_tree_context(jp, jax_key(path), jnp.asarray(gh), f, compact=compact)
    tctx, tgh = TS.make_tree_context(tp, path, torch.from_numpy(gh), f, compact=compact)
    np.testing.assert_array_equal(tgh.numpy(), _np(jgh))
    for name in ("row_ids", "feature_mask"):
        want, got = getattr(jctx, name), getattr(tctx, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=name)
    assert tctx.key == path and tctx.params == tp


def test_sharded_arguments_raise(rng, replay):
    """The sharded arguments are ported: a shard's masked gh is the slice
    of the selection drawn over n_total, bit for bit the reference's; a
    compact buffer over part of the rows raises the reference's error, and
    axis_name on one shard's full range gathers nothing."""
    gh = rng.normal(size=(20, 2)).astype(np.float32)
    p = TS.StochasticParams(subsample=0.5)
    jp = JS.StochasticParams(subsample=0.5)
    for kw in (dict(n_total=20), dict(row_offset=5), dict(axis_name="data")):
        n_total, off = kw.get("n_total", 10), kw.get("row_offset", 0)
        local = gh[off:off + 10]
        _, jgh = JS.make_tree_context(jp, jax_key((0, 0, 0)), jnp.asarray(local), 3,
                                      compact=False, n_total=n_total, row_offset=off)
        _, tgh = TS.make_tree_context(p, (0, 0, 0), torch.from_numpy(local), 3,
                                      compact=False, **kw)
        np.testing.assert_array_equal(tgh.numpy(), np.asarray(jgh))
        if "n_total" in kw:
            with pytest.raises(ValueError, match="full row range on one shard"):
                TS.make_tree_context(p, (0, 0, 0), torch.from_numpy(local), 3, **kw)


@pytest.mark.parametrize("n,frac", [(10, 0.25), (10, 0.35), (2, 0.25), (1001, 0.5), (5, 0.1),
                                    (28, 0.8), (7, 1.0)])
def test_sample_size(n, frac):
    assert TS.sample_size(n, frac) == JS.sample_size(n, frac)


@pytest.mark.parametrize("n,a,b", [(10, 0.55, 0.5), (3, 0.5, 0.5), (1000, 0.2, 0.1), (7, 0.9, 0.1)])
def test_goss_sizes(n, a, b):
    """Including the corner where round(n a) + round(n b) > n."""
    p = dict(sampling_method="goss", top_rate=a, other_rate=b)
    got = TS.goss_sizes(n, TS.StochasticParams(**p))
    assert got == JS.goss_sizes(n, JS.StochasticParams(**p))
    assert sum(got) <= n


def test_default_generator_per_path():
    """The port's own draws: float32 in [0, 1), the same for the same path,
    different for another path (order within the path counts)."""
    a = TS.uniform((1, 2, 3), (1000,), "cpu")
    assert a.dtype == torch.float32 and float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, TS.uniform((1, 2, 3), (1000,), "cpu"))
    for other in ((1, 2, 4), (2, 1, 3), (1, 2, 3, 0), (0, 1, 2, 3)):
        assert not torch.equal(a, TS.uniform(other, (1000,), "cpu"))
    assert TS.path_seed((1, 2)) != TS.path_seed((2, 1))


@pytest.mark.parametrize("knobs", [
    dict(), dict(subsample=0.5), dict(monotone_constraints=(0, 0)),
    dict(monotone_constraints=(1, 0)), dict(sampling_method="goss"),
    dict(colsample_bynode=0.3), dict(seed=99)])
def test_stochastic_params(knobs):
    """None when every knob is at its default (a seed alone or all-zero
    constraints change nothing), else the reference's policy."""
    want = JS.stochastic_params(JConfig(**knobs))
    got = TS.stochastic_params(BoosterConfig(**knobs))
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)


@pytest.mark.parametrize("knobs", [
    dict(subsample=0.0), dict(subsample=1.5), dict(colsample_bytree=1.5),
    dict(colsample_bylevel=0.0), dict(colsample_bynode=-0.1),
    dict(monotone_constraints=(2, 0)), dict(sampling_method="lossguide"),
    dict(sampling_method="goss", top_rate=0.0), dict(sampling_method="goss", other_rate=1.0),
    dict(sampling_method="goss", top_rate=0.7, other_rate=0.6),
    dict(sampling_method="goss", subsample=0.5)])
def test_config_validation_matches_reference(knobs):
    with pytest.raises(ValueError) as want:
        JConfig(**knobs)
    with pytest.raises(ValueError) as got:
        BoosterConfig(**knobs)
    assert str(got.value) == str(want.value)


def test_config_accepts_the_reference_values():
    """Lists of constraints (a checkpoint's) coerce to a hashable tuple; the
    GOSS rates are inert under uniform sampling, as in the reference."""
    cfg = BoosterConfig(monotone_constraints=[1, 0, -1], subsample=0.5, colsample_bytree=0.8,
                        colsample_bylevel=0.8, colsample_bynode=0.8)
    assert cfg.monotone_constraints == (1, 0, -1)
    hash(cfg)
    BoosterConfig(top_rate=0.0, other_rate=1.0)
    BoosterConfig(sampling_method="goss", top_rate=0.3, other_rate=0.7)
