"""Worst port-vs-reference readings over many seeds, behind the tolerances of
tests/test_torch_kernels.py (split scan), tests/test_torch_booster.py (fits)
and tests/test_torch_ranking.py (the pairwise gradient and rank fits).

Run from the repository root (CPU, a few minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_parity_readings.py

Prints one JSON line per reading: the split scan's |Δgain| / max(|gain|, 1) and
hl error per shape over 60 seeds, then for each fit the atol it needs beside
rtol 1e-5 on leaves, training margins and predicted margins, over data seeds
0-9 of the booster fixture (null where the tree structure differs; there
`tie` scores both packages' splits at the first slot that differs by the
reference's gain, see `tie_witness`). With objective names as arguments,
only those objectives' fit readings; `rank:pairwise` reads the pairwise
gradient over 60 seeds and the 4-round rank fits of test_torch_ranking.py
over data seeds 0-9:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_parity_readings.py \
        reg:quantile reg:pseudohubererror count:poisson
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_parity_readings.py rank:pairwise

`stochastic` reads the tolerances of tests/test_torch_stochastic.py: the
constrained split scan's |Δgain| / max(|gain|, 1) per (node, feature) over
60 seeds, and the replayed fits of `STOCHASTIC` (subsample, each
colsample_*, GOSS, monotone, monotone with subsample, softmax with
subsample; both packages draw the reference's uniforms) over data seeds
0-9: the atol each needs beside rtol 1e-5, or, where the structure
differs, the witness of the first difference (`tie_witness`, which scores
splits on the tree's sampled and GOSS-weighted rows, at the node's
monotone bounds; for GOSS also `goss_witness`):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_parity_readings.py stochastic

`resilience` reads the tolerances of tests/test_torch_resilience.py and
tests/test_torch_kill_resume.py (the warn_skip and clamp policies under the
same nan_grad fault, a reference snapshot resumed by both packages), and
`external` those of tests/test_torch_external.py (the chunked default,
lossguide, subsample and GOSS fits, with whether the port's chunked fit is
torch.equal to its in-memory fit), over data seeds 0-9:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_parity_readings.py resilience
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_parity_readings.py external

`dist` reads the gaps of tests/test_torch_dist.py: every collective case
against the reference's on the same per-shard inputs (largest absolute
and relative difference), and every sharded fit of its `FITS` against the
reference's on 8 virtual CPU devices (structure, the leaf atol needed,
comm_stats; the compressed fits' RMSE gap to the exact fit), then the
port's sharded fits against its single-device fit:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_parity_readings.py dist
"""
import json

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import objectives as JOBJ
from repro.core import sampling as JSMP
from repro.core import split as JS
from repro.kernels import ops as JO
from repro_torch.core import Booster, DeviceDMatrix
from repro_torch.core import objectives as TOBJ
from repro_torch.core import sampling as TSMP
from repro_torch.core import split as TS
from repro_torch.kernels import ops

from _torch_parity import constrained_split_inputs, jax_key, replay_uniform

SCAN_SHAPES = [((1, 3, 8), 1.0, 0.5), ((3, 17, 64), 1.0, 1.0), ((8, 5, 256), 0.5, 2.0),
               ((2, 4, 33), 2.0, 0.0)]  # as in test_split_scan_plain_vs_reference
OBJECTIVES = {"reg:squarederror": 1, "binary:logistic": 1, "multi:softmax": 3,
              "reg:quantile": 1, "reg:pseudohubererror": 1, "count:poisson": 1}
QUANTILE_ALPHA = 0.9  # reg:quantile's alpha in these fits
STRUCTURE = ("feature", "split_bin", "default_left", "is_leaf")


def split_scan_readings(n_seeds=60):
    for shape, lam, mcw in SCAN_SHAPES:
        gain_err = hl_err = 0.0
        for seed in range(n_seeds):
            rng = np.random.default_rng(seed)
            g, h = rng.normal(size=shape), rng.random(shape) * 2
            hist = np.stack([g, h], -1).astype(np.float32)
            parent = hist[:, 0].sum(axis=1)
            want = np.asarray(JO.split_scan_op(jnp.asarray(hist), jnp.asarray(parent), lam, mcw))
            got = ops.split_scan(torch.from_numpy(hist), torch.from_numpy(parent), lam,
                                 mcw).numpy()[..., [0, 1, 2, 4]]
            assert np.array_equal(got[..., 1:3], want[..., 1:3]), (shape, seed)
            fin = np.isfinite(want[..., 0])
            scale = np.maximum(np.abs(want[..., 0]), 1.0)
            gain_err = max(gain_err, float((np.abs(got[..., 0] - want[..., 0]) / scale)[fin]
                                           .max(initial=0.0)))
            hl_err = max(hl_err, float((np.abs(got[..., 3] - want[..., 3])
                                        / np.maximum(np.abs(want[..., 3]), 1.0)).max()))
        yield {"split_scan": list(shape), "seeds": n_seeds, "gain_err_over_max_gain_1": gain_err,
               "limit": 5 * shape[2] * 2.0**-24, "hl_err_over_max_hl_1": hl_err}


def extra_labels(rng, sig, regression):
    """Labels of the objectives added after the fixture: drawn after its
    other arrays, so those stay as they were."""
    return {"reg:quantile": regression, "reg:pseudohubererror": regression,
            "count:poisson": rng.poisson(np.exp(np.clip(0.5 * sig, -3, 3))).astype(np.float32)}


def first_difference(jb, tb):
    """(tree, node) of the first arena slot whose structure differs between
    the reference's model and the port's, or None."""
    differ = np.zeros(tuple(tb.ensemble.feature.shape), bool)
    for a in STRUCTURE:
        differ |= getattr(tb.ensemble, a).numpy() != np.asarray(getattr(jb.ensemble, a))
    return tuple(int(i) for i in np.argwhere(differ)[0]) if differ.any() else None


def _split_gain(gh, bins, feature, split_bin, default_left, missing_bin, lam,
                bounds=None, sign=0):
    """The reference's gain formula for one split of a node's rows, in
    float64: (gain, the sum of its terms' magnitudes, the smaller child's
    hessian sum). gh (n, 2) and bins (n, f) are the node's rows. With
    `bounds` (lower, upper) the constrained form: weights clipped to the
    bounds, each leaf's reduction taken at its clipped weight, and -inf
    where the clipped weights break `sign`."""
    col = bins[:, feature]
    left = np.where(col == missing_bin, default_left, col <= split_bin)
    g, h = gh.sum(0)
    gl, hl = gh[left].sum(0)
    gr, hr = g - gl, h - hl
    if bounds is None:
        terms = (gl * gl / (hl + lam), gr * gr / (hr + lam), g * g / (h + lam))
        gain = 0.5 * (terms[0] + terms[1] - terms[2])
    else:
        def weight(a, b):
            return float(np.clip(-a / (b + lam), *bounds))

        def at(a, b, w):
            return -(2.0 * a * w + (b + lam) * w * w)

        wl, wr = weight(gl, hl), weight(gr, hr)
        terms = (at(gl, hl, wl), at(gr, hr, wr), at(g, h, weight(g, h)))
        gain = 0.5 * (terms[0] + terms[1] - terms[2])
        if (sign > 0 and wl > wr) or (sign < 0 and wl < wr):
            gain = -np.inf
    return gain, 0.5 * sum(abs(t) for t in terms), float(min(hl, hr))


def _path_to(node, ref, bins, gh, missing_bin, lam, monotone):
    """Rows (bool, over all rows) reaching `node` along the reference's
    arena `ref`, and the node's float64 monotone bounds (None without
    constraints), propagated from the root as the tree does: the midpoint
    of the clipped child weights on the constrained side."""
    chain = []
    a = node
    while a > 0:
        chain.append(a)
        a = (a - 1) // 2
    rows = np.ones(bins.shape[0], bool)
    lo, hi = -np.inf, np.inf
    cur = 0
    for child in reversed(chain):
        f = int(ref["feature"][cur])
        col = bins[:, f]
        left = np.where(col == missing_bin, ref["default_left"][cur], col <= ref["split_bin"][cur])
        if monotone is not None:
            (gl, hl), (gr, hr) = gh[rows & left].sum(0), gh[rows & ~left].sum(0)
            wl = float(np.clip(-gl / (hl + lam), lo, hi))
            wr = float(np.clip(-gr / (hr + lam), lo, hi))
            mid, c = 0.5 * (wl + wr), monotone[f]
            if child == 2 * cur + 1:
                lo, hi = (mid if c < 0 else lo), (mid if c > 0 else hi)
            else:
                lo, hi = (mid if c > 0 else lo), (mid if c < 0 else hi)
        rows &= left if child == 2 * cur + 1 else ~left
        cur = child
    return rows, (None if monotone is None else (lo, hi))


def _tree_gh(kw, jd, jb, y, tree, group_ids=None):
    """The reference's own float64 (g, h) of `tree` (n, 2) at the start of
    its round, with the tree's sample applied as masked mode applies it
    (unselected rows zero, GOSS's rest scaled)."""
    k = jb.ensemble.n_classes
    rounds = tree // k
    n = jd.n_rows
    margins = (np.full((n, k), jb.base_score, np.float32) if rounds == 0
               else np.asarray(JBooster(**{**kw, "n_rounds": rounds}).fit(jd).margins))
    groups = {} if group_ids is None else {"group_ids": jnp.asarray(group_ids)}
    gh = JOBJ.get_objective(kw["objective"]).grad(
        jnp.asarray(margins), jnp.asarray(y), quantile_alpha=QUANTILE_ALPHA, **groups)[:, tree % k]
    stoch = JSMP.stochastic_params(jb.cfg)
    if stoch is not None:
        _, gh = JSMP.make_tree_context(stoch, jax_key((jb.cfg.seed, rounds, tree % k)), gh,
                                       jd.n_features, compact=False)
    return np.asarray(gh).astype(np.float64)


def tie_witness(kw, jd, jb, tb, y, group_ids=None):
    """Where the port's structure first departs from the reference's (every
    earlier slot equal, so both reach the node with the same rows): each
    package's choice there, None for a leaf, else its split scored by the
    reference's gain in float64 on the reference's own gradients at the
    start of that tree's round (with the training matrix's query groups,
    `group_ids`, for rank:pairwise), on the tree's sampled and GOSS-weighted
    rows and at the node's monotone bounds, where the config has them. A
    flip that is only rounding scores both alike. None when the structures
    agree."""
    at = first_difference(jb, tb)
    if at is None:
        return None
    tree, node = at
    missing_bin, lam = kw["max_bins"] - 1, jb.cfg.reg_lambda
    mono = jb.cfg.monotone_constraints
    mono = mono if mono is not None and any(mono) else None
    ref = {a: np.asarray(getattr(jb.ensemble, a))[tree] for a in STRUCTURE}
    bins = np.asarray(jd.matrix.unpack())
    gh = _tree_gh(kw, jd, jb, y, tree, group_ids)
    rows, bounds = _path_to(node, ref, bins, gh, missing_bin, lam, mono)
    out = {"tree": tree, "node": node, "rows": int(rows.sum()), "bounds": bounds}
    for who, ens in (("ref", jb.ensemble), ("port", tb.ensemble)):
        arena = {a: np.asarray(getattr(ens, a))[tree][node] for a in STRUCTURE}
        if arena["is_leaf"]:
            out[who] = None
            continue
        f = int(arena["feature"])
        gain, scale, min_hess = _split_gain(gh[rows], bins[rows], f, int(arena["split_bin"]),
                                            bool(arena["default_left"]), missing_bin, lam,
                                            bounds, 0 if mono is None else mono[f])
        out[who] = {"feature": f, "split_bin": int(arena["split_bin"]),
                    "default_left": bool(arena["default_left"]), "gain": float(gain),
                    "terms": float(scale), "min_child_hess": min_hess}
    return out


def goss_witness(kw, td, jd, jb, tb, y, tree):
    """GOSS's selection of `tree` in both packages, each from its own
    gradients at the start of the tree's round and the reference's
    uniforms. Where they differ: the rows in or out of one top set only,
    the largest distance of their reference |g| from the m_top-th largest
    |g| (the boundary) and of the two packages' |g| from each other, in
    float32 ulps of the boundary."""
    k = jb.ensemble.n_classes
    rounds, c = tree // k, tree % k
    path = (jb.cfg.seed, rounds, c)
    stoch = JSMP.stochastic_params(jb.cfg)
    m_top, m_other = JSMP.goss_sizes(jd.n_rows, stoch)
    base = {"n_rounds": rounds} if rounds else None
    jm = (np.full((jd.n_rows, k), jb.base_score, np.float32) if base is None
          else np.asarray(JBooster(**{**kw, **base}).fit(jd).margins))
    tm = (torch.full((jd.n_rows, k), tb.base_score) if base is None
          else Booster(**{**kw, **base}).fit(td).margins)
    jg = np.abs(np.asarray(JOBJ.get_objective(kw["objective"]).grad(
        jnp.asarray(jm), jnp.asarray(y))[:, c, 0]))
    tg = TOBJ.get_objective(kw["objective"]).grad(tm, torch.from_numpy(y))[:, c, 0].abs()
    jsel = np.asarray(JSMP.goss_selection(jax_key(path), jnp.asarray(jg), m_top, m_other)[0])
    tsel = TSMP.goss_selection(path, tg, m_top, m_other)[0].numpy()
    out = {"tree": tree, "selection_same": bool(np.array_equal(jsel, tsel))}
    if not out["selection_same"]:
        jtop = np.argsort(-jg, kind="stable")[:m_top]
        ttop = np.argsort(-tg.numpy(), kind="stable")[:m_top]
        moved = np.setxor1d(jtop, ttop)
        boundary = np.sort(jg)[::-1][m_top - 1]
        ulp = float(np.spacing(np.float32(boundary)))
        out.update(rows_moved=int(moved.size),
                   boundary_ulps=float(np.abs(jg[moved] - boundary).max() / ulp),
                   g_ulps=float(np.abs(jg[moved] - tg.numpy()[moved]).max() / ulp))
    return out


def fit_data(seed):
    """test_torch_booster.py's fixture at a data seed (seed 5 there): 2000
    rows of 6 features, 5% missing; a regression, a binary and a 3-class
    target from one signal; 300 new rows; then the later objectives'
    labels."""
    rng = np.random.default_rng(seed)
    n, f = 2000, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x)
    sig = z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3]
    labels = {"reg:squarederror": (sig + 0.1 * rng.normal(size=n)).astype(np.float32),
              "binary:logistic": (sig > 0).astype(np.float32),
              "multi:softmax": np.digitize(sig, [-0.5, 0.5]).astype(np.float32)}
    x_new = rng.normal(size=(300, f)).astype(np.float32)
    x_new[rng.random(x_new.shape) < 0.1] = np.nan
    labels.update(extra_labels(rng, sig, labels["reg:squarederror"]))
    return x, labels, x_new


def fit_readings(seeds=range(10), objectives=()):
    def atol(a, b):  # the least atol that passes beside rtol 1e-5
        return float(np.max(np.abs(a - b) - 1e-5 * np.abs(b)))

    for seed in seeds:
        x, labels, x_new = fit_data(seed)
        for objective, k in OBJECTIVES.items():
            if objectives and objective not in objectives:
                continue
            kw = dict(n_rounds=4, max_depth=4, max_bins=32, objective=objective, n_classes=k,
                      quantile_alpha=QUANTILE_ALPHA)
            jd = JDMatrix(x, label=labels[objective], max_bins=32)
            jb = JBooster(**kw).fit(jd)
            tb = Booster(**kw).fit(DeviceDMatrix(x, label=labels[objective], max_bins=32,
                                                 cuts=np.asarray(jd.cuts), device="cpu"))
            tie = tie_witness(kw, jd, jb, tb, labels[objective])
            same = tie is None
            reading = {"fit_seed": seed, "objective": objective, "structure_same": same,
                       "atol_needed": None, "tie": tie}
            if same:
                reading["atol_needed"] = max(
                    atol(tb.ensemble.leaf_value.numpy(), np.asarray(jb.ensemble.leaf_value)),
                    atol(tb.margins.numpy(), np.asarray(jb.margins)),
                    *(atol(tb.predict_margins(r).numpy(), np.asarray(jb.predict_margins(r)))
                      for r in (x, x_new)))
            yield reading


# The replayed stochastic fits of test_torch_stochastic.py: 4 rounds, depth
# 4, 32 bins on the fixture of `fit_data`; the knobs beside each objective.
# Feature 0 rises and feature 3 falls with the fixture's signal.
STOCHASTIC = {
    "subsample": dict(objective="binary:logistic", subsample=0.5),
    "colsample_bytree": dict(objective="binary:logistic", colsample_bytree=0.5),
    "colsample_bylevel": dict(objective="binary:logistic", colsample_bylevel=0.5),
    "colsample_bynode": dict(objective="binary:logistic", colsample_bynode=0.5),
    "goss": dict(objective="binary:logistic", sampling_method="goss"),
    "monotone": dict(objective="reg:squarederror", monotone_constraints=(1, 0, 0, -1, 0, 0)),
    "monotone_subsample": dict(objective="reg:squarederror", subsample=0.7,
                               monotone_constraints=(1, 0, 0, -1, 0, 0)),
    "softmax_subsample": dict(objective="multi:softmax", n_classes=3, subsample=0.5),
}
STOCHASTIC_SEED = 11  # the knobs' draw seed (BoosterConfig.seed)


def stochastic_fit(seed, name):
    """One replayed fit of STOCHASTIC[name] at data seed `seed` in both
    packages on the reference's cuts; call with `repro_torch`'s
    `sampling.uniform` replaced by `replay_uniform`. Returns (kw, x, y,
    x_new, td, jd, jb, tb)."""
    x, labels, x_new = fit_data(seed)
    kw = dict(n_rounds=4, max_depth=4, max_bins=32, seed=STOCHASTIC_SEED, **STOCHASTIC[name])
    y = labels[kw["objective"]]
    jd = JDMatrix(x, label=y, max_bins=32)
    td = DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts), device="cpu")
    return kw, x, y, x_new, td, jd, JBooster(**kw).fit(jd), Booster(**kw).fit(td)


def stochastic_fit_readings(seeds=range(10)):
    """Each replayed stochastic fit: structure, the witness where it
    differs, else the atol leaves, margins and predictions need beside
    rtol 1e-5."""
    draw, TSMP.uniform = TSMP.uniform, replay_uniform
    try:
        for name in STOCHASTIC:
            for seed in seeds:
                kw, x, y, x_new, td, jd, jb, tb = stochastic_fit(seed, name)
                tie = tie_witness(kw, jd, jb, tb, y)
                reading = {"fit_seed": seed, "stochastic": name, "structure_same": tie is None,
                           "atol_needed": None, "tie": tie}
                if tie is None:
                    reading["atol_needed"] = max(
                        _atol_needed(tb.ensemble.leaf_value.numpy(),
                                     np.asarray(jb.ensemble.leaf_value)),
                        _atol_needed(tb.margins.numpy(), np.asarray(jb.margins)),
                        *(_atol_needed(tb.predict_margins(r).numpy(),
                                       np.asarray(jb.predict_margins(r))) for r in (x, x_new)))
                elif name == "goss":
                    reading["goss"] = goss_witness(kw, td, jd, jb, tb, y, tie["tree"])
                yield reading
    finally:
        TSMP.uniform = draw


def per_feature_splits(split_fn, hist, parent, params, mono, bounds, mask):
    """Each feature's best split at every node, from a package's
    `evaluate_splits` called once a feature with a mask that keeps that
    feature alone (and `mask`'s own choice of it): gain, split_bin,
    default_left, each (n_nodes, F)."""
    n, f = hist.shape[:2]
    out = {k: np.zeros((n, f)) for k in ("gain", "split_bin", "default_left")}
    for j in range(f):
        keep = mask & (np.arange(f) == j)[None, :]
        sp = split_fn(hist, parent, params, keep, mono, bounds)
        for k_ in out:
            out[k_][:, j] = np.asarray(getattr(sp, k_))
    return out


def jax_splits(hist, parent, params, mask, mono, bounds):
    return JS.evaluate_splits(jnp.asarray(hist), jnp.asarray(parent), JS.SplitParams(*params),
                              feature_mask=jnp.asarray(mask), monotone=jnp.asarray(mono),
                              node_bounds=jnp.asarray(bounds))


def torch_splits(hist, parent, params, mask, mono, bounds):
    return TS.evaluate_splits(torch.from_numpy(hist), torch.from_numpy(parent),
                              TS.SplitParams(*params), feature_mask=torch.from_numpy(mask),
                              monotone=torch.from_numpy(mono),
                              node_bounds=torch.from_numpy(bounds))


CONSTRAINED_SHAPES = [((5, 3, 8), (1.0, 0.0, 0.5)), ((10, 7, 64), (1.0, 0.0, 1.0)),
                      ((5, 4, 256), (0.5, 0.0, 2.0)), ((6, 3, 33), (2.0, 0.1, 0.0))]


def constrained_gain_readings(n_seeds=60):
    """The constrained scan's per-(node, feature) best gain in the port
    against the reference's, |Δgain| / max(|gain|, 1), over inputs of
    `constrained_split_inputs` (every constraint sign, bounds that clip,
    ±inf and pinched; no mask beside the one that picks the feature)."""
    for shape, params in CONSTRAINED_SHAPES:
        err = 0.0
        for seed in range(n_seeds):
            hist, parent, mono, bounds, _ = constrained_split_inputs(
                np.random.default_rng(seed), *shape)
            everything = np.ones(shape[:2], bool)
            want = per_feature_splits(jax_splits, hist, parent, params, mono, bounds, everything)
            got = per_feature_splits(torch_splits, hist, parent, params, mono, bounds,
                                     everything)
            fin = np.isfinite(want["gain"])
            assert np.array_equal(fin, np.isfinite(got["gain"])), (shape, seed)
            diff = np.abs(got["gain"][fin] - want["gain"][fin])
            err = max(err, float((diff / np.maximum(np.abs(want["gain"][fin]), 1.0))
                                 .max(initial=0.0)))
        yield {"constrained_split_scan": list(shape), "params": list(params), "seeds": n_seeds,
               "gain_err_over_max_gain_1": err, "limit": 5 * shape[2] * 2.0**-24}


def _atol_needed(got, want):
    """The least atol that passes beside rtol 1e-5."""
    return float(np.max(np.abs(got - want) - 1e-5 * np.abs(want), initial=0.0))


def pairwise_inputs(rng, case, n=240):
    """Scores, labels and query ids of one gradient case (test_torch_ranking.py):
    "groups" non-contiguous ids of 1-30 rows in shuffled row order, integer
    relevance 0-4 (tied labels); "singletons" one row a group; "equal" one
    relevance everywhere; "none" no ids (one query)."""
    sizes = rng.integers(1, 31, size=n)
    ids = np.repeat(rng.permutation(10 * n)[:n] * 3 + 7, sizes)[:n]
    ids = {"groups": rng.permutation(ids), "singletons": rng.permutation(n) * 5,
           "equal": rng.permutation(ids), "none": None}[case]
    s = (rng.normal(size=(n, 1)) * 2).astype(np.float32)
    y = rng.integers(0, 5, size=n).astype(np.float32)
    if case == "equal":
        y[:] = 2.0
    return s, y, None if ids is None else ids.astype(np.int32)


PAIRWISE_CASES = ("groups", "singletons", "equal", "none")


def pairwise_readings(n_seeds=60):
    """rank:pairwise's gradient in the port (its plain version on the CPU)
    against the reference's `_pairwise_grad`: the atol each case needs
    beside rtol 1e-5, and what it needs beyond rtol 1e-5 and atol 1e-6 in
    float32 ulps (2^-24) of the row's summed term magnitudes (the rounding
    of the reference's float32 sums over a large query)."""
    from repro_torch.core import objectives as TOBJ

    jobj, tobj = JOBJ.get_objective("rank:pairwise"), TOBJ.get_objective("rank:pairwise")
    for case in PAIRWISE_CASES:
        need = ulps = 0.0
        for seed in range(n_seeds):
            s, y, ids = pairwise_inputs(np.random.default_rng(seed), case)
            want = np.asarray(jobj.grad(jnp.asarray(s), jnp.asarray(y),
                                        group_ids=None if ids is None else jnp.asarray(ids)))
            got = tobj.grad(torch.from_numpy(s), torch.from_numpy(y),
                            group_ids=None if ids is None else torch.from_numpy(ids)).numpy()
            need = max(need, _atol_needed(got, want))
            mag = pairwise_magnitudes(s, y, ids)[:, None, :]
            ulps = max(ulps, float(np.max((np.abs(got - want) - 1e-5 * np.abs(want) - 1e-6)
                                          / (mag * 2.0**-24 + 1e-30))))
        yield {"pairwise_grad": case, "seeds": n_seeds, "atol_needed": need,
               "magnitude_ulps_needed": max(ulps, 0.0)}


def pairwise_magnitudes(s, y, ids):
    """(n, 2) float64: each row's summed |g| terms and h terms."""
    from repro_torch.kernels import ops, ref

    g = torch.zeros(len(y), dtype=torch.int32) if ids is None else torch.from_numpy(ids)
    t = ref.pairwise_terms_ref(torch.from_numpy(s[:, 0]), torch.from_numpy(y),
                               *ops.query_groups(g)).numpy()
    return np.stack([t[:, 0] + t[:, 1], t[:, 2]], axis=1)


RANK_KW = dict(n_rounds=4, max_depth=3, max_bins=32, objective="rank:pairwise")


def rank_data(seed):
    """tests/test_booster.py::test_rank_pairwise's data at a data seed: 40
    queries of 8 rows, a linear relevance, and 300 new rows."""
    rng = np.random.default_rng(seed)
    n_groups, per = 40, 8
    x = rng.normal(size=(n_groups * per, 5)).astype(np.float32)
    rel = (x @ rng.normal(size=5)).astype(np.float32)
    gids = np.repeat(np.arange(n_groups), per).astype(np.int32)
    return x, rel, gids, rng.normal(size=(300, 5)).astype(np.float32)


def rank_fit_readings(seeds=range(10)):
    """4-round rank:pairwise fits on shared cuts: structure, the tie where it
    differs, and else the atol leaves and margins need beside rtol 1e-5."""
    for seed in seeds:
        x, rel, gids, x_new = rank_data(seed)
        jd = JDMatrix(x, label=rel, group_ids=gids, max_bins=32)
        jb = JBooster(**RANK_KW).fit(jd)
        tb = Booster(**RANK_KW).fit(DeviceDMatrix(x, label=rel, group_ids=gids, max_bins=32,
                                                  cuts=np.asarray(jd.cuts), device="cpu"))
        tie = tie_witness(RANK_KW, jd, jb, tb, rel, gids)
        reading = {"fit_seed": seed, "objective": "rank:pairwise",
                   "structure_same": tie is None, "atol_needed": None, "tie": tie}
        if tie is None:
            reading["atol_needed"] = max(
                _atol_needed(tb.ensemble.leaf_value.numpy(), np.asarray(jb.ensemble.leaf_value)),
                _atol_needed(tb.margins.numpy(), np.asarray(jb.margins)),
                *(_atol_needed(tb.predict_margins(r).numpy(), np.asarray(jb.predict_margins(r)))
                  for r in (x, x_new)))
        yield reading


def _fit_atol(jb, tb, rows, margins=True, chunked=None):
    """The atol leaves, training margins and predicted margins of rows (and,
    with `chunked`, of that ExternalDMatrix) need beside rtol 1e-5."""
    got = [_atol_needed(tb.ensemble.leaf_value.numpy(), np.asarray(jb.ensemble.leaf_value))]
    if margins:
        got.append(_atol_needed(tb.margins.numpy(), np.asarray(jb.margins)))
    got += [_atol_needed(tb.predict_margins(r).numpy(), np.asarray(jb.predict_margins(r)))
            for r in rows]
    if chunked is not None:
        got.append(_atol_needed(tb.predict_margins(chunked).numpy(),
                                np.asarray(jb.predict_margins(rows[0]))))
    return max(got)


# The numeric policies of tests/test_torch_resilience.py: 6 rounds, depth 3,
# 32 bins, binary:logistic, nan_grad at round 3 (NaN: clamped to zero).
RESILIENCE_KW = dict(n_rounds=6, max_depth=3, max_bins=32, objective="binary:logistic")


def resilience_readings(seeds=range(10)):
    """Each numeric policy under the same nan_grad fault in both packages,
    and a reference snapshot (4 rounds of 10 done, depth 3) resumed by both:
    equal events, the structure, and the atol leaves and margins need
    beside rtol 1e-5 (null where the structure differs; `first` is then the
    first differing (tree, slot))."""
    import tempfile
    import warnings
    from pathlib import Path

    from repro.testing import faults as JF
    from repro_torch.testing import faults as TF

    class Stop(Exception):
        pass

    def stop(r, rec):
        if r >= 5:
            raise Stop

    for seed in seeds:
        x, labels, x_new = fit_data(seed)
        y = labels["binary:logistic"]
        jd = JDMatrix(x, label=y, max_bins=32)
        td = DeviceDMatrix(x, label=y, max_bins=32, cuts=np.asarray(jd.cuts), device="cpu")
        for policy in ("warn_skip", "clamp"):
            fits = []
            for F, B, d in ((JF, JBooster, jd), (TF, Booster, td)):
                with F.inject("nan_grad", round=3), warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    fits.append(B(**RESILIENCE_KW, numeric_check=policy).fit(d))
            jb, tb = fits
            first = first_difference(jb, tb)
            yield {"fit_seed": seed, "resilience": policy, "structure_same": first is None,
                   "events_equal": jb.resilience_events == tb.resilience_events
                   and jb.skipped_rounds == tb.skipped_rounds,
                   "first": first,
                   "atol_needed": None if first else _fit_atol(jb, tb, (x, x_new))}
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "run.ckpt"
            kw = dict(RESILIENCE_KW, n_rounds=10)
            try:
                JBooster(**kw).fit(jd, checkpoint_every=4, checkpoint_path=str(path),
                                   callback=stop)
            except Stop:
                pass
            copy = Path(tmp) / "copy.ckpt"
            copy.write_bytes(path.read_bytes())
            jb = JBooster.resume(str(path), jd)
            tb = Booster.resume(str(copy), td)
        first = first_difference(jb, tb)
        yield {"fit_seed": seed, "resilience": "resume_reference_snapshot",
               "structure_same": first is None, "first": first,
               "atol_needed": None if first else _fit_atol(jb, tb, (x, x_new))}


# The chunked fits of tests/test_torch_external.py: 4 rounds, depth 4, 32
# bins, binary:logistic, 333 rows a chunk, on the reference's cuts; the
# sampled fits draw the reference's uniforms.
EXTERNAL = {
    "default": {},
    "lossguide": {"growth": "lossguide", "max_leaves": 6},
    "subsample": {"subsample": 0.5, "seed": 11},
    "goss": {"sampling_method": "goss", "seed": 11},
}
EXTERNAL_CHUNK_ROWS = 333


def external_readings(seeds=range(10)):
    """Each chunked fit in both packages: the structure (the witness where
    it differs), the atol leaves, margins and predictions (raw rows, and
    the port's ExternalDMatrix) need beside rtol 1e-5, and whether the
    port's chunked fit is torch.equal to its in-memory fit."""
    from repro.core import ExternalDMatrix as JExternal
    from repro_torch.core import ExternalDMatrix

    draw, TSMP.uniform = TSMP.uniform, replay_uniform
    try:
        for name, knobs in EXTERNAL.items():
            for seed in seeds:
                x, labels, x_new = fit_data(seed)
                y = labels["binary:logistic"]
                kw = dict(n_rounds=4, max_depth=4, max_bins=32, objective="binary:logistic",
                          **knobs)
                jd = JDMatrix(x, label=y, max_bins=32)
                cuts = np.asarray(jd.cuts)
                je = JExternal.from_arrays(x, y, chunk_rows=EXTERNAL_CHUNK_ROWS, max_bins=32,
                                           cuts=cuts)
                td = DeviceDMatrix(x, label=y, max_bins=32, cuts=cuts, device="cpu")
                te = ExternalDMatrix.from_arrays(x, y, chunk_rows=EXTERNAL_CHUNK_ROWS, ref=td)
                jb, tb = JBooster(**kw).fit(je), Booster(**kw).fit(te)
                flat = Booster(**kw).fit(td)
                tie = tie_witness(kw, jd, jb, tb, y)
                yield {"fit_seed": seed, "external": name, "structure_same": tie is None,
                       "tie": tie,
                       "atol_needed": None if tie else _fit_atol(jb, tb, (x, x_new), chunked=te),
                       "chunked_equals_resident": all(
                           torch.equal(getattr(tb.ensemble, f), getattr(flat.ensemble, f))
                           for f in (*STRUCTURE, "leaf_value", "gain"))
                       and torch.equal(tb.margins, flat.margins)}
    finally:
        TSMP.uniform = draw


def dist_readings():
    """The gaps behind tests/test_torch_dist.py's tolerances: each
    collective case's largest absolute and relative difference from the
    reference's on the same per-shard inputs, and each sharded fit's
    structure, the atol its leaves need, comm_stats equality and, for the
    compressed fits, the relative RMSE gap to the exact fit."""
    import tempfile
    from pathlib import Path

    import test_torch_dist as TD

    with tempfile.TemporaryDirectory() as tmp:
        ref = TD.reference_outputs(Path(tmp))
        arrays, meta, _, data = ref
        for i, (mesh_name, name, comp, tol) in enumerate(TD.COLLECTIVES):
            xs = TD._coll_inputs(int(np.prod(TD.MESHES[mesh_name][0])), seed=len(mesh_name))
            got, fb, _ = TD._port_collective(mesh_name, name, comp, tol, xs)
            want = arrays[f"coll/{i}"]
            diff = np.abs(got.astype(np.float64) - want)
            yield {"collective": name, "mesh": mesh_name, "compression": comp, "tolerance": tol,
                   "max_abs_diff": float(diff.max()),
                   "max_rel_diff": float((diff / np.maximum(np.abs(want), 1e-30)).max()),
                   "fallbacks_equal": fb.tolist() == arrays[f"coll/{i}/fallbacks"].tolist()}
        draw, TSMP.uniform = TSMP.uniform, replay_uniform
        try:
            exact_rmse = {}
            for name, (ds, knobs, *_rest) in TD.FITS.items():
                tb = TD._port_fit(ref, name)
                same = all(np.array_equal(getattr(tb.ensemble, f).numpy(), arrays[f"{name}/{f}"])
                           for f in STRUCTURE)
                line = {"fit": name, "structure_same": same,
                        "leaf_atol_needed": float(np.abs(tb.ensemble.leaf_value.numpy()
                                                         - arrays[f"{name}/leaf_value"]).max())
                        if same else None,
                        "comm_stats_equal": tb.comm_stats == meta["fits"][name]["comm_stats"]}
                if ds == "b":
                    x, y = data["b"]
                    rmse = float(np.sqrt(np.mean((tb.predict(x).numpy() - y) ** 2)))
                    exact_rmse.setdefault("b", rmse)
                    line["rmse_rel_gap_to_exact"] = abs(rmse - exact_rmse["b"]) / exact_rmse["b"]
                yield line
        finally:
            TSMP.uniform = draw
        one = Booster(**TD.A).fit(TD._dmat(ref, "a", 32))
        for name in ("psum", "psum_d2", "hier_2axis"):
            tb = TD._port_fit(ref, name)
            yield {"fit": name, "against": "the port's single-device fit",
                   "structure_same": all(torch.equal(getattr(tb.ensemble, f),
                                                     getattr(one.ensemble, f)) for f in STRUCTURE),
                   "leaf_atol_needed": float((tb.ensemble.leaf_value
                                              - one.ensemble.leaf_value).abs().max())}


if __name__ == "__main__":
    import sys

    # Objective names as arguments: only their fit readings; `stochastic`:
    # the stochastic readings alone.
    chosen = tuple(sys.argv[1:])
    if chosen == ("stochastic",):
        lines = (*constrained_gain_readings(), *stochastic_fit_readings())
    elif chosen == ("resilience",):
        lines = resilience_readings()
    elif chosen == ("external",):
        lines = external_readings()
    elif chosen == ("dist",):
        lines = dist_readings()
    else:
        rank = "rank:pairwise" in chosen or not chosen
        chosen = tuple(o for o in chosen if o != "rank:pairwise")
        lines = (*(() if sys.argv[1:] else split_scan_readings()),
                 *(fit_readings(objectives=chosen) if chosen or not sys.argv[1:] else ()),
                 *((*pairwise_readings(), *rank_fit_readings()) if rank else ()))
    for line in lines:
        print(json.dumps(line), flush=True)
