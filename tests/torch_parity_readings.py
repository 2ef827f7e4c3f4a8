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
"""
import json

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.core import objectives as JOBJ
from repro.kernels import ops as JO
from repro_torch.core import Booster, DeviceDMatrix
from repro_torch.kernels import ops

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


def _split_gain(gh, bins, feature, split_bin, default_left, missing_bin, lam):
    """The reference's gain formula for one split of a node's rows, in
    float64: (gain, the sum of its terms' magnitudes, the smaller child's
    hessian sum). gh (n, 2) and bins (n, f) are the node's rows."""
    col = bins[:, feature]
    left = np.where(col == missing_bin, default_left, col <= split_bin)
    g, h = gh.sum(0)
    gl, hl = gh[left].sum(0)
    terms = (gl * gl / (hl + lam), (g - gl) ** 2 / (h - hl + lam), g * g / (h + lam))
    return 0.5 * (terms[0] + terms[1] - terms[2]), 0.5 * sum(terms), float(min(hl, h - hl))


def tie_witness(kw, jd, jb, tb, y, group_ids=None):
    """Where the port's structure first departs from the reference's (every
    earlier slot equal, so both reach the node with the same rows): each
    package's choice there, None for a leaf, else its split scored by the
    reference's gain in float64 on the reference's own gradients at the
    start of that tree's round (with the training matrix's query groups,
    `group_ids`, for rank:pairwise). A flip that is only rounding scores
    both alike. None when the structures agree."""
    at = first_difference(jb, tb)
    if at is None:
        return None
    tree, node = at
    k, missing_bin = jb.ensemble.n_classes, kw["max_bins"] - 1
    ref = {a: np.asarray(getattr(jb.ensemble, a))[tree] for a in STRUCTURE}
    bins = np.asarray(jd.matrix.unpack())
    row = np.arange(bins.shape[0])
    pos = np.zeros(bins.shape[0], np.int64)  # each row's node on the shared path
    for _ in range(int(np.log2(node + 1))):
        col = bins[row, ref["feature"][pos]]
        go_left = np.where(col == missing_bin, ref["default_left"][pos],
                           col <= ref["split_bin"][pos])
        pos = np.where(ref["is_leaf"][pos], pos, np.where(go_left, 2 * pos + 1, 2 * pos + 2))
    rows = pos == node
    rounds = tree // k
    margins = (np.full((bins.shape[0], k), jb.base_score, np.float32) if rounds == 0
               else np.asarray(JBooster(**{**kw, "n_rounds": rounds}).fit(jd).margins))
    groups = {} if group_ids is None else {"group_ids": jnp.asarray(group_ids)}
    gh = np.asarray(JOBJ.get_objective(kw["objective"]).grad(
        jnp.asarray(margins), jnp.asarray(y), quantile_alpha=QUANTILE_ALPHA, **groups))
    gh = gh[rows, tree % k].astype(np.float64)
    out = {"tree": tree, "node": node, "rows": int(rows.sum())}
    for who, ens in (("ref", jb.ensemble), ("port", tb.ensemble)):
        arena = {a: np.asarray(getattr(ens, a))[tree][node] for a in STRUCTURE}
        if arena["is_leaf"]:
            out[who] = None
            continue
        gain, scale, min_hess = _split_gain(gh, bins[rows], int(arena["feature"]),
                                            int(arena["split_bin"]),
                                            bool(arena["default_left"]), missing_bin,
                                            jb.cfg.reg_lambda)
        out[who] = {"feature": int(arena["feature"]), "split_bin": int(arena["split_bin"]),
                    "default_left": bool(arena["default_left"]), "gain": float(gain),
                    "terms": float(scale), "min_child_hess": min_hess}
    return out


def fit_readings(seeds=range(10), objectives=()):
    def atol(a, b):  # the least atol that passes beside rtol 1e-5
        return float(np.max(np.abs(a - b) - 1e-5 * np.abs(b)))

    for seed in seeds:  # the data of test_torch_booster.py's fixture, seed 5 there
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


if __name__ == "__main__":
    import sys

    # Objective names as arguments: only their fit readings.
    chosen = tuple(sys.argv[1:])
    rank = "rank:pairwise" in chosen or not chosen
    chosen = tuple(o for o in chosen if o != "rank:pairwise")
    lines = (*(() if sys.argv[1:] else split_scan_readings()),
             *(fit_readings(objectives=chosen) if chosen or not sys.argv[1:] else ()),
             *((*pairwise_readings(), *rank_fit_readings()) if rank else ()))
    for line in lines:
        print(json.dumps(line), flush=True)
