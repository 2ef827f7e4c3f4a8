"""Worst port-vs-reference readings over many seeds, behind the tolerances of
tests/test_torch_kernels.py (split scan) and tests/test_torch_booster.py (fits).

Run from the repository root (CPU, a few minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_parity_readings.py

Prints one JSON line per reading: the split scan's |Δgain| / max(|gain|, 1) and
hl error per shape over 60 seeds, then for each fit the atol it needs beside
rtol 1e-5 on leaves, training margins and predicted margins, over data seeds
0-9 of the booster fixture (null where the tree structure differs).
"""
import json

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import Booster as JBooster
from repro.core import DeviceDMatrix as JDMatrix
from repro.kernels import ops as JO
from repro_torch.core import Booster, DeviceDMatrix
from repro_torch.kernels import ops

SCAN_SHAPES = [((1, 3, 8), 1.0, 0.5), ((3, 17, 64), 1.0, 1.0), ((8, 5, 256), 0.5, 2.0),
               ((2, 4, 33), 2.0, 0.0)]  # as in test_split_scan_plain_vs_reference
OBJECTIVES = {"reg:squarederror": 1, "binary:logistic": 1, "multi:softmax": 3}


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


def fit_readings(seeds=range(10)):
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
        for objective, k in OBJECTIVES.items():
            kw = dict(n_rounds=4, max_depth=4, max_bins=32, objective=objective, n_classes=k)
            jd = JDMatrix(x, label=labels[objective], max_bins=32)
            jb = JBooster(**kw).fit(jd)
            tb = Booster(**kw).fit(DeviceDMatrix(x, label=labels[objective], max_bins=32,
                                                 cuts=np.asarray(jd.cuts), device="cpu"))
            same = all(np.array_equal(getattr(tb.ensemble, a).numpy(),
                                      np.asarray(getattr(jb.ensemble, a)))
                       for a in ("feature", "split_bin", "default_left", "is_leaf"))
            reading = {"fit_seed": seed, "objective": objective, "structure_same": same,
                       "atol_needed": None}
            if same:
                reading["atol_needed"] = max(
                    atol(tb.ensemble.leaf_value.numpy(), np.asarray(jb.ensemble.leaf_value)),
                    atol(tb.margins.numpy(), np.asarray(jb.margins)),
                    *(atol(tb.predict_margins(r).numpy(), np.asarray(jb.predict_margins(r)))
                      for r in (x, x_new)))
            yield reading


if __name__ == "__main__":
    for line in (*split_scan_readings(), *fit_readings()):
        print(json.dumps(line), flush=True)
