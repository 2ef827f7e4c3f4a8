#!/usr/bin/env python3
"""Write the reference checkpoint that the port loads where JAX is absent.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/make_reference_checkpoint.py [--out tests/data]

Trains a small model with the JAX package (`repro`): 4 rounds, depth 3,
8 features, 64 bins, binary:logistic, with an eval set so that its history
is not empty. It writes, from seed 0:

  repro_booster_v2.ckpt       the model, by `Booster.save` (format
                              repro.booster, version 2)
  repro_booster_v2_rows.npy   256 rows (float32, some NaN)
  repro_booster_v2_pred.npy   the model's `predict` on those rows (float32)

The same versions of jax and numpy give the same bytes on every run;
`tests/test_torch_checkpoint.py` checks that they match the committed files.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

NAME = "repro_booster_v2"
N_ROWS, N_FEATURES, N_PREDICT = 2000, 8, 256
KW = dict(n_rounds=4, max_depth=3, max_bins=64, objective="binary:logistic")


def write(out: Path) -> dict[str, Path]:
    """Fit the model and write the three files into `out`; returns their paths."""
    from repro.core import Booster, DeviceDMatrix

    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_ROWS, N_FEATURES)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    z = np.nan_to_num(x)
    y = (z[:, 0] + 0.5 * z[:, 1] * z[:, 2] - z[:, 3] > 0).astype(np.float32)
    rows = rng.normal(size=(N_PREDICT, N_FEATURES)).astype(np.float32)
    rows[rng.random(rows.shape) < 0.1] = np.nan

    n_tr = N_ROWS * 3 // 4
    dtrain = DeviceDMatrix(x[:n_tr], label=y[:n_tr], max_bins=KW["max_bins"])
    dvalid = DeviceDMatrix(x[n_tr:], label=y[n_tr:], ref=dtrain)
    bst = Booster(**KW).fit(dtrain, evals=[(dvalid, "valid")], eval_metric="logloss")

    out.mkdir(parents=True, exist_ok=True)
    paths = {"ckpt": out / f"{NAME}.ckpt", "rows": out / f"{NAME}_rows.npy",
             "pred": out / f"{NAME}_pred.npy"}
    bst.save(str(paths["ckpt"]))
    np.save(paths["rows"], rows)
    np.save(paths["pred"], np.asarray(bst.predict(rows), np.float32))
    return paths


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path,
                    default=Path(__file__).resolve().parents[1] / "tests" / "data")
    for path in write(ap.parse_args().out).values():
        print(path, path.stat().st_size)


if __name__ == "__main__":
    main()
