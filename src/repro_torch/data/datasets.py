"""Synthetic stand-ins for the paper's six datasets (Table 1).

A numpy copy of `repro.data.datasets` (the port imports nothing of the JAX
package): the same seed gives the same arrays in both packages. Each public
dataset is mirrored by a generator with the SAME rows/columns/task (and
sparsity character for bosch), so nothing is downloaded. Learnable
structure (linear + interactions + noise) is injected so accuracy numbers
are meaningful, even though absolute values cannot match the real data.

| name            | rows | cols | task                      |
|-----------------|------|------|---------------------------|
| year_prediction | 515K | 90   | regression                |
| synthetic       | 10M  | 100  | regression                |
| higgs           | 11M  | 28   | binary classification     |
| covtype         | 581K | 54   | multiclass (7)            |
| bosch           | 1M   | 968  | binary, 81% missing       |
| airline         | 115M | 13   | binary classification     |
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_rows: int
    n_features: int
    task: str  # reg | binary | multiclass
    n_classes: int = 1
    missing_frac: float = 0.0
    objective: str = "reg:squarederror"
    metric: str = "rmse"


DATASETS: dict[str, DatasetSpec] = {
    "year_prediction": DatasetSpec(
        "year_prediction", 515_345, 90, "reg", objective="reg:squarederror"
    ),
    "synthetic": DatasetSpec(
        "synthetic", 10_000_000, 100, "reg", objective="reg:squarederror"
    ),
    "higgs": DatasetSpec(
        "higgs", 11_000_000, 28, "binary",
        objective="binary:logistic", metric="accuracy",
    ),
    "covtype": DatasetSpec(
        "covtype", 581_012, 54, "multiclass", n_classes=7,
        objective="multi:softmax", metric="accuracy",
    ),
    "bosch": DatasetSpec(
        "bosch", 1_183_747, 968, "binary", missing_frac=0.81,
        objective="binary:logistic", metric="accuracy",
    ),
    "airline": DatasetSpec(
        "airline", 115_000_000, 13, "binary",
        objective="binary:logistic", metric="accuracy",
    ),
}


def dataset_spec(name: str) -> DatasetSpec:
    return DATASETS[name]


def make_dataset(
    name: str,
    n_rows: int | None = None,
    seed: int = 0,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray, DatasetSpec]:
    """Generate (x, y, spec). n_rows defaults to the full paper size —
    pass a reduced count for CPU benchmarking."""
    spec = DATASETS[name]
    n = n_rows or spec.n_rows
    f = spec.n_features
    # zlib.crc32, not hash(): Python string hashing is randomised per
    # process, which would make every process generate different "datasets"
    # (and cross-process comparisons — e.g. single- vs multi-device CLI
    # runs — silently incomparable).
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**31)

    x = rng.standard_normal((n, f), dtype=np.float32)
    # Learnable structure: sparse linear signal + pairwise interactions.
    # Informative features are the FIRST k columns so that benchmark column
    # caps (e.g. bosch's 968 -> 128 on CPU) keep the signal intact.
    k = max(3, min(f // 5, 24))
    w = np.zeros(f, np.float32)
    w[:k] = rng.standard_normal(k).astype(np.float32)
    signal = x @ w
    for _ in range(3):
        i, j = rng.integers(0, k, size=2)
        signal += 0.5 * x[:, i] * x[:, j]
    noise = 0.3 * rng.standard_normal(n).astype(np.float32)

    if spec.task == "reg":
        y = (signal + noise).astype(dtype)
    elif spec.task == "binary":
        y = (signal + noise > 0).astype(dtype)
    else:
        qs = np.quantile(signal, np.linspace(0, 1, spec.n_classes + 1)[1:-1])
        y = np.digitize(signal + noise, qs).astype(dtype)

    if spec.missing_frac > 0:
        mask = rng.random(x.shape) < spec.missing_frac
        x[mask] = np.nan

    return x.astype(dtype), y, spec
