"""Carry a trained model across from numpy arrays.

`booster_from_numpy(state)` builds a port Booster from a dict of numpy
values: the `BoosterConfig` fields, `cuts`, `base_score`, `n_classes` and the
seven Ensemble arena fields. A model trained by the JAX package converts with
`np.asarray` on each of its arrays, so both packages predict with one model.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.booster import Booster, BoosterConfig
from repro_torch.core.predict import ENSEMBLE_FIELDS, Ensemble
from repro_torch.device import as_tensor, resolve_device

_DTYPES = {
    "feature": torch.int32, "split_bin": torch.int32, "threshold": torch.float32,
    "default_left": torch.bool, "leaf_value": torch.float32,
    "is_leaf": torch.bool, "gain": torch.float32,
}


def booster_from_numpy(state: dict, device=None) -> Booster:
    """A fitted Booster on `device` (the card unless "cpu") from `state`."""
    dev = resolve_device(device)
    names = {f.name for f in dataclasses.fields(BoosterConfig)}
    cfg = BoosterConfig(**{k: v for k, v in state.items() if k in names})
    n_classes = int(state["n_classes"])
    base_score = float(state["base_score"])
    arrays = {f: as_tensor(state[f], dev, _DTYPES[f]) for f in ENSEMBLE_FIELDS}
    ens = Ensemble(**arrays, n_classes=n_classes, base_score=base_score)
    if ens.n_trees % n_classes:
        raise ValueError(f"{ens.n_trees} trees do not fill rounds of {n_classes}")
    bst = Booster(cfg)
    bst.device = dev
    bst.cuts = as_tensor(state["cuts"], dev)
    bst.base_score = base_score
    bst.ensemble = ens
    bst.n_rounds_trained = ens.n_trees // n_classes
    return bst
