"""Weights across packages: the reference's parameter tree (nested dicts of
arrays, taken leaf by leaf with `np.asarray`) as the port's tree of
tensors, path for path, and back. Dtypes are kept (float32 parameters,
int8 or bf16 cache leaves alike)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.pytree import tree_map


def _to_tensor(leaf, dev: torch.device) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry its bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_numpy(tree, device=None):
    """The tree with every array leaf a tensor on `device` (the card unless
    "cpu"); dicts, lists and tuples keep their structure."""
    dev = resolve_device(device)
    return tree_map(lambda leaf: _to_tensor(leaf, dev), tree)


def params_to_numpy(params):
    """The tree with every tensor leaf a numpy array on the host (bf16 as
    float32: numpy has no bf16)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(host, params)
