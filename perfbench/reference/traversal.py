"""Scoring raw rows with a tree ensemble, in plain torch.

Each tree is an arena (node i has children 2i + 1 and 2i + 2): at a split a
row goes left when its feature value is at most the threshold, a missing
value (NaN) to the node's default side; a leaf adds its value. A row's
margin is the base score plus every tree's leaf; binary:logistic returns
its sigmoid. Computed in `dtype` (float64 for the judge; the control's
lower precision rounds the rows, the thresholds and the leaves), in blocks
of rows and trees.
"""
from __future__ import annotations

import torch

ROWS_BLOCK = 1 << 18
TREES_BLOCK = 64


def margins(feature: torch.Tensor, threshold: torch.Tensor, default_left: torch.Tensor,
            leaf_value: torch.Tensor, is_leaf: torch.Tensor, x: torch.Tensor, depth: int,
            dtype: torch.dtype, base_score: float = 0.0) -> torch.Tensor:
    """(n,) margins of the rows x (n, F) under trees (T, A)."""
    n = x.shape[0]
    out = torch.full((n,), float(base_score), dtype=dtype, device=x.device)
    thr_all = threshold.to(dtype)
    leaf_all = leaf_value.to(dtype)
    for r0 in range(0, n, ROWS_BLOCK):
        xb = x[r0:r0 + ROWS_BLOCK].to(dtype)
        row = torch.arange(xb.shape[0], device=x.device)[None, :]
        parts = []
        for t0 in range(0, feature.shape[0], TREES_BLOCK):
            t = slice(t0, t0 + TREES_BLOCK)
            feat, thr = feature[t].to(torch.int64), thr_all[t]
            dl, leaf = default_left[t], is_leaf[t]
            node = torch.zeros((feat.shape[0], xb.shape[0]), dtype=torch.int64,
                               device=x.device)
            for _ in range(depth):
                v = xb[row, torch.gather(feat, 1, node)]
                left = torch.where(torch.isnan(v), torch.gather(dl, 1, node),
                                   v <= torch.gather(thr, 1, node))
                nxt = torch.where(left, 2 * node + 1, 2 * node + 2)
                node = torch.where(torch.gather(leaf, 1, node), node, nxt)
            parts.append(torch.gather(leaf_all[t], 1, node))
        out[r0:r0 + xb.shape[0]] += torch.cat(parts).sum(dim=0)
    return out


def predict(objective: str, *args, **kwargs) -> torch.Tensor:
    m = margins(*args, **kwargs)
    if objective == "binary:logistic":
        return torch.sigmoid(m)
    raise ValueError(f"the reference has no transform for {objective!r}")
