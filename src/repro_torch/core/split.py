"""Split evaluation via a prefix sum over bins (paper §2.3, EvaluateSplit);
counterpart of `repro.core.split`.

The per-(node, feature) scan, both missing-value directions and the
per-feature argmax run in one pass (the split-scan kernel on a CUDA tensor,
its plain version on a CPU tensor); a small epilogue here subtracts gamma,
takes the argmax across features and forms the child sums.

Gain (XGBoost's regularised objective):
  gain = 1/2 [ GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam) ] - gamma
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops


class SplitParams(NamedTuple):
    reg_lambda: float = 1.0
    gamma: float = 0.0
    min_child_weight: float = 1.0


class Splits(NamedTuple):
    """Best split per node (level-local tensors of length n_nodes)."""

    gain: torch.Tensor  # (n,) float32, -inf if no valid split
    feature: torch.Tensor  # (n,) int32
    split_bin: torch.Tensor  # (n,) int32: bin <= split_bin goes left
    default_left: torch.Tensor  # (n,) bool: where missing values go
    left_sum: torch.Tensor  # (n, 2) float32 (G, H) of the left child
    right_sum: torch.Tensor  # (n, 2) float32


def evaluate_splits(
    hist: torch.Tensor,  # (n_nodes, n_features, max_bins, 2)
    parent_sum: torch.Tensor,  # (n_nodes, 2) total (G, H) per node
    params: SplitParams = SplitParams(),
    feature_mask: torch.Tensor | None = None,
    monotone: torch.Tensor | None = None,
    node_bounds: torch.Tensor | None = None,
) -> Splits:
    """Best split of every node. Ties go to the lowest (feature, bin), as in
    the reference's flat argmax."""
    if feature_mask is not None:
        raise NotImplementedError("feature_mask (colsample_*) is not ported yet")
    if monotone is not None or node_bounds is not None:
        raise NotImplementedError("monotone constraints are not ported yet")
    n_nodes = hist.shape[0]
    per_feature = ops.split_scan(hist, parent_sum, params.reg_lambda,
                                 params.min_child_weight)  # (n, F, 5)
    gain = per_feature[..., 0] - params.gamma  # (n, F)
    best_f = torch.argmax(gain, dim=1)  # first max: lowest feature
    nodes = torch.arange(n_nodes, device=hist.device)
    best = per_feature[nodes, best_f]  # (n, 5)
    left_sum = best[:, 3:5].contiguous()
    return Splits(
        gain=gain[nodes, best_f],
        feature=best_f.to(torch.int32),
        split_bin=best[:, 1].to(torch.int32),
        default_left=best[:, 2] > 0.5,
        left_sum=left_sum,
        right_sum=parent_sum - left_sum,
    )


def leaf_value(sum_gh: torch.Tensor, reg_lambda: float) -> torch.Tensor:
    """Optimal leaf weight -G/(H+lambda). sum_gh (..., 2) -> (...)."""
    return -sum_gh[..., 0] / (sum_gh[..., 1] + reg_lambda)
