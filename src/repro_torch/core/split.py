"""Split evaluation via a prefix sum over bins (paper §2.3, EvaluateSplit);
counterpart of `repro.core.split`.

The per-(node, feature) scan, both missing-value directions and the
per-feature argmax run in one pass (the split-scan kernel on a CUDA tensor,
its plain version on a CPU tensor); a small epilogue here subtracts gamma,
takes the argmax across features and forms the child sums.

Gain (XGBoost's regularised objective):
  gain = 1/2 [ GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam) ] - gamma

Stochastic and constrained inputs, as in the reference (DESIGN.md §12),
both taken by the same kernel launch:

  * feature_mask — (f,) or (n_nodes, f) bool; a masked-out feature scores
    -inf and never wins (colsample_bytree/bylevel/bynode).
  * monotone + node_bounds — per-feature direction constraints with the
    nodes' inherited value bounds [lower, upper]: child weights clipped to
    the bounds, the gain taken at the clipped weights (`_gain_at_weight`,
    XGBoost's CalcGainGivenWeight), splits whose clipped weights break
    their feature's direction rejected.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
# The reference's helper, shared with the plain version of the split scan.
from repro_torch.kernels.ref import gain_at_weight as _gain_at_weight  # noqa: F401


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
    feature_mask: torch.Tensor | None = None,  # (f,) or (n_nodes, f) bool
    monotone: torch.Tensor | None = None,  # (f,) int in {-1, 0, 1}
    node_bounds: torch.Tensor | None = None,  # (n_nodes, 2) [lower, upper]
) -> Splits:
    """Best split of every node. Ties go to the lowest (feature, bin), as in
    the reference's flat argmax. `node_bounds` is required with
    `monotone`."""
    if monotone is not None and node_bounds is None:
        raise ValueError("evaluate_splits: node_bounds is required with monotone")
    n_nodes = hist.shape[0]
    per_feature = ops.split_scan(
        hist, parent_sum, params.reg_lambda, params.min_child_weight,
        feature_mask=feature_mask, monotone=monotone,
        node_bounds=None if monotone is None else node_bounds)  # (n, F, 5)
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
