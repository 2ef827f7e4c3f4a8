"""Dispatch between the CUDA kernels and their plain versions; counterpart
of `repro.kernels.ops`.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version in
`kernels/ref.py`. Nothing else: a kernel that fails to build or launch
raises, it never gives way to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels.ensemble_traversal import ensemble_margins_kernel
from repro_torch.kernels.histogram import build_histograms_packed_kernel
from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
from repro_torch.kernels.split_scan import split_scan as split_scan_kernel

# The wrappers whose `launches` count shows which kernels a run went through.
KERNELS = {
    "histogram": build_histograms_packed_kernel,
    "split_scan": split_scan_kernel,
    "quantile_cuts": quantile_cuts_from_sorted,
    "ensemble_traversal": ensemble_margins_kernel,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def histogram(packed: torch.Tensor, gh: torch.Tensor, positions: torch.Tensor,
              n_nodes: int, max_bins: int, bits: int) -> torch.Tensor:
    """(n_nodes, F, max_bins, 2) histogram from packed words."""
    if packed.is_cuda:
        return build_histograms_packed_kernel(
            packed, gh.contiguous(), positions.to(torch.int32).contiguous(),
            n_nodes, max_bins, bits)
    return R.histogram_ref(packed, gh, positions, n_nodes, max_bins, bits)


def split_scan(hist: torch.Tensor, parent_sum: torch.Tensor,
               reg_lambda: float = 1.0, min_child_weight: float = 1.0) -> torch.Tensor:
    """(n_nodes, F, 5): [gain, bin, default_left, gl, hl] per (node, feature)."""
    if hist.is_cuda:
        return split_scan_kernel(hist.contiguous(), parent_sum.contiguous(),
                                 reg_lambda, min_child_weight)
    return R.split_scan_ref(hist, parent_sum, reg_lambda, min_child_weight)


def quantile_cuts(srt: torch.Tensor, n_valid: torch.Tensor, max_bins: int) -> torch.Tensor:
    """(F, max_bins - 2) pre-sort candidate cuts from sorted columns."""
    if srt.is_cuda:
        return quantile_cuts_from_sorted(srt.contiguous(), n_valid, max_bins)
    return R.quantile_cuts_ref(srt, n_valid, max_bins)


def ensemble_margins(feature, threshold, default_left, leaf_value, is_leaf,
                     x: torch.Tensor, n_classes: int, max_depth: int) -> torch.Tensor:
    """(N, n_classes) margins of raw rows over all trees, without base_score."""
    if x.is_cuda:
        return ensemble_margins_kernel(
            feature, threshold.contiguous(), default_left, leaf_value.contiguous(),
            is_leaf, x.contiguous(), n_classes, max_depth)
    return R.ensemble_margins_ref(feature, threshold, default_left, leaf_value,
                                  is_leaf, x, n_classes, max_depth)
