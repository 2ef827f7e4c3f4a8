"""Dispatch between the CUDA kernels and their plain versions; counterpart
of `repro.kernels.ops`.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version in
`kernels/ref.py`. Nothing else: a kernel that fails to build or launch
raises, it never gives way to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantile as Q
from repro_torch.core.compress import PackedBins
from repro_torch.kernels import ref as R
from repro_torch.kernels.decompress import decompress
from repro_torch.kernels.ensemble_traversal import ensemble_margins_kernel
from repro_torch.kernels.histogram import (
    build_histograms_packed_kernel,
    build_histograms_rows_kernel,
    histogram_packed,
)
from repro_torch.kernels.quantile_cuts import quantile_cuts_from_sorted
from repro_torch.kernels.split_scan import split_scan as split_scan_kernel

# The wrappers whose `launches` count shows which kernels a run went through.
KERNELS = {
    "histogram_private": build_histograms_packed_kernel,
    "histogram_rows": build_histograms_rows_kernel,
    "histogram_packed": histogram_packed,
    "split_scan": split_scan_kernel,
    "quantile_cuts": quantile_cuts_from_sorted,
    "ensemble_traversal": ensemble_margins_kernel,
    "decompress": decompress,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def histogram_packed_op(packed: torch.Tensor, gh: torch.Tensor, positions: torch.Tensor,
                        n_nodes: int, max_bins: int, bits: int) -> torch.Tensor:
    """(n_nodes, F, max_bins, 2) histogram from packed words through the
    global-atomic kernel; positions n_nodes or -1 are inactive."""
    if packed.is_cuda:
        return histogram_packed(packed, gh.contiguous(),
                                positions.to(torch.int32).contiguous(),
                                n_nodes, max_bins, bits)
    return R.histogram_packed_ref(packed, gh, positions, n_nodes, max_bins, bits)


def histogram_private_op(packed: torch.Tensor, gh: torch.Tensor, positions: torch.Tensor,
                         n_nodes: int, max_bins: int, bits: int) -> torch.Tensor:
    """(n_nodes, F, max_bins, 2) histogram from packed words through the
    privatised kernel."""
    if packed.is_cuda:
        return build_histograms_packed_kernel(
            packed, gh.contiguous(), positions.to(torch.int32).contiguous(),
            n_nodes, max_bins, bits)
    return R.histogram_ref(packed, gh, positions, n_nodes, max_bins, bits)


def build_histograms_kernel_packed(data: PackedBins, gh: torch.Tensor,
                                   positions: torch.Tensor, n_nodes: int,
                                   max_bins: int) -> torch.Tensor:
    """The `hist_builder` of `use_kernel_histograms=True`: the training
    matrix's packed words straight to the privatised kernel, every level."""
    return histogram_private_op(data.packed, gh, positions, n_nodes, max_bins,
                                data.bits)


def histogram_rows(packed: torch.Tensor, gh_sel: torch.Tensor, pos_sel: torch.Tensor,
                   row_ids: torch.Tensor, n_nodes: int, max_bins: int,
                   bits: int) -> torch.Tensor:
    """(n_nodes, F, max_bins, 2) histogram of a compacted row buffer."""
    if packed.is_cuda:
        return build_histograms_rows_kernel(
            packed, gh_sel.contiguous(), pos_sel.to(torch.int32).contiguous(),
            row_ids.to(torch.int32).contiguous(), n_nodes, max_bins, bits)
    return R.histogram_rows_ref(packed, gh_sel, pos_sel, row_ids, n_nodes,
                                max_bins, bits)


def decompress_op(packed: torch.Tensor, bits: int, n_rows: int) -> torch.Tensor:
    """(n_rows, F) int32 bins unpacked from the packed words."""
    if packed.is_cuda:
        return decompress(packed.contiguous(), bits, n_rows)
    return R.decompress_ref(packed, bits, n_rows)


def compute_cuts_op(x: torch.Tensor, max_bins: int) -> torch.Tensor:
    """Per-feature cut points (F, max_bins - 2) f32, ascending, +inf tail:
    missing values filled with +inf, each column sorted with `torch.sort`,
    then the cut-selection kernel (its plain version on the CPU) and the
    ascending re-sort that moves its +inf dedup markers to the tail."""
    x = x.to(torch.float32)
    finite = torch.isfinite(x)
    srt = torch.sort(torch.where(finite, x, float("inf")), dim=0).values
    n_valid = finite.sum(dim=0, dtype=torch.int32)
    if srt.is_cuda:
        cand = quantile_cuts_from_sorted(srt.contiguous(), n_valid, max_bins)
    else:
        cand = R.quantile_cuts_ref(srt, n_valid, max_bins)
    return torch.sort(cand, dim=-1).values


def quantize_op(x: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """(n_rows, F) int32 bin ids; NaN takes the missing bin. Plain PyTorch
    on both devices: the reference computes it outside any kernel too."""
    return Q.quantize(x, cuts)


def split_scan(hist: torch.Tensor, parent_sum: torch.Tensor,
               reg_lambda: float = 1.0, min_child_weight: float = 1.0) -> torch.Tensor:
    """(n_nodes, F, 5): [gain, bin, default_left, gl, hl] per (node, feature);
    `core.split` forms the left child's sums from gl and hl."""
    if hist.is_cuda:
        return split_scan_kernel(hist.contiguous(), parent_sum.contiguous(),
                                 reg_lambda, min_child_weight)
    return R.split_scan_ref(hist, parent_sum, reg_lambda, min_child_weight)


def split_scan_op(hist: torch.Tensor, parent_sum: torch.Tensor,
                  reg_lambda: float = 1.0, min_child_weight: float = 1.0) -> torch.Tensor:
    """(n_nodes, F, 4): [gain, bin, default_left, hl] per (node, feature), the
    reference's fields (`split_scan` without gl)."""
    return split_scan(hist, parent_sum, reg_lambda, min_child_weight)[..., [0, 1, 2, 4]]


def ensemble_margins_op(feature, threshold, default_left, leaf_value, is_leaf,
                        x: torch.Tensor, n_classes: int, max_depth: int) -> torch.Tensor:
    """(N, n_classes) margins of raw rows over all trees, without base_score."""
    if x.is_cuda:
        return ensemble_margins_kernel(
            feature, threshold.contiguous(), default_left, leaf_value.contiguous(),
            is_leaf, x.contiguous(), n_classes, max_depth)
    return R.ensemble_margins_ref(feature, threshold, default_left, leaf_value,
                                  is_leaf, x, n_classes, max_depth)
