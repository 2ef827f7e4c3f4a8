"""Gradient histogram construction (paper §2.3, BuildPartialHistograms);
counterpart of `repro.core.histogram`.

positions[i] is the level-local node index of row i (0..n_nodes-1), or
`n_nodes` for rows that are inactive (already in a finished leaf); a
negative position is inactive too.
"""
from __future__ import annotations

import torch


def build_histograms(
    bins: torch.Tensor,  # (n, f) int bin ids
    gh: torch.Tensor,  # (n, 2) float32 gradient/hessian pairs
    positions: torch.Tensor,  # (n,) int level-local node ids, n_nodes = inactive
    n_nodes: int,
    max_bins: int,
) -> torch.Tensor:
    """Dense scatter-add: hist (n_nodes, n_features, max_bins, 2) in gh's
    dtype (float32 on the training path).

    One flat index ((pos * F) + f) * B + bin per (row, feature); inactive
    rows land in a dump slot that is sliced off."""
    n, f = bins.shape
    pos = positions.to(torch.int64)
    pos = torch.where((pos >= 0) & (pos < n_nodes), pos, n_nodes)
    fidx = torch.arange(f, dtype=torch.int64, device=bins.device)[None, :]
    idx = (pos[:, None] * f + fidx) * max_bins + bins.to(torch.int64)
    flat = torch.zeros(((n_nodes + 1) * f * max_bins, 2), dtype=gh.dtype,
                       device=bins.device)
    flat.index_add_(0, idx.reshape(-1), gh[:, None, :].expand(n, f, 2).reshape(-1, 2))
    return flat.reshape(n_nodes + 1, f, max_bins, 2)[:n_nodes]


def build_histograms_packed(
    packed: torch.Tensor,  # (f, n_words) int32 bit-packed bins
    gh: torch.Tensor,  # (n, 2) float32
    positions: torch.Tensor,  # (n,) int32 level-local node ids, n_nodes = inactive
    n_nodes: int,
    max_bins: int,
    bits: int,
) -> torch.Tensor:
    """build_histograms straight from the packed words (the dense bins never
    exist on the CUDA path): the privatised histogram kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    from repro_torch.kernels import ops  # lazy: ops imports kernels.ref -> here

    return ops.histogram_private_op(packed, gh, positions, n_nodes, max_bins, bits)


def build_histograms_packed_rows(
    packed: torch.Tensor,  # (f, n_words) int32 bit-packed bins
    gh_sel: torch.Tensor,  # (m, 2) float32, gathered for the selected rows
    pos_sel: torch.Tensor,  # (m,) int32 node ids, n_nodes = dump/padding slot
    row_ids: torch.Tensor,  # (m,) int32 original row ids (>= n_rows = padding)
    n_nodes: int,
    max_bins: int,
    bits: int,
) -> torch.Tensor:
    """Histogram over a compacted row subset straight from the packed words:
    the workhorse of the subtraction trick (the caller compacts the rows of
    each level's smaller children into `row_ids`). The row-id histogram
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    from repro_torch.kernels import ops  # lazy: ops imports kernels.ref -> here

    return ops.histogram_rows(packed, gh_sel, pos_sel, row_ids, n_nodes,
                              max_bins, bits)


def node_sums(hist: torch.Tensor) -> torch.Tensor:
    """Total (G, H) per node, (n_nodes, 2): every feature's bins partition
    the same rows, so feature 0's suffice."""
    return hist[:, 0].sum(dim=1)
