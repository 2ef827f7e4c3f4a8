"""RepartitionInstances (paper §2.3, Algorithm 1); counterpart of
`repro.core.partition.update_positions_packed`.

Arena indexing: complete binary tree, children of node k are 2k+1 / 2k+2.
positions[i] = arena node id of row i, or -1 once the row rests in a leaf.
"""
from __future__ import annotations

import torch

from repro_torch.core import compress as C


def update_positions_packed(
    packed: torch.Tensor,  # (f, n_words) int32 bit-packed bins
    positions: torch.Tensor,  # (n,) int32 arena node ids, -1 = inactive
    split_mask: torch.Tensor,  # (n_arena,) bool — nodes that split this level
    feature: torch.Tensor,  # (n_arena,) int32
    split_bin: torch.Tensor,  # (n_arena,) int32
    default_left: torch.Tensor,  # (n_arena,) bool
    missing_bin: int,
    bits: int,
) -> torch.Tensor:
    """Route every row of a splitting node to a child: the split-feature bin
    comes straight from the packed words (one word gather + shift/mask per
    row), missing values follow the learned default direction."""
    pos = torch.clamp(positions, min=0).to(torch.int64)
    splits_here = split_mask[pos] & (positions >= 0)
    b = C.gather_feature_bins(packed, bits, feature[pos])
    go_left = torch.where(b == missing_bin, default_left[pos], b <= split_bin[pos])
    child = torch.where(go_left, 2 * pos + 1, 2 * pos + 2)
    return torch.where(splits_here, child, -1).to(torch.int32)
