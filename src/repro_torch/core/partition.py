"""RepartitionInstances (paper §2.3, Algorithm 1); counterpart of
`repro.core.partition`. `update_positions` routes on dense bins,
`update_positions_packed` on the flat words, and `update_positions_on`,
which growth calls and which stands for the reference's
`update_positions_packed_rows`, `update_positions_chunked(_rows)` and the
streamed executor's routing, on any bins type (`compress.PackedBins`, the
external-memory chunk stack `compress.ChunkedPackedBins`, or
`stream.StreamedChunkedBins`), over all rows or a buffer's row ids,
through `bins.feature_bins`. On the resident chunk stack it reads each
row's bin by global row id; on the streamed stack `feature_bins` fills
the bins in one pass over the chunks. Routing is elementwise, so either
gives the flat routing's result.

Arena indexing: complete binary tree, children of node k are 2k+1 / 2k+2.
positions[i] = arena node id of row i, or -1 once the row rests in a leaf.
"""
from __future__ import annotations

import torch

from repro_torch.core import compress as C


def _route(positions, split_mask, feature, split_bin, default_left, missing_bin,
           gather_bins) -> torch.Tensor:
    """Send every row of a splitting node to a child; `gather_bins(f)` gives
    each row's bin of feature f[i]. Missing values follow the learned
    default direction."""
    pos = torch.clamp(positions, min=0).to(torch.int64)
    splits_here = split_mask[pos] & (positions >= 0)
    b = gather_bins(feature[pos])
    go_left = torch.where(b == missing_bin, default_left[pos], b <= split_bin[pos])
    child = torch.where(go_left, 2 * pos + 1, 2 * pos + 2)
    return torch.where(splits_here, child, -1).to(torch.int32)


def update_positions(
    bins: torch.Tensor,  # (n, f) int32 dense bins
    positions: torch.Tensor,  # (n,) int32 arena node ids, -1 = inactive
    split_mask: torch.Tensor,  # (n_arena,) bool — nodes that split this level
    feature: torch.Tensor,  # (n_arena,) int32
    split_bin: torch.Tensor,  # (n_arena,) int32
    default_left: torch.Tensor,  # (n_arena,) bool
    missing_bin: int,
) -> torch.Tensor:
    """Route rows on the dense bins (`compress_matrix=False`): a gather of
    each row's split-feature column."""
    return _route(positions, split_mask, feature, split_bin, default_left, missing_bin,
                  lambda f: torch.gather(bins, 1, f[:, None].to(torch.int64))[:, 0])



def update_positions_packed(
    packed: torch.Tensor,  # (f, n_words) int32 bit-packed bins
    positions: torch.Tensor,
    split_mask: torch.Tensor,
    feature: torch.Tensor,
    split_bin: torch.Tensor,
    default_left: torch.Tensor,
    missing_bin: int,
    bits: int,
) -> torch.Tensor:
    """update_positions on the packed words: the split-feature bin comes
    straight from them (one word gather + shift/mask per row)."""
    return _route(positions, split_mask, feature, split_bin, default_left, missing_bin,
                  lambda f: C.gather_feature_bins(packed, bits, f))


def update_positions_on(
    bins,  # a bins type: PackedBins, ChunkedPackedBins or StreamedChunkedBins
    positions: torch.Tensor,  # (n,) or, with row_ids, (m,) int32 arena node ids
    split_mask: torch.Tensor,
    feature: torch.Tensor,
    split_bin: torch.Tensor,
    default_left: torch.Tensor,
    missing_bin: int,
    row_ids: torch.Tensor | None = None,  # (m,) int row id of each buffer slot
) -> torch.Tensor:
    """update_positions_packed on any bins type: each row's
    (or, with `row_ids`, each buffer slot's) split-feature bin through
    `bins.feature_bins`."""
    return _route(positions, split_mask, feature, split_bin, default_left, missing_bin,
                  lambda f: bins.feature_bins(f, row_ids))
