"""Gradient histogram construction (paper §2.3, BuildPartialHistograms);
counterpart of `repro.core.histogram`.

positions[i] is the level-local node index of row i (0..n_nodes-1), or
`n_nodes` for rows that are inactive (already in a finished leaf); a
negative position is inactive too. The `*_chunked` builders read the
external-memory chunk stack (`compress.ChunkedPackedBins`); the
`*_chunk_update` units add ONE chunk's rows into a running histogram, the
streamed path's unit (`core/stream.py`): the running buffer is a slab,
(n_nodes + 1, F, max_bins, 2) float32 whose last node is the dump slot,
and `finalize_slab_histogram` drops that slot once every chunk is in.
"""
from __future__ import annotations

import torch


def build_histograms(
    bins: torch.Tensor,  # (n, f) int bin ids
    gh: torch.Tensor,  # (n, 2) float32 gradient/hessian pairs
    positions: torch.Tensor,  # (n,) int level-local node ids, n_nodes = inactive
    n_nodes: int,
    max_bins: int,
    flat: torch.Tensor | None = None,  # (n_nodes + 1, f, max_bins, 2) slab to add into
) -> torch.Tensor:
    """Dense scatter-add: hist (n_nodes, n_features, max_bins, 2) in gh's
    dtype (float32 on the training path).

    One flat index ((pos * F) + f) * B + bin per (row, feature); inactive
    rows land in a dump slot that is sliced off. Given `flat`, the rows are
    added into it in row order (not zeroed first, the dump slot kept), so
    chunk after chunk into one slab adds each slot's terms in the order of
    one call over all the rows."""
    n, f = bins.shape
    pos = positions.to(torch.int64)
    pos = torch.where((pos >= 0) & (pos < n_nodes), pos, n_nodes)
    fidx = torch.arange(f, dtype=torch.int64, device=bins.device)[None, :]
    idx = (pos[:, None] * f + fidx) * max_bins + bins.to(torch.int64)
    if flat is None:
        flat = torch.zeros((n_nodes + 1, f, max_bins, 2), dtype=gh.dtype, device=bins.device)
    flat.view(-1, 2).index_add_(0, idx.reshape(-1),
                                gh[:, None, :].expand(n, f, 2).reshape(-1, 2))
    return flat[:n_nodes]


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


def build_histograms_chunked(
    packed: torch.Tensor,  # (n_chunks, f, words_per_chunk) int32 chunk stack
    gh: torch.Tensor,  # (n, 2) float32
    positions: torch.Tensor,  # (n,) int32 level-local node ids, n_nodes = inactive
    n_nodes: int,
    max_bins: int,
    bits: int,
    chunk_rows: int,
    n_rows: int,
) -> torch.Tensor:
    """build_histograms_packed over the external-memory chunk stack: the
    privatised kernel's chunked instantiation on a CUDA tensor (the whole
    stack in one launch; chunk padding rows go to the dump slot), its plain
    version on a CPU tensor, bit for bit the flat plain version on the same
    rows."""
    from repro_torch.kernels import ops  # lazy: ops imports kernels.ref -> here

    if gh.shape[0] != n_rows:
        raise ValueError(f"gh has {gh.shape[0]} rows, the matrix {n_rows}")
    return ops.histogram_private_op(packed, gh, positions, n_nodes, max_bins, bits,
                                    chunk_rows=chunk_rows)


def build_histograms_chunked_rows(
    packed: torch.Tensor,  # (n_chunks, f, words_per_chunk) int32 chunk stack
    gh_sel: torch.Tensor,  # (m, 2) float32, gathered for the selected rows
    pos_sel: torch.Tensor,  # (m,) int32 node ids, n_nodes = dump/padding slot
    row_ids: torch.Tensor,  # (m,) int32 GLOBAL row ids (past the stack = padding)
    n_nodes: int,
    max_bins: int,
    bits: int,
    chunk_rows: int,
) -> torch.Tensor:
    """build_histograms_packed_rows over the chunk stack, each row's words
    gathered from its own chunk: the row-id kernel's chunked instantiation
    on a CUDA tensor (one launch), its plain version on a CPU tensor."""
    from repro_torch.kernels import ops  # lazy: ops imports kernels.ref -> here

    return ops.histogram_rows(packed, gh_sel, pos_sel, row_ids, n_nodes, max_bins,
                              bits, chunk_rows=chunk_rows)


def new_slab(n_nodes: int, n_features: int, max_bins: int, device) -> torch.Tensor:
    """A zeroed running histogram for the `*_chunk_update` units:
    (n_nodes + 1, F, max_bins, 2) float32, the last node the dump slot."""
    return torch.zeros((n_nodes + 1, n_features, max_bins, 2), dtype=torch.float32,
                       device=device)


def histogram_chunk_update(
    hist: torch.Tensor,  # (n_nodes + 1, f, max_bins, 2) running slab
    words_c: torch.Tensor,  # (f, words_per_chunk) int32: one paged-in chunk
    gh_c: torch.Tensor,  # (rows, 2) float32: this chunk's gradient slice
    pos_c: torch.Tensor,  # (rows,) int32: this chunk's position slice
    n_nodes: int,
    max_bins: int,
    bits: int,
) -> torch.Tensor:
    """Add ONE chunk's rows into the running slab, the streamed twin of
    build_histograms_chunked: the privatised kernel's flat instantiation
    over the chunk's words on a CUDA tensor (one launch, added into the
    slab's first n_nodes nodes), its plain version on a CPU tensor
    (scattered into the slab in row order, so chunk after chunk is bit for
    bit one build over all rows). Returns `hist`."""
    from repro_torch.kernels import ops  # lazy: ops imports kernels.ref -> here

    ops.histogram_private_op(words_c, gh_c, pos_c, n_nodes, max_bins, bits, out=hist)
    return hist


def histogram_rows_chunk_update(
    hist: torch.Tensor,  # (n_nodes + 1, f, max_bins, 2) running slab
    words_c: torch.Tensor,  # (f, words_per_chunk) int32: one paged-in chunk
    gh_b: torch.Tensor,  # (m, 2) float32: this segment's compacted gradients
    pos_b: torch.Tensor,  # (m,) int32: this segment's node ids, n_nodes = dump
    rid_local: torch.Tensor,  # (m,) int: CHUNK-LOCAL row ids
    n_nodes: int,
    max_bins: int,
    bits: int,
) -> torch.Tensor:
    """Add one chunk-segment of a compacted row buffer into the running
    slab, the streamed twin of build_histograms_chunked_rows: the row-id
    kernel's flat instantiation over the chunk's words with chunk-local row
    ids. The caller splits the ascending buffer into per-chunk segments, so
    segments in chunk order add each slot's terms in the buffer's order.
    Returns `hist`."""
    from repro_torch.kernels import ops

    ops.histogram_rows(words_c, gh_b, pos_b, rid_local, n_nodes, max_bins, bits, out=hist)
    return hist


def finalize_slab_histogram(hist: torch.Tensor, n_nodes: int, max_bins: int) -> torch.Tensor:
    """(n_nodes + 1, f, max_bins, 2) running slab -> (n_nodes, f, max_bins,
    2) histogram: the dump slot dropped."""
    if hist.shape[0] != n_nodes + 1 or hist.shape[2] != max_bins:
        raise ValueError(f"a slab of {n_nodes} nodes and {max_bins} bins is "
                         f"({n_nodes + 1}, F, {max_bins}, 2), got {tuple(hist.shape)}")
    return hist[:n_nodes]


def node_sums(hist: torch.Tensor) -> torch.Tensor:
    """Total (G, H) per node, (n_nodes, 2): every feature's bins partition
    the same rows, so feature 0's suffice."""
    return hist[:, 0].sum(dim=1)
