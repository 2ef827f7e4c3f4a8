"""Gradient histogram construction (paper §2.3, BuildPartialHistograms);
counterpart of `repro.core.histogram`.

positions[i] is the level-local node index of row i (0..n_nodes-1), or
`n_nodes` for rows that are inactive (already in a finished leaf); a
negative position is inactive too. The `*_chunked` builders read the
external-memory chunk stack (`compress.ChunkedPackedBins`); the
`*_chunk_update` units add ONE chunk's rows into a running histogram, the
streamed path's unit (`core/stream.py`): the running buffer is a slab,
(n_nodes + 1, F, max_bins, 2) whose last node is the dump slot, and
`finalize_slab_histogram` drops that slot once every chunk is in.

Where `ops.fixed_point_histograms` says so (on a CUDA device) every
histogram is built in 64-bit fixed point (`kernels/fixed.py`): the rows'
(g, h) quantised at the call's exponent, added as integers, converted to
float32 once. Such a histogram is the same bits whatever the order of its
adds, so the dense scatter here, the kernels and their chunked and streamed
forms all give the same bits for the same rows. The slab is then int64, and
every chunk update and the finalize take the pass's one exponent
(`slab_exponent`). Elsewhere (the CPU) histograms are float32 sums in row
order, as in the reference. The histograms handed to growth are float32
either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fixed as FX


def build_histograms(
    bins: torch.Tensor,  # (n, f) int bin ids
    gh: torch.Tensor,  # (n, 2) float32 gradient/hessian pairs
    positions: torch.Tensor,  # (n,) int level-local node ids, n_nodes = inactive
    n_nodes: int,
    max_bins: int,
    flat: torch.Tensor | None = None,  # (n_nodes + 1, f, max_bins, 2) slab to add into
) -> torch.Tensor:
    """Dense scatter-add: hist (n_nodes, n_features, max_bins, 2) float32 on
    the training path (`scatter_histograms`, in gh's dtype).

    Where `ops.fixed_point_histograms` holds (the card), the rows are
    quantised at their exponent, added with an int64 `index_add_` (whose
    integer sums do not depend on the atomics' order) and converted once:
    the same bits as the kernels on the same rows. The expanded values,
    n * F pairs, double from 8 to 16 bytes a pair: at 11M x 28, 2.46 GB
    of float32 become 4.93 GB of int64, beside the 2.46 GB int64 index.
    `flat` (a float slab to add into) is the float scatter's alone."""
    from repro_torch.kernels import ops  # lazy: ops imports kernels.ref -> here

    if ops.fixed_point_histograms(bins.device):
        if flat is not None:
            raise ValueError("flat= adds float (g, h); a fixed-point slab takes "
                             "histogram_chunk_update with the pass's exponent")
        k = ops.fixed_point_exponent(gh)
        acc = scatter_histograms(bins, FX.quantise(gh, k), positions, n_nodes, max_bins)
        return ops.dequantise(acc, k)
    return scatter_histograms(bins, gh, positions, n_nodes, max_bins, flat)


def scatter_histograms(
    bins: torch.Tensor,  # (n, f) int bin ids
    values: torch.Tensor,  # (n, 2) (g, h): float, or int64 quantised
    positions: torch.Tensor,  # (n,) int level-local node ids, n_nodes = inactive
    n_nodes: int,
    max_bins: int,
    flat: torch.Tensor | None = None,  # (n_nodes + 1, f, max_bins, 2) slab to add into
) -> torch.Tensor:
    """The scatter-add itself: (n_nodes, n_features, max_bins, 2) in
    values' dtype.

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
        flat = torch.zeros((n_nodes + 1, f, max_bins, 2), dtype=values.dtype,
                           device=bins.device)
    flat.view(-1, 2).index_add_(0, idx.reshape(-1),
                                values[:, None, :].expand(n, f, 2).reshape(-1, 2))
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
    (n_nodes + 1, F, max_bins, 2), the last node the dump slot; int64 where
    `ops.fixed_point_histograms` holds for `device`, float32 elsewhere."""
    from repro_torch.kernels import ops

    fixed = ops.fixed_point_histograms(device)
    return torch.zeros((n_nodes + 1, n_features, max_bins, 2),
                       dtype=torch.int64 if fixed else torch.float32, device=device)


def slab_exponent(slab: torch.Tensor, gh: torch.Tensor) -> torch.Tensor | None:
    """The exponent of a pass into `slab` whose rows' (g, h) are all of `gh`
    (the whole pass's, not a chunk's): what every chunk update and the
    finalize of a fixed-point slab take, so that the pass adds the integers
    of one resident call: the exponent kernel on the card. None for a float
    slab."""
    from repro_torch.kernels import ops

    return ops.fixed_point_exponent(gh) if slab.dtype == torch.int64 else None


def histogram_chunk_update(
    hist: torch.Tensor,  # (n_nodes + 1, f, max_bins, 2) running slab
    words_c: torch.Tensor,  # (f, words_per_chunk) int32: one paged-in chunk
    gh_c: torch.Tensor,  # (rows, 2) float32: this chunk's gradient slice
    pos_c: torch.Tensor,  # (rows,) int32: this chunk's position slice
    n_nodes: int,
    max_bins: int,
    bits: int,
    exponent: torch.Tensor | None = None,  # the pass's (slab_exponent); int64 slab
) -> torch.Tensor:
    """Add ONE chunk's rows into the running slab, the streamed twin of
    build_histograms_chunked: the privatised kernel's flat instantiation
    over the chunk's words on a CUDA tensor (one launch, added into the
    slab's first n_nodes nodes), its plain version on a CPU tensor
    (scattered into the slab in row order). Chunk after chunk is bit for bit
    one build over all rows: in row order for a float slab, and as the same
    integers at the pass's `exponent` for a fixed-point one. Returns
    `hist`."""
    from repro_torch.kernels import ops  # lazy: ops imports kernels.ref -> here

    ops.histogram_private_op(words_c, gh_c, pos_c, n_nodes, max_bins, bits, out=hist,
                             exponent=exponent)
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
    exponent: torch.Tensor | None = None,  # the pass's (slab_exponent); int64 slab
) -> torch.Tensor:
    """Add one chunk-segment of a compacted row buffer into the running
    slab, the streamed twin of build_histograms_chunked_rows: the row-id
    kernel's flat instantiation over the chunk's words with chunk-local row
    ids. The caller splits the ascending buffer into per-chunk segments, so
    segments in chunk order add each slot's terms in the buffer's order
    (a fixed-point slab: the same integers at the pass's `exponent`).
    Returns `hist`."""
    from repro_torch.kernels import ops

    ops.histogram_rows(words_c, gh_b, pos_b, rid_local, n_nodes, max_bins, bits, out=hist,
                       exponent=exponent)
    return hist


def finalize_slab_histogram(hist: torch.Tensor, n_nodes: int, max_bins: int,
                            exponent: torch.Tensor | None = None) -> torch.Tensor:
    """(n_nodes + 1, f, max_bins, 2) running slab -> (n_nodes, f, max_bins,
    2) float32 histogram: the dump slot dropped; an int64 slab converted
    once at the pass's `exponent` (given none, at the slab's own)."""
    if hist.shape[0] != n_nodes + 1 or hist.shape[2] != max_bins:
        raise ValueError(f"a slab of {n_nodes} nodes and {max_bins} bins is "
                         f"({n_nodes + 1}, F, {max_bins}, 2), got {tuple(hist.shape)}")
    if hist.dtype == torch.int64:
        from repro_torch.kernels import ops

        if exponent is None:  # the slab's own (fixed.running_exponent), if it has one
            exponent = getattr(hist, "fixed_exponent", None)
        if exponent is None:  # nothing added: zeros at any exponent
            exponent = torch.zeros((), dtype=torch.int32, device=hist.device)
        return ops.dequantise(hist[:n_nodes], exponent)
    return hist[:n_nodes]


def node_sums(hist: torch.Tensor) -> torch.Tensor:
    """Total (G, H) per node, (n_nodes, 2): every feature's bins partition
    the same rows, so feature 0's suffice."""
    return hist[:, 0].sum(dim=1)
