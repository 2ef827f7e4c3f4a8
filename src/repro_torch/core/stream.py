"""Streamed external-memory training; counterpart of `repro.core.stream`.

Resident paging (`ExternalDMatrix.packed_bins()`) puts the whole compressed
chunk stack on the device before the fit. Streamed paging keeps it on the
host: `StreamedChunkedBins` answers the questions growth, routing and
traversal ask of a bins type (`feature_bins`, `histograms`,
`histograms_rows`, `traverse`; as `compress.PackedBins` and
`compress.ChunkedPackedBins` do) by paging the stack one chunk at a time
through the matrix's `ChunkPager` (on a card: a ring of
prefetch_chunks + 1 pinned and device slots, the copy of chunk k+1 on a
copy stream overlapping the kernels on chunk k) and launching the existing
kernels once a chunk, their flat instantiation over the chunk's words:

  * `histograms` (a level in full): every chunk added into one running
    slab (`histogram.histogram_chunk_update`, the privatised kernel with
    `out=`);
  * `histograms_rows` (a compacted, ascending row buffer): the buffer split
    into per-chunk segments by one `torch.searchsorted` over the chunk
    bounds and one host read of the n_chunks + 1 bounds, each segment
    added with chunk-local row ids (`histogram_rows_chunk_update`, the
    row-id kernel); chunks with no selected row are never paged;
  * `feature_bins` (routing, once a level): each row's (or buffer slot's)
    bin filled in one pass over the chunks;
  * `traverse` (the round's margin update): each chunk walked to its
    leaves as a `PackedBins` of its words, all of a round's trees at once.

A depth-6 round of the default growth pages the stack about 13 times: 1
pass for the root, up to 5 for the row buffers below it, 6 routing passes
and 1 traversal. The round loop is `Booster._run_rounds`, which reaches
these through `Booster._bins`: no second loop.

A streamed fit is bit for bit the resident and the flat fit, on the CPU
and on the card: on the CPU each histogram slot's terms are added in global
row (or buffer) order in all three; on the card each pass quantises every
row at the exponent of the whole pass's (g, h) (`H.slab_exponent`), so its
chunks add the integers of one resident call into an int64 slab, converted
once. Routing and traversal are elementwise.
Counters, with the reference's meaning: `rows_touched` (rows scattered
into histograms) and `chunks_paged` (chunks the pager served); and
`row_segments` (row-buffer segments added, one row-id launch each on the
card) and `device_slots` (the most device slots one of its pagers held).
"""
from __future__ import annotations

import torch

from repro_torch.core import compress as C
from repro_torch.core import histogram as H


class StreamedChunkedBins:
    """A bins type over an ExternalDMatrix's host chunk stack, paged chunk
    by chunk (see the module docstring)."""

    def __init__(self, source):
        self.source = source  # ExternalDMatrix
        self.bits = source.bits
        self.chunk_rows = source.chunk_rows
        self.n_rows = source.n_rows
        self.rows_touched = 0
        self.chunks_paged = 0
        self.row_segments = 0
        self.device_slots = 0

    @property
    def n_chunks(self) -> int:
        return self.source.n_chunks

    @property
    def n_features(self) -> int:
        return self.source.n_features

    def iter_chunks(self, indices=None):
        """(index, chunk words) pairs through the source's pager; a chunk is
        valid until the next is asked for."""
        pager = self.source.chunk_pager(indices)
        self.device_slots = max(self.device_slots, pager.device_slots)
        for i, words in pager:
            self.chunks_paged += 1
            yield i, words

    def _rows(self, i: int) -> tuple[int, int]:
        s = i * self.chunk_rows
        return s, min(s + self.chunk_rows, self.n_rows)

    def _segments(self, row_ids: torch.Tensor) -> list[tuple[int, int, int]]:
        """(chunk, start, end) of each chunk's segment of an ASCENDING
        global row-id buffer: slots [start, end) hold rows of that chunk.
        Ids past the last chunk bound (subtraction-buffer padding) fall in
        no segment and are dropped; they only ever scatter into the dump
        slot. One searchsorted on the ids' device, one host read."""
        bounds = torch.arange(1, self.n_chunks + 1, dtype=torch.int64,
                              device=row_ids.device) * self.chunk_rows
        ends = torch.searchsorted(row_ids.to(torch.int64), bounds)
        edges = torch.cat([ends.new_zeros(1), ends]).tolist()
        return [(i, edges[i], edges[i + 1]) for i in range(self.n_chunks)
                if edges[i + 1] > edges[i]]

    # --- histograms ----------------------------------------------------------
    def histograms(self, gh, positions, n_nodes: int, max_bins: int) -> torch.Tensor:
        """A level in full: every chunk's rows added into one running slab."""
        slab = H.new_slab(n_nodes, self.n_features, max_bins, gh.device)
        k = H.slab_exponent(slab, gh)
        for i, words in self.iter_chunks():
            s, e = self._rows(i)
            H.histogram_chunk_update(slab, words, gh[s:e], positions[s:e], n_nodes,
                                     max_bins, self.bits, exponent=k)
            self.rows_touched += e - s
        return H.finalize_slab_histogram(slab, n_nodes, max_bins, exponent=k)

    def histograms_rows(self, gh_sel, pos_sel, row_ids, n_nodes: int,
                        max_bins: int) -> torch.Tensor:
        """A compacted row buffer (ascending global row ids): each chunk's
        segment added with chunk-local row ids; chunks with no selected row
        are never paged."""
        slab = H.new_slab(n_nodes, self.n_features, max_bins, gh_sel.device)
        k = H.slab_exponent(slab, gh_sel)
        segments = {i: (s, e) for i, s, e in self._segments(row_ids)}
        for i, words in self.iter_chunks(list(segments)):
            s, e = segments[i]
            H.histogram_rows_chunk_update(slab, words, gh_sel[s:e], pos_sel[s:e],
                                          row_ids[s:e] - i * self.chunk_rows, n_nodes,
                                          max_bins, self.bits, exponent=k)
            self.rows_touched += e - s
            self.row_segments += 1
        return H.finalize_slab_histogram(slab, n_nodes, max_bins, exponent=k)

    # --- routing -------------------------------------------------------------
    def feature_bins(self, feat: torch.Tensor, row_ids: torch.Tensor | None = None):
        """bins[row, feat[..., i]] of row i, or of global row row_ids[i]
        (ascending), in one pass over the chunks."""
        out = torch.zeros(feat.shape, dtype=torch.int32, device=feat.device)
        if row_ids is None:
            for i, words in self.iter_chunks():
                s, e = self._rows(i)
                out[..., s:e] = C.gather_feature_bins(words, self.bits, feat[..., s:e])
            return out
        segments = {i: (s, e) for i, s, e in self._segments(row_ids)}
        for i, words in self.iter_chunks(list(segments)):
            s, e = segments[i]
            out[..., s:e] = C.gather_feature_bins_rows(words, self.bits, feat[..., s:e],
                                                       row_ids[s:e] - i * self.chunk_rows)
        return out

    # --- traversal -----------------------------------------------------------
    def traverse(self, feature, split_bin, default_left, leaf_value, is_leaf,
                 missing_bin: int, max_depth: int) -> torch.Tensor:
        """Leaf outputs (t, n_rows) of t tree arenas (t, a): each chunk
        walked as a `PackedBins` of its words, in one pass over the stack."""
        out = torch.empty((feature.shape[0], self.n_rows), dtype=leaf_value.dtype,
                          device=leaf_value.device)
        for i, words in self.iter_chunks():
            s, e = self._rows(i)
            out[:, s:e] = C.PackedBins(words, self.bits, e - s).traverse(
                feature, split_bin, default_left, leaf_value, is_leaf, missing_bin,
                max_depth)
        return out
