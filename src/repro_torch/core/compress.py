"""Bit-packed quantised matrix (paper §2.2); counterpart of `repro.core.compress`.

Bin ids are packed into 32-bit words with `bits = ceil(log2(max_value+1))`
bits each. The layout is bit-identical to `repro.core.compress.pack`:
column-major per feature (symbols of feature f occupy packed[f, :]),
`spw = 32 // bits` symbols per word, symbol j of a word at shift j*bits, no
symbol straddling two words, rows zero-padded to a multiple of spw.

Words are stored as int32 tensors holding the uint32 bit patterns: torch on
the CPU has no `>>` on uint32, so shifts run in int64 after masking with
0xFFFFFFFF. The CUDA kernels read the same memory as `uint32_t`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_WORD_MASK = 0xFFFFFFFF


def bits_needed(max_value: int) -> int:
    """ceil(log2(max_value + 1)), minimum 1."""
    return max(1, int(max_value).bit_length())


def symbols_per_word(bits: int) -> int:
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    return 32 // bits


def words_as_uint(packed: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, as int64."""
    return packed.to(torch.int64) & _WORD_MASK


def pack(bins: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (n_rows, n_features) int bins -> (n_features, n_words) int32 words."""
    n, f = bins.shape
    spw = symbols_per_word(bits)
    n_pad = (-n) % spw
    b = bins.to(torch.int64) & ((1 << bits) - 1)
    b = torch.nn.functional.pad(b, (0, 0, 0, n_pad))
    b = b.t().reshape(f, -1, spw)
    shifts = torch.arange(spw, dtype=torch.int64, device=bins.device) * bits
    words = (b << shifts).sum(dim=-1)  # disjoint bit fields: sum == or
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack(packed: torch.Tensor, bits: int, n_rows: int) -> torch.Tensor:
    """Inverse of pack: (n_features, n_words) words -> (n_rows, n_features) int32."""
    spw = symbols_per_word(bits)
    shifts = torch.arange(spw, dtype=torch.int64, device=packed.device) * bits
    b = (words_as_uint(packed)[:, :, None] >> shifts) & ((1 << bits) - 1)
    return b.reshape(packed.shape[0], -1)[:, :n_rows].t().to(torch.int32)


def _traverse_on(bins, feature, split_bin, default_left, leaf_value, is_leaf,
                 missing_bin: int, max_depth: int) -> torch.Tensor:
    """Leaf outputs (t, n_rows) of t tree arenas (t, a) over a resident
    packed layout: all rows one level per step, each step's bins through
    `bins.feature_bins` (one word gather and a shift/mask per (tree, row))."""
    from repro_torch.core import predict as PR  # predict imports this module

    return PR._traverse(feature, split_bin, default_left, leaf_value, is_leaf, bins.n_rows,
                        missing_bin, max_depth, bins.feature_bins)


@dataclass(frozen=True)
class PackedBins:
    """The bit-packed matrix as the training representation: the tree grows
    straight from these words, the dense (n, f) bins never exist.

    It, `ChunkedPackedBins` and the streamed `stream.StreamedChunkedBins`
    answer the same four questions, so growth, routing and traversal never
    ask which layout they read: `feature_bins` (a row's bin of one
    feature), `histograms` (a level in full, the privatised kernel),
    `histograms_rows` (a compacted row buffer, the row-id kernel) and
    `traverse` (trees walked to their leaves over all rows)."""

    packed: torch.Tensor  # (n_features, n_words) int32 bit patterns
    bits: int
    n_rows: int

    @property
    def n_features(self) -> int:
        return self.packed.shape[0]

    def feature_bins(self, feat: torch.Tensor, row_ids: torch.Tensor | None = None):
        """bins[row, feat[..., i]] of row i, or of row row_ids[i]."""
        if row_ids is None:
            return gather_feature_bins(self.packed, self.bits, feat)
        return gather_feature_bins_rows(self.packed, self.bits, feat, row_ids)

    def histograms(self, gh, positions, n_nodes: int, max_bins: int) -> torch.Tensor:
        from repro_torch.core import histogram as H  # H's builders reach kernels.ops

        return H.build_histograms_packed(self.packed, gh, positions, n_nodes, max_bins,
                                         self.bits)

    def histograms_rows(self, gh_sel, pos_sel, row_ids, n_nodes: int,
                        max_bins: int) -> torch.Tensor:
        from repro_torch.core import histogram as H

        return H.build_histograms_packed_rows(self.packed, gh_sel, pos_sel, row_ids,
                                              n_nodes, max_bins, self.bits)

    traverse = _traverse_on


@dataclass(frozen=True)
class ChunkedPackedBins:
    """The chunk-stacked packed matrix: the external-memory training
    representation (`ExternalDMatrix.packed_bins()`).

    Each chunk of `chunk_rows` rows is packed on its own and the chunks are
    stacked on a leading axis. Row r lives in chunk r // chunk_rows at
    offset r % chunk_rows; each chunk is padded with zero words to
    `words_per_chunk` = ceil(chunk_rows / spw), and the last chunk may be
    logically short (`n_rows` bounds the real rows). Both histogram
    kernels read the whole stack in one launch."""

    packed: torch.Tensor  # (n_chunks, n_features, words_per_chunk) int32 bit patterns
    bits: int
    chunk_rows: int
    n_rows: int

    @property
    def n_chunks(self) -> int:
        return self.packed.shape[0]

    @property
    def n_features(self) -> int:
        return self.packed.shape[1]

    @property
    def words_per_chunk(self) -> int:
        return self.packed.shape[2]

    @property
    def padded_rows(self) -> int:
        return self.packed.shape[0] * self.chunk_rows

    def feature_bins(self, feat: torch.Tensor, row_ids: torch.Tensor | None = None):
        """bins[row, feat[..., i]] of row i, or of global row row_ids[i],
        each read from its row's chunk."""
        if row_ids is None:
            row_ids = torch.arange(feat.shape[-1], dtype=torch.int64, device=feat.device)
        return gather_feature_bins_chunked(self.packed, self.bits, self.chunk_rows, feat,
                                           row_ids)

    def histograms(self, gh, positions, n_nodes: int, max_bins: int) -> torch.Tensor:
        from repro_torch.core import histogram as H

        return H.build_histograms_chunked(self.packed, gh, positions, n_nodes, max_bins,
                                          self.bits, self.chunk_rows, self.n_rows)

    def histograms_rows(self, gh_sel, pos_sel, row_ids, n_nodes: int,
                        max_bins: int) -> torch.Tensor:
        from repro_torch.core import histogram as H

        return H.build_histograms_chunked_rows(self.packed, gh_sel, pos_sel, row_ids,
                                               n_nodes, max_bins, self.bits,
                                               self.chunk_rows)

    traverse = _traverse_on



def _chunk_word_index(bits: int, chunk_rows: int, n_chunks: int, row_ids: torch.Tensor):
    """(chunk, word offset in the chunk, shift) of each global row id,
    clipped into the padded range as the reference clips them."""
    spw = symbols_per_word(bits)
    r = torch.clamp(row_ids.to(torch.int64), 0, n_chunks * chunk_rows - 1)
    c = r // chunk_rows
    off = r % chunk_rows
    return c, off // spw, (off % spw) * bits


def gather_rows_chunked(packed: torch.Tensor, bits: int, chunk_rows: int,
                        row_ids: torch.Tensor) -> torch.Tensor:
    """All features' bins of a set of global row ids straight from the
    chunk stack: (m,) row ids -> (m, n_features) int32, one word gather per
    (row, feature). Out-of-range ids are clipped into the padded range, so
    padding slots may carry a sentinel (their bins are garbage: route them
    to a dump slot)."""
    n_chunks, f, _ = packed.shape
    c, w, shift = _chunk_word_index(bits, chunk_rows, n_chunks, row_ids)
    fidx = torch.arange(f, dtype=torch.int64, device=packed.device)[None, :]
    words = words_as_uint(packed[c[:, None], fidx, w[:, None]])  # (m, f)
    return ((words >> shift[:, None]) & ((1 << bits) - 1)).to(torch.int32)


def gather_feature_bins_chunked(packed: torch.Tensor, bits: int, chunk_rows: int,
                                feat: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
    """gather_feature_bins_rows over the chunk stack: bins[row_ids[i],
    feat[..., i]], each global row id resolved to (chunk, offset) and one
    word of its chunk gathered."""
    c, w, shift = _chunk_word_index(bits, chunk_rows, packed.shape[0], row_ids)
    word = words_as_uint(packed[c, feat.to(torch.int64), w])
    return ((word >> shift) & ((1 << bits) - 1)).to(torch.int32)


def unpack_chunked(packed: torch.Tensor, bits: int, chunk_rows: int,
                   n_rows: int) -> torch.Tensor:
    """The dense (n_rows, n_features) int32 bins of a chunk stack: each
    chunk unpacked, the chunks' padding dropped."""
    parts = [unpack(packed[i], bits, min(chunk_rows, n_rows - i * chunk_rows))
             for i in range(packed.shape[0])]
    return torch.cat(parts, dim=0)


def gather_feature_bins(packed: torch.Tensor, bits: int, feat: torch.Tensor) -> torch.Tensor:
    """bins[i, feat[..., i]] for every row i straight from the packed words:
    one word gather plus a shift/mask per row. feat is (n,) int, or (t, n)
    for t trees at once."""
    row = torch.arange(feat.shape[-1], dtype=torch.int64, device=feat.device)
    return gather_feature_bins_rows(packed, bits, feat, row)


def gather_feature_bins_rows(packed: torch.Tensor, bits: int, feat: torch.Tensor,
                             row_ids: torch.Tensor) -> torch.Tensor:
    """gather_feature_bins for any row set: bins[row_ids[i], feat[..., i]]
    per buffer slot i (the routing of subsampled growth), at the same cost:
    one word gather plus a shift/mask per slot."""
    spw = symbols_per_word(bits)
    row = row_ids.to(torch.int64)
    word = words_as_uint(packed[feat.to(torch.int64), row // spw])
    shift = (row % spw) * bits
    return ((word >> shift) & ((1 << bits) - 1)).to(torch.int32)


@dataclass(frozen=True)
class CompressedMatrix:
    """The quantised + bit-packed training matrix ("ELLPACK page" analogue)."""

    packed: torch.Tensor  # (n_features, n_words) int32 bit patterns
    cuts: torch.Tensor  # (n_features, n_cuts) float32
    bits: int
    n_rows: int
    max_bins: int

    @property
    def n_features(self) -> int:
        return self.packed.shape[0]

    def unpack(self) -> torch.Tensor:
        """(n_rows, n_features) int32 bins: the decompress kernel on the
        card, its plain version (`unpack`) on the CPU."""
        from repro_torch.kernels import ops  # ops imports this module

        return ops.decompress_op(self.packed, self.bits, self.n_rows)

    def nbytes_compressed(self) -> int:
        return self.packed.numel() * 4

    def nbytes_dense_fp32(self) -> int:
        return self.n_rows * self.n_features * 4

    def compression_ratio(self) -> float:
        return self.nbytes_dense_fp32() / self.nbytes_compressed()

    def as_packed_bins(self) -> PackedBins:
        return PackedBins(packed=self.packed, bits=self.bits, n_rows=self.n_rows)


def compress(bins: torch.Tensor, cuts: torch.Tensor, max_bins: int) -> CompressedMatrix:
    """Quantised matrix -> compressed form with the minimal bit width for
    the largest bin id present (as the paper and the reference do)."""
    bits = bits_needed(int(bins.max()))
    return CompressedMatrix(
        packed=pack(bins, bits),
        cuts=cuts,
        bits=bits,
        n_rows=bins.shape[0],
        max_bins=max_bins,
    )
